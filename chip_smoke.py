#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

Run from the repository root:  python3 chip_smoke.py [--profile]

Phases, one JSON line each (a few print several); any failure raises and
exits non-zero:

1. device  -- the card (``nvidia-smi`` name and power limit on a line of
   its own), torch and CUDA versions.
2. build   -- every ``objectdetectionpl_tpu_torch/csrc/*.cu`` compiled with
   nvcc for sm_90a into ``build/kernels/``, one nvcc per source, all
   started together: ptxas's registers, spills and shared memory per
   kernel, and its performance warnings; any spill fails the phase.
3. kernel  -- ``greedy_nms`` (CUDA) against ``greedy_nms_plain`` on the card
   over the listed cases (one with 80 classes at B=64, pairs whose IoU
   lies within ulps of the threshold, a negative threshold; the anchor
   families' scan, class-agnostic without merge at IoU 0.5 and K=100, at
   B=1 and B=64, ``drop_lone_survivor`` off and on; a last kept row that
   is lone, which the flag must drop, and one that is not): ``keep``
   identical, boxes within rtol=1e-4, atol=1e-3 on all
   rows; then timings at K=300, B=1 and B=256 with 5 classes and B=64 with
   80, and the anchor scan at B=64 with the flag on: the kernel's device
   time (CUDA events) and host-inclusive time per call; the plain
   version's host-inclusive time (a Python loop of ~100 to ~1200
   launches); the greedy chain's length (kept heads per image, mean, max);
   the K > 1024 route's device time on the same candidates (launched
   through ``greedy_nms_tiled_launch``, uncounted, its result checked
   first); the bound counts the pairs of one label (class-aware) or all
   pairs.
3a. kernel_wide -- the K > 1024 route (a partition kernel that splits each
   image's rows by label into segments, a segment kernel that runs each
   segment's chain) against ``greedy_nms_plain`` at K = 1025, 2048, 4096,
   B = 1 and 8, 80 classes: class-aware with merge and with
   ``drop_lone_survivor``, class-agnostic without merge with the flag off
   and on, and near-threshold pairs, within a tile and (K = 2048, 4096) a
   tile apart, so that the cross-tile test decides them; one label, two
   labels of which one holds 95 % of the rows, and labels over 0..2999
   (past the partition's histogram: the workspace header must count every
   image on the one-segment path); each check must count one tiled
   launch.  Then its device time at K = 2048, 4096 and 25,200, B = 1 and
   64, with 80 labels and (K=25,200) one label, with the segments, the
   chain length, K x kept heads, the bound, and the plain version's time
   at B=1.
4. fp32    -- YOLOv5s-640, 80 classes, B=2, f32 with TF32 off: head maps on
   the card against the CPU on the same seeded weights; the card's decoded
   candidates through the kernel and the plain version.
5. serving -- ``make_predict_step``'s ``predict_step(state, images)`` on
   YOLOv5s-640, 80 classes, bf16, /255 folded into the stem, uint8 input,
   a state without EMA (the module's own weights): 3 batches at B=1 and 3
   at B=64 after one warm-up each.  Every launch count is zeroed just
   before and read just after; every batch must launch the NMS kernel
   once.  Then serving_all: the same with every decoded row into the NMS
   (``top_k`` 25,200, ``conf_thres`` 0.001, as an mAP evaluation runs):
   each batch launches the K > 1024 route once and the plain version never;
   the B=1 candidates through the kernel and the plain version, both
   timed, and the B=64 kernel time, with every eighth image of that batch
   held against the plain version one image at a time and the whole batch
   against ``greedy_nms_segmented_plain``.
5a. export -- the serving export (``utils/export.py``): YOLOv5s-640, 80
   classes, bf16, /255 folded, ``build_inference_fn`` saved with
   ``torch.export`` at B=1 and B=64 and loaded in this process: ``valid``,
   ``labels`` and ``scores`` identical to eager ``predict_step`` on the
   same weights and batch, the largest box difference stated (0
   expected); one NMS launch per call of the loaded program (counts
   zeroed before, read after); ms a batch of eager and loaded, one warm-up
   and three requests; seconds to export and the ``.pt2`` size; at B=64
   one profiled call of each, device time by kernel class.  Then a
   fresh interpreter that imports only ``utils.export`` loads both
   programs and runs each once: one launch a call, no model module
   imported, detections identical.  Then SSD-300 once (the divide path and
   the class-agnostic NMS), loaded against its module.  Then across
   devices (``export_cross``): YOLOv5s-640 f32 exported on the CPU and
   loaded on the card (``utils.export.load``'s default device), and the
   B=1 bf16 program exported on the card loaded with ``device="cpu"``:
   each against the eager chain on the device it runs on, ``valid``,
   ``labels`` and ``scores`` identical and the largest box difference
   stated (0 expected: the same operations on the same device); one NMS
   launch on the card for the first, none for the second.
5b. bench -- the port bench (``objectdetectionpl_tpu_torch/bench.py``,
   YOLOv5s-640, 10 classes, bf16, folded) at B=64 and B=256, dense and
   ``--prefilter`` alternated (D P P D) in this process, each printing its
   JSON line; every run must launch the NMS kernel once per iteration
   (2 warm-up + 20); then both chains on one batch: every output of the
   prefilter identical to the dense chain's.
6. warp_check -- ``affine_warp`` (CUDA) against ``affine_warp_plain`` on
   the card: K=26 slots of 640x640 with random shift-scale-rotate matrices
   inside the ``AugmentConfig`` bounds, the identity, a 60 degree rotation
   at scale 0.5, a shift that maps every pixel outside, and 37x53 images;
   then ``affine_warp_slots`` against ``affine_warp_slots_plain`` with
   slots of a B=64 batch in coin order (not sorted): all warped, none
   (the copy path), the training mix, the 60 degree / 0.5 matrix (taps
   from global memory), and a mix on 37x53 images (stores by element);
   and the slots the anchor families' training gives it: B=32 batches of
   600x600 and 300x300 with the training mix of K=13, 16-byte stores with
   partial 32-pixel tiles at the right and bottom edges;
   each case must reach the paths it names (``tile_plan``).  Expected
   difference exactly 0 (the kernel's coordinate arithmetic is the plain
   version's IEEE operation sequence); tolerance 1e-6.
7. warp_time -- K=26 slots of a B=64 batch, 640x640x3: the kernel's device
   and host-inclusive time with every slot warped, its bound, the plain
   version's time and the library yardstick ``F.affine_grid`` +
   ``F.grid_sample`` (bilinear, zeros, align_corners=False), which the
   port never calls; the kernel on the training mix (about half the slots
   warped); the SSR tail of ``augment_batch``, the slot call through
   ``index_copy_``.
8. train_fp32 -- one YOLOv5s-640 train step, 80 classes, B=2, f32 with
   TF32 off, on the card and on the CPU from the same seeded weights and
   batch, augmentation skipped (the same ``u`` with every coin >= p):
   loss, d(loss)/d(head maps) and the BN running statistics after the
   step, within the tolerances stated at ``TRAIN_TOL``.
9. training -- the main path: YOLOv5s-640, 80 classes, bf16 compute, Adam
   lr 1e-3 / wd 1e-5, B=64, M=32 boxes per image; each step uint8 images
   on the card -> /255 -> ``augment_batch`` (warp kernel) ->
   ``train_step``; one warm-up and 3 timed steps.  Every launch count is
   zeroed just before and read just after; each ``augment_batch`` call must
   launch the warp kernel once.  Then ``accum_steps=2`` at B=8 with
   weights [1, 0] must leave the BN statistics equal to a step on the
   first microbatch alone.
9a. optim_check -- SGD (momentum 0.9), RMSprop (alpha 0.95, momentum 0.9)
   and Adagrad (``lr_decay`` 0 and 1e-2), each with weight decay 1e-5 and
   lr 1e-2, 5 steps of seeded gradients over the YOLOv5s-640 parameter
   shapes, fp32: parameters and optimizer state on the card against the
   CPU within ``OPTIM_TOL``; ms per step on the card.
9b. remat_check -- YOLOv5s-640, bf16, B=64 under ``remat`` none, early
   and all: one step from the same weights and batch with cuDNN's
   deterministic algorithms, loss and gradients of early and all against
   none (``REMAT_TOL``) and BN statistics equal; then uint8 -> /255 ->
   ``augment_batch`` -> ``train_step``, one warm-up and three timed steps
   (counts zeroed before, read after: one warp launch a step), ms per
   step and the peak memory over them.
9c. mosaic_check -- ``mosaic_batch`` at B=64, 640 px, p=1 on the card
   against the CPU on the same draws: images within ``MOSAIC_TOL``,
   boxes, labels and masks equal; ms per call.
10. trainer -- the user's entry point, in this process:
   ``cli.run.main`` on ``configs/config.yaml`` with YOLOv5s, 640 px, bf16,
   Synthetic (``synthetic_size`` 256, so that val and test hold two
   batches of 32), B=32, accumulation 2, 4 train, 2 val and 2 test batches,
   2 epochs, ``log_dir`` a temporary directory under ``build/``.  Every
   launch count is zeroed just before and read just after: the warp kernel
   must have launched once per training microbatch (8) and the NMS kernel
   once per test batch (2).  The test must give a finite mAP table, the
   run a checkpoint on disk; the best checkpoint, restored into a fresh
   state on the card, must equal the saved tensors bit for bit.  Prints
   each epoch's wall time, images/s (the Trainer's
   ``throughput/images_per_sec``), losses, the Loader's resize path and
   the peak memory.
10'. ddp -- data parallelism (``parallel/``), in processes of their own
   (``parallel/dryrun.py::spawn``, torchrun's environment): (a) two ranks
   on the one card over gloo (NCCL refuses two ranks on one device),
   YOLOv5s-640, 80 classes, f32 with TF32 off, B=4 a rank, accumulation
   2, ``mosaic_batch`` p=1 and ``augment_batch``, Adam, 3 steps; each
   step against this process stepping on the concatenated microbatches
   with the same draws from rank 0's state before that step: loss,
   parameter norm, Adam's first moment and the share of parameters whose
   update took the other sign within ``DDP_TOL`` (f32 reduction order),
   that share above it for a step on rank 0's rows alone (no collective),
   the two ranks' parameters equal; each rank's counts zeroed before and read after its
   steps, one warp launch a microbatch; step ms of 2 ranks (gloo over the
   host) and of 1 process.  (b) ``cli.run.main`` as rank 0 of a world of
   1 over NCCL (it joins the group from the environment, prints ``[run]
   distributed: process 0 / 1`` and leaves at exit; one all-reduce of
   a 1 inside its fit must give 1): YOLOv5s-640, bf16, one epoch of
   Synthetic with test on, counts zeroed before and read after: 2 warp
   launches, 1 NMS launch.  (c) ``dryrun_multichip(2)`` on the card over
   gloo: the four families' one-step losses finite and equal on both
   ranks.
10''. tp -- the mesh's model axis (``parallel/mesh.py``): four ranks on
   the card over gloo, (data=2, model=2), YOLOv2-416, 80 classes, TF32
   off, split by ``shard_model_parallel`` (the 425-channel head stays
   replicated), each data index's 2 rows of a 4-image batch: uint8 ->
   /255 -> ``augment_batch`` -> one SGD step (lr 1), counts zeroed before
   and read after (one warp launch a rank); once computing in f32, once in
   f64.  Against this process on the 4 rows: loss and BN statistics, the
   split parameters' gradients (the update of the gathered parameters) in
   relative L2, within ``TP_TOL``; half of ``ConvBN_13``'s channels on
   each rank, the same gathered state on all four, ranks at row-major
   (data, model) coordinates; step ms of the ranks and of one process.
10a. jpeg_check -- the port's host library (``csrc/preproc.cc`` and the
   JPEG decoder ``csrc/jpeg_decode.cc``) built with g++ (seconds, or
   ``native.build_error``, which fails the phase);
   every decodable fixture (``data/testdata``, baseline and progressive)
   decoded and its RGB bytes' SHA-256 held against the committed libjpeg
   hash, the two 1280x720 frames (baseline, progressive) also at 1/2, 1/4
   and 1/8; the CMYK fixture must raise naming its path where libjpeg's
   RGB output (the fused route) reads it, and decode where cv2.imread
   (the parser route) does; ``decode_batch``
   over the fixtures x 32 at 1 thread and at the Loader's thread count: ms
   per image, MP/s, ``os.cpu_count()``; and each frame's ms per image at
   each scale and both thread counts (``tools/decode_bench.py``), timed on
   the host's CPU.  Then jpeg_headers: the damaged headers of
   ``format_files.header_cases`` (31 files patched from the fixtures),
   each decode equal to cv2's committed hash
   (``formats/headers_sha256.json``) or refused where cv2 refuses, and
   the fused route reading exactly the cases the JAX library read; and
   ``format_files.idct_case`` (the 640x480 fixture's luma scan read with
   the chroma tables: huge coefficients through the reduced IDCTs) at
   1/1, 1/2, 1/4 and 1/8 through both routes' decoders, each equal to
   cv2's hash at that scale (``formats/idct_sha256.json``), the fused
   call reading it at each denominator.
10a'. formats -- the files a scraped tree holds
   (``tools/format_files.py``: a baseline JPEG, CMYK, YCCK, arithmetic
   sequential and progressive, a cut baseline JPEG, a cut progressive one
   (block smoothing), a damaged JPEG, a lossless JPEG, PNG RGB 8-bit,
   grey 16-bit Adam7, 4-bit palette, a PNG named .jpg, BMP 24-bit and
   RLE8, WebP VP8, VP8L and VP8X with alpha, TIFF LZW strips, Deflate
   tiles, an 8-bit palette and 16-bit RGB, JPEG 2000 (cv2's lossy and
   lossless 500x375 JP2s, a tiled three-layer 9/7 JP2, an RPCL J2K with
   precincts, a J2K with every code-block style bit, SOP/EPH and
   tile-parts, a 16-bit grey JP2), GIF (256 colours at 500x375, an
   interlaced transparent frame at an offset), a PPM, a 16-bit ASCII
   PGM, a PAM, a PFM, Sun rasters (24-bit, 8-bit mapped), a Radiance
   HDR, and TIFFs of JPEG compression (the 500x375 JPEG split into
   JPEGTables and a strip, libtiff's YCbCr strips and tiles, the CMYK
   JPEG), YCbCr units (2x2, clipped 4x4 tiles), CMYK, CIELab, CCITT RLE,
   Group 3 2-D and Group 4, FillOrder 2, old-style LZW, ThunderScan,
   signed samples, SGILog LogLuv and LogL), AVIF (cv2.imwrite's default
   with CDEF and quantizer matrices, Pillow's default, 4:4:4, 4:2:2,
   4:0:0, lossless, two tiles of 128x128 superblocks, an odd 167x125, a
   500x375, Wiener and self-guided loop restoration, superres at
   denominator 16 over two tile columns, film grain, palettes in 4:4:4
   and in 4:2:0 over 128x128 superblocks, intra block copy, a cropped
   2x2 grid, 10-bit 4:2:0, 4:4:4 with loop restoration, film grain,
   4:0:0 and screen content (palettes and intra block copy), 12-bit
   4:2:2, Pillow's three-frame sequence read from its track, a 10-bit
   image with premultiplied alpha; their host ms on a line of their own,
   ``formats_avif``):
   each decoded by
   ``native.decode_image`` (the port's
   ``load_image_rgb``), its SHA-256 held against cv2's recorded in
   ``data/testdata/formats/sha256.json``, with its host ms per image on
   this machine's CPU (median of ``FORMATS_DECODE_REPS``) and whether the
   fused route takes it; then ``formats_fit``: ``trainer_voc``'s fit on a
   VOC tree whose train ids are the baseline JPEG and whose test ids are
   the files of every kind, reporting the Loader's fused and parser
   batches (both must occur) beside its warp and NMS launches; inside it
   ``cli.predict.main`` on the run's checkpoint over one file of each kind:
   one JSON line and one NMS launch per image.
10b. trainer_voc -- ``cli.run.main`` with ``data_module`` VOC on a VOC2012
   tree written under ``build/`` (200 train and 64 val ids, each a hard
   link to the 500x375 4:2:0 fixture, VOC2012's typical size, 1-5 boxes
   each; ``tools/fixture_trees.py``), YOLOv2 at 416 px, bf16, B=32 and the
   ``yaml_test`` caps (accumulation 2, 4/2/2 batches, 2 epochs): checked
   as ``trainer`` (one warp launch per microbatch, one NMS launch per
   test batch, a finite mAP table, the best checkpoint restored bit-equal,
   a pinned ring of ``prefetch_batches`` + 2 slots) and ``decode_path``
   "fused"; prints the epochs, img/s and ``loader_split``: the Loader's
   host ms per batch for the two stages it ran before (decode, then
   resize, each alone), for the fused decode-and-resize call it runs now
   (into a pinned buffer), and for the batch's upload from the pinned ring
   against a copy into freshly pinned memory.
   Inside it, on its checkpoint: predict_cli -- ``cli.predict.main`` over
   the decodable fixtures and a copy of the 500x375 one with EXIF
   Orientation 6 with ``--out-dir``: one JSON line and one NMS launch per
   image (counts zeroed before, read after), each PNG's signature and IHDR
   size, the EXIF copy's record and panel equal to those of its turned
   image, ms per image in the call and warm; then
   predict_export -- ``cli.predict.main`` with ``--export`` and no images
   on that checkpoint: its line, then the loaded program on one fixture
   (uint8) against the module on the restored evaluation weights,
   detections identical, one NMS launch.
10c. trainer_coco -- the same on a COCO 2017 tree (``images/train2017``,
   ``images/val2017``, ``annotations/instances_*2017.json``) of the
   640x480 4:2:0 fixture, COCO 2017's typical size, YOLOv5s at 640 px,
   the flagship.
10d. trainer_coco_cache -- trainer_coco with ``--set cache_dir`` (a
   directory under the tree's): the CLI builds the packed uint8 caches
   (train, val, test) and trains, validates and tests from their gathers,
   ``decode_path`` "cache"; checked as ``trainer_coco``.  Then, on those
   caches: the builds' images per second, ``cache_split`` (host ms of one
   batch's gather into a pinned buffer and its upload) and
   ``check_ring``: 6 batches through a ring of the Trainer's size, their
   copies held back behind a 500 ms spin so that the Loader must wait for
   each slot's copy (the loop must last the spin), each batch on the card equal byte for byte to the
   same batch made by a fresh Loader (cached uint8 batches and fused
   float32 batches); the same check on a planted ring whose ``take`` does
   not wait must fail.
10e. trainer_widerperson -- as trainer_coco, one epoch, on a WiderPerson
   tree (``Images``, ``Annotations/<id>.jpg.txt``, ``train.txt``,
   ``val.txt``) of 128 + 64 copies of the 640x480 fixture, 5 classes.
10f. trainer_options -- as trainer_coco with the YAML's training options:
   ``optimizer`` SGD (momentum 0.9), ``mosaic`` 0.5, ``remat`` early and
   ``tune`` true.  The tuner runs before the fit: ``auto_lr_find`` (25
   steps of augmented microbatches: the warp launches must equal every
   augmented microbatch, the fit's and the sweep's) and
   ``auto_scale_batch_size`` from 32 (one executed step per candidate);
   prints both suggestions, their seconds and every candidate's peak
   memory; the best checkpoint, with the SGD momentum buffers, restored
   equal bit for bit.  Then one epoch each with RMSprop and Adagrad
   (``trainer_options_rmsprop``, ``trainer_options_adagrad``), and a
   summary line ``trainer_options``.
10g. trainer_bdd_ssd -- as trainer_coco, on a BDD100K tree
   (``images/track/{train,val}/<video>/``, ``labels/box_track_20``) of 160
   + 80 frames of 1280x720 (BDD100K's size), half the baseline frame and
   half the progressive one, SSD-300 (``img_size`` 0: SSD's 300 px), no
   cache: the fused Loader decodes every frame at libjpeg's 1/2 scale
   (1280/2 and 720/2 >= 300); one warp launch per microbatch, one NMS
   launch (``anchor_nms``) per test batch, the best checkpoint restored
   bit-equal; prints the epochs' img/s and ``loader_split`` (the fused
   call's ms a batch).  Inside it, ``bdd_scaled_batch``: one fused batch
   of the first train files at 300 px equals ``preproc_batch`` of
   ``decode_one(path, denom=2)`` on them bit for bit and differs from the
   full-scale decode's batch; orig sizes 1280x720.
11. yolo_fp32 -- YOLOv2, YOLOv3 and YOLOv4 at their published widths,
   416 px, 80 classes, B=2, f32 with TF32 off, on the card and on the CPU
   from the same seeded weights: head maps (``YOLO_HEAD_REL``), the card's
   decoded candidates through the NMS kernel and its plain version
   (``keep`` identical), and one train step from the same batch,
   augmentation skipped: loss and d(loss)/d(head maps)
   (``YOLO_TRAIN_TOL``).  Targets 0 and 1 of image 0 share a cell and an
   anchor: ``build_targets_yolo`` on the card must equal the CPU's
   (``YOLO_TARGET_TOL``) and keep the later target's offset and both
   labels there.
12. yolo_serving -- each family's ``predict_step`` at 416 px, 80 classes,
   bf16, uint8 input with /255 folded into its stem conv: B=64 and B=1,
   one warm-up and three batches each; counts zeroed before and read after
   each family; one NMS launch per batch.  Prints ms per batch and img/s.
13. yolo_training -- each family at 416 px, 80 classes, bf16, Adam lr 1e-3
   / wd 1e-5, B=32, M=32: uint8 -> /255 -> ``augment_batch`` ->
   ``train_step``, one warm-up and three timed steps; one warp launch per
   step, a finite loss.  Prints ms per step and peak memory.
14. trainer_yolov2 -- as ``trainer``, on the YAML's own model (YOLOv2,
   no ``model_name`` override) at its 416-px default (``img_size`` 0):
   warp launches equal the microbatches, NMS launches the test batches,
   and the results hold the per-grid statistics ``13/{key}``, finite; the
   best checkpoint (~0.6 GB) restored equal to the Trainer's tensors.
15. anchor_fp32 -- RetinaNet (ResNet-50-FPN) at 600 px and SSD-300 (VGG16),
   80 classes, B=2, f32 with TF32 off, card against CPU on the same
   seeded weights: head maps (``ANCHOR_HEAD_REL``), ``retina_match`` /
   ``ssd_match`` on the same targets (integer fields equal, offsets within
   ``ANCHOR_MATCH_TOL``), the card's anchor candidates through the NMS
   kernel and its plain version (``keep`` identical, the flag off and
   on), one train step's loss and d(loss)/d(head maps)
   (``ANCHOR_TRAIN_TOL``).
16. anchor_serving -- each family's ``predict_step`` at its size, 80
   classes, bf16, uint8 with /255 folded into its stem: B=64 and B=1, one
   warm-up and three batches each, one NMS launch a batch; ms per batch,
   img/s, forward GFLOP per image; the last B=64 batch's candidates
   (bf16 scores) through kernel and plain version.
17. anchor_training -- each family, bf16, Adam lr 1e-3 / wd 1e-5, B=32,
   M=32:
   ``augment_batch`` -> ``train_step``, one warm-up and three timed
   steps; one warp launch a step, a finite loss, peak memory.
18. trainer_retinanet, trainer_ssd -- as ``trainer``, one epoch, with
   ``model_name`` RetinaNet (600 px) or SSD (300 px): warp launches equal
   the microbatches, NMS launches the test batches, a finite mAP table,
   the best checkpoint restored equal bit for bit.
18'. torch_ckpt -- a torchvision VGG16 ``features.*`` state dict drawn
   from a seed (14,714,688 float32) written under ``build/``, read and
   loaded into SSD-300 on the card (``utils/torch_weights.py``, timed);
   then ``trainer_ssd`` at the ``yaml_test`` caps (2 epochs) with ``--set
   torch_ckpt``: the ``[trainer] loaded 13 tensors ... (vgg16 backbone)``
   line printed, the 13 conv weights and biases on the card right after
   construction equal to the file's bit for bit, and ``trainer``'s checks
   (a warp launch a microbatch, an NMS launch a test batch, the mAP
   table, the restore).  Then a full reference YOLOv2 state dict drawn
   from a seed through ``load_torch_checkpoint`` into YOLOv2-416 on the
   card and the CPU: every tensor in place bit for bit, f32 head maps
   within ``YOLO_HEAD_REL`` (TF32 off), one ``predict_step`` at B=1 with
   one NMS launch.
19. conv_check -- the 13 3x3/s1 convs of one YOLOv5s-640 bf16 train
   forward and backward at B=64, captured by hooks on ``blocks.Conv``
   (x, w, dy): ``conv3x3_s1`` (fwd, and dgrad on ``rot_w(w)``) and
   ``conv3x3_s1_wgrad`` against their plain versions, each twice (the two
   runs equal bit for bit: a race in the ring shows as a difference), with
   planted faults that the same check must reject: for fwd and dgrad the
   kernel's result with one k-tile of weights zeroed (what a skipped ring
   stage leaves out), for wgrad all zeros and one split chunk's pixels left
   out; then f32 cases (TF32 off), 5x5 and C=12 cases, the window
   kernels on odd images, and bf16 cases that the simple kernels take (odd
   channel counts, unaligned tensors): every pass's wgmma and simple bf16
   kernels must both have been checked; then one ``conv3x3_s1_op``
   forward and backward through autograd, whose launch counts must be 2
   forward-kernel, 1 wgrad, 1 reduction.  Tolerances elementwise at ``CONV_BF16_ULPS`` / ``CONV_SUM_TOL``; each case prints
   its median limit beside the median |reference| and each planted fault's
   share of the limit.
20. conv_time -- the conv path: one ``conv3x3_s1_op`` forward and backward
   per captured conv through the A/B tool's kernel step, launch counts
   zeroed before and read after; then per distinct shape and summed over
   the 13: device and host-inclusive ms of fwd, dgrad and wgrad, bounds and
   the share of the bound reached, plain versions' ms and the cuDNN
   yardstick's ms with the kernel's factor against it; then the A/B tool
   ``tools/conv_bench.py`` itself on 40x40 128->128, B=64, ``--grad``.
21. (``--profile``) torch.profiler over one B=64 serving batch and over one
   B=64 training step: device time by kernel and by kernel class, and the
   idle share against the profiled call and against the mean of three
   unprofiled calls (the profiler's own host cost inflates the first).

Then the ``kernels`` line (``greedy_nms`` is the single-tile NMS kernel,
K <= 1024, ``greedy_nms_tiled`` the K > 1024 route -- its device kernels
``greedy_nms_partition_kernel`` and ``greedy_nms_segment_kernel`` -- with
``serving_all``'s launches and times at B=1, K=25,200; the NMS and warp entries also carry the launch
counts of the YOLO, anchor, VOC, COCO (uncached and cached), WiderPerson,
training-options, BDD100K-SSD and predict phases, the NMS entry those of
the export, the fresh interpreter, ``predict --export`` and the bench, the warp entry those of
``remat_check``, both those of ``ddp`` and ``torch_ckpt``, the warp entry
those of ``tp``, and the NMS entry the anchor scan's times) and, last,
``{"ok": true, "device": {...}}``.
Without CUDA it prints nothing to stdout and exits 1.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from objectdetectionpl_tpu_torch import bench
from objectdetectionpl_tpu_torch.cli import predict as cli_predict
from objectdetectionpl_tpu_torch.cli import run as cli_run
from objectdetectionpl_tpu_torch.config import Config, load_config
from objectdetectionpl_tpu_torch.data import augment, build_datamodule, native
from objectdetectionpl_tpu_torch.data import cache as cache_lib
from objectdetectionpl_tpu_torch.data import datamodules, pipeline
from objectdetectionpl_tpu_torch.data.parsers import COCOParser
from objectdetectionpl_tpu_torch.data.types import Batch
from objectdetectionpl_tpu_torch.models import build_model
from objectdetectionpl_tpu_torch.nn import blocks
from objectdetectionpl_tpu_torch.ops import anchors as anchor_lib
from objectdetectionpl_tpu_torch.ops import assignment, losses, nms
from objectdetectionpl_tpu_torch.ops import boxes as box_ops
from objectdetectionpl_tpu_torch.ops.cuda import (_build, conv_kernel,
                                                  nms_kernel, warp_kernel)
from objectdetectionpl_tpu_torch.parallel import distributed, mesh
from objectdetectionpl_tpu_torch.parallel.dryrun import (dryrun_multichip,
                                                         spawn)
from objectdetectionpl_tpu_torch.tools import format_files
from objectdetectionpl_tpu_torch.tools import (conv_bench, decode_bench,
                                               fixture_trees, kernel_ab)
from objectdetectionpl_tpu_torch.tools.kernel_ab import (candidates,
                                                         ssr_inverses)
from objectdetectionpl_tpu_torch.train.checkpoint import CheckpointManager
from objectdetectionpl_tpu_torch.train.loop import PinnedRing, _to_host
from objectdetectionpl_tpu_torch.train.optim import build_optimizer
from objectdetectionpl_tpu_torch.train import tune
from objectdetectionpl_tpu_torch.train.state import create_train_state
from objectdetectionpl_tpu_torch.train.step import (YOLO_DECODE,
                                                    make_postprocess,
                                                    make_predict_step,
                                                    make_train_step)
from objectdetectionpl_tpu_torch.utils.fuse import (STEM_CONVS,
                                                    fold_input_scale)
from objectdetectionpl_tpu_torch.utils import export as export_lib
from objectdetectionpl_tpu_torch.utils import timing, torch_weights, viz
from objectdetectionpl_tpu_torch.utils.timing import (F32_OPS_PER_S,
                                                     HBM_BYTES_PER_S,
                                                     call_time_ms, time_ms)

NUM_CLASSES = 80
IMG = 640
TOP_K = 300
BOX_TOL = dict(rtol=1e-4, atol=1e-3)
HEAD_TOL = dict(rtol=1e-3, atol=1e-3)    # f32 card vs CPU, 60 convs deep
WARP_TOL = 1e-6          # expected 0: the same IEEE operation sequence
WARP_K = 26              # warp slots at B=64: round(64 * 2 * p_ssr)
TRAIN_B = 64
TRAIN_M = 32
# f32 train step, card vs CPU.  Batch-statistic BN over B=2 amplifies the
# two backends' different summation orders; the loss and BN statistics are
# sums over the whole batch, the head-map gradients elementwise (measured
# on the H100: 3.8e-7, 9.5e-7 absolute, 1.4e-4 of the largest gradient).
TRAIN_TOL = {"loss_rtol": 1e-5, "stats": dict(rtol=1e-4, atol=1e-5),
             "head_grad_rel": 2e-3}      # max |diff| / max |ref| per map

# The 3x3/s1 convs of YOLOv5s-640 in forward order (C->Co@HxW; B=64).
CONV_SHAPES = (["12->32@320x320", "32->64@160x160"] + ["64->64@80x80"] * 3
               + ["128->128@40x40"] * 3 + ["256->256@20x20"] * 3
               + ["128->128@40x40", "64->64@80x80"])
# Extra conv cases (name, (B, H, W, C, Co), dtype, offset): f32 with TF32
# off, the odd 5x5 image of tests/test_pallas_conv.py, the stem's C=12 off
# the tile, the window kernels on odd images with Co off their 64-column
# tiles; then bf16 cases the simple (mma.sync) kernels take: C or Co not a
# multiple of 4 (16 channels: its 16-byte loads), and x and dy starting
# ``offset`` elements past a 16-byte boundary.
CONV_EXTRA = [
    ("f32_stem_B2", (2, 320, 320, 12, 32), torch.float32, 0),
    ("f32_128_B4", (4, 40, 40, 128, 128), torch.float32, 0),
    ("f32_odd_5x5", (2, 5, 5, 4, 4), torch.float32, 0),
    ("bf16_odd_5x5", (2, 5, 5, 4, 4), torch.bfloat16, 0),
    ("f32_c12_37x53", (3, 37, 53, 12, 32), torch.float32, 0),
    ("bf16_c12_37x53", (3, 37, 53, 12, 32), torch.bfloat16, 0),
    ("bf16_c32_37x53", (3, 37, 53, 32, 24), torch.bfloat16, 0),
    ("bf16_c64_9x7", (2, 9, 7, 64, 40), torch.bfloat16, 0),
    ("bf16_c128_9x7", (2, 9, 7, 128, 72), torch.bfloat16, 0),
    ("bf16_c6_9x7", (2, 9, 7, 6, 10), torch.bfloat16, 0),
    ("bf16_c16_co6_9x7", (2, 9, 7, 16, 6), torch.bfloat16, 0),
    ("bf16_c64_9x7_misaligned", (2, 9, 7, 64, 40), torch.bfloat16, 1),
]
# Conv kernel against plain version on the same inputs, elementwise.  Both
# sum exact products in f32 in two orders, each blocked (the kernel sums
# k-tiles, or pixel chunks in order; cuBLAS its own tiles), over terms
# whose signs cancel: allowed CONV_SUM_TOL * log2(n) * eps_f32 * sum|a*b|,
# n the reduction length (9C or B*H*W) (measured on an H100: 0 to 7.8 eps
# * sum|a*b|, at most 0.23 of it).  A bf16 result rounds each sum once, so
# where the two sums straddle a rounding boundary it differs by one ulp of
# the element's own magnitude: allowed CONV_BF16_ULPS such ulps on top.
# The limit must stay below a typical |value|, or a wrong result passes:
# every check holds planted faults against it.
CONV_BF16_ULPS = 2
CONV_SUM_TOL = 2
CONV_REPS = 20
# greedy_nms work, counted from the candidates: one IoU test per valid pair
# i < j (of one label when class-aware) (4 min/max, 2x(sub, add, max), mul, add, sub, add, div, compare =
# 16 ops); per valid row its area (5) and, with merge, its share of a merge
# (4 mul, 5 add).  The route past K=1024 settles most pairs without an IoU:
# its bound counts one IoU per suppressed valid row (nms_split_bound_ms).
IOU_PAIR_OPS = 16
AREA_OPS = 5
MERGE_ROW_OPS = 9
# bytes each row must move: boxes, score, label, obj in; boxes, keep out.
ROW_BYTES = 16 + 4 + 4 + 4 + 16 + 1
# affine_warp work per output pixel, counted from csrc/affine_warp.cu:
# 20 f32 ops for the coordinates; 9 per channel for the blend (inside only).
WARP_COORD_OPS = 20
WARP_BLEND_OPS_PER_CHANNEL = 9

# the tiled NMS kernel (K above the single-tile kernel's 1024): checked
# against the plain version at WIDE_K x WIDE_B, timed at WIDE_TIME_K x
# WIDE_TIME_B (the plain version at B=1 only: its [B, K, K] tensors take
# GBs), and served at every row of a YOLOv5s-640 decode (3 anchors x (80²
# + 40² + 20²)) at mAP evaluation's confidence threshold
WIDE_K = (1025, 2048, 4096)
WIDE_B = (1, 8)
WIDE_TIME_K = (2048, 4096, 25200)
WIDE_TIME_B = (1, 64)
SERVE_ALL_K = 25200
SERVE_ALL_CONF = 0.001
NMS_TILE = 1024          # the tiled kernel's rows a tile (csrc kSeg)
LABEL_RANGE_WIDE = 3000  # labels 0..2999: above the partition's histogram

REPO = Path(__file__).resolve().parent
# the trainer phase: cli.run on the YAML with these overrides
TRAINER_SETS = {"model_name": "YOLOv5", "type": "Yolov5s", "img_size": "640",
                "compute_dtype": "bfloat16", "data_module": "Synthetic",
                "synthetic_size": "256", "batch_size": "32",
                "accumulate_grad_batches": "2", "limit_train_batches": "4",
                "limit_val_batches": "2", "limit_test_batches": "2",
                "max_epochs": "2"}
# the trainer_yolov2 phase: the YAML's own model (YOLOv2) at its 416-px
# default (img_size 0: the YAML's yaml_test section caps it at 128)
TRAINER_YOLOV2_SETS = {k: v for k, v in TRAINER_SETS.items()
                       if k not in ("model_name", "type")}
TRAINER_YOLOV2_SETS["img_size"] = "0"

# the YOLOv2/v3/v4 phases: published widths at 416 px, 80 classes
YOLO_FAMILIES = tuple(YOLO_DECODE)        # YOLOv2, YOLOv3, YOLOv4
YOLO_IMG = 416
YOLO_TRAIN_B = 32
YOLO_STATS = ("cls_acc", "recall50", "recall75", "precision", "conf_obj",
              "conf_noobj")
# f32 card vs CPU (TF32 off), YOLOv2/v3/v4 (25 to 110 convs deep): head
# maps and d(loss)/d(head maps) per map as max |diff| / max |ref|; the
# loss relative; the assignment's float fields elementwise, card against
# CPU on the same map.
YOLO_HEAD_REL = 1e-3
YOLO_TRAIN_TOL = {"loss_rtol": 1e-4, "head_grad_rel": 2e-3}
YOLO_TARGET_TOL = dict(rtol=1e-5, atol=1e-6)

# the RetinaNet and SSD phases: published widths at their published sizes,
# 80 classes; the anchor NMS as make_postprocess runs it
ANCHOR_FAMILIES = {"RetinaNet": 600, "SSD": 300}
ANCHOR_TOP_K = 100
ANCHOR_NMS = dict(class_aware=False, merge=False, thresh=0.5)
ANCHOR_CLASS_THRESH = 0.45
ANCHOR_SERVE_B = 64
ANCHOR_TRAIN_B = 32
# f32 card vs CPU (TF32 off): head maps and d(loss)/d(head maps) per map as
# max |diff| / max |ref|, the loss relative (as for YOLOv2/v3/v4; RetinaNet
# has 53 convs in its backbone, SSD 15 without BN); the matching's offsets
# elementwise, on the same targets
ANCHOR_HEAD_REL = 1e-3
ANCHOR_TRAIN_TOL = {"loss_rtol": 1e-4, "head_grad_rel": 2e-3}
ANCHOR_MATCH_TOL = dict(rtol=1e-5, atol=1e-5)
# trainer_retinanet / trainer_ssd: cli.run as in `trainer`, one epoch, each
# family at its published size (img_size 0: RetinaNet 600; SSD is 300)
TRAINER_ANCHOR_SETS = {
    name: {**{k: v for k, v in TRAINER_SETS.items() if k != "type"},
           "model_name": name, "img_size": "0", "max_epochs": "1"}
    for name in ANCHOR_FAMILIES}


# the real-dataset phases: cli.run on trees of a committed fixture JPEG
# at the dataset's typical image size (tools/fixture_trees.py) at the
# YAML's yaml_test caps (accumulation 2, 4 train, 2 val, 2 test batches,
# 2 epochs), bf16, B=32: VOC2012 (~500x375) with YOLOv2 at 416 px, COCO
# 2017 (~640x480) with YOLOv5s at 640 px, the flagship
VOC_TREE = {"n_train": 200, "n_val": 64, "seed": 0,
            "names": ["voc_420_q75_500x375.jpg"]}
COCO_TREE = {"n_train": 200, "n_val": 64, "seed": 1,
             "names": ["coco_420_q75_640x480.jpg"]}
REAL_SETS = {"compute_dtype": "bfloat16", "batch_size": "32",
             "accumulate_grad_batches": "2", "limit_train_batches": "4",
             "limit_val_batches": "2", "limit_test_batches": "2",
             "max_epochs": "2"}
TRAINER_VOC_SETS = {**REAL_SETS, "data_module": "VOC", "model_name": "YOLOv2",
                    "img_size": "416"}
TRAINER_COCO_SETS = {**REAL_SETS, "data_module": "COCO",
                     "model_name": "YOLOv5", "type": "Yolov5s",
                     "img_size": "640"}
JPEG_REPEAT = 32          # decode_batch timing: the fixtures x 32
FORMATS_DECODE_REPS = 10  # host decode timing of each format file: median
# the formats fit: train ids the baseline JPEG, test ids every kind (59),
# in two whole test batches of B=32 (the Loader drops a partial one)
FORMATS_TREE = {"n_train": 160, "n_val": 64, "seed": 6}
# trainer_bdd_ssd: SSD-300 on a BDD100K tree of the 1280x720 frames, half
# baseline and half progressive, which the fused Loader decodes at 1/2
BDD_TREE = {"n_train": 160, "n_val": 80, "seed": 3,
            "names": list(fixture_trees.BDD_FRAMES)}
TRAINER_BDD_SSD_SETS = {**REAL_SETS, "data_module": "BDD100K",
                        "model_name": "SSD", "img_size": "0"}
BDD_DENOM = 2             # libjpeg's scale for 1280x720 at 300 px
LOADER_REPS = 3           # the Loader's host split: median of 3
# trainer_coco_cache: trainer_coco with the packed cache, which the CLI
# builds under a temporary directory of build/ (cache_dir set at run time)
TRAINER_COCO_CACHE_SETS = dict(TRAINER_COCO_SETS)
# trainer_widerperson: one epoch of YOLOv5s-640 on a WiderPerson tree of
# the 640x480 fixture (WiderPerson's 5 classes)
WIDER_TREE = {"n_train": 128, "n_val": 64, "seed": 2,
              "names": ["coco_420_q75_640x480.jpg"]}
TRAINER_WIDER_SETS = {**REAL_SETS, "data_module": "WiderPerson",
                      "model_name": "YOLOv5", "type": "Yolov5s",
                      "img_size": "640", "max_epochs": "1"}
# optim_check: SGD, RMSprop and Adagrad over the YOLOv5s-640 parameter
# shapes, 5 steps of seeded gradients, fp32, card against CPU: parameters
# and state per tensor as max |card - CPU| / max |CPU| within OPTIM_TOL
# (the card's rsqrtf is within 2 ulps, the CPU's 1/sqrt correctly
# rounded, and a momentum sum of updates of either sign can cancel to
# near 0, where an elementwise relative bound means nothing)
OPTIM_CASES = {
    "SGD": dict(optimizer="SGD", momentum=0.9, weight_decay=1e-5),
    "RMSprop": dict(optimizer="RMSprop", alpha=0.95, momentum=0.9,
                    weight_decay=1e-5),
    "Adagrad": dict(optimizer="Adagrad", lr_decay=0.0, weight_decay=1e-5),
    "Adagrad_lr_decay": dict(optimizer="Adagrad", lr_decay=1e-2,
                             weight_decay=1e-5)}
OPTIM_STEPS = 5
OPTIM_LR = 1e-2
OPTIM_TOL = 1e-5
# remat_check: YOLOv5s-640 bf16 B=64 train steps under each setting; with
# cuDNN's deterministic algorithms, one step from the same weights and
# batch: loss relative, gradients per tensor as max |diff| / max |ref|
# against "none", BN statistics equal
REMAT_SETTINGS = ("none", "early", "all")
REMAT_TOL = {"loss_rtol": 1e-6, "grad_rel": 1e-3}
# mosaic_check: mosaic_batch at B=64, 640 px, p=1, card against CPU on the
# same draws: images elementwise (f32 products of 640 terms), boxes,
# labels and masks equal
MOSAIC_B = 64
MOSAIC_TOL = 1e-5
# trainer_options: cli.run as trainer_coco with the YAML's training
# options (SGD with momentum, mosaic, remat, the tuner), then one epoch
# each with RMSprop and Adagrad
TRAINER_OPTIONS_SETS = {**TRAINER_COCO_SETS, "optimizer": "SGD",
                        "mosaic": "0.5", "remat": "early", "tune": "true"}
TRAINER_OPTIONS_EPOCH_SETS = {
    name: {**TRAINER_OPTIONS_SETS, "optimizer": name, "tune": "false",
           "max_epochs": "1"} for name in ("RMSprop", "Adagrad")}

# the pinned ring check: batches through a ring of the Trainer's size
# (prefetch_batches + 2 slots), their copies held back behind a spin
RING_BATCHES = 6
RING_SPIN_MS = 500


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nms_bound_ms(args, class_aware: bool = True, merge: bool = True) -> dict:
    """The least time of greedy_nms on ``args`` (boxes, scores, labels,
    obj): one IoU test per pair i < j of valid rows that the function must
    decide -- with ``class_aware`` only the pairs of one label, the sum over
    labels of n_l (n_l - 1) / 2 an image -- and each valid row's area and
    merge share, against the rows' bytes.  ``bound_pairs``: the pairs
    counted."""
    scores, labels = args[1], args[2]
    B = scores.shape[0]
    valid = (scores > nms_kernel.NEG_INF).cpu()
    if class_aware:
        lab = labels.cpu().long()
        lab = lab - lab.min()
        per = int(lab.max()) + 1
        key = torch.arange(B)[:, None] * per + lab
        n = torch.bincount(key[valid], minlength=B * per).double()
    else:
        n = valid.sum(dim=1).double()
    pairs = float((n * (n - 1) / 2).sum())
    return {**_rows_bound(pairs, valid, scores.numel(), merge),
            "bound_pairs": int(pairs)}


def nms_split_bound_ms(args, keep, merge: bool = True) -> dict:
    """The least time of greedy_nms on ``args`` whose result is ``keep``,
    for a route that settles pairs without an IoU (the K > 1024 route's
    grid does, for most pairs of one label): the one IoU test that each
    suppressed valid row cannot skip, against its first kept suppressor,
    and each valid row's area and merge share, against the rows' bytes.
    ``bound_suppressed``: the rows counted."""
    valid = (args[1] > nms_kernel.NEG_INF).cpu()
    suppressed = int((valid & ~keep.cpu()).sum())
    return {**_rows_bound(suppressed, valid, args[1].numel(), merge),
            "bound_suppressed": suppressed}


def _rows_bound(ious, valid, rows, merge) -> dict:
    """``bound_ms`` and ``bound_by`` of ``ious`` IoU tests and each valid
    row's area (and merge share) against ``rows`` rows' bytes."""
    row_ops = AREA_OPS + (MERGE_ROW_OPS if merge else 0)
    ops = ious * IOU_PAIR_OPS + float(valid.sum()) * row_ops
    t_ops, t_bytes = ops / F32_OPS_PER_S, rows * ROW_BYTES / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def split_bounds(args) -> dict:
    """The K > 1024 route's bound (``nms_split_bound_ms``) on ``args``
    under the default flags, beside the same-label pair count
    (``nms_bound_ms``) as ``bound_ms_pairs``, kept so that figures taken
    against it stay comparable: that count is the single-tile kernel's
    work, not this route's."""
    pairs = nms_bound_ms(args)
    return {**nms_split_bound_ms(args, nms_kernel.greedy_nms(*args)[1]),
            "bound_ms_pairs": pairs["bound_ms"],
            "bound_by_pairs": pairs["bound_by"],
            "bound_pairs": pairs["bound_pairs"]}


def near_threshold(B, K, seed, thresh=0.4):
    """Candidates in pairs (2m, 2m + 1) of one label whose IoU+1 lies within
    a few ulps of ``thresh`` on either side: a box and its copy shifted
    right by s, (w + 1 - s) / (w + 1 + s) = thresh, s perturbed by up to
    64 * 2**-26 of itself.  Made on the CPU from a seed, on the card."""
    g = torch.Generator().manual_seed(seed)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(B, K // 2, generator=g)
    x, y, w, h = u(50, 500), u(50, 500), u(20, 120), u(20, 120)
    s = (w + 1) * (1 - thresh) / (1 + thresh) * (
        1 + torch.randint(-64, 65, (B, K // 2), generator=g) * 2.0 ** -26)
    first = torch.stack([x, y, x + w, y + h], -1)
    second = torch.stack([x + s, y, x + w + s, y + h], -1)
    boxes = torch.stack([first, second], 2).reshape(B, K, 4)
    labels = torch.randint(0, 5, (B, K // 2), generator=g,
                           dtype=torch.int32).repeat_interleave(2, dim=1)
    scores = torch.rand(B, K, generator=g).sort(dim=1, descending=True).values
    obj = torch.rand(B, K, generator=g)
    return [t.contiguous().cuda() for t in (boxes, scores, labels, obj)]


def near_threshold_k(B, K, seed):
    """``near_threshold`` at any K: an odd K drops the last pair's
    second row."""
    return [t[:, :K].contiguous()
            for t in near_threshold(B, K + K % 2, seed)]


def near_threshold_cross(B, K, seed):
    """``near_threshold``'s pairs with each second box a tile later and
    every row of one label: of every 2 * NMS_TILE rows, pair m at rows m
    and m + NMS_TILE, the scores still sorted, so that, class-aware or
    not, the pairs lie in one segment of K > 1024 rows, where the split
    route's cross-tile test (its step (a): the grid, the float band, the
    sorted head sums) decides them.  K a multiple of 2 * NMS_TILE."""
    boxes, scores, labels, obj = near_threshold(B, K, seed)
    labels = torch.zeros_like(labels)
    m = torch.arange(K // 2)
    first = m // NMS_TILE * 2 * NMS_TILE + m % NMS_TILE
    order = torch.empty(K, dtype=torch.long)
    order[first], order[first + NMS_TILE] = 2 * m, 2 * m + 1
    order = order.cuda()
    return [boxes[:, order].contiguous(), scores,
            labels[:, order].contiguous(), obj]


def tiled_at_any_k(args, nms_thresh=0.4, class_aware=True, merge=True,
                   drop=False, header=False):
    """The K > 1024 route (partition and segment kernels) at any K through
    ``greedy_nms_tiled_launch`` (the wrapper takes it only above 1024), not
    counted: to time it beside the single-tile kernel at K <= 1024, and to
    read its workspace header.  Its workspace is the library's size for K,
    or for K = 1025 at K <= 1024 (the size grows with K); with ``header``
    also returns the header's int32 words."""
    boxes, scores, labels, obj = args
    B, K = scores.shape
    lib = nms_kernel._lib()
    out = torch.empty_like(boxes)
    keep = torch.empty((B, K), dtype=torch.bool, device=boxes.device)
    size = lib.greedy_nms_workspace_bytes(
        B, max(K, lib.greedy_nms_max_k() + 1))
    workspace = torch.empty(size, dtype=torch.uint8, device=boxes.device)
    err = lib.greedy_nms_tiled_launch(
        boxes.data_ptr(), scores.data_ptr(), labels.data_ptr(),
        obj.data_ptr(), out.data_ptr(), keep.data_ptr(), B, K,
        float(nms_thresh), int(class_aware), int(merge), 1.0,
        torch.cuda.current_stream().cuda_stream, int(drop),
        workspace.data_ptr())
    if err:
        raise RuntimeError(f"greedy_nms_tiled_launch: cudaError {err}")
    if header:
        return out, keep, workspace[:256].view(torch.int32).tolist()
    return out, keep


def check_kernel(args, class_aware, merge, thresh=0.4, drop=False) -> float:
    """Kernel vs plain on the same CUDA tensors (``drop``:
    ``drop_lone_survivor``); returns max |box error|."""
    flags = dict(nms_thresh=thresh, class_aware=class_aware, merge=merge,
                 drop_lone_survivor=drop)
    kb, kk = nms_kernel.greedy_nms(*args, **flags)
    pb, pk = nms_kernel.greedy_nms_plain(*args, **flags)
    torch.cuda.synchronize()
    if not torch.equal(kk, pk):
        raise AssertionError(f"keep differs in {int((kk != pk).sum())} rows")
    torch.testing.assert_close(kb, pb, **BOX_TOL)
    return float((kb - pb).abs().max()) if kb.numel() else 0.0


def lone_survivor(lone: bool, B: int = 2, K: int = ANCHOR_TOP_K):
    """Anchor-scan candidates whose last kept row is lone, or not: rows 0
    .. K-3 are disjoint 20-px boxes on a grid (all kept), row K-2 is row 0
    shifted by 1 px (suppressed by row 0), row K-1 is row 1 shifted (lone:
    the last kept row K-3 suppresses nothing) or row K-3 shifted (K-3
    suppresses it first).  Image b is image 0 moved by 7b px."""
    n = K - 2
    i = torch.arange(n, dtype=torch.float32)
    x, y = 40.0 * (i % 10), 40.0 * (i // 10)
    grid = torch.stack([x, y, x + 20, y + 20], -1)
    last = grid[1] if lone else grid[n - 1]
    shift = torch.tensor([1.0, 0.0, 1.0, 0.0])
    one = torch.cat([grid, (grid[0] + shift)[None], (last + shift)[None]])
    boxes = torch.stack([one + 7.0 * b for b in range(B)])
    scores = torch.linspace(0.99, 0.5, K).expand(B, K)
    labels = torch.zeros(B, K, dtype=torch.int32)      # class-agnostic scan
    return [t.contiguous().cuda() for t in (boxes, scores, labels,
                                            torch.zeros(B, K))]


def phase_device() -> dict:
    card = timing.card()
    print(card, flush=True)
    info = {"phase": "device", "card": card,
            "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "python": sys.version.split()[0]}
    emit(info)
    return info


def kernel_name(mangled: str) -> str:
    """A kernel's name and template arguments from its mangled name."""
    m = re.search(r"(?<=\d)(?:conv3x3_(?:fwd|wgrad)|greedy_nms|affine_warp)"
                  r"\w*?(?:_kernel|_wgmma|_window)", mangled)
    if not m:
        return mangled
    rest = mangled[m.end():]
    if not rest.startswith("I"):
        return m.group(0)
    args = re.findall(r"L[ib](\d+)E", rest.split("EEv")[0]) or \
        ["f32" if rest.startswith("If") else "bf16"]
    return f"{m.group(0)}<{','.join(args)}>"


def ptxas_report(log: str) -> tuple:
    """From ``-Xptxas -v`` output: per kernel its registers, spilled bytes
    and static shared memory; and ptxas's performance notes (wgmma
    serialised, waits it injected)."""
    kernels, notes, name, spill = [], [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            kernels.append({"kernel": name, "registers": int(m.group(1)),
                            "spill_bytes": spill,
                            "static_smem": int(m.group(2) or 0)})
        if re.search(r"\(C75\d\d\)|Performance Loss", line):
            m = re.search(r"function '(\w+)'", line)
            notes.append(f"{kernel_name(m.group(1)) if m else name}: "
                         f"{line.split(':', 1)[1].strip()[:64]}")
    return kernels, notes


def phase_build() -> None:
    t0 = time.perf_counter()
    built = _build.build()
    secs = time.perf_counter() - t0
    report = {n: ptxas_report(_build.build_log[n]) for n in built}
    for n, (kernels, notes) in report.items():
        emit({"phase": "build", "source": f"csrc/{n}.cu", "kernels": kernels,
              "ptxas_notes": notes})
    spilled = [k["kernel"] for kernels, _ in report.values() for k in kernels
               if k["spill_bytes"]]
    emit({"phase": "build", "seconds": secs, "built": built,
          "sources": _build.sources(), "spilled": spilled})
    if spilled:
        raise AssertionError(f"ptxas spilled registers in {spilled}")


def phase_kernel(card: str) -> dict:
    both = ((True, True), (False, False))          # (class_aware, merge)
    cases = [
        ("random_B256_K300", candidates(256, 300, 1), both),
        ("random_B4_K37", candidates(4, 37, 2), both),
        ("dense_B8_K300", candidates(8, 300, 3, classes=3, dense=True), both),
        ("dense_B2_K1024", candidates(2, 1024, 4, dense=True), both[:1]),
        ("all_invalid_B2_K64", candidates(2, 64, 5, n_invalid=64), both[:1]),
        ("single_valid_B2_K64", candidates(2, 64, 6, n_invalid=63),
         both[:1]),
        ("random_B64_K300_C80", candidates(64, 300, 7, classes=80), both),
        ("near_threshold_B4_K256", near_threshold(4, 256, 8), both),
    ]
    max_err = 0.0
    for name, args, flag_pairs in cases:
        for class_aware, merge in flag_pairs:
            err = check_kernel(args, class_aware, merge)
            max_err = max(max_err, err)
            emit({"phase": "kernel_check", "case": name,
                  "class_aware": class_aware, "merge": merge,
                  "keep_equal": True, "max_abs_box_err": err})
    # a negative threshold suppresses disjoint pairs too: the kernel must
    # then divide where the intersection is empty
    args = candidates(4, 37, 2)
    err = check_kernel(args, True, True, thresh=-0.5)
    max_err = max(max_err, err)
    emit({"phase": "kernel_check", "case": "random_B4_K37_thresh_-0.5",
          "class_aware": True, "merge": True, "keep_equal": True,
          "max_abs_box_err": err})

    # the anchor families' scan (class-agnostic, no merge, IoU 0.5, K=100),
    # drop_lone_survivor off and on; then a last kept row that is lone and
    # one that is not: the flag must drop the first and keep the second
    a = ANCHOR_NMS
    for name, args in (
            ("anchor_B1_K100", candidates(1, ANCHOR_TOP_K, 12, classes=80)),
            ("anchor_B64_K100", candidates(64, ANCHOR_TOP_K, 13, classes=80)),
            ("anchor_dense_B64_K100", candidates(64, ANCHOR_TOP_K, 14,
                                                 classes=80, dense=True))):
        for drop in (False, True):
            err = check_kernel(args, a["class_aware"], a["merge"],
                               a["thresh"], drop)
            max_err = max(max_err, err)
            emit({"phase": "kernel_check", "case": name, **a,
                  "drop_lone_survivor": drop, "keep_equal": True,
                  "max_abs_box_err": err})
    for lone in (True, False):
        args = lone_survivor(lone)
        check_kernel(args, a["class_aware"], a["merge"], a["thresh"], True)
        _, keep = nms_kernel.greedy_nms(
            *args, nms_thresh=a["thresh"], class_aware=False, merge=False,
            drop_lone_survivor=True)
        kept = keep.sum(dim=1).tolist()
        want = ANCHOR_TOP_K - 2 - int(lone)
        if kept != [want] * len(kept) or bool(keep[:, -3].any()) == lone:
            raise AssertionError(f"drop_lone_survivor, lone={lone}: kept "
                                 f"{kept} rows, row K-3 {keep[:, -3]}")
        emit({"phase": "kernel_check", "case": f"last_kept_lone={lone}",
              **a, "drop_lone_survivor": True, "keep_equal": True,
              "kept": kept, "last_kept_dropped": lone})

    # B=1 and B=256 with 5 classes, as in every earlier run; B=64 with 80
    # classes, the serving configuration
    timing = {}
    for B, classes, seed in ((1, 5, 11), (256, 5, 266), (64, 80, 74)):
        args = candidates(B, TOP_K, seed, classes=classes)
        ms, call_ms = time_ms(lambda: nms_kernel.greedy_nms(*args), 200)
        plain_ms = call_time_ms(lambda: nms_kernel.greedy_nms_plain(*args),
                                20)
        # the tiled kernel on the same candidates, beside the single-tile one
        tb, tk = tiled_at_any_k(args)
        pb, pk = nms_kernel.greedy_nms_plain(*args)
        if not torch.equal(tk, pk):
            raise AssertionError(f"tiled kernel at K={TOP_K}: keep differs")
        torch.testing.assert_close(tb, pb, **BOX_TOL)
        tiled_ms, _ = time_ms(lambda: tiled_at_any_k(args), 200)
        timing[B] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                         tiled_ms=tiled_ms, **nms_bound_ms(args),
                         **kernel_ab.chain_length(args))
        emit({"phase": "kernel_time", "B": B, "K": TOP_K,
              "classes": classes, "card": card, **timing[B],
              "library_ms": None})
    # the anchor configuration at B=64, drop_lone_survivor on
    args = candidates(64, ANCHOR_TOP_K, 13, classes=80)
    flags = dict(nms_thresh=a["thresh"], class_aware=False, merge=False,
                 drop_lone_survivor=True)
    ms, call_ms = time_ms(lambda: nms_kernel.greedy_nms(*args, **flags), 200)
    plain_ms = call_time_ms(
        lambda: nms_kernel.greedy_nms_plain(*args, **flags), 20)
    ms_no_drop, _ = time_ms(lambda: nms_kernel.greedy_nms(
        *args, **{**flags, "drop_lone_survivor": False}), 200)
    timing["anchor_b64"] = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                                **nms_bound_ms(args, class_aware=False,
                                               merge=False),
                                ms_without_drop=ms_no_drop,
                                **kernel_ab.chain_length(args, **flags))
    emit({"phase": "kernel_time", "B": 64, "K": ANCHOR_TOP_K, "classes": 80,
          **a, "drop_lone_survivor": True, "card": card,
          **timing["anchor_b64"], "library_ms": None})
    return {"max_abs_err": max_err, "timing": timing}



def ious_k_by_kept(args, **flags) -> int:
    """K x kept heads summed over the images: the IoUs of a greedy scan
    that tests each kept head against every row (the Pallas kernel's)."""
    _, keep = nms_kernel.greedy_nms(*args, **flags)
    return int(keep.sum()) * args[1].shape[1]


def cross_tile_pairs(args, class_aware, drop) -> dict:
    """Of ``near_threshold_cross``'s pairs (plain version's keep): those
    whose first row is a kept head, so that the cross-tile test decides
    the second, and how many of those seconds are suppressed."""
    _, keep = nms_kernel.greedy_nms_plain(
        *args, class_aware=class_aware, merge=False, drop_lone_survivor=drop)
    B, K = keep.shape
    k = keep.view(B, K // (2 * NMS_TILE), 2, NMS_TILE)
    head = k[:, :, 0]
    return {"pairs_first_kept": int(head.sum()),
            "pairs_second_suppressed": int((head & ~k[:, :, 1]).sum())}


def relabel(args, labels_of, seed):
    """``args`` with labels drawn by ``labels_of(generator, shape)``."""
    boxes, scores, labels, obj = args
    g = torch.Generator().manual_seed(seed)
    new = labels_of(g, tuple(labels.shape)).to(torch.int32)
    return [boxes, scores, new.contiguous().cuda(), obj]


def label_cases(B, K, seed) -> list:
    """The split route's own cases: one label (a segment above 1024 rows
    from K=2048), two labels of which one holds 95 % of the rows, and
    labels spread over 0..2999 (a range above the partition's histogram:
    the one-segment path, label test on)."""
    return [
        ("c1", relabel(candidates(B, K, seed + 3), lambda g, sh:
                       torch.zeros(sh), 0)),
        ("c2_one_segment_above_1024", relabel(
            candidates(B, K, seed + 4), lambda g, sh:
            7 + (torch.rand(sh, generator=g) >= 0.95).int(), seed + 4)),
        ("label_range_above_histogram", relabel(
            candidates(B, K, seed + 5), lambda g, sh:
            torch.randint(0, LABEL_RANGE_WIDE, sh, generator=g), seed + 5)),
    ]


def phase_kernel_wide(card: str) -> dict:
    """The K > 1024 route (partition by label, then each segment's chain)
    against the plain version on the card at WIDE_K x WIDE_B, 80 classes:
    class-aware with merge and with drop_lone_survivor, class-agnostic
    without merge with drop_lone_survivor off and on, near-threshold
    pairs both ways; one label, two labels with a segment above 1024, and
    a label range above the histogram (the workspace header must count
    every image on the one-segment path); every check must count one
    launch of the route.  Then its device time at WIDE_TIME_K x
    WIDE_TIME_B with the chain length, the plain version's at B=1, and
    the bound; and at K=25,200 with one label."""
    max_err = 0.0
    flag_sets = ((True, True, False), (False, False, False),
                 (False, False, True), (True, True, True))
    # (class_aware, merge, drop)
    bins = nms_kernel._lib().greedy_nms_label_bins()
    for K in WIDE_K:
        for B in WIDE_B:
            seed = 10 * K + B
            cases = [("random_c80", candidates(B, K, seed, classes=80),
                      flag_sets),
                     ("near_threshold", near_threshold_k(B, K, seed + 1),
                      flag_sets[::2])]
            if K % (2 * NMS_TILE) == 0:
                cases.append(("near_threshold_cross_tile",
                              near_threshold_cross(B, K, seed + 2),
                              flag_sets[::2]))
            cases += [(name, args, (flag_sets[0], flag_sets[3]))
                      for name, args in label_cases(B, K, seed)]
            for name, args, flags in cases:
                for class_aware, merge, drop in flags:
                    tiled = nms_kernel.TILED_LAUNCHES
                    err = check_kernel(args, class_aware, merge, drop=drop)
                    if nms_kernel.TILED_LAUNCHES != tiled + 1:
                        raise AssertionError(f"K={K} did not take the tiled "
                                             f"kernel")
                    max_err = max(max_err, err)
                    row = {"phase": "kernel_check", "case": f"{name}_B{B}_K{K}",
                           "class_aware": class_aware, "merge": merge,
                           "drop_lone_survivor": drop, "keep_equal": True,
                           "max_abs_box_err": err, "card": card}
                    if name == "near_threshold_cross_tile":
                        row.update(cross_tile_pairs(args, class_aware, drop))
                    _, keep, hdr = tiled_at_any_k(
                        args, class_aware=class_aware, merge=merge,
                        drop=drop, header=True)
                    one = hdr[nms_kernel.HEADER_ONE_SEGMENT]
                    want = B if (class_aware and
                                 name == "label_range_above_histogram") else 0
                    if one != want or not torch.equal(
                            keep, nms_kernel.greedy_nms(
                                *args, class_aware=class_aware, merge=merge,
                                drop_lone_survivor=drop)[1]):
                        raise AssertionError(
                            f"{name}: {one} images on the one-segment path "
                            f"(want {want}, histogram {bins} labels)")
                    row.update(segments=hdr[nms_kernel.HEADER_SEGMENTS],
                               one_segment_images=one)
                    emit(row)
    timing = {}
    for K, B, classes in [(K, B, 80) for K in WIDE_TIME_K
                          for B in WIDE_TIME_B] + [
                              (SERVE_ALL_K, B, 1) for B in WIDE_TIME_B]:
        args = candidates(B, K, 7 * K + B + classes, classes=classes)
        ms, call_ms = time_ms(lambda: nms_kernel.greedy_nms(*args),
                              5 if K > 4096 else 50)
        plain_ms = (call_time_ms(lambda: nms_kernel.greedy_nms_plain(
            *args), 1, warmup=1) if B == 1 else None)
        timing[(K, B, classes)] = dict(
            ms=ms, call_ms=call_ms, plain_ms=plain_ms, **split_bounds(args),
            ious_k_by_kept=ious_k_by_kept(args),
            segments=tiled_at_any_k(args, header=True)[2][
                nms_kernel.HEADER_SEGMENTS],
            **kernel_ab.chain_length(args))
        emit({"phase": "kernel_time", "kernel": "tiled", "B": B, "K": K,
              "classes": classes, "card": card, **timing[(K, B, classes)],
              "library_ms": None})
    return {"max_abs_err": max_err, "timing": timing}


def check_large_batch(args, every: int = 8) -> dict:
    """The kernel's result on a large batch: ``keep`` of every ``every``-th
    image identical to ``greedy_nms_plain`` on that image alone (its
    [K, K] tensors take GBs an image), and the whole batch's ``keep``
    identical to ``greedy_nms_segmented_plain`` with boxes within
    BOX_TOL."""
    kb, kk = nms_kernel.greedy_nms(*args)
    images = list(range(0, args[1].shape[0], every))
    err = 0.0
    for b in images:
        pb, pk = nms_kernel.greedy_nms_plain(*[t[b:b + 1] for t in args])
        if not torch.equal(kk[b:b + 1], pk):
            raise AssertionError(f"image {b}: keep differs in "
                                 f"{int((kk[b:b + 1] != pk).sum())} rows")
        torch.testing.assert_close(kb[b:b + 1], pb, **BOX_TOL)
        err = max(err, float((kb[b:b + 1] - pb).abs().max()))
    sb, sk = nms_kernel.greedy_nms_segmented_plain(*args)
    if not torch.equal(kk, sk):
        raise AssertionError(f"segmented plain: keep differs in "
                             f"{int((kk != sk).sum())} rows")
    torch.testing.assert_close(kb, sb, **BOX_TOL)
    return {"images_checked_plain": images, "max_abs_err": max(
        err, float((kb - sb).abs().max())), "batch_checked_segmented": True}


def phase_serving_all(card: str) -> dict:
    """``predict_step`` on YOLOv5s-640 bf16 with every decoded row into the
    NMS (top_k SERVE_ALL_K, conf_thres SERVE_ALL_CONF) at B=1 and 64: one
    launch of the tiled kernel a batch and none of the plain version; ms a
    batch.  Then the B=1 batch's candidates through the kernel and the
    plain version (keep identical, boxes within BOX_TOL), both timed, and
    the B=64 batch's kernel time."""
    step, model = serving_model(conf_thres=SERVE_ALL_CONF, top_k=SERVE_ALL_K)
    g = torch.Generator(device="cuda").manual_seed(0)
    batches = {B: torch.randint(0, 256, (B, IMG, IMG, 3), generator=g,
                                dtype=torch.uint8, device="cuda")
               for B in (1, 64)}
    plain = nms_kernel.greedy_nms_plain
    plain_calls = []
    nms_kernel.greedy_nms_plain = lambda *a, **k: plain_calls.append(1) or \
        plain(*a, **k)
    torch.cuda.synchronize()
    try:
        reset_launches()                       # main path starts here
        calls, results, last = 0, {}, None
        for B, images in batches.items():
            times = []
            for i in range(4):                 # one warm-up, three batches
                t0 = time.perf_counter()
                last = step(images)
                torch.cuda.synchronize()
                calls += 1
                if i:
                    times.append((time.perf_counter() - t0) * 1e3)
            results[B] = {"ms_per_batch": times, "valid": int(
                last.valid.sum())}
        counts = read_launches()               # main path ends here
    finally:
        nms_kernel.greedy_nms_plain = plain
    if (counts["greedy_nms"], counts["greedy_nms_tiled"], len(plain_calls)) \
            != (calls, calls, 0):
        raise AssertionError(f"{calls} batches: {counts} launches, "
                             f"{len(plain_calls)} plain calls")
    if last.boxes.shape != (64, SERVE_ALL_K, 4) or not torch.isfinite(
            last.boxes).all():
        raise AssertionError("serving_all boxes: wrong shape or non-finite")
    for B, r in results.items():
        emit({"phase": "serving_all", "card": card, "model": "Yolov5s",
              "img": IMG, "classes": NUM_CLASSES, "dtype": "bfloat16",
              "top_k": SERVE_ALL_K, "conf_thres": SERVE_ALL_CONF, "B": B,
              **r, "launches": counts})
    out = {"launches": counts["greedy_nms_tiled"]}
    with torch.inference_mode():
        for B, images in batches.items():
            preds = nms.decode_yolov5_predictions(
                model(images), anchor_lib.YOLOV5_ANCHORS,
                anchor_lib.YOLOV5_STRIDES, NUM_CLASSES)
            args = nms.yolo_candidates(preds, SERVE_ALL_CONF,
                                       SERVE_ALL_K).nms_inputs()
            ms, call_ms = time_ms(lambda: nms_kernel.greedy_nms(*args), 5)
            r = dict(ms=ms, call_ms=call_ms, **split_bounds(args),
                     ious_k_by_kept=ious_k_by_kept(args),
                     segments=tiled_at_any_k(args, header=True)[2][
                         nms_kernel.HEADER_SEGMENTS],
                     valid_rows=int((args[1] > nms_kernel.NEG_INF).sum()),
                     **kernel_ab.chain_length(args))
            if B == 1:                          # the plain version's GBs
                r["max_abs_err"] = check_kernel(args, True, True)
                r["plain_ms"] = call_time_ms(
                    lambda: nms_kernel.greedy_nms_plain(*args), 1, warmup=1)
            else:
                r.update(check_large_batch(args))
            out[B] = r
            emit({"phase": "serving_all_check", "card": card, "B": B,
                  "K": SERVE_ALL_K, "keep_equal": True, **r,
                  "library_ms": None})
    return out

def phase_fp32(card: str) -> float:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.rand(2, IMG, IMG, 3, generator=torch.Generator().manual_seed(0))
    on_card = build_model("YOLOv5", NUM_CLASSES, device="cuda", seed=0)
    on_cpu = build_model("YOLOv5", NUM_CLASSES, device="cpu", seed=0)
    with torch.inference_mode():
        heads = on_card(x.cuda())
        ref = on_cpu(x)
    errs = []
    for h, r in zip(heads, ref):
        if not torch.isfinite(h).all():
            raise AssertionError("non-finite head map on the card")
        torch.testing.assert_close(h.cpu(), r, **HEAD_TOL)
        errs.append(float((h.cpu() - r).abs().max()))
    with torch.inference_mode():
        preds = nms.decode_yolov5_predictions(
            heads, anchor_lib.YOLOV5_ANCHORS, anchor_lib.YOLOV5_STRIDES,
            NUM_CLASSES)
        c = nms.yolo_candidates(preds, 0.5, TOP_K)
        err = check_kernel(c.nms_inputs(), True, True)
    n_valid = int((c.scores > nms.NEG_INF).sum())
    emit({"phase": "fp32_card_vs_cpu", "card": card, "B": 2, "img": IMG,
          "head_max_abs_err": errs, "head_tol": HEAD_TOL,
          "valid_candidates": n_valid, "keep_equal": True,
          "max_abs_box_err": err})
    return err


def serving_model(name: str = "YOLOv5", img: int = IMG, **post):
    """(images -> NMSResult, model): ``predict_step`` bound to a serving
    state (no optimizer, no EMA), bf16, /255 folded into the stem;
    ``post`` goes to ``make_postprocess`` (conf_thres, top_k)."""
    model = build_model(name, NUM_CLASSES, dtype=torch.bfloat16,
                        device="cuda", seed=0)
    model.load_state_dict(fold_input_scale(model.state_dict(), 1.0 / 255.0,
                                           STEM_CONVS[name]))
    step = make_predict_step(model, make_postprocess(name, NUM_CLASSES, img,
                                                     **post))
    return functools.partial(step, create_train_state(model)), model


def phase_serving(card: str) -> dict:
    step, model = serving_model()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(0)
    batches = {B: torch.randint(0, 256, (B, IMG, IMG, 3), generator=g,
                                dtype=torch.uint8, device="cuda")
               for B in (1, 64)}
    torch.cuda.synchronize()
    reset_launches()                           # main path starts here
    calls, results, last = 0, {}, None
    for B, images in batches.items():
        times = []
        for i in range(4):                     # one warm-up, three requests
            t0 = time.perf_counter()
            last = step(images)
            torch.cuda.synchronize()
            calls += 1
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        results[B] = {"ms_per_batch": times,
                      "img_per_s": [B * 1e3 / t for t in times]}
    counts = read_launches()                   # main path ends here
    launches = counts["greedy_nms"]
    if launches != calls:
        raise AssertionError(f"greedy_nms launched {launches} times in "
                             f"{calls} batches")
    for field, t in last._asdict().items():
        if not t.is_cuda:
            raise AssertionError(f"NMSResult.{field} is not on CUDA")
    if last.boxes.shape != (64, TOP_K, 4) or not torch.isfinite(
            last.boxes).all():
        raise AssertionError("serving boxes: wrong shape or non-finite")
    for B, r in results.items():
        emit({"phase": "serving", "card": card, "model": "Yolov5s",
              "img": IMG, "classes": NUM_CLASSES, "dtype": "bfloat16",
              "B": B, **r})
    # the last batch's candidates through kernel and plain version (bf16)
    with torch.inference_mode():
        preds = nms.decode_yolov5_predictions(
            model(batches[64]), anchor_lib.YOLOV5_ANCHORS,
            anchor_lib.YOLOV5_STRIDES, NUM_CLASSES)
        args = nms.yolo_candidates(preds, 0.5, TOP_K).nms_inputs()
        err = check_kernel(args, True, True)
        ms, call_ms = time_ms(lambda: nms_kernel.greedy_nms(*args), 100)
    bound = nms_bound_ms(args)
    emit({"phase": "serving_check", "card": card, "B": 64,
          "valid": int(last.valid.sum()), "keep_equal": True,
          "max_abs_box_err": err, "nms_ms": ms, "nms_call_ms": call_ms,
          **{f"nms_{k}": v for k, v in bound.items()},
          **kernel_ab.chain_length(args),
          "launches": counts,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"launches": launches, "max_abs_err": err}


# --- the serving export and the serving bench ------------------------------


EXPORT_BATCHES = (1, 64)
EXPORT_FAMILY = {"SSD": 300}      # the class-agnostic op variant, run once
BENCH_BATCHES = (64, 256)
BENCH_ORDER = (False, True, True, False)      # dense, prefilter, alternated

# a fresh interpreter that imports only the export module: loads each
# program, runs it once on its saved batch, and reports its NMS launches
# and the port's modules it imported
_LOAD_PROBE = r"""
import json, sys
import torch
from objectdetectionpl_tpu_torch.ops.cuda import nms_kernel
from objectdetectionpl_tpu_torch.utils import export
out = {}
for prog, raw, res in zip(*[iter(sys.argv[1:])] * 3):
    images = torch.load(raw).cuda()
    fn = export.load(prog)
    with torch.inference_mode():
        torch.save([t.cpu() for t in fn(images)], res)
torch.cuda.synchronize()
print(json.dumps({"launches": nms_kernel.LAUNCHES,
                  "calls": (len(sys.argv) - 1) // 3,
                  "modules": sorted(k for k in sys.modules
                                    if k.startswith("objectdetectionpl_tpu"))}))
"""


def requests_ms(fn, images, n: int = 3) -> list:
    """Host ms of each of ``n`` requests after one warm-up, each to a
    sync."""
    times = []
    for i in range(n + 1):
        t0 = time.perf_counter()
        fn(images)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def same_detections(name: str, got, want) -> float:
    """``valid``, ``labels`` and ``scores`` identical; returns the largest
    box difference."""
    got, want = tuple(got), tuple(want)
    for i, field in ((4, "valid"), (3, "labels"), (2, "scores")):
        if not torch.equal(got[i].to(want[i].device), want[i]):
            raise AssertionError(f"{name}: {field} differs from eager")
    return (got[0].to(want[0].device).float()
            - want[0].float()).abs().max().item()


def phase_export(card: str) -> dict:
    """YOLOv5s-640, bf16, 80 classes, /255 folded: ``build_inference_fn``
    saved at B=1 and B=64, loaded here and in a fresh interpreter, against
    eager ``predict_step`` on the same weights and batches; then SSD-300
    once."""
    step, _ = serving_model()          # the stem folded by fold_input_scale
    model = build_model("YOLOv5", NUM_CLASSES, dtype=torch.bfloat16,
                        device="cuda", seed=0)       # the same seed, unfolded
    fn = export_lib.build_inference_fn(
        model, model.state_dict(), make_postprocess("YOLOv5", NUM_CLASSES,
                                                    IMG))
    if not fn.fold:
        raise AssertionError("export: YOLOv5 must fold the /255")
    del model
    g = torch.Generator(device="cuda").manual_seed(1)
    batches = {B: torch.randint(0, 256, (B, IMG, IMG, 3), generator=g,
                                dtype=torch.uint8, device="cuda")
               for B in EXPORT_BATCHES}
    out = {"launches": 0}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_",
                                     dir=REPO / "build") as tmp:
        probe_args, rows = [], {}
        for B, images in batches.items():
            path = os.path.join(tmp, f"yolov5s_b{B}.pt2")
            t0 = time.perf_counter()
            export_lib.save(path, fn, batch=B, img_size=IMG)
            export_s = time.perf_counter() - t0
            loaded = export_lib.load(path)
            with torch.inference_mode():
                want = step(images)
                torch.cuda.synchronize()
                reset_launches()               # main path starts here
                got = loaded(images)
                torch.cuda.synchronize()
                counts = read_launches()       # main path ends here
                err = same_detections(f"export B={B}", got, want)
                eager_ms = requests_ms(step, images)
                reset_launches()
                loaded_ms = requests_ms(loaded, images)
                timed = read_launches()["greedy_nms"]
            if counts["greedy_nms"] != 1 or timed != 4:
                raise AssertionError(
                    f"export B={B}: the loaded program launched the NMS "
                    f"kernel {counts['greedy_nms']} times in one call, "
                    f"{timed} in four")
            out["launches"] += counts["greedy_nms"] + timed
            if B == max(EXPORT_BATCHES):       # where the device time goes
                with torch.inference_mode():
                    for name, call in (("eager", step), ("loaded", loaded)):
                        wall_ms, busy_ms, by_class, top = profile_one(
                            lambda: call(images))
                        emit({"phase": "export_profile", "card": card,
                              "B": B, "path": name, "wall_ms": wall_ms,
                              "device_busy_ms": busy_ms,
                              "by_class": by_class, "top": top})
                out["launches"] += read_launches()["greedy_nms"] - timed
            raw_path = os.path.join(tmp, f"raw_b{B}.pt")
            torch.save(images.cpu(), raw_path)
            probe_args += [path, raw_path, os.path.join(tmp, f"out_b{B}.pt")]
            rows[B] = {"export_s": export_s,
                       "pt2_mb": os.path.getsize(path) / 1e6,
                       "max_abs_box_err": err, "eager_ms": eager_ms,
                       "loaded_ms": loaded_ms,
                       "valid": int(got[4].sum()), "launches": counts}
        # the fresh interpreter: imports the export module alone
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", _LOAD_PROBE,
                               *probe_args], cwd=REPO, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"export: the fresh interpreter failed:\n"
                                 f"{proc.stderr[-4000:]}")
        fresh = json.loads(proc.stdout.strip().splitlines()[-1])
        if fresh["launches"] != fresh["calls"]:
            raise AssertionError(f"export: the fresh interpreter launched "
                                 f"the NMS kernel {fresh['launches']} times "
                                 f"in {fresh['calls']} calls")
        if any(m.startswith("objectdetectionpl_tpu_torch.models")
               or m.split(".")[0] == "objectdetectionpl_tpu"
               for m in fresh["modules"]):
            raise AssertionError(f"export: loading imported "
                                 f"{fresh['modules']}")
        for B, images in batches.items():
            got = torch.load(os.path.join(tmp, f"out_b{B}.pt"))
            with torch.inference_mode():
                rows[B]["fresh_max_abs_box_err"] = same_detections(
                    f"fresh B={B}", got, step(images))
        for B, r in rows.items():
            emit({"phase": "export", "card": card, "model": "Yolov5s",
                  "img": IMG, "classes": NUM_CLASSES, "dtype": "bfloat16",
                  "fold": True, "B": B, **r})
        emit({"phase": "export_fresh", "card": card,
              "wall_s": time.perf_counter() - t0, **fresh})
        out["fresh_launches"] = fresh["launches"]
        for name, img in EXPORT_FAMILY.items():
            model = build_model(name, NUM_CLASSES, dtype=torch.bfloat16,
                                device="cuda", seed=0)
            fam = export_lib.build_inference_fn(
                model, model.state_dict(),
                make_postprocess(name, NUM_CLASSES, img))
            path = os.path.join(tmp, f"{name.lower()}.pt2")
            t0 = time.perf_counter()
            export_lib.save(path, fam, batch=1, img_size=img)
            export_s = time.perf_counter() - t0
            images = torch.randint(0, 256, (1, img, img, 3), generator=g,
                                   dtype=torch.uint8, device="cuda")
            loaded = export_lib.load(path)
            with torch.inference_mode():
                want = fam(images)
                reset_launches()               # main path starts here
                got = loaded(images)
                torch.cuda.synchronize()
                counts = read_launches()       # main path ends here
            err = same_detections(f"export {name}", got, want)
            if counts["greedy_nms"] != 1:
                raise AssertionError(f"export {name}: {counts}")
            out["launches"] += 1
            emit({"phase": "export_family", "card": card, "model": name,
                  "img": img, "fold": fam.fold, "export_s": export_s,
                  "pt2_mb": os.path.getsize(path) / 1e6,
                  "max_abs_box_err": err, "valid": int(got[4].sum()),
                  "launches": counts})
        out["cross_launches"] = export_cross(
            card, tmp, fn, os.path.join(tmp, "yolov5s_b1.pt2"), batches[1])
    return out


def export_cross(card: str, tmp: str, fn, card_path: str, images) -> int:
    """A program exported on the CPU served on the card, and one exported
    on the card served on the CPU, each against the eager chain on its
    device; returns the NMS launches of the first."""
    model = build_model("YOLOv5", NUM_CLASSES, dtype=torch.float32,
                        device="cpu", seed=0)
    on_cpu = export_lib.build_inference_fn(
        model, model.state_dict(), make_postprocess("YOLOv5", NUM_CLASSES,
                                                    IMG))
    del model
    path = os.path.join(tmp, "yolov5s_f32_exported_on_cpu.pt2")
    t0 = time.perf_counter()
    export_lib.save(path, on_cpu, batch=1, img_size=IMG)
    export_s = time.perf_counter() - t0
    eager_card = on_cpu.to("cuda")
    loaded = export_lib.load(path)             # the port's rule: the card
    with torch.inference_mode():
        want = eager_card(images)
        torch.cuda.synchronize()
        reset_launches()                       # main path starts here
        got = loaded(images)
        torch.cuda.synchronize()
        counts = read_launches()               # main path ends here
    if counts["greedy_nms"] != 1 or got[0].device.type != "cuda":
        raise AssertionError(f"export cpu->cuda: {counts}, "
                             f"{got[0].device}")
    rows = [{"exported_on": "cpu", "loaded_on": "cuda", "dtype": "float32",
             "export_s": export_s, "launches": counts,
             "max_abs_box_err": same_detections("export cpu->cuda", got,
                                                want),
             "valid": int(got[4].sum())}]
    eager_cpu = fn.to("cpu")
    t0 = time.perf_counter()
    loaded = export_lib.load(card_path, "cpu")
    load_s = time.perf_counter() - t0
    raw = images.cpu()
    with torch.inference_mode():
        want = eager_cpu(raw)
        reset_launches()
        got = loaded(raw)
        torch.cuda.synchronize()
        cpu_counts = read_launches()
    fn.to("cuda")
    if cpu_counts["greedy_nms"] != 0 or got[0].device.type != "cpu":
        raise AssertionError(f"export cuda->cpu: {cpu_counts}, "
                             f"{got[0].device}")
    rows.append({"exported_on": "cuda", "loaded_on": "cpu",
                 "dtype": "bfloat16", "load_s": load_s,
                 "launches": cpu_counts,
                 "max_abs_box_err": same_detections("export cuda->cpu", got,
                                                    want),
                 "valid": int(got[4].sum())})
    for r in rows:
        emit({"phase": "export_cross", "card": card, "model": "Yolov5s",
              "img": IMG, "B": 1, **r})
    return counts["greedy_nms"]


def phase_bench(card: str) -> dict:
    """The port bench (``objectdetectionpl_tpu_torch/bench.py``) at B=64
    and B=256, dense and ``--prefilter`` alternated (D P P D) in this
    process, each run's launches counted; then the two chains on one
    batch: the prefilter's detections identical to the dense chain's."""
    out = {"launches": 0, "runs": []}
    for B in BENCH_BATCHES:
        for prefilter in BENCH_ORDER:
            reset_launches()                   # main path starts here
            res = bench.main(["--batch", str(B)]
                             + (["--prefilter"] if prefilter else []))
            counts = read_launches()           # main path ends here
            want = bench.WARMUP + bench.ITERS
            if counts["greedy_nms"] != want or res["nms_launches"] != want:
                raise AssertionError(f"bench B={B}: {counts} for {want} "
                                     f"iterations")
            out["launches"] += counts["greedy_nms"]
            out["runs"].append({"B": B, "prefilter": prefilter,
                                "img_per_s": res["value"]})
        raw = torch.from_numpy(np.random.RandomState(0).randint(
            0, 255, (B, IMG, IMG, 3)).astype(np.uint8)).cuda()
        with torch.inference_mode():
            dense = bench.make_chain("cuda", False)(raw)
            pre = bench.make_chain("cuda", True)(raw)
        for i, field in enumerate(("boxes", "obj", "scores", "labels",
                                   "valid")):
            if not torch.equal(dense[i], pre[i]):
                raise AssertionError(f"bench B={B}: the prefilter's "
                                     f"{field} differ from the dense chain's")
        emit({"phase": "bench_check", "card": card, "B": B,
              "detections_identical": True, "valid": int(dense[4].sum())})
    emit({"phase": "bench", "card": card, "runs": out["runs"],
          "launches": out["launches"]})
    return out


def reset_launches() -> None:
    nms_kernel.LAUNCHES = 0
    nms_kernel.TILED_LAUNCHES = 0
    warp_kernel.LAUNCHES = 0
    for name in conv_kernel.LAUNCHES:
        conv_kernel.LAUNCHES[name] = 0


def read_launches() -> dict:
    return {"greedy_nms": nms_kernel.LAUNCHES,
            "greedy_nms_tiled": nms_kernel.TILED_LAUNCHES,
            "affine_warp": warp_kernel.LAUNCHES, **conv_kernel.LAUNCHES}


# --- the affine warp -------------------------------------------------------


def rss_inverse(deg: float, scale: float, tx: float, ty: float):
    fwd = augment._rot_shift_scale_matrix(
        torch.tensor([math.radians(deg)]), torch.tensor([scale]),
        torch.tensor([tx]), torch.tensor([ty]))
    return torch.linalg.inv(fwd)


def warp_inside(H: int, W: int, inv: torch.Tensor) -> int:
    """Output pixels whose source point lies inside the image: the
    kernel's coordinate test, for counting the blend work."""
    dev = inv.device
    ys = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H
    xs = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    m = inv[:, :, :, None, None]
    sx = (m[:, 0, 0] * xx + m[:, 0, 1] * yy + m[:, 0, 2]) * W - 0.5
    sy = (m[:, 1, 0] * xx + m[:, 1, 1] * yy + m[:, 1, 2]) * H - 0.5
    return int(((sx >= 0) & (sx <= W - 1) & (sy >= 0)
                & (sy <= H - 1)).sum())


def warp_bound_ms(slots: torch.Tensor, inv: torch.Tensor,
                  use: torch.Tensor) -> tuple:
    """Read each slot once and write it; the coordinates of every pixel and
    the blend of the inside ones of the slots that are warped."""
    K, H, W, C = slots.shape
    nbytes = 2 * slots.numel() * 4 + inv.numel() * 4 + use.numel()
    ops = (int(use.sum()) * H * W * WARP_COORD_OPS
           + warp_inside(H, W, inv[use]) * C * WARP_BLEND_OPS_PER_CHANNEL)
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_warp(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Kernel vs plain on the same CUDA tensors; returns max |error|."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = float((got - want).abs().max())
    if err > WARP_TOL:
        raise AssertionError(f"{name}: the warp kernel differs from its "
                             f"plain version by {err} (tolerance "
                             f"{WARP_TOL})")
    return err


def edge_staged(plan: dict, H: int, W: int) -> int:
    """Staged tiles of a ``tile_plan`` in the partial last row or column
    of tiles (none where the size is a multiple of the tile)."""
    last = torch.zeros(plan["path"].shape[1:], dtype=torch.bool)
    last[:, -1] = W % warp_kernel.TILE != 0
    last[-1, :] |= H % warp_kernel.TILE != 0
    return int((plan["path"][:, last] == 1).sum())


def phase_warp_check() -> float:
    g = torch.Generator().manual_seed(20)
    img = lambda K, H, W: torch.rand(K, H, W, 3, generator=g).cuda()
    # affine_warp: every image warped
    cases = [
        ("ssr_K26_640", img(WARP_K, IMG, IMG), ssr_inverses(WARP_K, 21)),
        ("identity_640", img(1, IMG, IMG), torch.eye(3)[None]),
        ("rot60_scale0.5_640", img(1, IMG, IMG), rss_inverse(60, 0.5, 0, 0)),
        ("all_outside_640", img(1, IMG, IMG), rss_inverse(0, 1.0, 2.0, 0)),
        ("ssr_K4_37x53", img(4, 37, 53), ssr_inverses(4, 22)),
    ]
    max_err = 0.0
    for name, images, inv in cases:
        inv = inv.contiguous().cuda()
        err = check_warp(name, warp_kernel.affine_warp(images, inv),
                         warp_kernel.affine_warp_plain(images, inv))
        max_err = max(max_err, err)
        emit({"phase": "warp_check", "case": name,
              "shape": list(images.shape), "max_abs_err": err,
              "tolerance": WARP_TOL,
              "inside_pixels": warp_inside(images.shape[1], images.shape[2],
                                           inv)})
    # affine_warp_slots on a B=64 batch (8 of 37x53): slots in coin order,
    # as augment_batch gives them; each case reaches the kernel's paths
    # that its check names, counted by tile_plan
    batch, small = img(TRAIN_B, IMG, IMG), img(8, 37, 53)
    top, inv, use = kernel_ab.ssr_mix(TRAIN_B, WARP_K, 26)
    inv21 = ssr_inverses(WARP_K, 21).cuda()
    yes = lambda n: torch.ones(n, dtype=torch.bool, device="cuda")
    on = lambda *v: torch.tensor(v, device="cuda")
    slot_cases = [
        ("slots_all_used_K26_640", batch, top, inv21, yes(WARP_K),
         lambda n: n["copy"] == 0 and n["staged"] > 0),
        ("slots_none_used_K26_640", batch, top, inv21, ~yes(WARP_K),
         lambda n: n["copy"] == sum(n[p] for p in warp_kernel.PATHS)),
        ("slots_mix_K26_640", batch, top, inv, use,
         lambda n: n["copy"] > 0 and n["staged"] > 0),
        ("slots_rot60_scale0.5_640", batch, on(37, 5),
         rss_inverse(60, 0.5, 0, 0).expand(2, 3, 3).cuda(), yes(2),
         lambda n: n["global"] > 0),
        ("slots_mix_37x53", small, on(5, 2, 7, 0), ssr_inverses(4, 22).cuda(),
         on(True, False, True, True), lambda n: n["copy"] and n["staged"]),
    ]
    # the anchor families' training batches (B=32, K=13): the stores are
    # 16 bytes wide and the last row and column of tiles are partial
    anchor_k = round(ANCHOR_TRAIN_B * 2 * augment.AugmentConfig().p_ssr)
    for i, S in enumerate(sorted(set(ANCHOR_FAMILIES.values()))):
        slot_cases.append(
            (f"slots_mix_K{anchor_k}_B{ANCHOR_TRAIN_B}_{S}",
             img(ANCHOR_TRAIN_B, S, S),
             *kernel_ab.ssr_mix(ANCHOR_TRAIN_B, anchor_k, 27 + i),
             lambda n: n["copy"] > 0 and n["staged"] > 0
             and n["edge_staged"] > 0 and n["vec"]))
    for name, images, top, inv, use, expect in slot_cases:
        inv = inv.contiguous()
        _, H, W, C = images.shape
        plan = warp_kernel.tile_plan(H, W, C, inv, use)
        paths = warp_kernel.path_counts(plan)
        edge = edge_staged(plan, H, W)
        if not expect(dict(paths, vec=plan["vec"], edge_staged=edge)) \
                or bool((top.diff() > 0).all()):
            raise AssertionError(f"{name}: tiles per path {paths}, top "
                                 f"{top.tolist()}: not the case it names")
        err = check_warp(
            name, warp_kernel.affine_warp_slots(images, top, inv, use),
            warp_kernel.affine_warp_slots_plain(images, top, inv, use))
        max_err = max(max_err, err)
        emit({"phase": "warp_check", "case": name, "source": list(
              images.shape), "K": len(top), "used": int(use.sum()),
              "tiles": paths, "vec": plan["vec"], "edge_staged": edge,
              "max_abs_err": err, "tolerance": WARP_TOL})
    return max_err


def grid_sample_warp(images: torch.Tensor, inv: torch.Tensor):
    """The library yardstick: the same warp through ``F.affine_grid`` +
    ``F.grid_sample`` on [-1, 1] coordinates (NCHW out).  It blends with
    zero across the one-texel border where ``affine_warp`` zeroes the
    pixel, so it is a yardstick of time, not of values."""
    K, H, W, C = images.shape
    m = inv[:, :2]
    theta = torch.stack([m[:, 0, 0], m[:, 0, 1],
                         m[:, 0, 0] + m[:, 0, 1] + 2 * m[:, 0, 2] - 1,
                         m[:, 1, 0], m[:, 1, 1],
                         m[:, 1, 0] + m[:, 1, 1] + 2 * m[:, 1, 2] - 1],
                        -1).view(K, 2, 3)
    grid = F.affine_grid(theta, (K, C, H, W), align_corners=False)
    return F.grid_sample(images.permute(0, 3, 1, 2), grid, mode="bilinear",
                         padding_mode="zeros", align_corners=False)


def phase_warp_time(card: str) -> dict:
    w = kernel_ab.warp_inputs()
    batch, top, inv, use = w["batch"], w["top"], w["inv_all"], w["all_used"]
    slots = batch[top].contiguous()
    bound_ms, bound_by = warp_bound_ms(slots, inv, use)
    mix_bound_ms, _ = warp_bound_ms(slots, w["inv"], w["use"])
    plain_ms = call_time_ms(lambda: warp_kernel.affine_warp_slots_plain(
        batch, top, inv, use), 10)
    # ~10 launches a call: 40 calls stay inside the launch queue's depth,
    # which the spin needs to hold them all
    lib_ms, lib_call_ms = time_ms(lambda: grid_sample_warp(slots, inv), 40)
    q = slice(IMG // 4, 3 * IMG // 4)          # always inside for SSR draws
    lib_diff = float((grid_sample_warp(slots, inv).permute(0, 2, 3, 1)
                      - warp_kernel.affine_warp(slots, inv))[:, q, q]
                     .abs().max())
    t = kernel_ab.warp_times(w)                # last: the tail edits batch
    out = dict(ms=t["all_used_ms"], call_ms=t["all_used_call_ms"],
               plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               share_of_bound=bound_ms / t["all_used_ms"],
               library_ms=lib_ms, library_call_ms=lib_call_ms,
               library_max_abs_diff_center=lib_diff, used_mix=t["used"],
               ms_mix=t["mix_ms"], call_ms_mix=t["mix_call_ms"],
               bound_ms_mix=mix_bound_ms, tail_ms=t["tail_ms"],
               tail_call_ms=t["tail_call_ms"])
    emit({"phase": "warp_time", "K": WARP_K, "S": IMG, "C": 3, "B": TRAIN_B,
          "card": card, **out})
    return out


# --- training ----------------------------------------------------------------


def train_batch(B: int, seed: int, img: int = IMG):
    """uint8 images [B, img, img, 3] and padded targets (M=32: centers in
    [0.3, 0.7], wh in [0.05, 0.3], about half masked), made on the CPU
    from a seed."""
    g = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (B, img, img, 3), generator=g,
                           dtype=torch.uint8)
    labels = torch.randint(0, NUM_CLASSES, (B, TRAIN_M), generator=g,
                           dtype=torch.int32)
    boxes = torch.cat([0.3 + 0.4 * torch.rand(B, TRAIN_M, 2, generator=g),
                       0.05 + 0.25 * torch.rand(B, TRAIN_M, 2, generator=g)],
                      -1)
    mask = torch.rand(B, TRAIN_M, generator=g) < 0.5
    return images, labels, boxes, mask


def trainer(dtype: torch.dtype, device: str, seed: int = 0,
            accum_steps: int = 1, capture=None, name: str = "YOLOv5",
            model=None, img: int = IMG):
    """(state, train_step) for ``name`` (YOLOv5s by default, or ``model``
    when given) at ``img`` px with the config's Adam; ``capture`` receives
    the head maps of each step, their gradients retained."""
    if model is None:
        model = build_model(name, NUM_CLASSES, dtype=dtype, device=device,
                            seed=seed)
    opt = build_optimizer(Config(), model.parameters())
    loss_fn = losses.make_loss(name, NUM_CLASSES, img)
    if capture is not None:
        def loss_fn(outputs, *targets, _loss=loss_fn):
            maps = (outputs if isinstance(outputs, (list, tuple))
                    else [outputs])
            for o in maps:
                o.retain_grad()
            capture[:] = maps
            return _loss(outputs, *targets)
    return (create_train_state(model, opt),
            make_train_step(model, loss_fn, opt, accum_steps=accum_steps))


def bn_stats(model) -> dict:
    return {n: b.detach().float().cpu() for n, b in model.named_buffers()}


def phase_train_fp32(card: str) -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, labels, boxes, mask = train_batch(2, seed=30)
    u = torch.full((2, 14), 0.99)              # every coin >= p: no change
    res = {}
    for dev in ("cuda", "cpu"):
        heads = []
        state, step = trainer(torch.float32, dev, seed=0, capture=heads)
        x = images.to(dev).float() / 255.0
        x, bx, mk = augment.augment_batch(x, boxes.to(dev), mask.to(dev),
                                          u=u)
        state, metrics = step(state, x[None], labels.to(dev)[None],
                              bx[None], mk[None])
        res[dev] = dict(loss=metrics["loss"].item(),
                        grads=[h.grad.float().cpu() for h in heads],
                        stats=bn_stats(state.model))
    card_res, cpu = res["cuda"], res["cpu"]
    loss_err = abs(card_res["loss"] / cpu["loss"] - 1)
    if loss_err > TRAIN_TOL["loss_rtol"]:
        raise AssertionError(f"train_fp32 loss {card_res['loss']} vs CPU "
                             f"{cpu['loss']}")
    grad_rel = []
    for g, r in zip(card_res["grads"], cpu["grads"]):
        rel = float((g - r).abs().max() / r.abs().max())
        grad_rel.append(rel)
        if not torch.isfinite(g).all() or rel > TRAIN_TOL["head_grad_rel"]:
            raise AssertionError(f"train_fp32 head-map gradient differs by "
                                 f"{rel} of its largest element")
    stat_err = 0.0
    for k, r in cpu["stats"].items():
        torch.testing.assert_close(card_res["stats"][k], r,
                                   **TRAIN_TOL["stats"], msg=k)
        stat_err = max(stat_err, float((card_res["stats"][k] - r).abs()
                                       .max()))
    emit({"phase": "train_fp32", "card": card, "B": 2, "img": IMG,
          "loss_card": card_res["loss"], "loss_cpu": cpu["loss"],
          "loss_rel_err": loss_err, "head_grad_rel_err": grad_rel,
          "bn_stats_max_abs_err": stat_err, "tolerance": TRAIN_TOL})


def augment_and_step(state, step, images_u8, labels, boxes, mask, gen):
    x = images_u8.float() / 255.0
    x, bx, mk = augment.augment_batch(x, boxes, mask, generator=gen)
    return step(state, x[None], labels[None], bx[None], mk[None])


def phase_training(card: str) -> dict:
    batch = [t.cuda() for t in train_batch(TRAIN_B, seed=31)]
    state, step = trainer(torch.bfloat16, "cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(32)
    model = state.model
    param0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                           # main path starts here
    calls, step_ms, loss = 0, [], []
    for i in range(4):                         # one warm-up, three timed
        t0 = time.perf_counter()
        state, metrics = augment_and_step(state, step, *batch, gen)
        torch.cuda.synchronize()
        calls += 1
        loss.append(metrics["loss"].item())
        if i:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_launches()                   # main path ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if counts["affine_warp"] != calls:
        raise AssertionError(f"affine_warp launched {counts['affine_warp']} "
                             f"times in {calls} augment_batch calls")
    if not all(math.isfinite(v) for v in loss):
        raise AssertionError(f"non-finite training loss {loss}")
    moved = sum(not torch.equal(p, param0[n])
                for n, p in model.named_parameters())
    stats_moved = sum(not torch.equal(b, stats0[n])
                      for n, b in model.named_buffers())
    if moved != len(param0) or stats_moved != len(stats0):
        raise AssertionError(f"{moved}/{len(param0)} parameters and "
                             f"{stats_moved}/{len(stats0)} BN statistics "
                             f"changed")
    on_card = ([t for t in model.parameters()] + [t for t in model.buffers()]
               + [t for s in state.optimizer.state.values()
                  for t in s.values() if torch.is_tensor(t)
                  and t.dim() > 0] + [state.step])
    if not all(t.is_cuda for t in on_card):
        raise AssertionError("training state is not all on CUDA")

    aug_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        augment.augment_batch(batch[0].float() / 255.0, batch[2], batch[3],
                              generator=gen)
        torch.cuda.synchronize()
        aug_ms.append((time.perf_counter() - t0) * 1e3)
    emit({"phase": "training", "card": card, "model": "Yolov5s", "img": IMG,
          "classes": NUM_CLASSES, "dtype": "bfloat16", "B": TRAIN_B,
          "M": TRAIN_M, "optimizer": "Adam lr 1e-3 wd 1e-5",
          "ms_per_step": step_ms,
          "img_per_s": [TRAIN_B * 1e3 / t for t in step_ms],
          "augment_ms": aug_ms, "loss": loss, "launches": counts,
          "augment_calls": calls, "peak_mem_gb": peak_gb,
          "params_changed": moved, "bn_stats_changed": stats_moved})
    return {"launches": counts["affine_warp"]}


def phase_accumulation(card: str) -> None:
    images, labels, boxes, mask = [t.cuda() for t in train_batch(8, seed=33)]
    x = images.float() / 255.0
    split = lambda t: t.view(2, 4, *t.shape[1:])
    acc_state, acc_step = trainer(torch.bfloat16, "cuda", seed=1,
                                  accum_steps=2)
    one_state, one_step = trainer(torch.bfloat16, "cuda", seed=1)
    # the two forwards of the first microbatch must be the same arithmetic:
    # cuDNN's default algorithms may differ in the last bit between two
    # calls (once 7.5e-9 on the BN statistics, H100)
    torch.backends.cudnn.deterministic = True
    try:
        acc_state, m2 = acc_step(acc_state, split(x), split(labels),
                                 split(boxes), split(mask),
                                 weights=[1.0, 0.0])
        one_state, m1 = one_step(one_state, split(x)[:1], split(labels)[:1],
                                 split(boxes)[:1], split(mask)[:1])
    finally:
        torch.backends.cudnn.deterministic = False
    a, b = bn_stats(acc_state.model), bn_stats(one_state.model)
    err = max(float((a[k] - b[k]).abs().max()) for k in a)
    if err != 0.0:
        raise AssertionError(f"a zero-weight microbatch moved the BN "
                             f"statistics by up to {err}")
    emit({"phase": "accumulation", "card": card, "B": 8, "accum_steps": 2,
          "weights": [1.0, 0.0], "bn_stats_max_abs_diff": err,
          "loss_accumulated": m2["loss"].item(),
          "loss_first_alone": m1["loss"].item()})


# --- the training options: optimizers, remat, mosaic -------------------------


def optim_run(kw: dict, shapes: list, grads: list, device: str):
    """OPTIM_STEPS steps of ``kw``'s optimizer on ``device``, from the
    seeded parameters of ``shapes``: (parameters, per-parameter state)."""
    g = torch.Generator().manual_seed(40)
    params = [torch.nn.Parameter((0.1 * torch.randn(s, generator=g))
                                 .to(device)) for s in shapes]
    opt = build_optimizer(Config(lr=OPTIM_LR, **kw), params)
    for step_grads in grads:
        for p, gr in zip(params, step_grads):
            p.grad = gr.to(device)
        opt.step()
    return ([p.detach().cpu() for p in params],
            [{k: v.detach().cpu() for k, v in opt.state[p].items()}
             for p in params])


def event_ms(fn, reps: int) -> tuple:
    """(device ms, host-inclusive ms) per call, median of ``reps`` calls
    each between CUDA events and a synchronize: for calls long enough
    (tens of ms) that the enqueue is a small share."""
    for _ in range(2):
        fn()
    dev, host = [], []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return _median(dev), _median(host)


def phase_optim_check(card: str) -> dict:
    """The port's SGD, RMSprop and Adagrad (optax's updates) on the card
    against the same updates on the CPU, over the YOLOv5s-640 parameter
    shapes; ms per step on the card."""
    shapes = [tuple(p.shape) for p in build_model(
        "YOLOv5", NUM_CLASSES, device="cpu").parameters()]
    g = torch.Generator().manual_seed(41)
    grads = [[0.01 * torch.randn(s, generator=g) for s in shapes]
             for _ in range(OPTIM_STEPS)]
    out = {}
    for name, kw in OPTIM_CASES.items():
        card_p, card_s = optim_run(kw, shapes, grads, "cuda")
        cpu_p, cpu_s = optim_run(kw, shapes, grads, "cpu")
        err, rel = 0.0, 0.0
        for a, b in zip(card_p + [v for st in card_s for v in st.values()],
                        cpu_p + [v for st in cpu_s for v in st.values()]):
            diff = float((a - b).abs().max())
            err = max(err, diff)
            rel = max(rel, diff / max(float(b.abs().max()), 1e-30))
        if rel > OPTIM_TOL:
            raise AssertionError(f"optim_check {name}: card off the CPU by "
                                 f"{rel} of a tensor's largest element "
                                 f"({err} absolute)")
        params = [torch.nn.Parameter(torch.zeros(s, device="cuda"))
                  for s in shapes]
        for p, gr in zip(params, grads[0]):
            p.grad = gr.cuda()
        opt = build_optimizer(Config(lr=OPTIM_LR, **kw), params)
        ms = call_time_ms(opt.step, 10)
        out[name] = {"max_abs_err": err, "max_rel_err": rel,
                     "ms_per_step": ms,
                     "state": sorted(card_s[0])}
    emit({"phase": "optim_check", "card": card, "tensors": len(shapes),
          "elements": sum(math.prod(s) for s in shapes),
          "steps": OPTIM_STEPS, "lr": OPTIM_LR, "cases": OPTIM_CASES,
          "tolerance": OPTIM_TOL, "results": out})
    return out


def phase_remat_check(card: str) -> dict:
    """YOLOv5s-640 bf16 B=64 train steps under each ``remat`` setting:
    one deterministic step from the same weights and batch held against
    "none"; then uint8 -> /255 -> ``augment_batch`` (warp kernel) ->
    ``train_step``, one warm-up and three timed steps, counts zeroed before
    and read after, and the peak memory over them."""
    images, labels, boxes, mask = [t.cuda() for t in
                                   train_batch(TRAIN_B, seed=42)]
    x = images.float() / 255.0
    ref, out, launches = None, {}, 0
    for remat in REMAT_SETTINGS:
        model = build_model("YOLOv5", NUM_CLASSES, dtype=torch.bfloat16,
                            device="cuda", seed=0, remat=remat)
        state, step = trainer(torch.bfloat16, "cuda", model=model)
        torch.backends.cudnn.deterministic = True
        try:
            state, metrics = step(state, x[None], labels[None], boxes[None],
                                  mask[None])
        finally:
            torch.backends.cudnn.deterministic = False
        got = {"loss": metrics["loss"].item(),
               "grads": {n: p.grad.float().cpu().clone()
                         for n, p in model.named_parameters()},
               "stats": {n: t.clone() for n, t in bn_stats(model).items()}}
        check = {}
        if ref is None:
            ref = got
        else:
            loss_err = abs(got["loss"] / ref["loss"] - 1)
            grad_rel = max(float((got["grads"][n] - r).abs().max()
                                 / r.abs().max().clamp(min=1e-30))
                           for n, r in ref["grads"].items())
            stat_diff = max(float((got["stats"][n] - r).abs().max())
                            for n, r in ref["stats"].items())
            if (loss_err > REMAT_TOL["loss_rtol"]
                    or grad_rel > REMAT_TOL["grad_rel"] or stat_diff != 0.0):
                raise AssertionError(
                    f"remat={remat}: loss {loss_err}, gradients {grad_rel}, "
                    f"BN statistics {stat_diff} off remat=none")
            check = {"loss_rel_err": loss_err, "grad_rel_err": grad_rel,
                     "bn_stats_max_abs_diff": stat_diff}
        gen = torch.Generator(device="cuda").manual_seed(43)
        state, _ = augment_and_step(state, step, images, labels, boxes, mask,
                                    gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()                       # the path starts here
        step_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            state, metrics = augment_and_step(state, step, images, labels,
                                              boxes, mask, gen)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_launches()               # the path ends here
        if counts["affine_warp"] != 3 or not math.isfinite(
                metrics["loss"].item()):
            raise AssertionError(f"remat={remat}: {counts['affine_warp']} "
                                 f"warp launches in 3 steps, loss "
                                 f"{metrics['loss'].item()}")
        launches += counts["affine_warp"]
        out[remat] = {"ms_per_step": step_ms,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "loss": got["loss"], **check}
        del model, state, step, got
        torch.cuda.empty_cache()
    emit({"phase": "remat_check", "card": card, "model": "Yolov5s",
          "img": IMG, "B": TRAIN_B, "dtype": "bfloat16",
          "tolerance": REMAT_TOL, "results": out})
    return {"launches": launches,
            "peak_mem_gb": {k: v["peak_mem_gb"] for k, v in out.items()}}


def phase_mosaic_check(card: str) -> dict:
    """``mosaic_batch`` at B=64, 640 px, p=1 on the card against the CPU on
    the same draws; ms per call on the card."""
    images, labels, boxes, mask = train_batch(MOSAIC_B, seed=44)
    x = images.float() / 255.0
    g = torch.Generator().manual_seed(45)
    centers = 0.3 + 0.4 * torch.rand(MOSAIC_B, 2, generator=g)
    u_apply = torch.zeros(MOSAIC_B)
    args = (x, boxes, labels, mask)
    cpu = augment.mosaic_batch(*args, p=1.0, centers=centers,
                               u_apply=u_apply)
    cuda_args = [t.cuda() for t in args]
    draws = dict(centers=centers.cuda(), u_apply=u_apply.cuda())
    got = [t.cpu() for t in augment.mosaic_batch(*cuda_args, p=1.0, **draws)]
    err = float((got[0] - cpu[0]).abs().max())
    if err > MOSAIC_TOL or not all(torch.equal(a, b) for a, b in
                                   zip(got[1:], cpu[1:])):
        raise AssertionError(f"mosaic_check: images off the CPU's by {err}, "
                             f"or boxes, labels, masks differ")
    if not cpu[3].any():
        raise AssertionError("mosaic_check: no box kept")
    # a host sync inside would stall the Loader's thread: find the op
    torch.cuda.set_sync_debug_mode("error")
    try:
        augment.mosaic_batch(*cuda_args, p=1.0, **draws)
        sync = None
    except RuntimeError as e:
        sync = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ms, call_ms = event_ms(lambda: augment.mosaic_batch(
        *cuda_args, p=1.0, **draws), 10)
    emit({"phase": "mosaic_check", "card": card, "B": MOSAIC_B, "img": IMG,
          "M": TRAIN_M, "p": 1.0, "max_abs_err": err,
          "tolerance": MOSAIC_TOL, "boxes_equal": True,
          "kept_boxes": int(cpu[3].sum()), "ms": ms, "call_ms": call_ms,
          "host_sync": sync,
          "matmul_gflop": 2 * 2 * 4 * MOSAIC_B * IMG ** 3 * 3 / 1e9})
    return {"max_abs_err": err, "ms": ms}


# --- YOLOv2 / YOLOv3 / YOLOv4 ------------------------------------------------


def yolo_fp32_batch(seed: int):
    """train_batch(2) at 416 px, with targets 0 and 1 of image 0 in one cell
    and anchor of every output map (centers 0.002 apart near the middle,
    the same size) but with other offsets and labels; image 0's other
    targets lie left of x = 0.35, away from that cell."""
    images, labels, boxes, mask = train_batch(2, seed, YOLO_IMG)
    boxes[0, 2:, 0] *= 0.5
    boxes[0, 0] = torch.tensor([0.501, 0.502, 0.2, 0.15])
    boxes[0, 1] = torch.tensor([0.503, 0.504, 0.2, 0.15])
    labels[0, 0], labels[0, 1] = 3, 7
    mask[0, :2] = True
    return images, labels, boxes, mask


def max_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float().cpu() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp(min=1e-30))


def check_last_write(head, anchors_grid, labels, boxes, mask):
    """``build_targets_yolo`` on the card against the CPU on the same map
    (``head``, the first output map of the CPU's step); the shared cell
    must hold target 1's offset and both labels.  Returns the largest
    float difference."""
    out = []
    for dev in ("cuda", "cpu"):
        x = head.detach().float().to(dev)
        xy, wh, conf, cls = losses.decode_yolo_map(x, len(anchors_grid),
                                                   NUM_CLASSES)
        anc = torch.as_tensor(anchors_grid, device=dev)
        pred = losses.decode_yolo_boxes(xy, wh, anc, cap_wh=True)
        out.append(assignment.build_targets_yolo(
            pred, cls, labels.to(dev), boxes.to(dev), mask.to(dev), anc))
    card_t, cpu_t = out
    err = 0.0
    for name in card_t._fields:
        a, b = getattr(card_t, name).cpu(), getattr(cpu_t, name)
        torch.testing.assert_close(a, b, **YOLO_TARGET_TOL,
                                   msg=lambda m: f"{name}: {m}")
        err = max(err, float((a.float() - b.float()).abs().max()))
    g = head.shape[2]
    gx, gy = (boxes[0, 1, :2] * g).tolist()
    gi, gj = int(gx), int(gy)
    a = int(assignment.box_ops.wh_iou(
        boxes[0, 1, 2:] * g, torch.as_tensor(anchors_grid)).argmax())
    if float(card_t.obj_mask[0, :, gj, gi].sum()) != 1.0 or abs(
            float(card_t.tx[0, a, gj, gi]) - (gx - math.floor(gx))) > 1e-6:
        raise AssertionError("the shared cell does not hold the later "
                             "target")
    if card_t.tcls[0, a, gj, gi, [3, 7]].tolist() != [1.0, 1.0]:
        raise AssertionError("the shared cell lost a label")
    return err


def phase_yolo_fp32(card: str) -> float:
    """YOLOv2/v3/v4 at 416 px, 80 classes, f32 (TF32 off): head maps and
    NMS on the card against the CPU, then one train step's loss and
    d(loss)/d(head maps).  Returns the largest NMS box difference."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, labels, boxes, mask = yolo_fp32_batch(seed=40)
    x = images.float() / 255.0
    worst = 0.0
    for name in YOLO_FAMILIES:
        on_cpu = build_model(name, NUM_CLASSES, device="cpu", seed=0)
        on_card = build_model(name, NUM_CLASSES, device="cuda", seed=0)
        with torch.inference_mode():
            heads = on_card(x.cuda())
            ref = on_cpu(x)
        heads = heads if isinstance(heads, list) else [heads]
        ref = ref if isinstance(ref, list) else [ref]
        head_rel = [max_rel(h, r) for h, r in zip(heads, ref)]
        if not all(torch.isfinite(h).all() for h in heads) or max(
                head_rel) > YOLO_HEAD_REL:
            raise AssertionError(f"{name} head maps: card vs CPU {head_rel}")
        anchors_px, strides = YOLO_DECODE[name]
        with torch.inference_mode():
            preds = nms.decode_yolo_predictions(heads, anchors_px, strides,
                                                NUM_CLASSES)
            c = nms.yolo_candidates(preds, 0.5, TOP_K)
            err = check_kernel(c.nms_inputs(), True, True)
        worst = max(worst, err)

        res = {}
        for dev, model in (("cuda", on_card), ("cpu", on_cpu)):
            maps = []
            state, step = trainer(torch.float32, dev, capture=maps,
                                  name=name, model=model)
            state, metrics = step(state, x.to(dev)[None],
                                  labels.to(dev)[None], boxes.to(dev)[None],
                                  mask.to(dev)[None])
            res[dev] = dict(loss=metrics["loss"].item(), maps=maps,
                            grads=[m.grad.float().cpu() for m in maps])
        loss_err = abs(res["cuda"]["loss"] / res["cpu"]["loss"] - 1)
        grad_rel = [max_rel(g, r) for g, r in zip(res["cuda"]["grads"],
                                                  res["cpu"]["grads"])]
        if loss_err > YOLO_TRAIN_TOL["loss_rtol"] or not all(
                torch.isfinite(g).all() for g in res["cuda"]["grads"]) \
                or max(grad_rel) > YOLO_TRAIN_TOL["head_grad_rel"]:
            raise AssertionError(f"{name} train step: loss {res['cuda']} vs "
                                 f"{res['cpu']['loss']}, d(loss)/d(maps) "
                                 f"{grad_rel}")
        target_err = check_last_write(
            res["cpu"]["maps"][0], losses.yolo_anchors_grid(name)[0],
            labels, boxes, mask)
        emit({"phase": "yolo_fp32", "card": card, "model": name, "B": 2,
              "img": YOLO_IMG, "head_max_rel_err": head_rel,
              "valid_candidates": int((c.scores > nms.NEG_INF).sum()),
              "keep_equal": True, "max_abs_box_err": err,
              "loss_card": res["cuda"]["loss"], "loss_cpu": res["cpu"]["loss"],
              "loss_rel_err": loss_err, "head_grad_rel_err": grad_rel,
              "target_max_abs_err": target_err, "last_write_wins": True,
              "tolerance": {"head_rel": YOLO_HEAD_REL, **YOLO_TRAIN_TOL,
                            "targets": YOLO_TARGET_TOL}})
        del on_card, on_cpu, res
        torch.cuda.empty_cache()
    return worst


def forward_flops(model, img: int) -> float:
    """Forward FLOPs per image, from the layer shapes: 2 * Cin * Cout * k *
    k * Ho * Wo per convolution (a multiply-add is two), read by hooks on
    ``blocks.Conv`` during one B=1 forward; BN, activations, pools and the
    decode are left out (under 1 % of it)."""
    flops = []

    def hook(mod, inputs, out):
        flops.append(2.0 * mod.weight[0].numel() * out.shape[1]
                     * out.shape[2] * out.shape[3])

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, blocks.Conv)]
    try:
        with torch.inference_mode():
            model(torch.zeros(1, img, img, 3, dtype=torch.uint8,
                              device=next(model.parameters()).device))
    finally:
        for h in hooks:
            h.remove()
    return sum(flops)


def phase_yolo_serving(card: str) -> dict:
    """Each family's ``predict_step`` at 416 px, 80 classes, bf16, uint8
    with /255 folded: B=64 and B=1, one warm-up and three batches each,
    one NMS launch per batch."""
    out = {}
    for name in YOLO_FAMILIES:
        step, model = serving_model(name, YOLO_IMG)
        g = torch.Generator(device="cuda").manual_seed(41)
        batches = {B: torch.randint(0, 256, (B, YOLO_IMG, YOLO_IMG, 3),
                                    generator=g, dtype=torch.uint8,
                                    device="cuda") for B in (64, 1)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()                       # main path starts here
        calls, results, last = 0, {}, {}
        for B, images in batches.items():
            times = []
            for i in range(4):                 # one warm-up, three requests
                t0 = time.perf_counter()
                last[B] = step(images)
                torch.cuda.synchronize()
                calls += 1
                if i:
                    times.append((time.perf_counter() - t0) * 1e3)
            results[B] = {"ms_per_batch": times,
                          "img_per_s": [B * 1e3 / t for t in times]}
        counts = read_launches()               # main path ends here
        if counts["greedy_nms"] != calls:
            raise AssertionError(f"{name}: greedy_nms launched "
                                 f"{counts['greedy_nms']} times in {calls} "
                                 f"batches")
        rows = (5 if name == "YOLOv2" else 3) * sum(
            (YOLO_IMG // s) ** 2 for s in YOLO_DECODE[name][1])
        for B, res in last.items():
            if res.boxes.shape != (B, min(TOP_K, rows), 4) \
                    or not res.boxes.is_cuda \
                    or not torch.isfinite(res.boxes).all():
                raise AssertionError(f"{name} serving boxes at B={B}: wrong "
                                     f"shape, device or non-finite")
        gflop = forward_flops(model, YOLO_IMG) / 1e9
        for B, r in results.items():
            emit({"phase": "yolo_serving", "card": card, "model": name,
                  "img": YOLO_IMG, "classes": NUM_CLASSES,
                  "dtype": "bfloat16", "B": B, **r,
                  "forward_gflop_per_img": gflop,
                  "valid": int(last[B].valid.sum()), "launches": counts,
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        out[name] = counts["greedy_nms"]
        del step, model
        torch.cuda.empty_cache()
    return out


def phase_yolo_training(card: str) -> dict:
    """Each family at 416 px, 80 classes, bf16, Adam, B=32, M=32: uint8 ->
    /255 -> ``augment_batch`` (one warp launch) -> ``train_step``; one
    warm-up and three timed steps."""
    out = {}
    batch = [t.cuda() for t in train_batch(YOLO_TRAIN_B, seed=42,
                                           img=YOLO_IMG)]
    for name in YOLO_FAMILIES:
        state, step = trainer(torch.bfloat16, "cuda", name=name)
        gen = torch.Generator(device="cuda").manual_seed(43)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()                       # main path starts here
        calls, step_ms, loss = 0, [], []
        for i in range(4):                     # one warm-up, three timed
            t0 = time.perf_counter()
            state, metrics = augment_and_step(state, step, *batch, gen)
            torch.cuda.synchronize()
            calls += 1
            loss.append(metrics["loss"].item())
            if i:
                step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = read_launches()               # main path ends here
        if counts["affine_warp"] != calls:
            raise AssertionError(f"{name}: affine_warp launched "
                                 f"{counts['affine_warp']} times in {calls} "
                                 f"steps")
        if not all(math.isfinite(v) for v in loss):
            raise AssertionError(f"{name}: non-finite training loss {loss}")
        emit({"phase": "yolo_training", "card": card, "model": name,
              "img": YOLO_IMG, "classes": NUM_CLASSES, "dtype": "bfloat16",
              "B": YOLO_TRAIN_B, "M": TRAIN_M,
              "optimizer": "Adam lr 1e-3 wd 1e-5", "ms_per_step": step_ms,
              "img_per_s": [YOLO_TRAIN_B * 1e3 / t for t in step_ms],
              "loss": loss, "metrics": {k: float(v)
                                        for k, v in metrics.items()},
              "launches": counts,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        out[name] = counts["affine_warp"]
        del state, step
        torch.cuda.empty_cache()
    return out


# --- RetinaNet / SSD -----------------------------------------------------------


def anchor_postprocess_args(name: str, img: int, outputs):
    """(loc, cls, anchors, keywords) of ``anchor_candidates`` as
    ``make_postprocess`` calls it for the family."""
    loc, cls = outputs
    if name == "SSD":
        return loc, cls[..., 1:], anchor_lib.ssd_dboxes(), dict(
            scale=float(img))
    return loc, cls, anchor_lib.retina_anchors(img), dict(
        decode=box_ops.retina_decode)


def check_match(name: str, img: int, labels, boxes, mask) -> float:
    """The family's matching on the card against the CPU on the same
    targets: the integer fields equal, the offsets within
    ``ANCHOR_MATCH_TOL``.  Returns the largest offset difference."""
    out = []
    for dev in ("cuda", "cpu"):
        t = [x.to(dev) for x in (labels, boxes, mask)]
        if name == "SSD":
            dbox = torch.as_tensor(anchor_lib.ssd_dboxes(), device=dev)
            out.append(assignment.ssd_match(dbox, *t))
        else:
            anc = torch.as_tensor(anchor_lib.retina_anchors(img), device=dev)
            out.append(assignment.retina_match(anc, *t, img))
    card_m, cpu_m = out
    err = 0.0
    for field in card_m._fields:
        a, b = getattr(card_m, field).cpu(), getattr(cpu_m, field)
        if a.is_floating_point():
            torch.testing.assert_close(a, b, **ANCHOR_MATCH_TOL,
                                       msg=lambda m: f"{field}: {m}")
            err = max(err, float((a - b).abs().max()))
        elif not torch.equal(a, b):
            raise AssertionError(f"{name} matching: {field} differs in "
                                 f"{int((a != b).sum())} entries")
    return err


def phase_anchor_fp32(card: str) -> float:
    """RetinaNet-600 and SSD-300, 80 classes, B=2, f32 (TF32 off), card
    against CPU on the same seeded weights: head maps, the matching, the
    anchor NMS scan through the kernel and its plain version (``keep``
    identical, ``drop_lone_survivor`` off and on), one train step's loss
    and d(loss)/d(head maps).  Returns the largest NMS box difference."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = 0.0
    for name, img in ANCHOR_FAMILIES.items():
        images, labels, boxes, mask = train_batch(2, seed=50, img=img)
        x = images.float() / 255.0
        on_cpu = build_model(name, NUM_CLASSES, device="cpu", seed=0)
        on_card = build_model(name, NUM_CLASSES, device="cuda", seed=0)
        with torch.inference_mode():
            heads = on_card(x.cuda())
            ref = on_cpu(x)
        head_rel = [max_rel(h, r) for h, r in zip(heads, ref)]
        if not all(torch.isfinite(h).all() for h in heads) or max(
                head_rel) > ANCHOR_HEAD_REL:
            raise AssertionError(f"{name} head maps: card vs CPU {head_rel}")
        match_err = check_match(name, img, labels, boxes, mask)
        with torch.inference_mode():
            loc, cls, anchors, kw = anchor_postprocess_args(name, img, heads)
            c = nms.anchor_candidates(loc, cls, anchors, ANCHOR_TOP_K,
                                      ANCHOR_CLASS_THRESH, **kw)
            for drop in (False, True):
                worst = max(worst, check_kernel(
                    c.nms_inputs(), ANCHOR_NMS["class_aware"],
                    ANCHOR_NMS["merge"], ANCHOR_NMS["thresh"], drop))

        res = {}
        for dev, model in (("cuda", on_card), ("cpu", on_cpu)):
            maps = []
            state, step = trainer(torch.float32, dev, capture=maps,
                                  name=name, model=model, img=img)
            state, metrics = step(state, x.to(dev)[None],
                                  labels.to(dev)[None], boxes.to(dev)[None],
                                  mask.to(dev)[None])
            res[dev] = dict(loss=metrics["loss"].item(),
                            grads=[m.grad.float().cpu() for m in maps])
        loss_err = abs(res["cuda"]["loss"] / res["cpu"]["loss"] - 1)
        grad_rel = [max_rel(g, r) for g, r in zip(res["cuda"]["grads"],
                                                  res["cpu"]["grads"])]
        if loss_err > ANCHOR_TRAIN_TOL["loss_rtol"] or not all(
                torch.isfinite(g).all() for g in res["cuda"]["grads"]) \
                or max(grad_rel) > ANCHOR_TRAIN_TOL["head_grad_rel"]:
            raise AssertionError(f"{name} train step: loss {res['cuda']['loss']}"
                                 f" vs {res['cpu']['loss']}, d(loss)/d(maps) "
                                 f"{grad_rel}")
        emit({"phase": "anchor_fp32", "card": card, "model": name, "B": 2,
              "img": img, "head_max_rel_err": head_rel,
              "match_max_abs_err": match_err, "match_equal": True,
              "valid_candidates": int((c.scores > nms.NEG_INF).sum()),
              "keep_equal": True, "drop_lone_survivor": [False, True],
              "loss_card": res["cuda"]["loss"], "loss_cpu": res["cpu"]["loss"],
              "loss_rel_err": loss_err, "head_grad_rel_err": grad_rel,
              "tolerance": {"head_rel": ANCHOR_HEAD_REL, **ANCHOR_TRAIN_TOL,
                            "match": ANCHOR_MATCH_TOL}})
        del on_card, on_cpu, res, heads
        torch.cuda.empty_cache()
    return worst


def phase_anchor_serving(card: str) -> dict:
    """Each family's ``predict_step`` at its size, 80 classes, bf16, uint8
    with /255 folded: B=64 and B=1, one warm-up and three batches each, one
    NMS launch per batch; then the last B=64 batch's candidates through the
    kernel and its plain version.  Returns launches and the largest NMS
    box difference."""
    out, worst = {}, 0.0
    for name, img in ANCHOR_FAMILIES.items():
        step, model = serving_model(name, img)
        g = torch.Generator(device="cuda").manual_seed(51)
        batches = {B: torch.randint(0, 256, (B, img, img, 3), generator=g,
                                    dtype=torch.uint8, device="cuda")
                   for B in (ANCHOR_SERVE_B, 1)}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()                       # main path starts here
        calls, results, last = 0, {}, {}
        for B, images in batches.items():
            times = []
            for i in range(4):                 # one warm-up, three requests
                t0 = time.perf_counter()
                last[B] = step(images)
                torch.cuda.synchronize()
                calls += 1
                if i:
                    times.append((time.perf_counter() - t0) * 1e3)
            results[B] = {"ms_per_batch": times,
                          "img_per_s": [B * 1e3 / t for t in times]}
        counts = read_launches()               # main path ends here
        if counts["greedy_nms"] != calls:
            raise AssertionError(f"{name}: greedy_nms launched "
                                 f"{counts['greedy_nms']} times in {calls} "
                                 f"batches")
        for B, res in last.items():
            if res.boxes.shape != (B, ANCHOR_TOP_K, 4) \
                    or not res.boxes.is_cuda \
                    or not torch.isfinite(res.boxes).all():
                raise AssertionError(f"{name} serving boxes at B={B}: wrong "
                                     f"shape, device or non-finite")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        gflop = forward_flops(model, img) / 1e9
        for B, r in results.items():
            emit({"phase": "anchor_serving", "card": card, "model": name,
                  "img": img, "classes": NUM_CLASSES, "dtype": "bfloat16",
                  "B": B, **r, "forward_gflop_per_img": gflop,
                  "valid": int(last[B].valid.sum()), "launches": counts,
                  "peak_mem_gb": peak_gb})
        # the candidates of the last B=64 batch (bf16 scores: masked rows
        # hold -998244352 and count as valid in the f32 scan, as in JAX)
        with torch.inference_mode():
            loc, cls, anchors, kw = anchor_postprocess_args(
                name, img, model(batches[ANCHOR_SERVE_B]))
            c = nms.anchor_candidates(loc, cls, anchors, ANCHOR_TOP_K,
                                      ANCHOR_CLASS_THRESH, **kw)
            args = c.nms_inputs()
            for drop in (False, True):
                worst = max(worst, check_kernel(
                    args, False, False, ANCHOR_NMS["thresh"], drop))
        emit({"phase": "anchor_serving_check", "card": card, "model": name,
              "B": ANCHOR_SERVE_B, "keep_equal": True,
              "drop_lone_survivor": [False, True],
              "valid_candidates": int((c.scores > nms.NEG_INF).sum()),
              **kernel_ab.chain_length(args, nms_thresh=ANCHOR_NMS["thresh"],
                                       class_aware=False, merge=False)})
        out[name] = counts["greedy_nms"]
        del step, model, batches, last
        torch.cuda.empty_cache()
    return {"launches": out, "max_abs_err": worst}


def anchor_training_run(name: str, img: int, B: int) -> dict:
    """One warm-up and three timed augment + train steps of ``name`` at
    batch B; raises if the warp kernel is not launched once a step or the
    loss is not finite."""
    batch = [t.cuda() for t in train_batch(B, seed=52, img=img)]
    state, step = trainer(torch.bfloat16, "cuda", name=name, img=img)
    gen = torch.Generator(device="cuda").manual_seed(53)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()                           # main path starts here
    calls, step_ms, loss = 0, [], []
    for i in range(4):                         # one warm-up, three timed
        t0 = time.perf_counter()
        state, metrics = augment_and_step(state, step, *batch, gen)
        torch.cuda.synchronize()
        calls += 1
        loss.append(metrics["loss"].item())
        if i:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_launches()                   # main path ends here
    if counts["affine_warp"] != calls:
        raise AssertionError(f"{name}: affine_warp launched "
                             f"{counts['affine_warp']} times in {calls} "
                             f"steps")
    if not all(math.isfinite(v) for v in loss):
        raise AssertionError(f"{name}: non-finite training loss {loss}")
    return {"B": B, "ms_per_step": step_ms,
            "img_per_s": [B * 1e3 / t for t in step_ms], "loss": loss,
            "metrics": {k: float(v) for k, v in metrics.items()},
            "launches": counts,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_anchor_training(card: str) -> dict:
    """Each family at its size, 80 classes, bf16, Adam lr 1e-3 / wd 1e-5,
    B=32, M=32: uint8 -> /255 -> ``augment_batch`` (one warp launch) ->
    ``train_step``; one warm-up and three timed steps."""
    out = {}
    for name, img in ANCHOR_FAMILIES.items():
        r = anchor_training_run(name, img, ANCHOR_TRAIN_B)
        emit({"phase": "anchor_training", "card": card, "model": name,
              "img": img, "classes": NUM_CLASSES, "dtype": "bfloat16",
              "M": TRAIN_M, "optimizer": "Adam lr 1e-3 wd 1e-5", **r})
        out[name] = r["launches"]["affine_warp"]
        torch.cuda.empty_cache()
    return out


def epoch_rows(log_dir: str, cfg) -> list:
    """Per-epoch scalars from the run's ``metrics.jsonl``."""
    path = os.path.join(log_dir, cfg.data_module, cfg.model_name,
                        "metrics.jsonl")
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    epochs = {}
    for r in rows:
        if r["tag"] in ("time/epoch_seconds", "throughput/images_per_sec",
                        "Epoch/loss/Train", "val_loss"):
            epochs.setdefault(r["step"], {})[r["tag"]] = r["value"]
    train_steps = [r for r in rows if r["tag"] == "Loss/loss/Train"]
    if not train_steps or not all(math.isfinite(r["value"]) for r in rows):
        raise AssertionError("metrics.jsonl: no step losses, or a "
                             "non-finite value")
    return [{"epoch": e, "seconds": v["time/epoch_seconds"],
             "images_per_sec": v["throughput/images_per_sec"],
             "train_loss": v["Epoch/loss/Train"], "val_loss": v["val_loss"]}
            for e, v in sorted(epochs.items())]


def live_tensors(state) -> dict:
    """{name: (device type, host copy)} of every tensor the state holds: the
    model's parameters and buffers, the optimizer's per-parameter state, the
    EMA and the step, read from the objects themselves, not from the state
    dicts that a checkpoint is written from."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    out = {f"model.{n}": t for n, t in state.model.named_parameters()}
    out.update({f"model.{n}": t for n, t in state.model.named_buffers()})
    if state.optimizer is not None:
        for p, st in state.optimizer.state.items():
            out.update({f"opt.{names[id(p)]}.{k}": v for k, v in st.items()})
    if state.ema_params is not None:
        out.update({f"ema.{k}": v for k, v in state.ema_params.items()})
    out["step"] = state.step
    return {k: (v.device.type, v.detach().cpu().clone())
            for k, v in out.items()}


def check_restore(ckpt_dir: str, cfg, num_classes: int, device,
                  at_save: dict) -> dict:
    """Restore the best checkpoint into a fresh state on ``device``; every
    tensor must equal, bit for bit and on the same kind of device, what the
    Trainer held when it saved that step (``at_save[step]``)."""
    with open(os.path.join(ckpt_dir, "best_model_path.txt")) as f:
        best = f.read().strip()
    if not os.path.isfile(os.path.join(best, "state.pt")):
        raise AssertionError(f"no checkpoint at {best}")
    mgr = CheckpointManager(ckpt_dir, cfg.save_top_k)
    step = mgr.best_step()
    if os.path.basename(best) != str(step) or step not in at_save:
        raise AssertionError(f"best_model_path.txt names {best}, the "
                             f"manager step {step}, the Trainer saved "
                             f"{sorted(at_save)}")
    dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
             else torch.float32)
    model = build_model(cfg.model_name, num_classes, dtype=dtype,
                        yolov5_type=cfg.type, ssd_bn=cfg.ssd_bn,
                        device=device, seed=cfg.seed + 1)
    state = create_train_state(model, build_optimizer(cfg, model.parameters()),
                               ema_decay=cfg.ema_decay)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    if mgr.restore(state) is not state:
        raise AssertionError("restore found no checkpoint")
    got, want = live_tensors(state), at_save[step]
    if got.keys() != want.keys():
        raise AssertionError(f"restored state holds other tensors than the "
                             f"Trainer's: {sorted(got.keys() ^ want.keys())}")
    for k, (place, w) in want.items():
        if got[k][0] != place or not torch.equal(got[k][1], w):
            raise AssertionError(f"restore: {k} differs from the Trainer's "
                                 f"at step {step}, or lies on another device")
    moved = sum(not torch.equal(v, fresh[k])
                for k, v in model.state_dict().items())
    return {"best_step": step, "steps_on_disk": mgr.steps(),
            "tensors_bit_equal": len(want), "tensors_moved_from_init": moved,
            "step_count": int(state.step),
            "checkpoint_mb": os.path.getsize(os.path.join(best, "state.pt"))
            / 1e6}


def _median(xs: list) -> float:
    return sorted(xs)[len(xs) // 2]


def warm_ring(shape, dtype, slots: int = 2) -> PinnedRing:
    """A ring whose slots are allocated (pinned) for ``shape``, ``dtype``
    before anything is timed, its next slot the first."""
    ring = PinnedRing(slots, torch.device("cuda"))
    for _ in range(slots):
        ring.take(shape, dtype)
    return ring


def _upload_ms(ring, batch, reps: int = LOADER_REPS) -> float:
    """Host ms of ``ring.upload`` of a batch and a sync (median)."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ring.upload(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return _median(times)


def loader_split(loader) -> dict:
    """Host ms of one batch of the Loader's first indices (median of
    ``LOADER_REPS``): the two stages the Loader ran before, each alone
    (one ``decode_batch`` call at full scale, then the float32 resize), the
    fused ``decode_preproc_batch`` call the Loader runs now (at the DCT
    scale it picks), writing into a pinned ring buffer, and that batch's upload from the ring against the
    replaced upload (a copy into freshly pinned memory, then the copy to
    the card)."""
    recs = [loader.parser.record(int(i))
            for i in loader.indices[:loader.batch_size]]
    paths = [r[0] for r in recs]
    S, n = loader.img_size, len(paths)
    ring = warm_ring((n, S, S, 3), np.float32)
    times = {"decode": [], "resize": [], "fused": [], "pin_copy": []}
    for _ in range(LOADER_REPS):
        t0 = time.perf_counter()
        images = native.decode_batch(paths)
        t1 = time.perf_counter()
        native.preproc_batch(images, S, loader.letterbox)
        out = ring.take((n, S, S, 3), np.float32)
        t2 = time.perf_counter()
        native.decode_preproc_batch(paths, S, loader.letterbox, out,
                                    max_denom=native.MAX_DENOM)
        t3 = time.perf_counter()
        times["decode"].append((t1 - t0) * 1e3)
        times["resize"].append((t2 - t1) * 1e3)
        times["fused"].append((t3 - t2) * 1e3)
    plain = np.array(out)
    torch.from_numpy(plain).pin_memory().to("cuda")           # warm
    for _ in range(LOADER_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.from_numpy(plain).pin_memory().to("cuda", non_blocking=True)
        torch.cuda.synchronize()
        times["pin_copy"].append((time.perf_counter() - t0) * 1e3)
    zeros = [np.zeros((n, loader.max_boxes), np.int32),
             np.zeros((n, loader.max_boxes, 4), np.float32),
             np.zeros((n, loader.max_boxes), bool)]
    upload = _upload_ms(ring, Batch(out, *zeros))
    pixels = sum(im.shape[0] * im.shape[1] for im in images)
    med = {k: _median(v) for k, v in times.items()}
    return {"batch": n, "threads": min(n, os.cpu_count() or 1),
            "cpu_count": os.cpu_count(),
            "mp_per_image": pixels / 1e6 / n,
            "decode_ms_per_batch": med["decode"],
            "resize_ms_per_batch": med["resize"],
            "fused_ms_per_batch": med["fused"],
            "decode_mp_per_s": pixels / 1e6 / (med["decode"] / 1e3),
            "host_img_per_s_two_stage": n / ((med["decode"] + med["resize"])
                                             / 1e3),
            "host_img_per_s_fused": n / (med["fused"] / 1e3),
            "batch_mb": out.nbytes / 1e6,
            "upload_ms_pinned_ring": upload,
            "upload_ms_pin_copy": med["pin_copy"]}


def cache_split(loader) -> dict:
    """Host ms of one cached batch of the Loader's first indices (median of
    ``LOADER_REPS``): the gather of uint8 rows from the packed cache into a
    pinned ring buffer, and its upload from the ring."""
    idx = loader.indices[:loader.batch_size]
    S, n = loader.img_size, len(idx)
    ring = warm_ring((n, S, S, 3), np.uint8)
    times = []
    for _ in range(LOADER_REPS):
        out = ring.take((n, S, S, 3), np.uint8)
        t0 = time.perf_counter()
        batch = loader.cache.batch(idx, loader.max_boxes, out)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"batch": n, "batch_mb": batch.images.nbytes / 1e6,
            "gather_ms_per_batch": _median(times),
            "host_img_per_s_gather": n / (_median(times) / 1e3),
            "upload_ms_pinned_ring": _upload_ms(ring, batch)}


class UnwaitedRing(PinnedRing):
    """A planted fault: a ring whose ``take`` hands out a slot without
    waiting for the copy that reads it."""

    def take(self, shape, dtype):
        k = self.next
        self.next = (k + 1) % len(self.buffers)
        self.events[k] = None
        return self._view(k, "images", shape, dtype)


def check_ring(make_loader, n_batches: int = RING_BATCHES,
               ring_cls=PinnedRing) -> dict:
    """The Trainer's pinned ring on the card: ``n_batches`` batches that a
    Loader writes into a ring of the Trainer's size and that are uploaded
    from it, their copies held back behind a ``RING_SPIN_MS`` spin, so
    that the Loader must wait for a slot's copy before it writes the slot
    again: the loop must last the spin, and each batch on the card must
    equal, byte for byte, the same batch made by a fresh Loader into
    arrays of its own.  A first pass through the ring allocates its slots,
    so that no allocation outlasts the spin."""
    cfg = Config()
    ring = ring_cls(cfg.prefetch_batches + 2, torch.device("cuda"))
    if n_batches <= len(ring.buffers):
        raise AssertionError("the check must reuse the ring's slots")
    for _, b in zip(range(len(ring.buffers)), make_loader().batches(
            ring.take)):
        ring.upload(b)
    ring.next = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda._sleep(int(RING_SPIN_MS * timing.SPIN_CYCLES_PER_MS))
    on_card = [ring.upload(b) for _, b in zip(range(n_batches),
                                               make_loader().batches(
                                                   ring.take))]
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    want = [b for _, b in zip(range(n_batches), make_loader())]
    if len(want) != n_batches or len(on_card) != n_batches:
        raise AssertionError(f"the Loader gave {len(want)} batches")
    for i, (got, w) in enumerate(zip(on_card, want)):
        for name, g, a in zip(Batch._fields, got, w):
            if g.cpu().numpy().tobytes() != np.ascontiguousarray(a).tobytes():
                raise AssertionError(f"batch {i}'s {name} on the card "
                                     f"differs from the Loader's")
    if host_ms < RING_SPIN_MS:
        raise AssertionError(f"the Loader wrote {n_batches} batches into "
                             f"{len(ring.buffers)} slots in {host_ms:.1f} "
                             f"ms, within the {RING_SPIN_MS} ms spin that "
                             f"holds their copies: it did not wait")
    return {"batches": n_batches, "slots": len(ring.buffers),
            "images_dtype": str(want[0].images.dtype),
            "bytes_equal": sum(a.nbytes for w in want for a in w),
            "spin_ms": RING_SPIN_MS, "host_loop_ms": host_ms}


def phase_trainer(card: str, sets: dict = TRAINER_SETS,
                  phase: str = "trainer", after=None, on_init=None) -> dict:
    """The CLI's fit -> validate -> checkpoint -> test on the card, on the
    YAML with ``sets`` as ``--set`` overrides; YOLOv2/v3/v4 runs must also
    report the per-grid statistics.  ``after(argv)``, when given, runs
    while the run's log_dir (and its checkpoints) still exist;
    ``on_init(trainer)`` right after the CLI's Trainer is made."""
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{phase}_",
                                     dir=build) as log_dir:
        argv = [str(REPO / "configs" / "config.yaml"), "--set", "log_dir",
                log_dir]
        for k, v in sets.items():
            argv += ["--set", k, v]
        cfg = load_config(argv[0], {k: cli_run._coerce(v) for k, v in
                                    zip(argv[2::3], argv[3::3])})
        # counted without the cache, which the run itself must build
        dm = build_datamodule(dataclasses.replace(cfg, cache_dir=""))
        microbatches = cfg.max_epochs * len(dm.train_dataloader())
        resize_path = dm.train_dataloader().resize_path
        split = (loader_split(dm.train_dataloader())
                 if dm.train_dataloader().decode_path == "fused" else None)
        dm.setup("test")                  # as the CLI does before its test
        test_batches = len(dm.test_dataloader())
        build_error = native.build_error
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        at_save, kept = {}, []

        class KeptTrainer(cli_run.Trainer):
            """The CLI's Trainer, its state copied at every checkpoint save
            for the restore check."""

            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                kept.append(self)
                if on_init is not None:
                    on_init(self)
                save = self.ckpt.save

                def save_and_copy(step, state, val_loss):
                    at_save[step] = live_tensors(state)
                    return save(step, state, val_loss)
                self.ckpt.save = save_and_copy

            def _device_batch(self, batch, augment):
                augmented[0] += bool(augment)
                return super()._device_batch(batch, augment)

        augmented = [0]
        tuner = {} if cfg.tune else None
        trainer_cls, cli_run.Trainer = cli_run.Trainer, KeptTrainer
        try:
            with recorded_tuner(tuner):
                reset_launches()               # main path starts here
                t0 = time.perf_counter()
                results = cli_run.main(argv)
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
                counts = read_launches()       # main path ends here
        finally:
            cli_run.Trainer = trainer_cls
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        decode_path = kept[0].dm.train_dataloader().decode_path
        if kept[0].ring is None or len(kept[0].ring.buffers) != \
                cfg.prefetch_batches + 2:
            raise AssertionError("the Trainer has no pinned ring of "
                                 "prefetch_batches + 2 slots")
        # the tuner's LR sweep augments microbatches of its own
        if augmented[0] != microbatches and not cfg.tune:
            raise AssertionError(f"{augmented[0]} microbatches augmented "
                                 f"for {microbatches} training microbatches")
        if counts["affine_warp"] != augmented[0] or \
                augmented[0] < microbatches:
            raise AssertionError(f"affine_warp launched "
                                 f"{counts['affine_warp']} times for "
                                 f"{augmented[0]} augmented microbatches "
                                 f"({microbatches} of the fit)")
        if counts["greedy_nms"] != test_batches:
            raise AssertionError(f"greedy_nms launched "
                                 f"{counts['greedy_nms']} times for "
                                 f"{test_batches} test batches")
        table = [results[k] for k in ("mAP", "precision", "recall", "f1")]
        table += list(results["per_class_AP"].values())
        if not results["per_class_AP"] or not all(
                math.isfinite(v) and 0.0 <= v <= 1.0 for v in table):
            raise AssertionError(f"test results not a finite mAP table: "
                                 f"{results}")
        if cfg.model_name in YOLO_FAMILIES:
            grids = [cfg.effective_img_size // s
                     for s in YOLO_DECODE[cfg.model_name][1]]
            stats = {f"{g}/{k}": results.get(f"{g}/{k}") for g in grids
                     for k in YOLO_STATS}
            if not all(v is not None and math.isfinite(v)
                       for v in stats.values()):
                raise AssertionError(f"per-grid statistics missing or "
                                     f"non-finite: {stats}")
        epochs = epoch_rows(log_dir, cfg)
        if len(epochs) != cfg.max_epochs:
            raise AssertionError(f"{len(epochs)} epochs logged")
        restore = check_restore(os.path.join(
            log_dir, cfg.data_module, cfg.model_name, "checkpoints"), cfg,
            len(dm.get_class()), kept[0].device, at_save)
        extra = after(argv) if after is not None else None
    emit({"phase": phase, "card": card, "model": cfg.model_name,
          "img": cfg.effective_img_size, "sets": sets,
          "wall_s": wall_s, "epochs": epochs, "microbatches": microbatches,
          "test_batches": test_batches, "augmented": augmented[0],
          "launches": counts, "tuner": tuner,
          "resize_path": resize_path, "decode_path": decode_path,
          "loader_split": split, "native_build_error": build_error,
          "peak_mem_gb": peak_gb,
          "results": results, "restore": restore})
    return {"launches": counts, "after": extra, "decode_path": decode_path,
            "tuner": tuner, "epochs": epochs, "restore": restore}


@contextlib.contextmanager
def recorded_tuner(tuner):
    """While active, and when ``tuner`` is a dict: the tuner's two entry
    points record their suggestions, seconds and the batch sizes tried
    with each peak into ``tuner``."""
    if tuner is None:
        yield
        return
    find, scale = tune.auto_lr_find, tune.auto_scale_batch_size
    probe = tune.probe_batch_size

    def auto_lr_find(trainer, *args, **kwargs):
        t0 = time.perf_counter()
        tuner["lr"] = find(trainer, *args, **kwargs)
        tuner["lr_find_s"] = time.perf_counter() - t0
        return tuner["lr"]

    def auto_scale_batch_size(trainer, *args, **kwargs):
        tuner["trials"] = []
        t0 = time.perf_counter()
        tuner["batch_size"] = scale(trainer, *args, **kwargs)
        tuner["scale_s"] = time.perf_counter() - t0
        tuner["budget_gb"] = 0.9 * tune._device_bytes_limit(
            trainer.device) / 1e9
        for trial in tuner["trials"]:
            trial["fits"] = (trial["peak_gb"] is not None
                             and trial["peak_gb"] <= tuner["budget_gb"])
        return tuner["batch_size"]

    def probe_batch_size(trainer, bs):
        peak = probe(trainer, bs)
        tuner["trials"].append({"batch_size": bs, "peak_gb":
                                None if peak is None else peak / 1e9})
        return peak

    tune.auto_lr_find = auto_lr_find
    tune.auto_scale_batch_size = auto_scale_batch_size
    tune.probe_batch_size = probe_batch_size
    try:
        yield
    finally:
        tune.auto_lr_find, tune.auto_scale_batch_size = find, scale
        tune.probe_batch_size = probe


# --- the JPEG decoder and the real datasets ---------------------------------


def phase_jpeg_check(card: str) -> None:
    """Build the decoder with g++, hold every decodable fixture's decode
    (and the 1280x720 frames' at 1/2, 1/4 and 1/8) against its committed
    libjpeg hash, check that the CMYK fixture raises naming its path on
    the fused (libjpeg RGB) route and decodes on cv2's, and
    time ``decode_batch`` on the fixtures x ``JPEG_REPEAT`` and on each
    frame at each scale, at 1 thread and at the Loader's thread count."""
    t0 = time.perf_counter()
    if not native.available():
        emit({"phase": "jpeg_check", "build_error": native.build_error})
        raise AssertionError(f"the JPEG decoder did not build: "
                             f"{native.build_error}")
    build_s = time.perf_counter() - t0
    want = fixture_trees.fixtures()
    names = fixture_trees.decodable()
    checked = 0
    for name in names:
        path = str(fixture_trees.TESTDATA / name)
        for denom, entry in [("1", want[name]),
                             *want[name].get("scaled", {}).items()]:
            img = native.decode_one(path, int(denom))
            digest = hashlib.sha256(img.tobytes()).hexdigest()
            if list(img.shape) != entry["shape"] or \
                    digest != entry["sha256"]:
                raise AssertionError(f"{name} at 1/{denom}: decode differs "
                                     f"from libjpeg's (shape {img.shape})")
            checked += 1
    for name in fixture_trees.BDD_FRAMES:
        if sorted(want[name].get("scaled", {})) != ["2", "4", "8"]:
            raise AssertionError(f"{name}: no hashes at 1/2, 1/4, 1/8")
    for name in fixture_trees.UNSUPPORTED:
        path = str(fixture_trees.TESTDATA / name)
        try:
            native.decode_one(path)
        except native.JpegError as e:
            if not str(e).startswith(path):
                raise AssertionError(f"the error does not name {path}: {e}")
            refused = str(e)
        else:
            raise AssertionError(f"{name} decoded; it must raise")
        if native.decode_image(path).shape[2] != 3:
            raise AssertionError(f"{name}: not read as cv2.imread reads it")
    paths = [str(fixture_trees.TESTDATA / n) for n in names] * JPEG_REPEAT
    pixels = sum(want[n]["shape"][0] * want[n]["shape"][1]
                 for n in names) * JPEG_REPEAT
    thread_counts = sorted({1, min(len(paths), os.cpu_count() or 1)})
    timing = {}
    for threads in thread_counts:
        native.decode_batch(paths[:len(names)], threads=threads)   # warm
        t0 = time.perf_counter()
        native.decode_batch(paths, threads=threads)
        dt = time.perf_counter() - t0
        timing[f"threads_{threads}"] = {
            "ms_per_image": dt * 1e3 / len(paths),
            "mp_per_s": pixels / 1e6 / dt}
    per_file = {}
    for name in names:
        path = str(fixture_trees.TESTDATA / name)
        t0 = time.perf_counter()
        for _ in range(JPEG_REPEAT):
            native.decode_one(path)
        per_file[name] = (time.perf_counter() - t0) * 1e3 / JPEG_REPEAT
    frames = [decode_bench.time_decode(
        str(fixture_trees.TESTDATA / name), denom, threads, JPEG_REPEAT)
        for name in fixture_trees.BDD_FRAMES for denom in native.DENOMS
        for threads in thread_counts]
    emit({"phase": "jpeg_check", "card": card, "build_s": build_s,
          "library": native.library_path().name,
          "hashes_equal": checked, "refused": refused,
          "images": len(paths), "megapixels": pixels / 1e6,
          "cpu_count": os.cpu_count(), "decode_batch": timing,
          "decode_one_ms": per_file, "frames_ms_per_image": frames})
    check_header_cases(card)


def check_header_cases(card: str) -> None:
    """The damaged headers of ``format_files.header_cases``: each decode
    equal to cv2's committed hash, or refused where cv2 refuses; the fused
    route reading exactly the cases the JAX library read."""
    want = json.loads(format_files.HEADER_HASHES.read_text())
    read = fused = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_headers_",
                                     dir=REPO / "build") as tmp:
        for case, path in format_files.write_header_cases(tmp).items():
            rec = want[case]
            try:
                img = native.decode_image(path)
            except native.ImageError:
                img = None
            if (img is None) != (rec["sha256"] is None) or (
                    img is not None and (list(img.shape) != rec["shape"] or
                                         hashlib.sha256(img.tobytes())
                                         .hexdigest() != rec["sha256"])):
                raise AssertionError(f"header case {case}: decode differs "
                                     f"from cv2's")
            code = native.decode_preproc_codes([path], 64, False)[-1][0]
            if (code == native.JPEG_OK) != rec["fused"]:
                raise AssertionError(f"header case {case}: fused route "
                                     f"{code}, the JAX library's "
                                     f"{rec['fused']}")
            read += img is not None
            fused += rec["fused"]
    emit({"phase": "jpeg_headers", "card": card, "cases": len(want),
          "read_as_cv2": read, "fused_read": fused,
          "refused_as_cv2": len(want) - read,
          "reduced_idct": check_idct_case()})


def check_idct_case() -> dict:
    """``format_files.idct_case`` (huge coefficients through the reduced
    IDCTs) at 1/1, 1/2, 1/4 and 1/8 on both routes' decoders -- cv2's
    (imread) and the fused call's (libjpeg 2.1's rules) -- each equal to
    cv2's recorded hash at that scale, and the fused call reading it at
    the denominators 1, 2, 4 and 8."""
    want = json.loads(format_files.IDCT_HASHES.read_text())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_idct_",
                                     dir=REPO / "build") as tmp:
        path = os.path.join(tmp, "luma_chroma_tables.jpg")
        with open(path, "wb") as f:
            f.write(format_files.idct_case())
        for denom, rec in want.items():
            for imread in (True, False):
                img = native.decode_one(path, int(denom), imread=imread)
                if list(img.shape) != rec["shape"] or hashlib.sha256(
                        img.tobytes()).hexdigest() != rec["sha256"]:
                    route = "imread" if imread else "fused"
                    raise AssertionError(f"idct case at 1/{denom} ({route} "
                                         f"route): decode differs from cv2's")
        # targets at which the fused call picks 1/8, 1/4, 1/2 and 1/1 of
        # the 640x480 frame (the JAX library's rule)
        fused = {}
        for size in (60, 120, 240, 480):
            code = native.decode_preproc_codes(
                [path], size, False, max_denom=native.MAX_DENOM)[-1][0]
            if code != native.JPEG_OK:
                raise AssertionError(f"idct case: the fused call refused it "
                                     f"at {size} px")
            fused[size] = int(code)
    return {"scales": sorted(want, key=int), "fused_sizes": sorted(fused)}


def phase_formats(card: str) -> dict:
    """Every kind of ``tools/format_files.py`` decoded against cv2's
    recorded hash and timed on the host; the fit on a VOC tree of them
    (``FORMATS_TREE``) with its Loader's route counts, and ``cli.predict``
    over one file of each kind inside it."""
    want = json.loads(format_files.HASHES.read_text())
    counted = {"fused": 0, "parser": 0}
    fused = pipeline.Loader._fused

    def counting(self, idx, out):
        res = fused(self, idx, out)
        counted["fused" if res is not None else "parser"] += 1
        return res

    with tempfile.TemporaryDirectory(prefix="chip_smoke_formats_",
                                     dir=REPO / "build") as tmp:
        paths = format_files.write_format_files(tmp)
        decode = {}
        for kind, path in paths.items():
            img = native.decode_image(path)
            digest = hashlib.sha256(img.tobytes()).hexdigest()
            if list(img.shape) != want[kind]["shape"] or \
                    digest != want[kind]["sha256"]:
                raise AssertionError(f"formats {kind}: decode differs from "
                                     f"cv2's (shape {img.shape})")
            times = []
            for _ in range(FORMATS_DECODE_REPS):
                t0 = time.perf_counter()
                native.decode_image(path)
                times.append((time.perf_counter() - t0) * 1e3)
            code = native.decode_preproc_codes([path], 416, False,
                                               max_denom=native.MAX_DENOM)[-1]
            decode[kind] = {"shape": list(img.shape), "ms": _median(times),
                            "fused_route": bool(code[0] == native.JPEG_OK)}
        emit({"phase": "formats_decode", "card": card,
              "cpu_count": os.cpu_count(), "decode": decode})
        emit({"phase": "formats_avif", "card": card,    # host ms an image
              "ms": {k: decode[k]["ms"] for k in format_files.AVIF_KINDS},
              "shapes": {k: decode[k]["shape"]
                         for k in format_files.AVIF_KINDS}})
        n_train = FORMATS_TREE["n_train"]
        tree = {**FORMATS_TREE,
                "files": [paths["jpeg"]] * n_train + list(paths.values())}
        served = {}
        pipeline.Loader._fused = counting
        try:
            fit = phase_trainer_real(card, "formats_fit", TRAINER_VOC_SETS,
                                     tree, formats_predict(card, paths,
                                                           served))
        finally:
            pipeline.Loader._fused = fused
    if not counted["fused"] or not counted["parser"]:
        raise AssertionError(f"formats_fit: the Loader's batches took one "
                             f"route only: {counted}")
    emit({"phase": "formats", "card": card, "kinds": len(paths),
          "loader_batches": counted, "launches": fit["launches"],
          "predict": served})
    return {"fit": fit, "predict": served["launches"], "batches": counted}


def formats_predict(card: str, paths: dict, out: dict):
    """``after`` for ``formats_fit``: ``cli.predict.main`` on the run's
    checkpoint over one file of each kind: one JSON line and one NMS
    launch per image."""
    def after(argv):
        images = list(paths.values())
        stdout = io.StringIO()
        reset_launches()                       # main path starts here
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            records = cli_predict.main([*argv, "--images", *images])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        counts = read_launches()               # main path ends here
        lines = [json.loads(x) for x in stdout.getvalue().splitlines()
                 if x.startswith("{")]
        if lines != records or [r["image"] for r in records] != images:
            raise AssertionError("formats predict: not one JSON line per "
                                 "image")
        if counts["greedy_nms"] != len(images):
            raise AssertionError(f"formats predict: greedy_nms launched "
                                 f"{counts['greedy_nms']} times for "
                                 f"{len(images)} images")
        out.update({"images": len(images), "wall_s": wall_s,
                    "launches": counts,
                    "detections": {k: len(r["labels"]) for k, r in
                                   zip(paths, records)}})
    return after


EXIF_FIXTURE = "voc_420_q75_500x375.jpg"   # served turned by Orientation 6


def exif6_copy(path: str, name: str = EXIF_FIXTURE) -> np.ndarray:
    """Writes the fixture ``name`` to ``path`` with an APP1 Exif segment
    after its SOI whose IFD0 holds Orientation 6 (little-endian TIFF);
    returns the image cv2.imread gives for it: the fixture's pixels turned
    90 degrees clockwise."""
    tiff = b"II*\0" + (8).to_bytes(4, "little") + (1).to_bytes(2, "little")
    tiff += bytes.fromhex("1201 0300 01000000 0600 0000") + bytes(4)
    seg = b"Exif\0\0" + tiff
    raw = (fixture_trees.TESTDATA / name).read_bytes()
    with open(path, "wb") as f:
        f.write(raw[:2] + b"\xff\xe1" + (len(seg) + 2).to_bytes(2, "big")
                + seg + raw[2:])
    img = native.decode_one(str(fixture_trees.TESTDATA / name))
    return np.ascontiguousarray(img.transpose(1, 0, 2)[:, ::-1])


def check_exif_served(trainer, path: str, turned: np.ndarray, record: dict,
                      panel: np.ndarray) -> dict:
    """The CLI's record and panel for the Orientation-6 file are those of
    its turned image: ``load_image_rgb`` gives the turned pixels, and
    ``predict_step`` on their resized input gives the record and the
    panel the CLI gave, bit for bit; the unturned input differs."""
    if not np.array_equal(cli_predict.load_image_rgb(path), turned):
        raise AssertionError("load_image_rgb did not turn the EXIF-6 file")
    S = trainer.img_size
    x = cli_predict.resize_input(turned, S)
    unturned = cli_predict.resize_input(
        np.ascontiguousarray(turned[:, ::-1].transpose(1, 0, 2)), S)
    if np.array_equal(x, unturned):
        raise AssertionError("the turned and unturned inputs are equal")
    res = trainer.predict_step(trainer.state,
                               torch.from_numpy(x).to(trainer.device))
    boxes, scores, labels, valid = (a[0] for a in _to_host(
        (res.boxes, res.scores, res.labels, res.valid)))
    want = {"image": path, "boxes_xyxy": boxes[valid].round(2).tolist(),
            "scores": scores[valid].round(4).tolist(),
            "labels": [trainer.classes[int(c)] for c in labels[valid]]}
    if record != want:
        raise AssertionError(f"the EXIF-6 record {record} is not the "
                             f"turned image's {want}")
    if not np.array_equal(panel, viz.draw_boxes(x[0], boxes, labels,
                                                valid=valid)):
        raise AssertionError("the EXIF-6 panel is not the turned image's")
    return {"shape": list(turned.shape), "detections": len(want["labels"])}


def predict_after(card: str, out: dict):
    """``after`` for ``trainer_voc``: ``cli.predict.main`` on the run's
    best checkpoint over the decodable fixtures and a copy of one with EXIF
    Orientation 6 (``check_exif_served``) with ``--out-dir``: one JSON line
    and one NMS launch per image, a PNG of the model's input size per
    image; ms per image of ``predict_images`` in the call (the first image
    includes the warm-up) and again on the warm Trainer."""
    def after(argv):
        calls, panels = {}, {}
        predict_images = cli_predict.predict_images
        write_png = viz.write_png

        def kept_png(path, image):
            panels[os.path.basename(path)] = image.copy()
            write_png(path, image)

        def timed(trainer, images, on_image=None):
            calls["trainer"] = trainer
            t0 = time.perf_counter()
            res = predict_images(trainer, images, on_image)
            calls["ms"] = (time.perf_counter() - t0) * 1e3
            return res

        build = REPO / "build"
        with tempfile.TemporaryDirectory(prefix="chip_smoke_predict_",
                                         dir=build) as out_dir:
            exif_path = os.path.join(out_dir, "exif6_voc.jpg")
            turned = exif6_copy(exif_path)
            paths = [str(fixture_trees.TESTDATA / n)
                     for n in fixture_trees.decodable()] + [exif_path]
            stdout = io.StringIO()
            cli_predict.predict_images = timed
            viz.write_png = kept_png
            try:
                reset_launches()               # main path starts here
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(stdout):
                    records = cli_predict.main(
                        [*argv, "--images", *paths, "--out-dir", out_dir])
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
                counts = read_launches()       # main path ends here
            finally:
                cli_predict.predict_images = predict_images
                viz.write_png = write_png
            lines = [json.loads(x) for x in stdout.getvalue().splitlines()
                     if x.startswith("{")]
            if lines != records or [r["image"] for r in lines] != paths:
                raise AssertionError("predict printed other lines than one "
                                     "JSON record per image")
            if counts["greedy_nms"] != len(paths):
                raise AssertionError(f"greedy_nms launched "
                                     f"{counts['greedy_nms']} times for "
                                     f"{len(paths)} images")
            if "restored best checkpoint" not in stdout.getvalue():
                raise AssertionError("predict did not restore the "
                                     "checkpoint")
            S = calls["trainer"].img_size
            for p in paths:
                stem = os.path.splitext(os.path.basename(p))[0]
                with open(os.path.join(out_dir, f"{stem}_pred.png"),
                          "rb") as f:
                    head = f.read(24)
                if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != \
                        b"IHDR" or (int.from_bytes(head[16:20], "big"),
                                    int.from_bytes(head[20:24], "big")) != (
                                        S, S):
                    raise AssertionError(f"{stem}_pred.png: not an "
                                         f"{S}x{S} PNG")
            exif = check_exif_served(calls["trainer"], exif_path, turned,
                                     records[-1],
                                     panels["exif6_voc_pred.png"])
        t0 = time.perf_counter()
        predict_images(calls["trainer"], paths[:-1])
        warm_ms = (time.perf_counter() - t0) * 1e3 / (len(paths) - 1)
        out.update({"launches": counts,
                    "export": predict_export(card, argv, calls["trainer"],
                                             paths[0])})
        emit({"phase": "predict_cli", "card": card, "images": len(paths),
              "img": S, "wall_s": wall_s, "launches": counts,
              "ms_per_image_in_call": calls["ms"] / len(paths),
              "ms_per_image_warm": warm_ms,
              "detections": sum(len(r["labels"]) for r in records),
              "pngs": len(paths), "exif6": exif})
    return after


def predict_export(card: str, argv: list, trainer, image_path: str) -> dict:
    """``cli.predict.main`` with ``--export`` and no images on the same
    checkpoint: it must print its line and return; the loaded program on
    one fixture (resized, as uint8) launches the NMS kernel once and
    detects as the module made from the restored Trainer's evaluation
    weights."""
    S = trainer.img_size
    with tempfile.TemporaryDirectory(prefix="chip_smoke_predict_export_",
                                     dir=REPO / "build") as tmp:
        path = os.path.join(tmp, "model.pt2")
        stdout = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            records = cli_predict.main([*argv, "--export", path])
        export_s = time.perf_counter() - t0
        if records != [] or stdout.getvalue().strip().splitlines()[-1] != (
                f"[predict] exported serving graph to {path}"):
            raise AssertionError(f"predict --export: {stdout.getvalue()!r}")
        x = cli_predict.resize_input(
            cli_predict.load_image_rgb(image_path), S)
        images = torch.from_numpy(
            np.round(x * 255.0).astype(np.uint8)).cuda()
        fn = export_lib.build_inference_fn(
            trainer.model, {**trainer.model.state_dict(),
                            **trainer.state.eval_params},
            trainer.postprocess)
        loaded = export_lib.load(path)
        with torch.inference_mode():
            want = fn(images)
            torch.cuda.synchronize()
            reset_launches()                   # main path starts here
            got = loaded(images)
            torch.cuda.synchronize()
            counts = read_launches()           # main path ends here
        err = same_detections("predict --export", got, want)
        if counts["greedy_nms"] != 1:
            raise AssertionError(f"predict --export: {counts}")
        row = {"phase": "predict_export", "card": card,
               "model": trainer.cfg.model_name, "img": S, "fold": fn.fold,
               "export_s": export_s, "pt2_mb": os.path.getsize(path) / 1e6,
               "max_abs_box_err": err, "valid": int(got[4].sum()),
               "launches": counts}
    emit(row)
    return row


TREE_WRITERS = {"VOC": fixture_trees.write_voc_tree,
                "COCO": fixture_trees.write_coco_tree,
                "BDD100K": fixture_trees.write_bdd100k_tree,
                "WiderPerson": fixture_trees.write_widerperson_tree}


def phase_trainer_real(card: str, name: str, sets: dict, tree: dict,
                       after=None, cache: bool = False) -> dict:
    """``phase_trainer`` on a tree of the fixture JPEGs written under
    ``build/``: the Loader must decode with the port's decoder, one fused
    ``decode_preproc_batch`` call a batch, or, with ``cache``, gather from
    the packed caches that the run builds under the tree's directory."""
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_tree_",
                                     dir=REPO / "build") as root:
        t0 = time.perf_counter()
        TREE_WRITERS[sets["data_module"]](root, **tree)
        emit({"phase": name, "tree": {k: len(v) if k == "files" else v
                                      for k, v in tree.items()},
              "root": "build/" +
              os.path.basename(root), "write_s": time.perf_counter() - t0})
        sets = {**sets, "data_root": root}
        if cache:
            sets["cache_dir"] = os.path.join(root, "cache")
        out = phase_trainer(card, sets, name, after)
    want = "cache" if cache else "fused"
    if out["decode_path"] != want:
        raise AssertionError(f"{name}: the Loader read its batches through "
                             f"{out['decode_path']!r}, not {want!r}")
    return out


def cache_after(card: str, builds: list):
    """``after`` for ``trainer_coco_cache``, on the caches the run built:
    the cache builds' images per second and ``cache_split`` of the train
    loader; then ``check_ring`` on the cached (uint8) and on the fused
    (float32) batches of a COCO tree of every decodable fixture (the run's
    tree holds one image, so a batch written into the wrong slot would
    show only in its targets)."""
    def after(argv):
        cfg = load_config(argv[0], {k: cli_run._coerce(v) for k, v in
                                    zip(argv[2::3], argv[3::3])})
        dm = build_datamodule(cfg)
        S = cfg.effective_img_size
        first = {}                      # each cache's first build call
        for b in builds:
            first.setdefault(b["cache"], b)
        if sorted(first) != [f"{dm.name}_{role}_{S}px" for role in
                             ("test", "train", "val")] or any(
                                 b["was_valid"] for b in first.values()):
            raise AssertionError(f"the run did not build its three "
                                 f"caches: {builds}")
        built = list(first.values())
        split = cache_split(dm.train_dataloader())
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ring_",
                                         dir=REPO / "build") as root:
            n = RING_BATCHES * cfg.batch_size
            fixture_trees.write_coco_tree(root, n_train=n, n_val=0, seed=5)
            parser = COCOParser(root, "2017", "train")
            cache_dir = cache_lib.build_packed_cache(
                parser, S, os.path.join(root, "cache"))

            def loader(cache_dir=None):
                return pipeline.Loader(parser, S, cfg.batch_size,
                                       cfg.max_boxes, shuffle=True,
                                       seed=cfg.seed, cache_dir=cache_dir)
            makers = {"cache": lambda: loader(cache_dir), "fused": loader}
            rings = {name: check_ring(make) for name, make in makers.items()}
            for name, make in makers.items():   # the check must catch it
                try:
                    check_ring(make, ring_cls=UnwaitedRing)
                except AssertionError as e:
                    rings[name]["planted_fault_caught"] = str(e)
                else:
                    raise AssertionError(f"check_ring passed a ring that "
                                         f"does not wait ({name})")
        emit({"phase": "cache_split", "card": card, "builds": built,
              "build_img_per_s": sum(b["images"] for b in built)
              / sum(b["seconds"] for b in built),
              "split": split, "ring": rings})
    return after


def scaled_after(card: str):
    """``after`` for ``trainer_bdd_ssd``: one fused batch of the train
    loader's first files at the run's size (``max_denom`` the Loader's)
    equals ``preproc_batch`` of ``decode_one(path, denom=BDD_DENOM)`` on
    the same files bit for bit, and not the full-scale decode's batch; its
    orig sizes are the files' own."""
    def after(argv):
        cfg = load_config(argv[0], {k: cli_run._coerce(v) for k, v in
                                    zip(argv[2::3], argv[3::3])})
        loader = build_datamodule(cfg).train_dataloader()
        S = cfg.effective_img_size
        paths = [loader.parser.record(int(i))[0]
                 for i in loader.indices[:loader.batch_size]]
        got, ows, ohs, scales, _, _ = native.decode_preproc_batch(
            paths, S, loader.letterbox, max_denom=native.MAX_DENOM)
        reduced = [native.decode_one(p, BDD_DENOM) for p in paths]
        want = native.preproc_batch(reduced, S, loader.letterbox)[0]
        full = native.decode_preproc_batch(paths, S, loader.letterbox)[0]
        if not np.array_equal(got, want):
            raise AssertionError(
                f"the fused batch differs from preproc_batch of the 1/"
                f"{BDD_DENOM} decodes by up to "
                f"{float(np.abs(got - want).max())}")
        if np.array_equal(got, full):
            raise AssertionError("the fused batch equals the full-scale "
                                 "decode's: the Loader did not scale")
        sizes = {(int(w), int(h)) for w, h in zip(ows, ohs)}
        if sizes != {(1280, 720)} or {im.shape[:2] for im in reduced} != \
                {(360, 640)}:
            raise AssertionError(f"orig sizes {sizes}, reduced "
                                 f"{[im.shape for im in reduced][:2]}")
        progressive = sum(open(p, "rb").read().find(b"\xff\xc2") >= 0
                          for p in paths)
        emit({"phase": "bdd_scaled_batch", "card": card, "img": S,
              "batch": len(paths), "progressive_files": progressive,
              "denom": BDD_DENOM, "orig_sizes": sorted(sizes),
              "bit_equal_to_decode_one_denom": True,
              "max_abs_diff_full_scale": float(np.abs(got - full).max())})
    return after


def phase_trainer_coco_cache(card: str) -> dict:
    """``trainer_coco`` with ``--set cache_dir``: the CLI builds the packed
    caches (timed by a wrapper around ``build_packed_cache``), then trains,
    validates and tests from uint8 gathers."""
    builds = []
    build = datamodules.cache_lib.build_packed_cache

    def timed_build(parser, img_size, cache_dir, letterbox=False,
                    log_every=0):
        was_valid = cache_lib.cache_valid(cache_dir, len(parser), img_size,
                                          letterbox)
        t0 = time.perf_counter()
        out = build(parser, img_size, cache_dir, letterbox, log_every)
        builds.append({"cache": os.path.basename(cache_dir),
                       "images": len(parser), "was_valid": was_valid,
                       "seconds": time.perf_counter() - t0})
        return out

    datamodules.cache_lib.build_packed_cache = timed_build
    try:
        return phase_trainer_real(card, "trainer_coco_cache",
                                  TRAINER_COCO_CACHE_SETS, COCO_TREE,
                                  cache_after(card, builds), cache=True)
    finally:
        datamodules.cache_lib.build_packed_cache = build


def profile_one(fn) -> tuple:
    """(wall ms, device-busy ms, device ms and launches by kernel class, top
    kernels) of one call under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # user annotations (e.g. ``Optimizer.step#Adam.step``) are ranges over
    # kernels that are counted on their own
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")
              and not getattr(e, "is_user_annotation", False)]
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    events.sort(key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    by_class = {}
    for e in events:
        c = by_class.setdefault(kernel_class(e.key), {"ms": 0.0, "calls": 0})
        c["ms"] += dev_us(e) / 1e3
        c["calls"] += e.count
    return wall_ms, busy_ms, by_class, [
        {"name": e.key[:80], "ms": dev_us(e) / 1e3, "calls": e.count}
        for e in events[:25]]


KERNEL_CLASSES = (
    ("port kernels", ("affine_warp_slots_kernel", "greedy_nms_kernel",
                      "conv3x3_")),
    ("layout transposes", ("nchwToNhwc", "nhwcToNchw")),
    ("convolutions and GEMMs", ("xmma", "cutlass", "nvjet", "gemm",
                                "cudnn")),
    ("reductions", ("reduce_kernel",)),
    ("copies and casts", ("Memcpy", "Memset", "copy", "Cat")),
    ("pooling and upsampling", ("max_pool", "upsample")),
    ("elementwise", ("elementwise", "Functor")),
)


def kernel_class(name: str) -> str:
    for cls, marks in KERNEL_CLASSES:
        if any(m in name for m in marks):
            return cls
    return "other"


# --- the 3x3/s1 conv ---------------------------------------------------------


def capture_convs() -> list:
    """x and dy (NHWC, bf16) and w (HWIO, bf16) of every 3x3/s1 conv of one
    YOLOv5s-640 bf16 train-mode forward and backward at B=64 (loss of a
    ``train_batch``, no augmentation), in forward order."""
    model = build_model("YOLOv5", NUM_CLASSES, dtype=torch.bfloat16,
                        device="cuda", seed=0)
    model.train()
    loss_fn = losses.make_loss("YOLOv5", NUM_CLASSES, IMG)
    images, labels, boxes, mask = [t.cuda() for t in
                                   train_batch(TRAIN_B, seed=36)]
    convs, handles = [], []

    def hook(mod, inp, out):
        rec = {"x": inp[0].detach().to(mod.dtype).permute(0, 2, 3, 1)
               .contiguous(),
               "w": mod.weight.detach().to(mod.dtype).permute(2, 3, 1, 0)
               .contiguous()}
        convs.append(rec)
        out.register_hook(lambda g: rec.__setitem__(
            "dy", g.permute(0, 2, 3, 1).contiguous()))

    for m in model.modules():
        if isinstance(m, blocks.Conv) and m.weight.shape[-1] == 3 \
                and m.stride == 1:
            handles.append(m.register_forward_hook(hook))
    loss_fn(model(images.float() / 255.0), labels, boxes, mask)["loss"] \
        .backward()
    for h in handles:
        h.remove()
    torch.cuda.synchronize()
    shapes = [conv_key(c) for c in convs]
    if shapes != CONV_SHAPES or not all("dy" in c for c in convs):
        raise AssertionError(f"captured 3x3/s1 convs {shapes}, expected "
                             f"{CONV_SHAPES} each with a gradient")
    return convs


def conv_key(c) -> str:
    B, H, W, C = c["x"].shape
    return f"{C}->{c['w'].shape[-1]}@{H}x{W}"


def f32_sum_tol(plain, x_abs, other_abs, n: int) -> torch.Tensor:
    """Elementwise bound on the reordered-sum error of an f32 result:
    CONV_SUM_TOL * log2(n) * eps_f32 * the same product of |inputs|."""
    return CONV_SUM_TOL * math.log2(max(n, 2)) \
        * torch.finfo(torch.float32).eps * plain(x_abs, other_abs).float()


def tol_share(got, want, tol) -> tuple:
    """(max |got - want|, its largest share of the tolerance, which is a
    scalar or an elementwise tensor)."""
    diff = (got.detach().float() - want.detach().float()).abs()
    share = float((diff / tol).max()) if torch.is_tensor(tol) \
        else float(diff.max()) / tol
    return float(diff.max()), share


def check_close(name: str, got, want, tol) -> dict:
    """Raises unless got is finite and within tol of want; returns the
    error, its share of tol, and the median limit beside the median
    |want|."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err, share = tol_share(got, want, tol)
    if not share <= 1.0:
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"by {err}, {share} of the tolerance")
    return {"err": err, "share_of_tol": share,
            "tol_median": float(tol.median()) if torch.is_tensor(tol)
            else tol,
            "ref_median_abs": float(want.detach().float().abs().median())}


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 numbers at each |t| (at 0: at the smallest
    normal bf16)."""
    a = t.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    _, e = torch.frexp(a)                     # a = m * 2**e, m in [0.5, 1)
    return torch.ldexp(torch.ones_like(a), e - 8)


def out_tol(plain, a, b, n: int):
    """``plain(a, b)`` and its tolerance, elementwise: the f32 reordered-sum
    bound over the reduction length n, plus for a bf16 result
    CONV_BF16_ULPS ulps of each element's own magnitude."""
    ref = plain(a, b)
    tol = f32_sum_tol(plain, a.abs().float(), b.abs().float(), n)
    if ref.dtype == torch.bfloat16:
        tol = tol + CONV_BF16_ULPS * bf16_ulp(ref)
    return ref, tol


def reject_faults(name: str, faults: dict, ref, tol) -> dict:
    """Shares of the tolerance of wrong results, each of which the check
    must reject (share > 1)."""
    shares = {}
    for kind, bad in faults.items():
        shares[kind] = tol_share(bad, ref, tol)[1]
        if not shares[kind] > 1.0:
            raise AssertionError(f"{name}: the planted fault {kind} passes "
                                 f"the check ({shares[kind]} of the "
                                 f"tolerance)")
    return shares


def fwd_faults(a, b) -> dict:
    """The forward kernel's result with one k-tile's worth of weights
    zeroed: the first tap's first 64 input channels, what a ring stage
    that was skipped (or read before it landed as zeros) leaves out."""
    lost = b.clone()
    lost[0, 0, :conv_kernel.STEP] = 0
    return {"lost_k_tile": conv_kernel.conv3x3_s1(a, lost)}


def wgrad_faults(x, dy) -> dict:
    """All zeros, and the wgrad kernel's result with the first split
    chunk's pixels left out, i.e. with one partial lost."""
    B, H, W, C = x.shape
    p = conv_kernel.wgrad_plan(
        B, H, W, C, dy.shape[-1],
        torch.cuda.get_device_properties(x.device).multi_processor_count,
        conv_kernel.wgmma_path(x, dy))
    # the pixels' positions in the reduction (rows of W, or of W + 2)
    pos = (torch.arange(B * H, device=x.device)[:, None]
           * (p.positions // (B * H))
           + torch.arange(W, device=x.device)[None, :])
    lost = dy.clone()
    lost.view(B * H, W, -1)[pos < p.chunk] = 0
    return {"zeros": torch.zeros(3, 3, C, dy.shape[-1], device=x.device),
            "lost_split": conv_kernel.conv3x3_s1_wgrad(x, lost)}


def at_offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """t's values in a contiguous tensor that starts ``offset`` elements
    into a fresh buffer (so, for offset 1, not 16-byte aligned)."""
    if not offset:
        return t
    buf = torch.empty(offset + t.numel(), dtype=t.dtype, device=t.device)
    return buf[offset:].view(t.shape).copy_(t)


def check_conv(name: str, x, w, dy) -> dict:
    """Forward, dgrad and wgrad kernels against their plain versions on the
    same CUDA tensors, each twice (the runs must agree bit for bit), and
    each with its planted faults, which must fail the same check; with the
    kernel each pass took (``wgmma``, or ``simple`` for f32, odd channel
    counts and unaligned tensors)."""
    B, H, W, C = x.shape
    wr = conv_kernel.rot_w(w).contiguous()
    res = {}
    for part, a, b, plain, kernel, n, faults in (
            ("fwd", x, w, conv_kernel.conv3x3_s1_plain,
             conv_kernel.conv3x3_s1, 9 * C, fwd_faults),
            ("dgrad", dy, wr, conv_kernel.conv3x3_s1_plain,
             conv_kernel.conv3x3_s1, 9 * w.shape[-1], fwd_faults),
            ("wgrad", x, dy, conv_kernel.conv3x3_s1_wgrad_plain,
             conv_kernel.conv3x3_s1_wgrad, B * H * W, wgrad_faults)):
        ref, tol = out_tol(plain, a, b, n)
        got = kernel(a, b)
        res[part] = check_close(f"{name} {part}", got, ref, tol)
        res[part]["kernel"] = "wgmma" if conv_kernel.wgmma_path(a, b) \
            else "simple"
        if not torch.equal(got, kernel(a, b)):
            raise AssertionError(f"{name} {part}: two runs differ")
        res[part]["planted_fault_share_of_tol"] = reject_faults(
            f"{name} {part}", faults(a, b), ref, tol)
    torch.cuda.synchronize()
    return res


def conv_plans(x, w) -> dict:
    """The wgmma kernels' tiles, grids and shared memory for the conv of x
    [B, H, W, C] with w [3, 3, C, Co]: forward, dgrad, wgrad."""
    B, H, W, C = x.shape
    Co = w.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return {"fwd": conv_kernel.fwd_plan(B, H, W, C, Co, sms)._asdict(),
            "dgrad": conv_kernel.fwd_plan(B, H, W, Co, C, sms)._asdict(),
            "wgrad": conv_kernel.wgrad_plan(B, H, W, C, Co, sms)._asdict()}


def phase_conv_check(card: str) -> tuple:
    """Returns (the captured convs, max |kernel - plain| of the forward
    kernel (fwd and dgrad) and of wgrad)."""
    torch.backends.cuda.matmul.allow_tf32 = False     # plain versions: f32
    convs = capture_convs()
    err = {"fwd": 0.0, "wgrad": 0.0}
    for i, c in enumerate(convs):
        res = check_conv(f"conv {i}", c["x"], c["w"], c["dy"])
        err["fwd"] = max(err["fwd"], res["fwd"]["err"], res["dgrad"]["err"])
        err["wgrad"] = max(err["wgrad"], res["wgrad"]["err"])
        emit({"phase": "conv_check", "case": f"yolov5s_conv{i}",
              "shape": conv_key(c), "B": TRAIN_B, "dtype": "bfloat16", **res,
              "plan": conv_plans(c["x"], c["w"])})
    g = torch.Generator(device="cuda").manual_seed(40)
    bf16_kernels = {part: set() for part in ("fwd", "dgrad", "wgrad")}
    for name, (B, H, W, C, Co), dtype, offset in CONV_EXTRA:
        x, w, dy = (torch.randn(*s, generator=g, device="cuda").to(dtype)
                    for s in ((B, H, W, C), (3, 3, C, Co), (B, H, W, Co)))
        x, dy = at_offset(x, offset), at_offset(dy, offset)
        res = check_conv(name, x, w, dy)
        err["fwd"] = max(err["fwd"], res["fwd"]["err"], res["dgrad"]["err"])
        err["wgrad"] = max(err["wgrad"], res["wgrad"]["err"])
        if dtype == torch.bfloat16:
            for part, kernels in bf16_kernels.items():
                kernels.add(res[part]["kernel"])
        emit({"phase": "conv_check", "case": name,
              "shape": f"{C}->{Co}@{H}x{W}", "B": B,
              "dtype": str(dtype).split(".")[-1], "offset": offset, **res})
    # CUDA bf16 inputs reach both the wgmma and the simple kernels of every
    # pass: each must have been held against its plain version
    for part, kernels in bf16_kernels.items():
        if kernels != {"wgmma", "simple"}:
            raise AssertionError(f"the bf16 {part} cases took only the "
                                 f"{sorted(kernels)} kernels")

    # the op through autograd: bf16 x, f32 master weights (dw in f32)
    c = convs[CONV_SHAPES.index("128->128@40x40")]
    x = c["x"].detach().requires_grad_()
    w = c["w"].float().requires_grad_()
    torch.cuda.synchronize()
    reset_launches()
    y = conv_kernel.conv3x3_s1_op(x, w)
    dx, dw = torch.autograd.grad(y, (x, w), c["dy"])
    torch.cuda.synchronize()
    counts = read_launches()
    want = {"conv3x3_s1": 2, "conv3x3_s1_wgrad": 1, "wgrad_reduce": 1,
            "greedy_nms": 0, "greedy_nms_tiled": 0, "affine_warp": 0}
    if counts != want or dx.dtype != torch.bfloat16 \
            or dw.dtype != torch.float32:
        raise AssertionError(f"conv3x3_s1_op fwd+bwd launched {counts} "
                             f"(expected {want}), dx {dx.dtype}, dw "
                             f"{dw.dtype}")
    res, w = {}, w.detach()
    ref, tol = out_tol(conv_kernel.conv3x3_s1_plain, c["x"], w, 9 * 128)
    res["y"] = check_close("op y", y, ref, tol)
    ref, tol = out_tol(conv_kernel.conv3x3_s1_plain, c["dy"],
                       conv_kernel.rot_w(w).to(torch.bfloat16).contiguous(),
                       9 * 128)
    res["dx"] = check_close("op dx", dx, ref, tol)
    ref, tol = out_tol(conv_kernel.conv3x3_s1_wgrad_plain, c["x"], c["dy"],
                       c["x"].shape[0] * 40 * 40)
    res["dw"] = check_close("op dw", dw, ref, tol)
    emit({"phase": "conv_check", "case": "conv3x3_s1_op_autograd",
          "shape": "128->128@40x40", "B": TRAIN_B, "launches": counts, **res,
          "tolerance": {"f32_sum": f"{CONV_SUM_TOL}*log2(n)*eps*sum|a*b|",
                        "bf16_ulps_of_each": CONV_BF16_ULPS}})
    return convs, err


def phase_conv_time(card: str, convs: list) -> dict:
    # the conv path: one forward and backward of conv3x3_s1_op per conv,
    # through the A/B tool's kernel step
    torch.cuda.synchronize()
    reset_launches()                           # main path starts here
    for c in convs:
        conv_bench.kernel_step(c["x"], c["w"], c["dy"])
    torch.cuda.synchronize()
    counts = read_launches()                   # main path ends here
    n = len(convs)
    want = {"conv3x3_s1": 2 * n, "conv3x3_s1_wgrad": n, "wgrad_reduce": n,
            "greedy_nms": 0, "greedy_nms_tiled": 0, "affine_warp": 0}
    if counts != want:
        raise AssertionError(f"{n} conv3x3_s1_op fwd+bwd launched {counts}, "
                             f"expected {want}")

    rows, total = {}, {}
    for c in convs:
        key = conv_key(c)
        if key in rows:
            rows[key]["count"] += 1
            continue
        fns = conv_bench.passes(c["x"], c["w"], c["dy"])
        bounds = conv_bench.pass_bounds(*c["x"].shape, c["w"].shape[-1])
        row = {"count": 1}
        for part in conv_bench.PASSES:
            ms, call_ms = time_ms(fns["kernel"][part], CONV_REPS)
            lib_ms, _ = time_ms(fns["cudnn"][part], CONV_REPS)
            bound_ms, bound_by = conv_bench.bound_ms(*bounds[part])
            row[part] = {"ms": ms, "call_ms": call_ms,
                         "plain_ms": call_time_ms(fns["plain"][part], 2,
                                                  warmup=1),
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "share_of_bound": bound_ms / ms,
                         "library_ms": lib_ms, "vs_library": ms / lib_ms}
        rows[key] = row
    for key, row in rows.items():
        emit({"phase": "conv_time", "shape": key, "B": TRAIN_B,
              "dtype": "bfloat16", "card": card, **row})
        for part in conv_bench.PASSES:
            t = total.setdefault(part, {"ms": 0.0, "call_ms": 0.0,
                                        "plain_ms": 0.0, "bound_ms": 0.0,
                                        "library_ms": 0.0,
                                        "bound_by_operations_ms": 0.0})
            for k in ("ms", "call_ms", "plain_ms", "bound_ms", "library_ms"):
                t[k] += row["count"] * row[part][k]
            if row[part]["bound_by"] == "operations":
                t["bound_by_operations_ms"] += row["count"] \
                    * row[part]["bound_ms"]
    for t in total.values():
        t["bound_by"] = "operations" if t.pop("bound_by_operations_ms") \
            >= t["bound_ms"] / 2 else "bytes"
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        t["vs_library"] = t["ms"] / t["library_ms"]
    emit({"phase": "conv_time", "shape": f"all {n} convs", "B": TRAIN_B,
          "dtype": "bfloat16", "card": card, "launches": counts, **total})
    # the A/B tool as a user runs it, on one shape
    conv_bench.main(["--shape", "40,128,128", "--batch", str(TRAIN_B),
                     "--grad", "--iters", str(CONV_REPS)])
    return {"launches": counts, "total": total}


def phase_profile(card: str) -> None:
    step, _ = serving_model()
    images = torch.randint(0, 256, (64, IMG, IMG, 3), dtype=torch.uint8,
                           device="cuda")
    for _ in range(2):
        step(images)
    paths = {"serving": lambda: step(images)}
    batch = [t.cuda() for t in train_batch(TRAIN_B, seed=34)]
    state, tstep = trainer(torch.bfloat16, "cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(35)
    for _ in range(2):
        state, _ = augment_and_step(state, tstep, *batch, gen)
    paths["training"] = lambda: augment_and_step(state, tstep, *batch, gen)
    # time every path unprofiled before the first profile: timed after a
    # profiled call, the train step took 40 % longer than in `training`
    unprofiled = {path: call_time_ms(fn, 3, warmup=0)
                  for path, fn in paths.items()}
    for path, fn in paths.items():
        unprofiled_ms = unprofiled[path]
        wall_ms, busy_ms, by_class, top = profile_one(fn)
        emit({"phase": "profile", "path": path, "card": card, "B": 64,
              "wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "idle_share": 1.0 - busy_ms / wall_ms,
              "unprofiled_ms": unprofiled_ms,
              "idle_share_unprofiled": 1.0 - busy_ms / unprofiled_ms,
              "by_class": by_class, "top": top})


# --- data parallelism (ddp) ------------------------------------------------

# (a) two ranks on the one card over gloo (NCCL refuses two ranks on one
# device): YOLOv5s-640 at full width, f32, B=4 a rank, accumulation 2,
# mosaic 1.0, Adam, 3 steps, against one process on the concatenated
# microbatches with the same draws
DDP_RANKS = 2
DDP_B = 4                 # images a rank and microbatch
DDP_ACCUM = 2
DDP_STEPS = 3
DDP_LR = 1e-3
# Each step of the two ranks is held against one process stepping on the
# concatenated microbatches, with the same draws, from the ranks' state
# before that step: what differs is the f32 reduction order alone.  That
# order moves this model's gradient by ~1 % in relative L2 at random
# init (the BN cancellation of test_torch_port_train.py: permuting the
# rows of one process's batch moved it by 1.06 % at 64 px on the CPU),
# and Adam turns a gradient of unsettled sign into a whole step either
# way, so trajectories are not compared: over 3 steps they drift apart
# by ~lr.  Loss and parameter norm at rtol 1e-4 as
# tests/test_distributed_2proc.py holds JAX's processes; Adam's first
# moment (0.1 x the summed gradient) within 3 % (a lost or halved
# reduction is ~50 % off).  An Adam update is ~lr whatever the gradient's
# size, so parameters are compared by the share of them whose update
# (post - pre) took the other sign than one process's: 2 %, five times
# the largest of a sound run (0.39 / 0.21 / 0.06 % at steps 1-3, H100),
# which a step on rank 0's rows alone (what a rank without any collective
# computes: 45 / 22 / 13 % there) must exceed, or the check could not
# tell.
DDP_TOL = {"loss_rtol": 1e-4, "pnorm_rtol": 1e-4, "mu_rel_l2": 3e-2,
           "update_sign_mismatch": 2e-2}
# (b) cli.run at world size 1 over NCCL: one epoch of Synthetic, test on
DDP_CLI_SETS = {"model_name": "YOLOv5", "type": "Yolov5s", "img_size": "640",
                "compute_dtype": "bfloat16", "data_module": "Synthetic",
                "synthetic_size": "64", "batch_size": "16",
                "accumulate_grad_batches": "2", "limit_train_batches": "2",
                "limit_val_batches": "1", "limit_test_batches": "1",
                "max_epochs": "1"}


def ddp_setup():
    """(state, step, microbatches) of the ``ddp`` (a) run: this process's
    rows of every global microbatch (all of them without a process
    group), augmented from one generator, mosaic first."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    R, r = distributed.data_shard()
    b = DDP_RANKS * DDP_B // R
    model = build_model("YOLOv5", NUM_CLASSES, device="cuda", seed=0)
    opt = build_optimizer(Config(lr=DDP_LR), model.parameters())
    state = create_train_state(model, opt)
    distributed.broadcast_state(state)
    step = make_train_step(model, losses.make_loss("YOLOv5", NUM_CLASSES,
                                                   IMG), opt, DDP_ACCUM)
    rows = slice(r * b, (r + 1) * b)
    batches = [[t[rows].cuda() for t in train_batch(DDP_RANKS * DDP_B,
                                                    seed=37 + i)]
               for i in range(DDP_STEPS * DDP_ACCUM)]
    return state, step, batches


def ddp_augmented(batches, gen, s: int) -> list:
    """Step ``s``'s stacked microbatches: uint8 -> /255 -> mosaic (p=1)
    -> ``augment_batch``, drawing from ``gen``."""
    micro = []
    for images, labels, boxes, mask in batches[s * DDP_ACCUM:
                                               (s + 1) * DDP_ACCUM]:
        x, boxes, labels, mask = augment.mosaic_batch(
            images.float() / 255.0, boxes, labels, mask, p=1.0,
            generator=gen)
        x, boxes, mask = augment.augment_batch(x, boxes, mask,
                                               generator=gen)
        micro.append((x, labels, boxes, mask))
    return [torch.stack([m[i] for m in micro]) for i in range(4)]


def _pnorm(model) -> float:
    return math.sqrt(sum(p.detach().double().square().sum().item()
                         for p in model.parameters()))


def _params_and_mu(state) -> dict:
    return {"params": {n: p.detach().cpu()
                       for n, p in state.model.named_parameters()},
            "mu": {n: state.optimizer.state[p]["exp_avg"].cpu()
                   for n, p in state.model.named_parameters()}}


def ddp_ranks(out: str) -> dict:
    """One rank of ``ddp`` (a): its steps, each rank's parameters and
    Adam's first moment after each step saved to ``out`` (rank 0 also its
    state before each step); returns the losses, norms, step ms and this
    rank's launches."""
    state, step, batches = ddp_setup()
    r = distributed.process_index()
    gen = torch.Generator(device="cuda").manual_seed(36)
    res = {"loss": [], "pnorm": [], "ms": []}
    torch.cuda.synchronize()
    reset_launches()                           # main path starts here
    for s in range(DDP_STEPS):
        if r == 0:
            torch.save({"model": state.model.state_dict(),
                        "optimizer": state.optimizer.state_dict()},
                       os.path.join(out, f"pre{s}.pt"))
        t0 = time.perf_counter()
        state, metrics = step(state, *ddp_augmented(batches, gen, s))
        torch.cuda.synchronize()
        res["ms"].append((time.perf_counter() - t0) * 1e3)
        res["loss"].append(metrics["loss"].item())
        res["pnorm"].append(_pnorm(state.model))
        torch.save(_params_and_mu(state), os.path.join(out,
                                                       f"post{s}_{r}.pt"))
    res["launches"] = read_launches()          # main path ends here
    return res


def ddp_reference(out: str, ranks: list) -> dict:
    """``ddp`` (a)'s one process: each step on the concatenated
    microbatches from rank 0's state before it, held to ``DDP_TOL``
    against the ranks after it; then the same step on rank 0's rows
    alone, the update sign check's fault."""
    state, step, batches = ddp_setup()
    gen = torch.Generator(device="cuda").manual_seed(36)
    res = {"loss": [], "loss_rel_err": [], "pnorm_rel_err": [],
           "mu_rel_l2": [], "update_sign_mismatch": [],
           "update_sign_mismatch_rank0_alone": [], "ms": []}
    flat = lambda d: torch.cat([d[n].double().ravel() for n in sorted(d)])
    for s in range(DDP_STEPS):
        pre = torch.load(os.path.join(out, f"pre{s}.pt"))
        state.model.load_state_dict(pre["model"])
        state.optimizer.load_state_dict(pre["optimizer"])
        batch = ddp_augmented(batches, gen, s)
        t0 = time.perf_counter()
        state, metrics = step(state, *batch)
        torch.cuda.synchronize()
        res["ms"].append((time.perf_counter() - t0) * 1e3)
        loss = metrics["loss"].item()
        res["loss"].append(loss)
        got = [torch.load(os.path.join(out, f"post{s}_{r}.pt"))
               for r in range(DDP_RANKS)]
        want = _params_and_mu(state)
        if any(not torch.equal(got[0]["params"][n], g["params"][n])
               for g in got[1:] for n in want["params"]):
            raise AssertionError(f"ddp: the ranks' parameters differ after "
                                 f"step {s}")
        res["loss_rel_err"].append(abs(ranks[0]["loss"][s] / loss - 1))
        res["pnorm_rel_err"].append(abs(ranks[0]["pnorm"][s]
                                        / _pnorm(state.model) - 1))
        res["mu_rel_l2"].append(((flat(got[0]["mu"]) - flat(want["mu"]))
                                 .norm() / flat(want["mu"]).norm()).item())
        signs = lambda params: torch.cat([
            (params[n] - pre["model"][n].cpu()).sign().ravel()
            for n in sorted(params)])
        ref = signs(want["params"])
        res["update_sign_mismatch"].append(
            (signs(got[0]["params"]) != ref).double().mean().item())
        state.model.load_state_dict(pre["model"])
        state.optimizer.load_state_dict(pre["optimizer"])
        state, _ = step(state, *[t[:, :DDP_B] for t in batch])
        res["update_sign_mismatch_rank0_alone"].append(
            (signs(_params_and_mu(state)["params"]) != ref).double().mean()
            .item())
    return res


def ddp_worker(kind: str, out: str) -> None:
    """One rank of ``ddp``, started by ``parallel.dryrun.spawn``: ``train``
    (a, over gloo) or ``cli`` (b, ``cli.run.main`` joining the group from
    torchrun's environment, NCCL); prints one JSON line."""
    if kind == "train":
        distributed.maybe_initialize("gloo")
        try:
            res = ddp_ranks(out)
        finally:
            distributed.shutdown()
    else:
        seen = {}

        class Seen(cli_run.Trainer):
            def fit(self):
                seen["backend"] = torch.distributed.get_backend()
                seen["device"] = str(self.device)
                one = torch.ones(1, device=self.device)
                torch.distributed.all_reduce(one)   # a collective it carries
                seen["all_reduce_of_one"] = one.item()
                return super().fit()

        cli_run.Trainer = Seen
        argv = [str(REPO / "configs" / "config.yaml"), "--set", "log_dir",
                out]
        for k, v in DDP_CLI_SETS.items():
            argv += ["--set", k, v]
        reset_launches()                       # main path starts here
        results = cli_run.main(argv)
        torch.cuda.synchronize()
        res = {**seen, "launches": read_launches(),  # main path ends here
               "mAP": results["mAP"],
               "group_left": not torch.distributed.is_initialized()}
    print("DDP " + json.dumps(res), flush=True)


def _ddp_result(out: str) -> dict:
    return json.loads([line for line in out.splitlines()
                       if line.startswith("DDP ")][-1][4:])


def phase_ddp(card: str) -> dict:
    """(a) two ranks on the card over gloo against one process, (b)
    ``cli.run`` at world size 1 over NCCL, (c) ``dryrun_multichip(2)`` on
    the card over gloo."""
    me = str(Path(__file__).resolve())
    threads = {"OMP_NUM_THREADS": str(max(os.cpu_count() // DDP_RANKS, 1))}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_",
                                     dir=REPO / "build") as tmp:
        t0 = time.perf_counter()
        ranks = [_ddp_result(o) for o in spawn(
            [me, "--ddp-worker", "train", tmp], DDP_RANKS, 900, threads)]
        ranks_s = time.perf_counter() - t0
        one = ddp_reference(tmp, ranks)
    warp = [r["launches"]["affine_warp"] for r in ranks]
    row = {"phase": "ddp", "part": "two_ranks_gloo", "card": card,
           "model": "Yolov5s", "img": IMG, "classes": NUM_CLASSES,
           "dtype": "float32", "B_per_rank": DDP_B, "ranks": DDP_RANKS,
           "accum": DDP_ACCUM, "mosaic": 1.0, "steps": DDP_STEPS,
           "loss_ranks": [r["loss"] for r in ranks],
           "loss_one_process": one["loss"],
           **{k: one[k] for k in ("loss_rel_err", "pnorm_rel_err",
                                  "mu_rel_l2", "update_sign_mismatch",
                                  "update_sign_mismatch_rank0_alone")},
           "tolerance": DDP_TOL, "warp_launches_per_rank": warp,
           "step_ms_two_ranks_gloo_over_host": [r["ms"] for r in ranks],
           "step_ms_one_process": one["ms"], "spawn_s": ranks_s}
    emit(row)
    if ranks[0]["loss"] != ranks[1]["loss"] or not all(
            math.isfinite(v) for v in ranks[0]["loss"]):
        raise AssertionError(f"ddp: rank losses {row['loss_ranks']}")
    for key, tol in (("loss_rel_err", "loss_rtol"),
                     ("pnorm_rel_err", "pnorm_rtol"),
                     ("mu_rel_l2", "mu_rel_l2"),
                     ("update_sign_mismatch", "update_sign_mismatch")):
        if max(one[key]) > DDP_TOL[tol]:
            raise AssertionError(f"ddp: two ranks against one process: "
                                 f"{key} {one[key]} beyond {DDP_TOL[tol]}")
    alone = one["update_sign_mismatch_rank0_alone"]
    if min(alone) <= DDP_TOL["update_sign_mismatch"]:
        raise AssertionError(f"ddp: a step on rank 0's rows alone changed the "
                             f"update's sign of {alone} of the parameters, "
                             f"not above the limit "
                             f"{DDP_TOL['update_sign_mismatch']}")
    if warp != [DDP_STEPS * DDP_ACCUM] * DDP_RANKS:
        raise AssertionError(f"ddp: warp launches per rank {warp}, expected "
                             f"{DDP_STEPS * DDP_ACCUM} each")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_cli_",
                                     dir=REPO / "build") as tmp:
        t0 = time.perf_counter()
        out = spawn([me, "--ddp-worker", "cli", tmp], 1, 900)[0]
        cli_s = time.perf_counter() - t0
    cli = _ddp_result(out)
    emit({"phase": "ddp", "part": "cli_nccl_world1", "card": card,
          "sets": DDP_CLI_SETS, "wall_s": cli_s, **cli,
          "printed": [line for line in out.splitlines()
                      if line.startswith("[run]")]})
    if "[run] distributed: process 0 / 1" not in out or \
            cli["backend"] != "nccl" or cli["all_reduce_of_one"] != 1.0 \
            or not cli["group_left"]:
        raise AssertionError(f"ddp: cli.run did not join and leave an NCCL "
                             f"group: {cli}\n{out[-3000:]}")
    if cli["launches"]["greedy_nms"] != 1 or \
            cli["launches"]["affine_warp"] != 2:
        raise AssertionError(f"ddp: cli.run launched {cli['launches']}, "
                             f"expected 1 NMS (one test batch) and 2 warp "
                             f"(two microbatches)")

    t0 = time.perf_counter()
    dry = dryrun_multichip(DDP_RANKS, device="cuda")
    emit({"phase": "ddp", "part": "dryrun_multichip_gloo", "card": card,
          "ranks": DDP_RANKS, "loss": dry,
          "wall_s": time.perf_counter() - t0})
    return {"warp_per_rank": warp, "cli": cli["launches"]}


# --- torch checkpoints (utils/torch_weights.py) ------------------------------

# torchvision vgg16.features, config D: conv widths, "M" a max-pool
VGG16_FEATURES = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512,
                  512, "M", 512, 512, 512, "M"]
VGG16_PARAMS = 14_714_688
# torch_ckpt: the trainer_ssd run (the YAML's yaml_test caps, bf16, B=32,
# 2 epochs) from a VGG16 ``features.*`` file
TORCH_CKPT_SETS = {**{k: v for k, v in TRAINER_SETS.items() if k != "type"},
                   "model_name": "SSD", "img_size": "0"}
# the reference YOLOv2's ConvBN modules (model/YOLOV2.py:42-102), in order
YOLOV2_REFERENCE = ([f"stage1_conv{i}" for i in range(1, 14)]
                    + [f"stage2_a_conv{i}" for i in range(1, 8)]
                    + ["stage2_b_conv", "stage3_conv1"])


def vgg16_features(seed: int) -> dict:
    """A torchvision vgg16 ``features.*`` state dict drawn from ``seed``:
    He-normal weights, small biases, torchvision's keys and shapes."""
    g = torch.Generator().manual_seed(seed)
    out, c, i = {}, 3, 0
    for v in VGG16_FEATURES:
        if v == "M":
            i += 1
            continue
        out[f"features.{i}.weight"] = (torch.randn(v, c, 3, 3, generator=g)
                                       * math.sqrt(2.0 / (9 * c)))
        out[f"features.{i}.bias"] = 0.01 * torch.randn(v, generator=g)
        c, i = v, i + 2                       # the conv and its ReLU
    return out


def reference_yolov2(model, seed: int) -> dict:
    """A full reference-YOLOv2 state dict for ``model``'s shapes, drawn
    from ``seed``: lecun-normal convs, BN near the identity."""
    g = torch.Generator().manual_seed(seed)
    have = model.state_dict()
    conv = lambda shape: torch.randn(shape, generator=g) / math.sqrt(
        math.prod(shape[1:]))
    out = {}
    for k, tk in enumerate(YOLOV2_REFERENCE):
        w = have[f"ConvBN_{k}.Conv_0.weight"]
        n = w.shape[0]
        out[f"{tk}.0.weight"] = conv(w.shape)
        out[f"{tk}.1.weight"] = 1.0 + 0.1 * torch.randn(n, generator=g)
        out[f"{tk}.1.bias"] = 0.1 * torch.randn(n, generator=g)
        out[f"{tk}.1.running_mean"] = 0.1 * torch.randn(n, generator=g)
        out[f"{tk}.1.running_var"] = 0.5 + torch.rand(n, generator=g)
    out["stage3_conv2.weight"] = conv(have["Conv_0.weight"].shape)
    return out


def yolov2_reference_predict(card: str) -> dict:
    """A full reference YOLOv2 dict through ``load_torch_checkpoint`` into
    YOLOv2-416 (80 classes) on the card and on the CPU: every tensor where
    the name map puts it, bit for bit; f32 head maps (TF32 off) within
    ``YOLO_HEAD_REL`` of the CPU's; one ``predict_step`` at B=1 on the
    card, one NMS launch (counts zeroed before, read after)."""
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    models = {dev: build_model("YOLOv2", NUM_CLASSES, device=dev, seed=0)
              for dev in ("cpu", "cuda")}
    ref = reference_yolov2(models["cpu"], seed=6)
    for dev, model in models.items():
        loaded, n, desc = torch_weights.load_torch_checkpoint(
            "YOLOv2", model.state_dict(), ref)
        if (n, desc) != (23, "reference YOLOv2 (full model)"):
            raise AssertionError(f"torch_ckpt: YOLOv2 route gave {n}, {desc}")
        model.load_state_dict(loaded, strict=True)
    sd = models["cuda"].state_dict()
    pairs = [("Conv_0.weight", "stage3_conv2.weight")]
    for k, tk in enumerate(YOLOV2_REFERENCE):
        pairs.append((f"ConvBN_{k}.Conv_0.weight", f"{tk}.0.weight"))
        for port, leaf in (("weight", "weight"), ("bias", "bias"),
                           ("running_mean", "running_mean"),
                           ("running_var", "running_var")):
            pairs.append((f"ConvBN_{k}.BatchNorm_0.{port}", f"{tk}.1.{leaf}"))
    moved = [p for p, r in pairs if not torch.equal(sd[p].cpu(), ref[r])]
    if moved or len(pairs) != len(ref):
        raise AssertionError(f"torch_ckpt: YOLOv2 tensors not loaded bit for "
                             f"bit: {moved[:4]} ({len(pairs)} of {len(ref)})")
    g = torch.Generator().manual_seed(62)
    x = torch.randint(0, 256, (1, YOLO_IMG, YOLO_IMG, 3), generator=g,
                      dtype=torch.uint8).float() / 255.0
    with torch.no_grad():
        head = models["cuda"](x.cuda())
        head_rel = max_rel(head, models["cpu"](x))
    if head_rel > YOLO_HEAD_REL:
        raise AssertionError(f"torch_ckpt: YOLOv2 head maps card vs CPU "
                             f"{head_rel} > {YOLO_HEAD_REL}")
    step = make_predict_step(models["cuda"], make_postprocess(
        "YOLOv2", NUM_CLASSES, YOLO_IMG))
    state = create_train_state(models["cuda"])
    torch.cuda.synchronize()
    reset_launches()                           # main path starts here
    res = step(state, x.cuda())
    torch.cuda.synchronize()
    counts = read_launches()                   # main path ends here
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    if counts["greedy_nms"] != 1:
        raise AssertionError(f"torch_ckpt: predict_step launched NMS "
                             f"{counts['greedy_nms']} times")
    rows = 5 * (YOLO_IMG // 32) ** 2
    if res.boxes.shape != (1, min(TOP_K, rows), 4) or not torch.isfinite(
            res.boxes).all():
        raise AssertionError("torch_ckpt: YOLOv2 boxes of a wrong shape or "
                             "non-finite")
    return {"tensors_bit_equal": len(pairs), "head_rel_err": head_rel,
            "valid": int(res.valid.sum()), "launches": counts}


def phase_torch_ckpt(card: str) -> dict:
    """A seeded VGG16 ``features.*`` file under ``build/``: its read and
    load into SSD-300 on the card, timed; then ``cli.run`` on the YAML with
    SSD and ``--set torch_ckpt`` (``phase_trainer``: warp and NMS launches,
    mAP table, restore), which must print the loaded line and hold the
    file's 13 convs bit for bit right after construction; then a full
    reference YOLOv2 through the router and one ``predict_step``."""
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    sd = vgg16_features(5)
    if sum(t.numel() for t in sd.values()) != VGG16_PARAMS:
        raise AssertionError("torch_ckpt: not VGG16's parameter count")
    path = build / "vgg16_features_seed5.pth"
    torch.save(sd, path)
    nbytes = os.path.getsize(path)
    t0 = time.perf_counter()
    read = torch_weights.read_torch_state_dict(str(path))
    read_s = time.perf_counter() - t0
    ssd = build_model("SSD", NUM_CLASSES, device="cuda", seed=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded, n, desc = torch_weights.load_torch_checkpoint(
        "SSD", ssd.state_dict(), read)
    ssd.load_state_dict(loaded, strict=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    del ssd, loaded, read

    at_init = {}

    def on_init(trainer):
        wrong = []
        for j, ti in enumerate(torch_weights.VGG16_CONV_IDX):
            stack, k = (0, j) if j < 10 else (1, j - 10)
            conv = trainer.model.get_submodule(
                f"_VGGStack_{stack}.ConvBN_{k}.Conv_0")
            for leaf in ("weight", "bias"):
                if not torch.equal(getattr(conv, leaf).detach().cpu(),
                                   sd[f"features.{ti}.{leaf}"]):
                    wrong.append(f"features.{ti}.{leaf}")
        at_init.update(device=str(conv.weight.device), wrong=wrong)

    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            fit = phase_trainer(card, {**TORCH_CKPT_SETS,
                                       "torch_ckpt": str(path)},
                                "torch_ckpt", on_init=on_init)
    finally:
        sys.stdout.write(printed.getvalue())
    line = f"[trainer] loaded 13 tensors from {path} (vgg16 backbone)"
    if line not in printed.getvalue():
        raise AssertionError(f"torch_ckpt: no line {line!r}")
    if at_init.get("wrong") != [] or not at_init["device"].startswith("cuda"):
        raise AssertionError(f"torch_ckpt: the Trainer's VGG convs differ from "
                             f"the file right after construction: {at_init}")
    predicted = yolov2_reference_predict(card)
    emit({"phase": "torch_ckpt", "card": card, "file_mb": nbytes / 1e6,
          "float32_tensors": VGG16_PARAMS, "read_s": read_s,
          "load_into_ssd_on_card_s": load_s, "n": n, "desc": desc,
          "trainer_convs_bit_equal": 26, "printed": line,
          "epoch_s": [e["seconds"] for e in fit["epochs"]],
          "launches": fit["launches"], "yolov2_reference": predicted})
    return {"launches": fit["launches"], "predict": predicted["launches"]}


# --- the mesh's model axis (parallel/mesh.py) --------------------------------

TP_SHAPE = (2, 2)         # (data, model): four ranks on the one card, gloo
TP_ROWS = 2               # images a data index
TP_LR = 1.0               # SGD: the update is the gradient
# loss and BN statistics against one process on the same four rows at f32
# (TF32 off); the gradient (the update of the gathered parameters) in f64,
# where one process's own reduction order moves it by ~1e-11, and in f32,
# where reversing one process's rows moves it by 2.2 % (YOLOv2 at 64 px on
# the CPU, tests/test_torch_port_model_axis.py): a gradient twice too large
# is off by 1
TP_TOL = {"loss_rtol": 1e-4, "bn_abs": 1e-4, "grad_rel_l2_f64": 1e-4,
          "grad_rel_l2_f32": 5e-2}


def tp_step(dtype: torch.dtype, data: int, index: int) -> tuple:
    """One SGD step of YOLOv2-416, 80 classes, computing in ``dtype``, on
    the rows of data index ``index`` (of ``data``) of a 4-image batch:
    uint8 -> /255 -> ``augment_batch`` (one warp launch) -> ``train_step``,
    split over the model axis under a process group.  Returns (state,
    metrics, ms, launches); counts zeroed just before, read just after."""
    model = build_model("YOLOv2", NUM_CLASSES, dtype=dtype, device="cuda",
                        seed=0)
    opt = torch.optim.SGD(model.parameters(), lr=TP_LR)
    state = create_train_state(model, opt)
    if distributed.process_count() > 1:
        distributed.broadcast_state(state)
        mesh.shard_model_parallel(mesh.Mesh(*TP_SHAPE), state)
    step = make_train_step(model, losses.make_loss("YOLOv2", NUM_CLASSES,
                                                   YOLO_IMG), opt)
    b = TP_SHAPE[0] * TP_ROWS // data
    images, labels, boxes, mask = (t[index * b:(index + 1) * b].cuda()
                                   for t in train_batch(TP_SHAPE[0] * TP_ROWS,
                                                        seed=59,
                                                        img=YOLO_IMG))
    gen = torch.Generator(device="cuda").manual_seed(60)
    torch.cuda.synchronize()
    reset_launches()                           # main path starts here
    t0 = time.perf_counter()
    x, boxes, mask = augment.augment_batch(images.float() / 255.0, boxes,
                                           mask, generator=gen)
    state, metrics = step(state, x[None], labels[None], boxes[None],
                          mask[None])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return state, metrics, ms, read_launches()  # main path ends here


def tp_worker(out: str) -> None:
    """One rank of ``tp``, started by ``parallel.dryrun.spawn``: the f32
    and the f64 step on its data index's rows, split over the model axis;
    rank 0 saves each gathered state; prints one JSON line."""
    distributed.maybe_initialize("gloo")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        grid = mesh.make_mesh(TP_SHAPE)
        a = distributed.axes()
        rank = distributed.process_index()
        res = {"rank": rank, "coords": [a.data_index, a.model_index]}
        for tag, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            state, metrics, ms, counts = tp_step(dtype, grid.data,
                                                 a.data_index)
            whole = {k: v.cpu() for k, v in
                     mesh.gather_state_dict(state).items()}
            h = hashlib.sha256()
            for k in sorted(whole):
                h.update(whole[k].numpy().tobytes())
            if rank == 0:
                torch.save(whole, os.path.join(out, f"tp_{tag}.pt"))
            res[tag] = {"loss": metrics["loss"].item(), "ms": ms,
                        "launches": counts, "hash": h.hexdigest(),
                        "conv13": list(state.model.ConvBN_13.Conv_0
                                       .weight.shape),
                        "head": list(state.model.Conv_0.weight.shape)}
            del state, whole
    finally:
        distributed.shutdown()
    print("TP " + json.dumps(res), flush=True)


def _grad_rel_l2(sd0: dict, got: dict, want: dict, keys) -> float:
    upd = lambda sd: torch.cat([(sd0[k] - sd[k]).double().ravel()
                                for k in keys])
    ref = upd(want)
    return float((upd(got) - ref).norm() / ref.norm())


def phase_tp(card: str) -> dict:
    """Four ranks (data=2, model=2) on the card over gloo against one
    process on the same four rows: loss and BN statistics (f32), the split
    parameters' gradients (f64, and f32 within its noise), half of
    ``ConvBN_13``'s output channels on each rank, the 425-channel head
    replicated, one warp launch a rank and step, the same gathered state on
    every rank."""
    me = str(Path(__file__).resolve())
    ranks = math.prod(TP_SHAPE)
    threads = {"OMP_NUM_THREADS": str(max(os.cpu_count() // ranks, 1))}
    sd0 = build_model("YOLOv2", NUM_CLASSES, device="cpu", seed=0).state_dict()
    splits = mesh.model_parallel_shardings(mesh.Mesh(*TP_SHAPE), sd0)
    split = [k for k, d in splits.items() if d == 0
             and not k.endswith(("running_mean", "running_var"))]
    stats = [k for k in sd0 if k.endswith(("running_mean", "running_var"))]
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    row = {"phase": "tp", "card": card, "model": "YOLOv2", "img": YOLO_IMG,
           "classes": NUM_CLASSES, "mesh": TP_SHAPE, "rows_per_data_index":
           TP_ROWS, "optimizer": f"SGD lr {TP_LR}", "tolerance": TP_TOL,
           "split_tensors": len(split), "replicated_head":
           splits["Conv_0.weight"] is None}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_",
                                     dir=REPO / "build") as tmp:
        t0 = time.perf_counter()
        outs = spawn([me, "--tp-worker", tmp], ranks, 900, threads)
        row["spawn_s"] = time.perf_counter() - t0
        got = [json.loads([line for line in o.splitlines()
                           if line.startswith("TP ")][-1][3:]) for o in outs]
        for tag, dtype in (("f32", torch.float32), ("f64", torch.float64)):
            state, metrics, ms, counts = tp_step(dtype, 1, 0)
            one = {k: v.cpu() for k, v in state.model.state_dict().items()}
            del state
            whole = torch.load(os.path.join(tmp, f"tp_{tag}.pt"))
            loss = metrics["loss"].item()
            row[tag] = {
                "loss_ranks": [r[tag]["loss"] for r in got],
                "loss_one_process": loss,
                "loss_rel_err": max(abs(r[tag]["loss"] / loss - 1)
                                    for r in got),
                "bn_max_abs_err": max(float((whole[k] - one[k]).abs().max())
                                      for k in stats),
                "grad_rel_l2_split": _grad_rel_l2(sd0, whole, one, split),
                "step_ms_ranks": [r[tag]["ms"] for r in got],
                "step_ms_one_process": ms,
                "warp_launches_ranks": [r[tag]["launches"]["affine_warp"]
                                        for r in got],
                "warp_launches_one_process": counts["affine_warp"]}
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    row["coords"] = [r["coords"] for r in got]
    row["conv13_per_rank"] = [r["f32"]["conv13"] for r in got]
    emit(row)
    if row["coords"] != [list(mesh.coords(mesh.Mesh(*TP_SHAPE), r))
                         for r in range(ranks)]:
        raise AssertionError(f"tp: ranks at {row['coords']}")
    full = list(sd0["ConvBN_13.Conv_0.weight"].shape)
    for r in got:
        for tag in ("f32", "f64"):
            if r[tag]["conv13"] != [full[0] // TP_SHAPE[1], *full[1:]] or \
                    r[tag]["head"] != list(sd0["Conv_0.weight"].shape):
                raise AssertionError(f"tp: rank {r['rank']} holds "
                                     f"ConvBN_13 {r[tag]['conv13']} and the "
                                     f"head {r[tag]['head']}")
            if r[tag]["launches"]["affine_warp"] != 1:
                raise AssertionError(f"tp: rank {r['rank']} {tag}: "
                                     f"{r[tag]['launches']} launches")
            if r[tag]["hash"] != got[0][tag]["hash"]:
                raise AssertionError(f"tp: rank {r['rank']} {tag}: its "
                                     f"gathered state differs from rank 0's")
    for tag in ("f32", "f64"):
        res = row[tag]
        if res["loss_rel_err"] > TP_TOL["loss_rtol"] or \
                res["bn_max_abs_err"] > TP_TOL["bn_abs"] or \
                res["grad_rel_l2_split"] > TP_TOL[f"grad_rel_l2_{tag}"] or \
                not math.isfinite(res["loss_one_process"]):
            raise AssertionError(f"tp: {tag} against one process: {res}")
    return {"warp_per_rank": row["f32"]["warp_launches_ranks"]}


def conv_entry(name, line, conv, err, part, library, card) -> dict:
    t, counts = conv["total"], conv["launches"]
    entry = {"name": name, "route": "cuda",
             "source": "objectdetectionpl_tpu_torch/csrc/conv3x3.cu",
             "replaces": f"objectdetectionpl_tpu/ops/pallas/conv_kernel.py"
                         f"{line}",
             "launches": counts[name], "max_abs_err": err,
             **{k: t[part][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms",
                                        "call_ms")},
             "library": library,
             "shape": f"the {len(CONV_SHAPES)} YOLOv5s-640 3x3/s1 convs, "
                      f"B={TRAIN_B}, bf16, summed", "card": card}
    if part == "fwd":         # the same kernel computes the input gradient
        entry.update({f"{k}_dgrad": t["dgrad"][k] for k in (
            "ms", "plain_ms", "bound_ms", "library_ms", "call_ms")})
    else:
        entry["reduce_launches"] = counts["wgrad_reduce"]
    return entry


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one B=64 serving batch and one "
                             "B=64 training step")
    parser.add_argument("--ddp-worker", nargs=2, metavar=("KIND", "OUT"),
                        help=argparse.SUPPRESS)   # a rank of the ddp phase
    parser.add_argument("--tp-worker", metavar="OUT",
                        help=argparse.SUPPRESS)   # a rank of the tp phase
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if args.ddp_worker:
        ddp_worker(*args.ddp_worker)
        return 0
    if args.tp_worker:
        tp_worker(args.tp_worker)
        return 0
    info = phase_device()
    card = info["card"]
    phase_build()
    kern = phase_kernel(card)
    wide = phase_kernel_wide(card)
    warp_err = phase_warp_check()
    warp = phase_warp_time(card)
    fp32_err = phase_fp32(card)
    phase_train_fp32(card)
    serve = phase_serving(card)
    serve_all = phase_serving_all(card)
    exported = phase_export(card)
    benched = phase_bench(card)
    train = phase_training(card)
    phase_accumulation(card)
    optim_check = phase_optim_check(card)
    remat = phase_remat_check(card)
    mosaic = phase_mosaic_check(card)
    fit = phase_trainer(card)
    ddp = phase_ddp(card)
    tp = phase_tp(card)
    phase_jpeg_check(card)
    formats = phase_formats(card)
    predicted = {}
    fit_voc = phase_trainer_real(card, "trainer_voc", TRAINER_VOC_SETS,
                                 VOC_TREE, predict_after(card, predicted))
    fit_coco = phase_trainer_real(card, "trainer_coco", TRAINER_COCO_SETS,
                                  COCO_TREE)
    fit_cache = phase_trainer_coco_cache(card)
    fit_wider = phase_trainer_real(card, "trainer_widerperson",
                                   TRAINER_WIDER_SETS, WIDER_TREE)
    fit_options = {"SGD": phase_trainer_real(
        card, "trainer_options", TRAINER_OPTIONS_SETS, COCO_TREE)}
    for name, sets in TRAINER_OPTIONS_EPOCH_SETS.items():
        fit_options[name] = phase_trainer_real(
            card, f"trainer_options_{name.lower()}", sets, COCO_TREE)
    fit_bdd = phase_trainer_real(card, "trainer_bdd_ssd",
                                 TRAINER_BDD_SSD_SETS, BDD_TREE,
                                 scaled_after(card))
    tuner = fit_options["SGD"]["tuner"]
    emit({"phase": "trainer_options", "card": card,
          "lr_suggested": tuner["lr"], "lr_find_s": tuner["lr_find_s"],
          "batch_size_suggested": tuner["batch_size"],
          "scale_s": tuner["scale_s"], "trials": tuner["trials"],
          "budget_gb": tuner["budget_gb"],
          "images_per_sec": {k: [e["images_per_sec"] for e in v["epochs"]]
                             for k, v in fit_options.items()},
          "launches": {k: v["launches"] for k, v in fit_options.items()},
          "optimizer_tensors_restored": {
              k: v["restore"]["tensors_bit_equal"]
              for k, v in fit_options.items()},
          "optim_check": optim_check, "mosaic": mosaic,
          "remat_peak_mem_gb": remat["peak_mem_gb"]})
    yolo_err = phase_yolo_fp32(card)
    yolo_serve = phase_yolo_serving(card)
    yolo_train = phase_yolo_training(card)
    fit_v2 = phase_trainer(card, TRAINER_YOLOV2_SETS, "trainer_yolov2")
    anchor_err = phase_anchor_fp32(card)
    anchor_serve = phase_anchor_serving(card)
    anchor_train = phase_anchor_training(card)
    fit_anchor = {name: phase_trainer(card, sets,
                                      f"trainer_{name.lower()}")["launches"]
                  for name, sets in TRAINER_ANCHOR_SETS.items()}
    ckpt = phase_torch_ckpt(card)
    convs, conv_err = phase_conv_check(card)
    conv = phase_conv_time(card, convs)
    if args.profile:
        phase_profile(card)
    t = kern["timing"]
    err = max(kern["max_abs_err"], fp32_err, serve["max_abs_err"], yolo_err,
              anchor_err, anchor_serve["max_abs_err"])
    ta = t["anchor_b64"]
    w1, w64 = serve_all[1], serve_all[64]
    emit({"kernels": [{
        "name": "greedy_nms", "route": "cuda",
        "source": "objectdetectionpl_tpu_torch/csrc/greedy_nms.cu",
        "replaces": "objectdetectionpl_tpu/ops/pallas/nms_kernel.py:120",
        "launches": fit["launches"]["greedy_nms"],
        "launches_serving": serve["launches"],
        "launches_yolo_serving": yolo_serve,
        "launches_trainer_yolov2": fit_v2["launches"]["greedy_nms"],
        "launches_anchor_serving": anchor_serve["launches"],
        **{f"launches_trainer_{n.lower()}": c["greedy_nms"]
           for n, c in fit_anchor.items()},
        "launches_trainer_voc": fit_voc["launches"]["greedy_nms"],
        "launches_trainer_coco": fit_coco["launches"]["greedy_nms"],
        "launches_trainer_coco_cache": fit_cache["launches"]["greedy_nms"],
        "launches_trainer_widerperson": fit_wider["launches"]["greedy_nms"],
        **{f"launches_trainer_options_{k.lower()}": v["launches"]
           ["greedy_nms"] for k, v in fit_options.items()},
        "launches_trainer_bdd_ssd": fit_bdd["launches"]["greedy_nms"],
        "launches_predict_cli": predicted["launches"]["greedy_nms"],
        "launches_export": exported["launches"],
        "launches_export_cross_device": exported["cross_launches"],
        "launches_formats_fit": formats["fit"]["launches"]["greedy_nms"],
        "launches_formats_predict": formats["predict"]["greedy_nms"],
        "launches_export_fresh_interpreter": exported["fresh_launches"],
        "launches_predict_export":
            predicted["export"]["launches"]["greedy_nms"],
        "launches_bench": benched["launches"],
        "launches_ddp_cli_nccl": ddp["cli"]["greedy_nms"],
        "launches_torch_ckpt": ckpt["launches"]["greedy_nms"],
        "launches_torch_ckpt_yolov2_predict": ckpt["predict"]["greedy_nms"],
        "keep_equal": True,
        "max_abs_err": err, "max_abs_box_err": err,
        "ms": t[256]["ms"], "plain_ms": t[256]["plain_ms"],
        "bound_ms": t[256]["bound_ms"], "bound_by": t[256]["bound_by"],
        "library_ms": None, "shape": "B=256,K=300",
        "call_ms": t[256]["call_ms"], "chain_mean": t[256]["chain_mean"],
        "chain_max": t[256]["chain_max"],
        "ms_b1": t[1]["ms"], "call_ms_b1": t[1]["call_ms"],
        "plain_ms_b1": t[1]["plain_ms"], "bound_ms_b1": t[1]["bound_ms"],
        "bound_pairs": t[256]["bound_pairs"],
        "ms_b64_c80": t[64]["ms"], "bound_ms_b64_c80": t[64]["bound_ms"],
        "ms_anchor_b64": ta["ms"], "call_ms_anchor_b64": ta["call_ms"],
        "plain_ms_anchor_b64": ta["plain_ms"],
        "ms_anchor_b64_without_drop": ta["ms_without_drop"],
        "bound_ms_anchor_b64": ta["bound_ms"],
        "bound_by_anchor_b64": ta["bound_by"],
        "shape_anchor": f"B=64,K={ANCHOR_TOP_K}, class-agnostic, no merge, "
                        f"IoU 0.5, drop_lone_survivor",
        "card": card}, {
        "name": "greedy_nms_tiled", "route": "cuda",
        "source": "objectdetectionpl_tpu_torch/csrc/greedy_nms.cu",
        "replaces": "objectdetectionpl_tpu/ops/pallas/nms_kernel.py:120",
        "launches": serve_all["launches"],
        "keep_equal": True,
        "max_abs_err": max(wide["max_abs_err"], w1["max_abs_err"]),
        "ms": w1["ms"], "plain_ms": w1["plain_ms"],
        "bound_ms": w1["bound_ms"], "bound_by": w1["bound_by"],
        "bound_suppressed": w1["bound_suppressed"],
        "bound_ms_pairs": w1["bound_ms_pairs"],
        "bound_pairs": w1["bound_pairs"],
        "library_ms": None,
        "shape": f"B=1,K={SERVE_ALL_K}: a YOLOv5s-640 bf16 decode at "
                 f"conf_thres {SERVE_ALL_CONF}, 80 classes, class-aware, "
                 f"merge",
        "call_ms": w1["call_ms"], "chain_mean": w1["chain_mean"],
        "valid_rows": w1["valid_rows"],
        "ious_k_by_kept": w1["ious_k_by_kept"],
        "ms_b64": w64["ms"], "bound_ms_b64": w64["bound_ms"],
        "bound_ms_pairs_b64": w64["bound_ms_pairs"],
        "bound_pairs_b64": w64["bound_pairs"],
        **{f"ms_k{TOP_K}_b{B}": t[B]["tiled_ms"] for B in (1, 64, 256)},
        "chain_mean_b64": w64["chain_mean"],
        **{f"ms_random_c{c}_K{K}_B{B}": r["ms"]
           for (K, B, c), r in wide["timing"].items()},
        **{f"{key}_random_c1_K{SERVE_ALL_K}_B{B}":
           wide["timing"][(SERVE_ALL_K, B, 1)][key]
           for B in WIDE_TIME_B
           for key in ("bound_ms", "bound_ms_pairs", "plain_ms")},
        "segments_b1": w1["segments"], "segments_b64": w64["segments"],
        "images_checked_plain_b64": w64["images_checked_plain"],
        "device_kernels": ["greedy_nms_partition_kernel",
                           "greedy_nms_segment_kernel"],
        "card": card}, {
        "name": "affine_warp", "route": "cuda",
        "source": "objectdetectionpl_tpu_torch/csrc/affine_warp.cu",
        "replaces": "objectdetectionpl_tpu/ops/pallas/warp_kernel.py:154",
        "launches": fit["launches"]["affine_warp"],
        "launches_training": train["launches"],
        "launches_yolo_training": yolo_train,
        "launches_trainer_yolov2": fit_v2["launches"]["affine_warp"],
        "launches_anchor_training": anchor_train,
        **{f"launches_trainer_{n.lower()}": c["affine_warp"]
           for n, c in fit_anchor.items()},
        "launches_trainer_voc": fit_voc["launches"]["affine_warp"],
        "launches_trainer_coco": fit_coco["launches"]["affine_warp"],
        "launches_trainer_coco_cache": fit_cache["launches"]["affine_warp"],
        "launches_trainer_widerperson":
            fit_wider["launches"]["affine_warp"],
        **{f"launches_trainer_options_{k.lower()}": v["launches"]
           ["affine_warp"] for k, v in fit_options.items()},
        "launches_trainer_bdd_ssd": fit_bdd["launches"]["affine_warp"],
        "launches_remat_check": remat["launches"],
        "launches_ddp_per_rank": ddp["warp_per_rank"],
        "launches_ddp_cli_nccl": ddp["cli"]["affine_warp"],
        "launches_torch_ckpt": ckpt["launches"]["affine_warp"],
        "launches_tp_per_rank": tp["warp_per_rank"],
        "max_abs_err": warp_err,
        "ms": warp["ms"], "plain_ms": warp["plain_ms"],
        "bound_ms": warp["bound_ms"], "bound_by": warp["bound_by"],
        "library_ms": warp["library_ms"],
        "library": "F.affine_grid + F.grid_sample",
        "shape": f"K={WARP_K} of B={TRAIN_B},S={IMG},C=3, all warped",
        "call_ms": warp["call_ms"], "ms_mix": warp["ms_mix"],
        "used_mix": warp["used_mix"], "tail_ms": warp["tail_ms"],
        "card": card}, conv_entry("conv3x3_s1", ":121", conv, conv_err["fwd"],
                                  "fwd", "F.conv2d (cuDNN)", card),
        conv_entry("conv3x3_s1_wgrad", ":185", conv, conv_err["wgrad"],
                   "wgrad", "aten.convolution_backward, dw (cuDNN)", card)]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
