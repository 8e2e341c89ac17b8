"""The port's serving bench (``objectdetectionpl_tpu_torch/bench.py``) and the
fused serving tail it can take, ``ops/nms.py::decode_select_yolov5``.

- ``decode_select_yolov5`` against JAX's (``exact_topk=True``), f32 maps
  drawn as ``tests/test_nms.py::test_decode_select_matches_dense_chain``
  draws them (B=3, 6 classes, 64 px, every image under-full, image 2 with
  one passing row a map, so 61 of its 64 rows fail the threshold): the same rows
  in the same order, values within ``rtol=1e-6, atol=1e-4`` (pixel
  coordinates; XLA's and torch's sigmoid may round apart).  Precondition,
  asserted: the selected scores are more than 1e-5 of their value apart,
  so the two frameworks cannot order them differently.
- In the port, select -> ``yolo_nms`` against dense decode -> ``yolo_nms``
  on the same maps, f32 and bf16: every field equal (``max(sigmoid(z)) ==
  sigmoid(max(z))``, the same rows, the same arithmetic).
- The two chains of the bench module at 64 px, B=2, bf16: detections
  equal.
- ``python -m objectdetectionpl_tpu_torch.bench --device cpu --batch 1
  --iters 1`` (dense and ``--prefilter``): one JSON line with bench.py's
  keys and the port's, and the NMS ran warmup + iters times (its plain
  version, counted; CUDA counts launches).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from objectdetectionpl_tpu.ops import anchors as jax_anchors
from objectdetectionpl_tpu.ops import nms as jax_nms
from objectdetectionpl_tpu_torch import bench
from objectdetectionpl_tpu_torch.models import build_model
from objectdetectionpl_tpu_torch.ops import anchors as anchor_lib
from objectdetectionpl_tpu_torch.ops import nms
from objectdetectionpl_tpu_torch.ops.cuda import nms_kernel
from objectdetectionpl_tpu_torch.utils import export as export_lib

torch.set_num_threads(2)

B, C, TOP_K = 3, 6, 64
ANCHORS, STRIDES = anchor_lib.YOLOV5_ANCHORS, anchor_lib.YOLOV5_STRIDES


def _maps(seed=0):
    """tests/test_nms.py's maps: thinned obj, image 2 nearly empty."""
    rng = np.random.RandomState(seed)
    outputs = []
    for stride in STRIDES:
        g = 64 // stride
        x = rng.randn(B, 3, g, g, 5 + C).astype(np.float32) * 2.0
        x[..., 4] -= 2.0
        x[2, :, :, :, 4] = -8.0
        x[2, 0, 0, 0, 4] = 4.0
        outputs.append(x)
    return outputs


def test_decode_select_equals_jax():
    maps = _maps()
    want = np.asarray(jax_nms.decode_select_yolov5(
        [jnp.asarray(m) for m in maps], jax_anchors.YOLOV5_ANCHORS,
        jax_anchors.YOLOV5_STRIDES, C, top_k=TOP_K, conf_thres=0.5,
        exact_topk=True))
    got = nms.decode_select_yolov5([torch.from_numpy(m) for m in maps],
                                   ANCHORS, STRIDES, C, top_k=TOP_K,
                                   conf_thres=0.5).numpy()
    assert got.shape == want.shape == (B, TOP_K, 5 + C)
    obj = want[..., 4]
    score = np.where(obj >= 0.5, obj * want[..., 5:].max(-1), -1.0)
    for s in score:                                # precondition
        passing = s[s > 0]
        assert (np.abs(np.diff(passing)) / passing[1:]).min() > 1e-5
    n_pass = (score > 0).sum(axis=1)
    assert n_pass[2] == 3 and (n_pass < TOP_K).all()   # all under-full
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_select_then_nms_equals_dense_then_nms(dtype):
    maps = [torch.from_numpy(m).to(dtype) for m in _maps(seed=3)]
    dense = nms.yolo_nms(nms.decode_yolov5_predictions(maps, ANCHORS,
                                                       STRIDES, C),
                         0.5, 0.4, TOP_K)
    cand = nms.decode_select_yolov5(maps, ANCHORS, STRIDES, C, top_k=TOP_K)
    assert cand.dtype == dtype
    got = nms.yolo_nms(cand, 0.5, 0.4, TOP_K)
    assert 0 < int(got.valid[2].sum()) <= 3 < int(got.valid[0].sum())
    for name, g, w in zip(got._fields, got, dense):
        assert torch.equal(g, w), name


def test_bench_chains_detect_alike():
    """The bench's dense and prefilter modules on the same weights and
    batch at 64 px, bf16: the same detections."""
    model = build_model("YOLOv5", bench.NUM_CLASSES, dtype=torch.bfloat16,
                        device="cpu", seed=0)
    raw = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(0))
    outs = []
    for prefilter in (False, True):
        fn = export_lib.build_inference_fn(
            model, model.state_dict(), bench.postprocess(prefilter),
            fold_preproc=True)
        assert fn.fold
        with torch.inference_mode():
            outs.append(fn(raw))
    assert int(outs[0][4].sum()) > 0
    for d, p in zip(*outs):
        assert torch.equal(d, p)


@pytest.mark.parametrize("prefilter", [False, True],
                         ids=["dense", "prefilter"])
def test_bench_cli_on_cpu(monkeypatch, capsys, prefilter):
    calls = []
    plain = nms_kernel.greedy_nms_plain

    def counting(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return plain(*args, **kwargs)

    monkeypatch.setattr(nms_kernel, "greedy_nms_plain", counting)
    argv = ["--device", "cpu", "--batch", "1", "--iters", "1"]
    res = bench.main(argv + (["--prefilter"] if prefilter else []))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res
    assert {"metric", "value", "unit", "vs_baseline"} <= set(line)
    assert line["unit"] == "images/sec/chip" and line["value"] > 0
    assert (line["batch"], line["iters"], line["warmup"],
            line["prefilter"]) == (1, 1, bench.WARMUP, prefilter)
    assert line["card"] is None and line["nms_launches"] == 0
    assert calls == [(1, bench.TOP_K, 4)] * (bench.WARMUP + 1)
