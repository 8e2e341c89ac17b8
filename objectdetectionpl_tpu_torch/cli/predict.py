"""Inference CLI: run a trained checkpoint on image files.

The port of ``objectdetectionpl_tpu/cli/predict.py``:

    python -m objectdetectionpl_tpu_torch.cli.predict configs/config.yaml \\
        --images a.jpg b.jpg [--out-dir preds/] [--set KEY VALUE]... \\
        [--export model.pt2 | --program model.pt2] [--device cpu]

Builds the config's Trainer (its DataModule too, for the class names),
restores the best checkpoint of its run directory, then serves each image
on its own: read as ``cv2.imread`` reads it (``native.decode_image``:
JPEG -- CMYK, cut and damaged files too -- PNG and BMP, picked by the
file's first bytes and turned by its EXIF orientation), resize to the model's img_size as
the JAX CLI does (cv2's uint8 INTER_LINEAR, then /255), ``predict_step``
(the NMS kernel once per image).  Prints one JSON line per image (boxes
xyxy in pixels of the resized input, scores, class names) and, with
``--out-dir``, writes ``<stem>_pred.png`` panels, each image's line and
panel before the next image is read, as the JAX CLI does.  Any
``nms_top_k`` is served (above 1024 the NMS kernel works in tiles).
``--export PATH`` first writes the serving chain
(uint8 -> cast, /255 folded into YOLOv5's stem or divided -> forward ->
decode -> NMS op) with the evaluation weights (EMA when on) at batch 1 and
the model's img_size as a ``torch.export`` program (``utils/export.py``),
and returns when no ``--images`` are given.  ``--program PATH`` serves
the images through a saved program instead of the checkpoint, moved to
``--device`` by ``utils.export.load`` whatever device it was exported on.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from objectdetectionpl_tpu_torch.cli.run import _coerce
from objectdetectionpl_tpu_torch.config import load_config
from objectdetectionpl_tpu_torch.data import native
from objectdetectionpl_tpu_torch.data.parsers.common import load_image_rgb
from objectdetectionpl_tpu_torch.data.pipeline import numpy_preproc_u8
from objectdetectionpl_tpu_torch.train.loop import Trainer, _to_host
from objectdetectionpl_tpu_torch.utils import export as export_lib
from objectdetectionpl_tpu_torch.utils import viz


def resize_u8(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 [H, W, 3] -> uint8 [1, S, S, 3]: cv2's uint8 INTER_LINEAR to
    S x S (the host library's uint8 resize, else
    ``pipeline.numpy_preproc_u8``)."""
    return (native.preproc_batch([img], size, False, u8=True)
            or numpy_preproc_u8([img], size, False))[0]


def resize_input(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 [H, W, 3] -> float32 [1, S, S, 3] in [0, 1], the JAX CLI's
    input bit for bit: :func:`resize_u8`, then /255 in float32."""
    return resize_u8(img, size).astype(np.float32) / np.float32(255.0)


def predict_images(trainer: Trainer, paths: Sequence[str],
                   on_image: Optional[Callable] = None,
                   program: Optional[Callable] = None) -> List[Dict]:
    """One ``predict_step`` per image -> the JSON records of the JAX CLI:
    ``image``, ``boxes_xyxy`` (rounded to 2 decimals), ``scores`` (4) and
    ``labels`` (class names).  With ``program`` (a loaded ``.pt2``,
    ``utils.export.load``) each image's uint8 input goes through it
    instead.  With ``on_image``, ``on_image(record, panel)`` runs after
    each image, before the next is read; ``panel()`` draws the input with
    its boxes (uint8)."""
    trainer.model.eval()
    out = []
    for path in paths:
        u8 = resize_u8(load_image_rgb(path), trainer.img_size)
        x = u8.astype(np.float32) / np.float32(255.0)
        if program is None:
            res = trainer.predict_step(
                trainer.state, torch.from_numpy(x).to(trainer.device))
            res = (res.boxes, res.scores, res.labels, res.valid)
        else:
            boxes, _, scores, labels, valid = program(
                torch.from_numpy(u8).to(trainer.device))
            res = (boxes, scores, labels, valid)
        boxes, scores, labels, valid = (a[0] for a in _to_host(res))
        out.append({
            "image": path,
            "boxes_xyxy": boxes[valid].round(2).tolist(),
            "scores": scores[valid].round(4).tolist(),
            "labels": [trainer.classes[int(c)] for c in labels[valid]],
        })
        if on_image is not None:
            on_image(out[-1], lambda: viz.draw_boxes(x[0], boxes, labels,
                                                     valid=valid))
    return out


def export_serving(trainer: Trainer, path: str) -> None:
    """Write the Trainer's serving chain with its evaluation weights (the
    EMA parameters when on, over the module's BN statistics) to ``path``
    at batch 1 and the model's img_size."""
    state_dict = {**trainer.model.state_dict(), **trainer.state.eval_params}
    fn = export_lib.build_inference_fn(trainer.model, state_dict,
                                       trainer.postprocess)
    export_lib.save(path, fn, batch=1, img_size=trainer.img_size)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config", nargs="?", default=None)
    p.add_argument("--set", nargs=2, action="append", metavar=("KEY", "VALUE"),
                   default=[], help="override a config field")
    p.add_argument("--images", nargs="+", default=[])
    p.add_argument("--out-dir", default=None,
                   help="write <stem>_pred.png panels here")
    p.add_argument("--export", default=None,
                   help="write the serving program (.pt2) to this path")
    p.add_argument("--program", default=None,
                   help="serve the images through this saved .pt2 "
                        "(exported on any device) instead of the checkpoint")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, which must exist)")
    return p.parse_args(argv)


def main(argv=None) -> List[Dict]:
    args = parse_args(argv)
    cfg = load_config(args.config, {k: _coerce(v) for k, v in args.set})
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)

    def on_image(record, panel):
        print(json.dumps(record), flush=True)
        if args.out_dir:
            stem = os.path.splitext(os.path.basename(record["image"]))[0]
            viz.write_png(os.path.join(args.out_dir, f"{stem}_pred.png"),
                          panel())

    trainer = Trainer(cfg, device=args.device)
    try:
        if args.program:
            program = export_lib.load(args.program, trainer.device)
            return predict_images(trainer, args.images, on_image, program)
        trainer.maybe_restore()
        if args.export:
            export_serving(trainer, args.export)
            print(f"[predict] exported serving graph to {args.export}")
            if not args.images:
                return []
        return predict_images(trainer, args.images, on_image)
    finally:
        trainer.ckpt.close()
        trainer.writer.close()


if __name__ == "__main__":
    main(sys.argv[1:])
