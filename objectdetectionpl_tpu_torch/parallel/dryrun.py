"""A multi-process dry run: one data-parallel train step of four families.

The port's twin of ``__graft_entry__.dryrun_multichip``.  JAX runs one
sharded step on an n-device mesh in one process; here n processes, ranks
of one process group on this host, each run the distributed train step
(``train/step.py``) on their shard of JAX's drawn batch, one image a rank
and microbatch: YOLOv2, YOLOv5s and RetinaNet at 64 px with two
microbatches, SSD at 300 px (its default-box ladder) with one.  Every rank
must report a finite loss, the same on every rank.

    python -m objectdetectionpl_tpu_torch.parallel.dryrun --n 2 [--device cpu]

runs it over gloo, every rank on the one card (``device.resolve_device``:
CUDA, or an error without it) unless ``--device`` names another device.  :func:`spawn` starts the ranks with torchrun's
environment; the tests start their own workers with it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Sequence

REPO = Path(__file__).resolve().parents[2]

NUM_CLASSES = 3
TIMEOUT_S = 900.0       # the dry run's ranks, compiles included
RUNS = (("YOLOv2", 64, 2), ("YOLOv5", 64, 2), ("RetinaNet", 64, 2),
        ("SSD", 300, 1))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(args: Sequence[str], nprocs: int, timeout_s: float = 600.0,
          env: Optional[dict] = None) -> List[str]:
    """Run ``python args...`` as ranks 0..nprocs-1 of one process group on
    this host (torchrun's environment, a free localhost port, the
    repository on ``PYTHONPATH``); returns each rank's standard output.
    When a rank fails or the time runs out, the others are killed (a rank
    left alone would wait in a collective) and this raises with the
    failed rank's output."""
    port = str(free_port())
    base = {**os.environ, **(env or {})}
    base["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [base.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        procs, logs = [], []
        for rank in range(nprocs):
            out = open(os.path.join(tmp, f"{rank}.out"), "w+")
            logs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, *args], cwd=REPO, stdout=out,
                stderr=subprocess.STDOUT,
                env={**base, "RANK": str(rank), "LOCAL_RANK": str(rank),
                     "WORLD_SIZE": str(nprocs), "LOCAL_WORLD_SIZE":
                     str(nprocs), "MASTER_ADDR": "127.0.0.1",
                     "MASTER_PORT": port}))
        deadline = time.monotonic() + timeout_s
        failed = None
        while any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.returncode not in (None, 0)), None)
            if failed is not None or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
            log.close()
    if failed is None:
        failed = next((r for r, p in enumerate(procs) if p.returncode != 0),
                      None)
    if failed is not None:
        raise RuntimeError(f"rank {failed} of {nprocs} failed (exit "
                           f"{procs[failed].returncode}):\n"
                           f"{outputs[failed][-6000:]}")
    return outputs


def worker(device: str) -> None:
    """One rank: the four families' train steps on its column of JAX's
    draws; prints one JSON line a family."""
    import numpy as np
    import torch

    from objectdetectionpl_tpu_torch.config import Config
    from objectdetectionpl_tpu_torch.models import build_model
    from objectdetectionpl_tpu_torch.ops import losses
    from objectdetectionpl_tpu_torch.parallel import distributed
    from objectdetectionpl_tpu_torch.train.optim import build_optimizer
    from objectdetectionpl_tpu_torch.train.state import create_train_state
    from objectdetectionpl_tpu_torch.train.step import make_train_step

    distributed.maybe_initialize("gloo")
    n, rank = distributed.data_shard()
    cfg = Config(optimizer="Adam", lr=1e-3, weight_decay=1e-5)
    try:
        for name, img, accum in RUNS:
            model = build_model(name, NUM_CLASSES, yolov5_type="Yolov5s",
                                device=device, seed=0)
            opt = build_optimizer(cfg, model.parameters())
            state = create_train_state(model, opt)
            distributed.broadcast_state(state)
            step = make_train_step(model, losses.make_loss(name, NUM_CLASSES,
                                                           img), opt, accum)
            # the JAX dry run's draws; this rank's image of each microbatch
            rng = np.random.RandomState(0)
            images = rng.rand(accum, n, img, img, 3).astype(np.float32)
            labels = rng.randint(0, NUM_CLASSES,
                                 (accum, n, 5)).astype(np.int32)
            boxes = np.tile(np.asarray([0.5, 0.5, 0.2, 0.2], np.float32),
                            (accum, n, 5, 1))
            mask = np.ones((accum, n, 5), bool)
            batch = [torch.from_numpy(a[:, rank:rank + 1]).to(device)
                     for a in (images, labels, boxes, mask)]
            state, metrics = step(state, *batch)
            print(json.dumps({"rank": rank, "model": name, "img": img,
                              "accum": accum,
                              "loss": float(metrics["loss"])}), flush=True)
    finally:
        distributed.shutdown()


def dryrun_multichip(n: int, device=None) -> dict:
    """One data-parallel train step of each family on ``n`` ranks (gloo,
    every rank on ``device``, resolved as every entry point resolves it);
    returns {family: loss}.  Raises unless every rank reports a finite
    loss equal to rank 0's (relative 1e-6)."""
    from objectdetectionpl_tpu_torch.device import resolve_device

    outs = spawn(["-m", "objectdetectionpl_tpu_torch.parallel.dryrun",
                  "--worker", "--device", str(resolve_device(device))], n,
                 TIMEOUT_S)
    losses = {}
    for rank, out in enumerate(outs):
        rows = [json.loads(line) for line in out.splitlines()
                if line.startswith("{")]
        if [r["model"] for r in rows] != [r[0] for r in RUNS]:
            raise AssertionError(f"rank {rank} reported {rows}:\n{out}")
        for r in rows:
            ref = losses.setdefault(r["model"], r["loss"])
            if not math.isfinite(r["loss"]) or not math.isclose(
                    r["loss"], ref, rel_tol=1e-6):
                raise AssertionError(f"rank {rank} {r['model']}: loss "
                                     f"{r['loss']}, rank 0 {ref}")
    for name, loss in losses.items():
        print(f"[dryrun_multichip] n={n} {name} one data-parallel train "
              f"step OK, loss={loss:.4f}")
    return losses


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=2, help="ranks")
    p.add_argument("--device", default=None,
                   help="every rank's device (default: the card)")
    p.add_argument("--worker", action="store_true",
                   help="run as one rank (torchrun's environment)")
    args = p.parse_args(argv)
    if args.worker:
        worker(args.device)
    else:
        dryrun_multichip(args.n, args.device)


if __name__ == "__main__":
    main()
