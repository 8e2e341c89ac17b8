"""CLI entry point: config -> datamodule -> model -> fit -> test.

The port of ``objectdetectionpl_tpu/cli/run.py``:

    python -m objectdetectionpl_tpu_torch.cli.run [configs/config.yaml] \\
        [--set KEY VALUE]... [--device cpu]

Any config field can be overridden with ``--set KEY VALUE`` (the value is
read as an int, a float, true/false, or else a string).  The run uses the
CUDA card unless ``--device`` names another; without CUDA and without
``--device`` it raises.  With ``tune`` on, the tuner runs before the fit
(``train/tune.py``): ``auto_lr_find`` sets the scheduler's base rate and
``cfg.lr``; ``auto_scale_batch_size`` ("power") prints its suggestion and
does not apply it, as in JAX.  ``main`` returns the test results (or None
when ``test`` is off).

Data-parallel on N cards of one host (``batch_size`` is each rank's)::

    python -m torch.distributed.run --nproc_per_node N \\
        -m objectdetectionpl_tpu_torch.cli.run configs/config.yaml

With torchrun's environment ``main`` joins the process group (NCCL, or
gloo with ``--device cpu``) before it builds the Trainer, and leaves it
at exit.
"""

from __future__ import annotations

import argparse
import sys

import torch

from objectdetectionpl_tpu_torch.config import load_config
from objectdetectionpl_tpu_torch.parallel import distributed
from objectdetectionpl_tpu_torch.train.loop import Trainer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config", nargs="?", default=None,
                   help="YAML config path (the JAX package's key surface)")
    p.add_argument("--set", nargs=2, action="append", metavar=("KEY", "VALUE"),
                   default=[], help="override a config field")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda, which must exist)")
    return p.parse_args(argv)


def _coerce(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    return v


def main(argv=None):
    args = parse_args(argv)
    overrides = {k: _coerce(v) for k, v in args.set}
    cfg = load_config(args.config, overrides)
    joined = (not torch.distributed.is_initialized()
              and distributed.maybe_initialize(
                  "gloo" if args.device == "cpu" else None))
    if joined:
        print(f"[run] distributed: process {distributed.process_index()} / "
              f"{distributed.process_count()}")
    try:
        return _run(cfg, args.device)
    finally:
        if joined:
            distributed.shutdown()


def _run(cfg, device):
    trainer = Trainer(cfg, device=device)
    print(f"[run] model={cfg.model_name} dataset={cfg.data_module} "
          f"img_size={cfg.effective_img_size} batch={cfg.batch_size} "
          f"accum={cfg.accumulate_grad_batches} device={trainer.device}")
    if cfg.tune:
        from objectdetectionpl_tpu_torch.train import tune
        if cfg.auto_lr_find:
            lr = tune.auto_lr_find(trainer)
            print(f"[tune] auto_lr_find suggests lr={lr:.2e}")
            trainer.scheduler.base_lr = lr
            cfg.lr = lr
        if cfg.auto_scale_batch_size == "power":
            bs = tune.auto_scale_batch_size(trainer, start=cfg.batch_size)
            print(f"[tune] auto_scale_batch_size suggests batch_size={bs}")
    try:
        if cfg.max_epochs > 0:
            trainer.fit()
        else:
            trainer.maybe_restore()   # eval-only: max_epochs 0 + checkpoint
        if cfg.test:
            trainer.dm.setup("test")
            return trainer.test()
        return None
    finally:
        trainer.ckpt.close()
        trainer.writer.close()


if __name__ == "__main__":
    main(sys.argv[1:])
