"""What every traffic kind's run shares: the device, the result line,
the checks."""

from __future__ import annotations

import contextlib
import gc
import json
import sys
import time

import numpy as np
import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "objectdetectionpl_tpu")


def p95_ms(seconds: list) -> float:
    return float(np.percentile(np.asarray(seconds) * 1e3, 95))


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that a run may not load,
    compared whole: the port's name begins with the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(device, count: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


@contextlib.contextmanager
def float32_reference():
    """float32 products in full float32: TF32 off for matmuls and convs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, ``{name: {"value", "limit"}}``): every number compared
    must be present, finite and at most its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not np.isfinite(value) or value > limit:
            ok = False
    return ok, checks


def emit(result: dict) -> None:
    """The checks on standard error, then the result as the last line of
    standard output, its ``checks`` key last."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


class Clock:
    """Host seconds since the process started the harness."""

    def __init__(self, t0: float = None):
        self.t0 = time.perf_counter() if t0 is None else t0

    def since(self) -> float:
        return time.perf_counter() - self.t0
