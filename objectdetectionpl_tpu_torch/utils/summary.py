"""Model summary: the port of ``objectdetectionpl_tpu/utils/summary.py``.

A parameter table with one row per top-level module (name, class,
parameter count) and the total, written to ``<run_dir>/summary.txt``.  The
JAX package adds XLA's cost analysis, which has no counterpart here.
"""

from __future__ import annotations

import os

import torch


def model_summary(model: torch.nn.Module) -> str:
    rows = [(name, type(mod).__name__,
             sum(p.numel() for p in mod.parameters()))
            for name, mod in model.named_children()]
    rows.append(("(total)", type(model).__name__,
                 sum(p.numel() for p in model.parameters())))
    w = max(len(r[0]) for r in rows)
    c = max(len(r[1]) for r in rows)
    lines = [f"{'module':<{w}}  {'class':<{c}}  {'parameters':>12}"]
    lines += [f"{n:<{w}}  {k:<{c}}  {p:>12,}" for n, k, p in rows]
    return "\n".join(lines)


def save_summary(model: torch.nn.Module, out_dir: str) -> str:
    """Write summary.txt; returns its path."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "summary.txt")
    with open(path, "w") as f:
        f.write(model_summary(model) + "\n")
    return path
