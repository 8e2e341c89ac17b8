"""One run of one cell: set-up, the window, the readings and the check,
assembled into the result line.

The traffic file's ``kind`` names the module that runs it,
``perfbench/harness/<kind>.py``, which gives ``Run`` (``setup``,
``window``, ``release``, ``check``), ``end_to_end`` and ``counts``.  An
end-to-end metric ``<base>.<group>`` takes the value the module gives
``<base>``: cells whose runs spread alike share a group, and so a bound.
"""

from __future__ import annotations

import importlib

import torch

from perfbench.harness import common, manifest
from perfbench.harness import trace as trace_lib


def kind_module(kind: str):
    """The module that runs traffic of ``kind``."""
    return importlib.import_module(f"perfbench.harness.{kind}")


def per_layer(cell: dict, ctx: dict) -> dict:
    """Each per-layer metric of the cell whose reader finds something."""
    out = {}
    for m in cell["per_layer"]:
        value = manifest.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell: dict, seed: int, seconds: float, traced: bool,
             device: torch.device, clock: common.Clock) -> dict:
    kind = cell["traffic"]["kind"]
    module = kind_module(kind)
    run = module.Run(cell, seed, device, traced)
    run.setup()
    setup_s = clock.since()
    out = run.window(seconds)
    info = common.device_info(device, cell["chips"])
    result = {"attempted": out.get("batches", out.get("steps")),
              "failed": out["failed"] + getattr(run, "failed_setup", 0)}
    if traced:
        tr = trace_lib.from_profiler(out.pop("profile"))
        ctx = {"kind": kind, "trace": tr, "out": out,
               "counts": module.counts(run, out), "traffic": cell["traffic"],
               "config": cell["config"],
               "end_to_end": module.end_to_end(out, cell["traffic"],
                                               setup_s)}
        metrics = per_layer(cell, ctx)
        info["busy_s"] = trace_lib.busy_s(tr)
        info["window_s"] = trace_lib.window_s(tr)
        result["breakdown"] = {"device_ops": trace_lib.top_device_ops(tr),
                               "idle_gaps": trace_lib.idle_by_host(tr)}
    else:
        values = module.end_to_end(out, cell["traffic"], setup_s)
        units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        metrics = {name: {"value": values[name.split(".")[0]],
                          "unit": unit} for name, unit in units.items()}
    out.pop("profile", None)
    run.release()
    numbers = run.check()
    correct, checks = common.judge(numbers, cell["limits"])
    return {"correct": correct and result["attempted"] > 0, **result,
            "metrics": metrics, "device": info, **(
                {"breakdown": result.pop("breakdown")}
                if "breakdown" in result else {}),
            "checks": checks}
