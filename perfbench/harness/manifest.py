"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration, whose file is
``configs[].file``, and a traffic mix, ``perfbench/traffic/<traffic>.json``.
The limits of its correctness check are
``perfbench/limits/<cell>.json``.  A metric's reader is
``perfbench/metrics/<metric name>.py``; a metric
belongs to a cell when its ``workloads`` list names the cell, or when it
has no such list.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict = None, root: Path = ROOT) -> dict:
    """``{"workload", "config", "traffic", "end_to_end", "per_layer",
    "chips"}`` of the cell ``name``."""
    bench = load(root) if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if len(found) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfg = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    return {
        "workload": w,
        "chips": w["chips"],
        "config": json.loads((root / cfg["file"]).read_text()),
        "traffic": json.loads((root / "perfbench" / "traffic"
                               / f"{w['traffic']}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if _applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if _applies(m, name)],
        "limits": json.loads((root / "perfbench" / "limits"
                              / f"{name}.json").read_text())["limits"],
    }


def reader(name: str, root: Path = ROOT):
    """The module ``perfbench/metrics/<name>.py`` (its ``read(ctx)``)."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference(cfg: dict):
    """The plain reference module a configuration names."""
    return importlib.import_module(f"perfbench.reference.{cfg['reference']}")
