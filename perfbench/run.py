"""Run one cell of ``BENCHMARK.json`` once on the card this machine holds.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the checks on standard error and one JSON line last on standard
output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` (each number
compared, with its limit).  Exits non-zero, printing no result, without
the card the cell needs, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, cell=None) -> int:
    """``device`` and ``cell`` stand in for the card and the manifest in
    the tests, which run a cell on the CPU at a small size."""
    args = parse(argv)
    import torch
    from perfbench.harness import common, manifest, runner
    cell = manifest.cell(args.workload) if cell is None else cell
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                  f"this machine has {have}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             device, common.Clock(T0))
    bad = common.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}", file=sys.stderr)
        return 3
    common.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
