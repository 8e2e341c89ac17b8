"""Readings behind the correctness limits of a cell, on the card: the
numbers that sound runs of the program give over many seeds, and those
that the control (the reference in float8 e4m3 operands, one precision
below the configurations' bfloat16) and planted faults give.  Not run by
the benchmark's runs.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--seconds 2]

Serving cells: each seed's run with a short window, checked as a run
checks it; on the control seeds, the same detections with one answer
altered where it is produced (a kept box moved by 1 px, another's label
changed), and the control's head maps against the float32 reference's.
Training cells: each seed's program readings after its checked steps
(no window) against the float32 reference; the control's, the
reference's on half of each batch (the fault of half the batch left
out) and a state left unchanged, against the same; and, looked at, the
reference with its compute alone in float8 (``look_fp8_compute``).

One JSON line per reading, each judged by the cell's limits as a run
judges it (``correct``; a control or fault by the limits of the
numbers it reads).  Exits 1 where a program reading is not correct, or
a control or fault is; a ``look_`` reading may go either way.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(got: dict, want: dict) -> dict:
    """The numbers a training run compares (``train.compare``), and those
    looked at beside them: every step's loss gap, the worst parameter's
    first-gradient gap, the median parameter's change gap."""
    from perfbench.harness import train
    return {**train.compare(got, want),
            "loss_gap_steps": [abs(a - b) / abs(b) for a, b in
                               zip(got["losses"], want["losses"])],
            "grad_gap_worst": float(train.leaf_gaps(got, want,
                                                    "first_grad").max()),
            "change_gap_median": float(train.leaf_gaps(
                got, want, "change")[train.moved(want)].median())}


WRONG = []      # readings judged otherwise than they should be


def emit(limits: dict, kind: str, numbers: dict, **kw) -> None:
    """One reading, judged: a program's by every limit, a control's or a
    fault's by the limits of the numbers it reads."""
    from perfbench.harness import common
    if kind != "program":
        limits = {k: v for k, v in limits.items() if k in numbers}
    correct, _ = common.judge(numbers, limits)
    if not kind.startswith("look_") and correct != (kind == "program"):
        WRONG.append((kind, kw.get("seed")))
    print(json.dumps({"kind": kind, "correct": correct, **kw, **numbers}),
          flush=True)


def serve(cell, seeds, control_seeds, seconds, device):
    from perfbench.harness import common, serve as drv
    from perfbench.reference.layers import Numerics
    limits = cell["limits"]
    for seed in seeds:
        t0 = time.perf_counter()
        run = drv.ServeRun(cell, seed, device, traced=False)
        run.setup()
        out = run.window(seconds)
        run.release()
        emit(limits, "program", run.check(), seed=seed,
             batches=out["batches"], seconds=time.perf_counter() - t0)
        if seed in control_seeds:
            det = run.detections[min(run.detections)]
            kept = det[4].nonzero()
            det[0][tuple(kept[0])] += 1.0
            det[3][tuple(kept[-1])] += 1
            emit(limits, "fault_altered_answer", run.check(), seed=seed)
    for seed in control_seeds:
        run = drv.ServeRun(cell, seed, device, traced=False)
        cfg, tr = run.cfg, run.tr
        pool = drv.traffic.image_pool(seed, tr["pool_batches"], tr["batch"],
                                      cfg["model"]["img_size"], device)
        with common.float32_reference():
            w = drv.serving_weights(run.reference, cfg, tr, seed, device)
            worst = 0.0
            for i in sorted(run.sample):
                images = pool[i % len(pool)].to(device)
                maps = {}
                for name, numerics in (("f32", None), ("fp8", "fp8")):
                    model = (run.reference.build(cfg) if numerics is None
                             else run.reference.build(
                                 cfg, Numerics(numerics))).to(device).eval()
                    model.load_state_dict(
                        {k: Numerics(numerics or "float32").store(v)
                         for k, v in w.items()})
                    maps[name] = run.reference.forward_blocks(
                        model, images, tr["check"]["reference_rows"])
                    del model
                for g, r in zip(maps["fp8"], maps["f32"]):
                    worst = max(worst, float((g - r).norm() / r.norm()))
        emit(limits, "control", {"heads_rel_rms": worst}, seed=seed)
        common.free(device)


def train(cell, seeds, control_seeds, device):
    from perfbench.harness import common, train as drv
    from perfbench.reference.layers import Numerics
    limits = cell["limits"]
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        run = drv.TrainRun(cell, seed, device, traced=False)
        run.setup()
        got = run.program_readings()
        run.release()
        want = run.reference_steps()
        if seed in seeds:
            emit(limits, "program", readings(got, want), seed=seed,
                 seconds=time.perf_counter() - t0)
        if seed in control_seeds:
            B = run.tr["batch"]
            emit(limits, "control", readings(
                run.reference_steps(Numerics("fp8")), want), seed=seed)
            emit(limits, "look_fp8_compute", readings(
                run.reference_steps(Numerics("fp8_compute")), want),
                seed=seed)
            emit(limits, "fault_half_batch", readings(
                run.reference_steps(rows=slice(0, B // 2)), want),
                seed=seed)
            emit(limits, "fault_state_unchanged", readings(
                {**got, "change": got["change"] * 0}, want), seed=seed)
        common.free(device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch
    from perfbench.harness import manifest
    ints = lambda s: [int(x) for x in s.split(",") if x]
    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    if cell["traffic"]["kind"] == "serve":
        serve(cell, ints(args.seeds), ints(args.control_seeds), args.seconds,
              device)
    else:
        train(cell, ints(args.seeds), ints(args.control_seeds), device)
    if WRONG:
        print(f"judged otherwise than they should be: {WRONG}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
