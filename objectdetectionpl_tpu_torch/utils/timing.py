"""Measuring on the card: its name and power limit, its peak rates,
host-inclusive time per call, and device time per call with CUDA events
behind a spin kernel.  The timers need CUDA."""

from __future__ import annotations

import subprocess
import time

import torch

# H100 SXM peaks (NVIDIA data sheet, 700 W), for the bounds: HBM bytes/s,
# non-tensor f32 FLOP/s, dense bf16 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# torch.cuda._sleep spins in clock cycles; 2 GHz is above the H100's boost
# clock, so a spin of ms * this lasts at least ms.
SPIN_CYCLES_PER_MS = 2_000_000


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def call_time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Host-inclusive ms per call: ``reps`` calls between synchronizes."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def time_ms(fn, reps: int) -> tuple:
    """(device ms per call, host-inclusive ms per call) of a function that
    launches a few kernels.

    For the device time the calls are queued behind a spin kernel long
    enough to hide the host's enqueue cost, so CUDA events see the device
    work alone; the run is repeated with a longer spin if the spin ended
    before the queue was full.  ``reps`` times the launches of one call
    must stay inside the launch queue's depth (about a thousand).
    """
    call_ms = call_time_ms(fn, reps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    spin_ms = 2.0 * call_ms * reps + 5.0
    for _ in range(4):
        torch.cuda._sleep(int(spin_ms * SPIN_CYCLES_PER_MS))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / reps, call_ms
        spin_ms *= 4
    raise RuntimeError("could not queue the timed calls behind the spin")
