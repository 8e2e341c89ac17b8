"""Reading the profiler: a bounded span of a run traced in memory, turned
into plain lists that the per-layer metric readers take.

A trace, as the readers see it, is a dict:

- ``device``: ``[(name, start_us, end_us, launch_us, launch_tid)]``, each
  kernel, copy or memset the card ran, with the start and thread of the
  host call that launched it (None where the profiler shows none);
- ``host``: ``[(name, start_us, end_us, tid)]``, the host operations and
  the benchmark's ``record_function`` ranges;
- ``window``: ``(start_us, end_us)``, the traced span.

Nothing is written to disk.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Iterable, Optional

WINDOW = "perfbench.window"
# the benchmark's own record_function ranges; the profiler mirrors each
# on the device as an annotation, which is no device activity
RANGES = (WINDOW, "postprocess", "augment", "loss")


def _end_ns(e) -> int:
    end = getattr(e, "end_ns", None)
    return end() if end is not None else e.start_ns() + e.duration_ns()


def _on_device(e) -> bool:
    """A kernel, copy or memset: an event on the card that is not the
    device-side mirror of a host annotation."""
    if str(e.device_type()).endswith("CPU"):
        return False
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind() in ("kernel", "gpu_memcpy", "gpu_memset",
                          "concurrent kernel")
    user = getattr(e, "is_user_annotation", None)
    if user is not None and user():
        return False
    return e.name() not in RANGES


def _runtime(name: str) -> bool:
    """A CUDA runtime call on the host (its correlation id is
    CUPTI's, shared with the device activity it started)."""
    return name.startswith("cu")


def from_profiler(prof) -> dict:
    """The trace of a stopped ``torch.profiler.profile`` whose span holds
    one ``record_function(WINDOW)`` range.  A device activity's launch is
    the host call that started it (matched by CUPTI's correlation id), or
    else the host operation the profiler links it to."""
    events = prof.profiler.kineto_results.events()
    ops, calls, device, host = {}, {}, [], []
    for e in events:
        if str(e.device_type()).endswith("CPU"):
            rec = (e.name(), e.start_ns() / 1e3, _end_ns(e) / 1e3,
                   e.start_thread_id())
            host.append(rec)
            if _runtime(rec[0]):
                calls[e.correlation_id()] = rec
            elif e.linked_correlation_id() == 0:
                ops[e.correlation_id()] = rec
    for e in events:
        if _on_device(e):
            at = calls.get(e.correlation_id()) or ops.get(
                e.linked_correlation_id())
            device.append((e.name(), e.start_ns() / 1e3, _end_ns(e) / 1e3,
                           at[1] if at else None, at[3] if at else None))
    spans = [h for h in host if h[0] == WINDOW]
    if len(spans) != 1:
        raise RuntimeError(f"the trace holds {len(spans)} {WINDOW} ranges")
    return {"device": device, "host": host,
            "window": (spans[0][1], spans[0][2])}


def busy_intervals(trace: dict) -> list:
    """The union of the device's activity, clipped to the window, as
    sorted disjoint ``[start, end]`` pairs."""
    w0, w1 = trace["window"]
    spans = sorted((max(s, w0), min(e, w1)) for _, s, e, _, _ in
                   trace["device"] if e > w0 and s < w1)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_s(trace: dict) -> float:
    return sum(e - s for s, e in busy_intervals(trace)) / 1e6


def window_s(trace: dict) -> float:
    w0, w1 = trace["window"]
    return (w1 - w0) / 1e6


def idle_share(trace: dict) -> Optional[float]:
    """% of the traced span in which the card runs nothing; None where
    nothing ran on it."""
    busy = busy_s(trace)
    return 100.0 * (1.0 - busy / window_s(trace)) if busy > 0 else None


def kernel_s(trace: dict, contains: str, count: int) -> float:
    """Device seconds of the last ``count`` activities whose name contains
    ``contains`` and that ran inside the window: the kernels a traced
    span launched, counted by the program's launch counters.  (The span
    ends on a sync, so nothing launched after it runs inside it; the
    profiler links a kernel launched through ctypes to no host
    operation, so the count, not the link, picks them.)"""
    w0, w1 = trace["window"]
    found = sorted((s, e) for n, s, e, _, _ in trace["device"]
                   if contains in n and e > w0 and s < w1)
    return sum(e - s for s, e in found[-count:]) / 1e6 if count else 0.0


def range_device_s(trace: dict, name: str) -> Optional[tuple]:
    """(device seconds, ranges): the device time of the activities
    launched inside the host ranges called ``name`` (by the launching
    operation's start and thread), and how many such ranges the trace
    holds; None where it holds none."""
    ranges = defaultdict(list)
    count = 0
    for n, s, e, tid in trace["host"]:
        if n == name:
            ranges[tid].append((s, e))
            count += 1
    if not ranges:
        return None
    for r in ranges.values():
        r.sort()
    starts = {tid: [s for s, _ in r] for tid, r in ranges.items()}
    total = 0.0
    for _, s, e, t, tid in trace["device"]:
        if t is None or tid not in ranges:
            continue
        i = bisect.bisect_right(starts[tid], t) - 1
        if i >= 0 and t <= ranges[tid][i][1]:
            total += e - s
    return total / 1e6, count


def top_device_ops(trace: dict, n: int = 10) -> list:
    """``[[name, seconds]]`` of the ``n`` activities with most device time
    in the window, summed by name."""
    w0, w1 = trace["window"]
    by = defaultdict(float)
    for name, s, e, _, _ in trace["device"]:
        if e > w0 and s < w1:
            by[name] += (min(e, w1) - max(s, w0)) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _gaps(trace: dict) -> list:
    w0, w1 = trace["window"]
    gaps, t = [], w0
    for s, e in busy_intervals(trace):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def _innermost(host: Iterable, times: list) -> list:
    """For each of the sorted ``times``, (start, name) of the innermost
    host operation running then on any thread, the one that started last;
    None where none runs."""
    per_thread = defaultdict(list)
    for name, s, e, tid in host:
        per_thread[tid].append((s, -e, name))
    best = [None] * len(times)
    for ops in per_thread.values():
        ops.sort()
        stack, i = [], 0
        for j, t in enumerate(times):
            while i < len(ops) and ops[i][0] <= t:
                s, neg_e, name = ops[i]
                while stack and -stack[-1][1] < s:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and -stack[-1][1] < t:
                stack.pop()
            if stack and (best[j] is None or stack[-1][0] > best[j][0]):
                best[j] = (stack[-1][0], stack[-1][2])
    return best


def idle_by_host(trace: dict, n: int = 10) -> list:
    """``[[host operation, seconds]]``: the device's idle time in the
    window, summed by the innermost host operation running when each idle
    gap began; the ``n`` largest."""
    gaps = _gaps(trace)
    labels = _innermost(trace["host"], [a for a, _ in gaps])
    by = defaultdict(float)
    for (a, b), lab in zip(gaps, labels):
        by[lab[1] if lab else "(no host operation)"] += (b - a) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
