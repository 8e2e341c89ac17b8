"""Profiler hooks and device memory: the port of ``objectdetectionpl_tpu/utils/profiler.py``.

``torch.profiler`` traces (CPU, and CUDA when a card is in use) written as
Chrome traces under ``log_dir``; ``device_memory_stats`` reads the CUDA
caching allocator under the JAX package's keys.
"""

from __future__ import annotations

import contextlib
import os

import torch


def start_trace(log_dir: str) -> "torch.profiler.profile":
    """Start a profiler; hand it to :func:`stop_trace`."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, log_dir: str) -> str:
    """Stop ``prof`` and write its Chrome trace; returns the file's path."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.stop()
    path = os.path.join(log_dir, f"trace-{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """Context manager wrapping a region in a profiler trace."""
    if not enabled:
        yield
        return
    prof = start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace(prof, log_dir)


def device_memory_stats() -> dict:
    """Memory of the current card's caching allocator: ``bytes_in_use``,
    ``peak_bytes_in_use``, ``bytes_limit`` (the card's memory).  ``{}``
    when no card is in use."""
    if not torch.cuda.is_initialized():
        return {}
    i = torch.cuda.current_device()
    stats = torch.cuda.memory_stats(i)
    return {f"cuda:{i}": {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(i).total_memory}}
