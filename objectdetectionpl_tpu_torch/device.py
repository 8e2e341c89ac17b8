"""The port's one device rule: CUDA unless the caller asks for something else.

Entry points take ``device=None`` and resolve it here.  With no device given
and no CUDA present this raises instead of dropping to the CPU, so a run that
was meant for the card can never silently measure the host.  Under a
process group each rank takes the card of its ``LOCAL_RANK``.

Also the per-device caches of constant tables (:func:`device_table`), which
a trace reads but never fills.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from objectdetectionpl_tpu_torch.parallel import distributed

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises if CUDA is absent), or under a process
    group ``cuda:LOCAL_RANK``, made the current device (the kernels'
    launches act on it); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if not torch.distributed.is_initialized():
            return torch.device("cuda")
        dev = torch.device("cuda", distributed.local_rank())
        torch.cuda.set_device(dev)
        return dev
    return torch.device(device)


def device_table(cache: dict, key, make: Callable[[], torch.Tensor]
                 ) -> torch.Tensor:
    """``cache[key]``, filled by ``make()`` on the first call: a constant
    table copied to the device once, since a copy from the host in every
    batch would wait for the card.  Made outside inference mode, so a
    table first made for serving also serves a training step's backward.

    A trace (``torch.export``, ``torch.compile``, any fake-tensor mode)
    reads the cached table (a real tensor, which it captures as a constant
    of the program) and never fills the cache: a table it made would be
    the trace's fake tensor, and every later eager call would get it.
    Without a cached table the trace makes its own.
    """
    if key in cache:
        return cache[key]
    if (torch.compiler.is_exporting() or torch.compiler.is_compiling()
            or torch._guards.detect_fake_mode() is not None):
        return make()
    with torch.inference_mode(False):
        table = make()
    cache[key] = table
    return table
