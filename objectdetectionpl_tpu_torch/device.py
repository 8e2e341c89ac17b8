"""The port's one device rule: CUDA unless the caller asks for something else.

Entry points take ``device=None`` and resolve it here.  With no device given
and no CUDA present this raises instead of dropping to the CPU, so a run that
was meant for the card can never silently measure the host.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises if CUDA is absent); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
