"""Weight carry-over: flax ``params`` / ``batch_stats`` trees -> the port's state_dict.

The port's modules carry the flax auto-names, so a key is the flax variable
path joined by dots, with the leaf renamed:

==============================  ====================================
flax leaf                       port state_dict entry
==============================  ====================================
``params/.../kernel``           ``....weight``, [kh,kw,I,O] -> [O,I,kh,kw]
``params/.../bias``             ``....bias`` (head convs and BN)
``params/.../BatchNorm_N/scale``  ``....BatchNorm_N.weight``
``batch_stats/.../mean``        ``....running_mean``
``batch_stats/.../var``         ``....running_var``
==============================  ====================================

Inputs are nested dicts of numpy arrays; the caller converts from whatever
framework produced them.  Load the result with ``strict=True``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_dict_from_flax(params: Mapping, batch_stats: Mapping
                         ) -> Dict[str, torch.Tensor]:
    """Nested numpy dicts (flax variable layout) -> float32 torch state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for tree, names in ((params, _PARAM_LEAVES), (batch_stats, _STAT_LEAVES)):
        for path, leaf in _flatten(tree):
            arr = np.array(leaf, dtype=np.float32)     # a writable copy
            if path[-1] == "kernel":
                arr = arr.transpose(3, 2, 0, 1)
            key = ".".join(path[:-1] + (names[path[-1]],))
            out[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return out
