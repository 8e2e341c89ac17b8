"""Independent random streams of one run, each derived from ``--seed`` and
a name: the same seed gives the same weights, images, targets and
uniforms; any whole number is a seed."""

from __future__ import annotations

import zlib

import numpy as np
import torch


def stream(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of run seed ``seed``."""
    seq = np.random.SeedSequence([abs(int(seed)) % 2 ** 64, int(seed < 0),
                                  zlib.crc32(name.encode())])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def numpy_rng(seed: int, name: str) -> np.random.Generator:
    return np.random.default_rng(stream(seed, name))


def torch_generator(seed: int, name: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream(seed, name))
