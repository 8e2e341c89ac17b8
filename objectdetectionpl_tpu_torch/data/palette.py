"""Deterministic 100-color drawing palette: the port's copy of
``objectdetectionpl_tpu/data/palette.py`` (a golden-ratio hue walk)."""

from __future__ import annotations

import colorsys

_N = 100


def _make():
    cols = []
    for i in range(_N):
        h = (i * 0.61803398875) % 1.0       # golden-ratio hue walk
        s = 0.65 + 0.35 * ((i * 7) % 3) / 2
        v = 0.75 + 0.25 * ((i * 5) % 2)
        r, g, b = colorsys.hsv_to_rgb(h, s, v)
        cols.append((int(r * 255), int(g * 255), int(b * 255)))
    return cols


COLORS = _make()
