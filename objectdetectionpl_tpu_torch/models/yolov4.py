"""YOLOv4: CSPDarknet53 backbone + SPP/PAN neck + 3-scale head.

The PyTorch counterpart of ``objectdetectionpl_tpu/models/yolov4.py``, with
the flax submodule names (``DownSample1_0``, ``DownSampleCSP_0`` .. ``_3``,
``Neck_0``, ``MishResBlock_0``, head ``Conv_0`` .. ``_2``) so weights carry
over one to one.  Input NHWC ``[B, S, S, 3]`` of any dtype.  Output: a list
of 3 raw maps ``[B, 3*(5+C), g, g]`` at strides (8, 16, 32).
"""

from __future__ import annotations

import torch
from torch import nn

from objectdetectionpl_tpu_torch.nn.blocks import (Conv, ConvBN,
                                                   MishResBlock, max_pool,
                                                   upsample2x)


def _add_convs(module: nn.Module, specs, act: str, dtype) -> None:
    """``ConvBN_i`` for each (c1, c2, kernel[, stride]) in ``specs``."""
    for i, spec in enumerate(specs):
        module.add_module(f"ConvBN_{i}", ConvBN(*spec, act=act, dtype=dtype))


class DownSample1(nn.Module):
    """The stem stage: 3x3 then a stride-2 3x3 to 64 channels, with
    full-width CSP routes around one residual pair (mish)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        _add_convs(self, [(3, 32, 3), (32, 64, 3, 2), (64, 64, 1),
                          (64, 64, 1), (64, 32, 1), (32, 64, 3), (64, 64, 1),
                          (128, 64, 1)], "mish", dtype)

    def forward(self, x):
        x2 = self.ConvBN_1(self.ConvBN_0(x))
        x3 = self.ConvBN_2(x2)
        x4 = self.ConvBN_3(x2)
        x6 = self.ConvBN_5(self.ConvBN_4(x4)) + x4
        return self.ConvBN_7(torch.cat([self.ConvBN_6(x6), x3], dim=1))


class DownSampleCSP(nn.Module):
    """A CSP downsample stage: stride-2 3x3, two 1x1 routes, ``nblocks``
    residual pairs on one, concat, 1x1 fuse (mish)."""

    def __init__(self, c1: int, out_ch: int, nblocks: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        half = out_ch // 2
        _add_convs(self, [(c1, out_ch, 3, 2), (out_ch, half, 1),
                          (out_ch, half, 1), (half, half, 1),
                          (out_ch, out_ch, 1)], "mish", dtype)
        self.MishResBlock_0 = MishResBlock(half, nblocks, dtype=dtype)

    def forward(self, x):
        x1 = self.ConvBN_0(x)
        route = self.ConvBN_1(x1)
        h = self.ConvBN_3(self.MishResBlock_0(self.ConvBN_2(x1)))
        return self.ConvBN_4(torch.cat([h, route], dim=1))


class Neck(nn.Module):
    """SPP (13/9/5 max-pools) + the PAN top-down path (leaky)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        _add_convs(self, [
            (1024, 512, 1), (512, 1024, 3), (1024, 512, 1),          # 0-2
            (2048, 512, 1), (512, 1024, 3), (1024, 512, 1),          # 3-5
            (512, 256, 1), (512, 256, 1),                            # 6-7
            (512, 256, 1), (256, 512, 3), (512, 256, 1), (256, 512, 3),
            (512, 256, 1),                                           # 8-12
            (256, 128, 1), (256, 128, 1),                            # 13-14
            (256, 128, 1), (128, 256, 3), (256, 128, 1), (128, 256, 3),
            (256, 128, 1)], "leaky", dtype)                          # 15-19

    def _chain(self, x, first: int, last: int):
        for i in range(first, last + 1):
            x = getattr(self, f"ConvBN_{i}")(x)
        return x

    def forward(self, d5, d4, d3):
        x3 = self._chain(d5, 0, 2)
        spp = torch.cat([max_pool(x3, 13, 1, 6), max_pool(x3, 9, 1, 4),
                         max_pool(x3, 5, 1, 2), x3], dim=1)
        x6 = self._chain(spp, 3, 5)
        up = upsample2x(self.ConvBN_6(x6))
        x13 = self._chain(torch.cat([self.ConvBN_7(d4), up], dim=1), 8, 12)
        up = upsample2x(self.ConvBN_13(x13))
        x20 = self._chain(torch.cat([self.ConvBN_14(d3), up], dim=1), 15, 19)
        return x20, x13, x6


class YOLOv4(nn.Module):
    def __init__(self, num_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        out_ch = 3 * (5 + num_classes)
        self.DownSample1_0 = DownSample1(dtype)
        for i, (c1, c2, n) in enumerate([(64, 128, 2), (128, 256, 8),
                                         (256, 512, 8), (512, 1024, 4)]):
            self.add_module(f"DownSampleCSP_{i}",
                            DownSampleCSP(c1, c2, n, dtype))
        self.Neck_0 = Neck(dtype)
        _add_convs(self, [
            (128, 256, 3),                                           # 0: s8
            (128, 256, 3, 2), (512, 256, 1), (256, 512, 3), (512, 256, 1),
            (256, 512, 3), (512, 256, 1), (256, 512, 3),             # 1-7: s16
            (256, 512, 3, 2), (1024, 512, 1), (512, 1024, 3),
            (1024, 512, 1), (512, 1024, 3), (1024, 512, 1),
            (512, 1024, 3)], "leaky", dtype)                     # 8-14: s32
        for i, c in enumerate((256, 512, 1024)):
            self.add_module(f"Conv_{i}", Conv(c, out_ch, 1, bias=True,
                                              dtype=dtype))

    def _chain(self, x, first: int, last: int):
        for i in range(first, last + 1):
            x = getattr(self, f"ConvBN_{i}")(x)
        return x

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)    # NHWC -> NCHW view
        d3 = self.DownSampleCSP_1(self.DownSampleCSP_0(self.DownSample1_0(x)))
        d4 = self.DownSampleCSP_2(d3)
        d5 = self.DownSampleCSP_3(d4)
        n20, n13, n6 = self.Neck_0(d5, d4, d3)

        out_s8 = self.Conv_0(self.ConvBN_0(n20))
        x8 = self._chain(torch.cat([self.ConvBN_1(n20), n13], dim=1), 2, 6)
        out_s16 = self.Conv_1(self.ConvBN_7(x8))
        h = self._chain(torch.cat([self.ConvBN_8(x8), n6], dim=1), 9, 14)
        out_s32 = self.Conv_2(h)
        return [out_s8, out_s16, out_s32]
