"""YOLOv3: Darknet53 with a 3-scale upsample + concat head.

The PyTorch counterpart of ``objectdetectionpl_tpu/models/yolov3.py``, with
the flax submodule names (``Darknet53_0``, ``_DetectSeq_0`` .. ``_2``,
``Residual_N``) so weights carry over one to one.  Input NHWC
``[B, S, S, 3]`` of any dtype.  Output: a list of 3 raw maps
``[B, 3*(5+C), g, g]`` at strides (32, 16, 8).
"""

from __future__ import annotations

import torch
from torch import nn

from objectdetectionpl_tpu_torch.nn.blocks import (Conv, ConvBN, Residual,
                                                   upsample2x)

# Darknet53 residual groups: (channels, residual blocks).
_GROUPS = [(64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)]


class Darknet53(nn.Module):
    """Feature extractor returning (c5 1024ch, tap 512ch, tap 256ch)."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ConvBN_0 = ConvBN(3, 32, 3, dtype=dtype)
        c, r = 32, 0
        for g, (ch, n) in enumerate(_GROUPS):
            self.add_module(f"ConvBN_{g + 1}",
                            ConvBN(c, ch, 3, 2, dtype=dtype))
            for _ in range(n):
                self.add_module(f"Residual_{r}",
                                Residual(ch, ch // 2, dtype=dtype))
                r += 1
            c = ch

    def forward(self, x):
        x = self.ConvBN_0(x)
        taps, r = {}, 0
        for g, (ch, n) in enumerate(_GROUPS):
            x = getattr(self, f"ConvBN_{g + 1}")(x)
            for _ in range(n):
                x = getattr(self, f"Residual_{r}")(x)
                r += 1
            taps[ch] = x
        return x, taps[512], taps[256]


class _DetectSeq(nn.Module):
    """(1x1, 3x3) x 3 alternating ConvBNs with a tap after the fifth, then
    the detection conv (with bias)."""

    def __init__(self, c1: int, mid: int, out_ch: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = c1
        for i in range(6):
            co = mid * 2 if i % 2 else mid
            self.add_module(f"ConvBN_{i}", ConvBN(c, co, 3 if i % 2 else 1,
                                                  dtype=dtype))
            c = co
        self.Conv_0 = Conv(c, out_ch, 1, bias=True, dtype=dtype)

    def forward(self, x):
        for i in range(5):
            x = getattr(self, f"ConvBN_{i}")(x)
        return self.Conv_0(self.ConvBN_5(x)), x


class YOLOv3(nn.Module):
    def __init__(self, num_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        out_ch = 3 * (5 + num_classes)
        self.Darknet53_0 = Darknet53(dtype)
        self.add_module("_DetectSeq_0", _DetectSeq(1024, 512, out_ch, dtype))
        self.ConvBN_0 = ConvBN(512, 256, 1, dtype=dtype)
        self.add_module("_DetectSeq_1",
                        _DetectSeq(256 + 512, 256, out_ch, dtype))
        self.ConvBN_1 = ConvBN(256, 128, 1, dtype=dtype)
        self.add_module("_DetectSeq_2",
                        _DetectSeq(128 + 256, 128, out_ch, dtype))

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)    # NHWC -> NCHW view
        c5, s_res, k_res = self.Darknet53_0(x)
        out0, tap = self._DetectSeq_0(c5)
        h = torch.cat([upsample2x(self.ConvBN_0(tap)), s_res], dim=1)
        out1, tap = self._DetectSeq_1(h)
        h = torch.cat([upsample2x(self.ConvBN_1(tap)), k_res], dim=1)
        out2, _ = self._DetectSeq_2(h)
        return [out0, out1, out2]
