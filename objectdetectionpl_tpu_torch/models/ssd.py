"""SSD-300 with a VGG16 backbone.

The PyTorch counterpart of ``objectdetectionpl_tpu/models/ssd.py``, with
the flax submodule names so weights carry over one to one
(``utils/weights.py``): VGG16 through conv4_3 (pool3 in ceil mode) in
``_VGGStack_0``, pool4 .. conv5_3 and a 3x3/1 pool5 in ``_VGGStack_1``,
the dilated conv6 and 1x1 conv7 (``ConvBN_0``, ``ConvBN_1``), the extra
blocks (``ConvBN_2`` .. ``ConvBN_7`` and the two 3x3 VALID convs
``Conv_0``, ``Conv_1``), and per scale a class head then a box head
(``Conv_2``, ``Conv_3``, ..., ``Conv_13``) with (4, 6, 6, 6, 4, 4)
default boxes per cell.  ``use_bn`` puts BatchNorm on the 13 VGG convs
(the vgg16_bn layout); the extras and heads never have it.

Initialisation, as the JAX module's for training from scratch: the VGG
convs He/fan-out normal, the extras and heads Xavier normal (truncated),
through ``Conv.init``.  Input NHWC ``[B, 300, 300, 3]`` of any dtype.
Output ``(loc [B, 8732, 4], cls [B, 8732, 1+C])``, class channel 0 the
background.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from objectdetectionpl_tpu_torch.nn.blocks import Conv, ConvBN, max_pool

# VGG16 'D' configuration through conv4_3 / conv5_3.
_VGG_F1 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "Mceil", 512, 512, 512]
_VGG_BASE1 = ["M", 512, 512, 512, "M311"]

ANCHORS_PER_CELL: Sequence[int] = (4, 6, 6, 6, 4, 4)
FEATURE_CHANNELS = (512, 1024, 512, 256, 256, 256)


def _ceil_pool(x):
    """2x2/2 max-pool with ceil_mode: an odd last row or column pools
    alone (JAX pads it with -inf)."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


class _VGGStack(nn.Module):
    def __init__(self, cfg, c1: int, dtype: torch.dtype = torch.float32,
                 use_bn: bool = False):
        super().__init__()
        self.cfg = list(cfg)
        i = 0
        for spec in self.cfg:
            if isinstance(spec, int):
                self.add_module(f"ConvBN_{i}", ConvBN(
                    c1, spec, 3, act="relu", dtype=dtype, use_bn=use_bn,
                    init="kaiming_fan_out"))
                c1, i = spec, i + 1

    def forward(self, x):
        i = 0
        for spec in self.cfg:
            if spec == "M":
                x = max_pool(x, 2, 2)
            elif spec == "Mceil":
                x = _ceil_pool(x)
            elif spec == "M311":
                x = max_pool(x, 3, 1, 1)
            else:
                x = getattr(self, f"ConvBN_{i}")(x)
                i += 1
        return x


class SSD(nn.Module):
    def __init__(self, num_classes: int, dtype: torch.dtype = torch.float32,
                 use_bn: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        cls_ch = num_classes + 1
        self.add_module("_VGGStack_0", _VGGStack(_VGG_F1, 3, dtype, use_bn))
        self.add_module("_VGGStack_1", _VGGStack(_VGG_BASE1, 512, dtype,
                                                 use_bn))
        relu_conv = lambda c1, c2, k, s=1, d=1: ConvBN(
            c1, c2, k, s, act="relu", dtype=dtype, use_bn=False, dilation=d,
            init="xavier_normal")
        self.ConvBN_0 = relu_conv(512, 1024, 3, d=3)      # dilated conv6
        self.ConvBN_1 = relu_conv(1024, 1024, 1)           # conv7
        self.ConvBN_2 = relu_conv(1024, 256, 1)
        self.ConvBN_3 = relu_conv(256, 512, 3, s=2)
        self.ConvBN_4 = relu_conv(512, 128, 1)
        self.ConvBN_5 = relu_conv(128, 256, 3, s=2)
        self.ConvBN_6 = relu_conv(256, 128, 1)
        self.ConvBN_7 = relu_conv(256, 128, 1)
        conv = lambda c1, c2, pad: Conv(c1, c2, 3, bias=True, dtype=dtype,
                                        padding=pad, init="xavier_normal")
        self.Conv_0 = conv(128, 256, 0)                    # 5 -> 3, VALID
        self.Conv_1 = conv(128, 256, 0)                    # 3 -> 1, VALID
        for i, (c, a) in enumerate(zip(FEATURE_CHANNELS, ANCHORS_PER_CELL)):
            self.add_module(f"Conv_{2 + 2 * i}", conv(c, a * cls_ch, 1))
            self.add_module(f"Conv_{3 + 2 * i}", conv(c, a * 4, 1))

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)    # NHWC -> NCHW view
        feats = [self._VGGStack_0(x)]                          # 38x38x512
        x = self.ConvBN_1(self.ConvBN_0(self._VGGStack_1(feats[0])))
        feats.append(x)                                        # 19x19x1024
        x = self.ConvBN_3(self.ConvBN_2(x))
        feats.append(x)                                        # 10x10x512
        x = self.ConvBN_5(self.ConvBN_4(x))
        feats.append(x)                                        # 5x5x256
        x = F.relu(self.Conv_0(self.ConvBN_6(x)))
        feats.append(x)                                        # 3x3x256
        feats.append(F.relu(self.Conv_1(self.ConvBN_7(x))))    # 1x1x256

        B = x.shape[0]
        locs, clss = [], []
        for i, f in enumerate(feats):
            # NCHW -> NHWC, then (y, x, box) rows as the flax reshape
            cl = getattr(self, f"Conv_{2 + 2 * i}")(f).permute(0, 2, 3, 1)
            bb = getattr(self, f"Conv_{3 + 2 * i}")(f).permute(0, 2, 3, 1)
            clss.append(cl.reshape(B, -1, self.num_classes + 1))
            locs.append(bb.reshape(B, -1, 4))
        return torch.cat(locs, 1), torch.cat(clss, 1)
