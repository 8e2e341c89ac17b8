"""RetinaNet: ResNet-50-FPN (p3..p7) with shared 4-conv box and class heads.

The PyTorch counterpart of ``objectdetectionpl_tpu/models/retinanet.py``,
with the flax submodule names so weights carry over one to one
(``utils/weights.py``).  flax numbers the FPN convs in the order Python
builds them: ``Conv_0`` p6, ``Conv_1`` p7, ``Conv_2`` the 1x1 lateral of
c5, ``Conv_3`` the smoothing conv of p4 (built before its lateral
``Conv_4``), ``Conv_5`` the smoothing conv of p3, ``Conv_6`` its lateral.
Input NHWC ``[B, S, S, 3]`` of any dtype (cast to the compute dtype).
Output ``(loc [B, A, 4], cls [B, A, C])``, A anchors ordered p3..p7,
row-major over (y, x, anchor) per level, as ``ops.anchors.retina_anchors``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from objectdetectionpl_tpu_torch.nn.blocks import (Conv, ConvBN, max_pool,
                                                   resize_bilinear)

BLOCKS = (3, 4, 6, 3)


class Bottleneck(nn.Module):
    """ResNet bottleneck, expansion 4: 1x1, 3x3 (strided), 1x1, plus the
    input (projected by ``ConvBN_3`` where the shape changes), then ReLU."""

    def __init__(self, c1: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out_ch = 4 * planes
        self.ConvBN_0 = ConvBN(c1, planes, 1, act="relu", dtype=dtype)
        self.ConvBN_1 = ConvBN(planes, planes, 3, stride, act="relu",
                               dtype=dtype)
        self.ConvBN_2 = ConvBN(planes, out_ch, 1, act="linear", dtype=dtype)
        self.ConvBN_3 = (ConvBN(c1, out_ch, 1, stride, act="linear",
                                dtype=dtype)
                         if stride != 1 or c1 != out_ch else None)

    def forward(self, x):
        h = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        if self.ConvBN_3 is not None:
            x = self.ConvBN_3(x)
        return F.relu(h + x)


class ResNetFPN(nn.Module):
    """Returns (p3, p4, p5, p6, p7), all 256 channels."""

    def __init__(self, num_blocks=BLOCKS, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ConvBN_0 = ConvBN(3, 64, 7, 2, act="relu", dtype=dtype)
        self.stages, c, n = [], 64, 0
        for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                 num_blocks)):
            stage = []
            for b in range(blocks):
                stride = 2 if i > 0 and b == 0 else 1
                self.add_module(f"Bottleneck_{n}",
                                Bottleneck(c, planes, stride, dtype=dtype))
                stage.append(f"Bottleneck_{n}")
                c, n = 4 * planes, n + 1
            self.stages.append(stage)
        conv = lambda c1, k, s=1: Conv(c1, 256, k, s, bias=True, dtype=dtype)
        self.Conv_0 = conv(2048, 3, 2)          # p6
        self.Conv_1 = conv(256, 3, 2)           # p7
        self.Conv_2 = conv(2048, 1)             # lateral c5
        self.Conv_3 = conv(256, 3)              # smooth p4
        self.Conv_4 = conv(1024, 1)             # lateral c4
        self.Conv_5 = conv(256, 3)              # smooth p3
        self.Conv_6 = conv(512, 1)              # lateral c3

    def forward(self, x):
        x = max_pool(self.ConvBN_0(x), 3, 2, 1)
        feats = []
        for stage in self.stages:
            for name in stage:
                x = getattr(self, name)(x)
            feats.append(x)
        _, c3, c4, c5 = feats
        p6 = self.Conv_0(c5)
        p7 = self.Conv_1(F.relu(p6))
        p5 = self.Conv_2(c5)
        p4 = self.Conv_3(resize_bilinear(p5, c4.shape[2:]) + self.Conv_4(c4))
        p3 = self.Conv_5(resize_bilinear(p4, c3.shape[2:]) + self.Conv_6(c3))
        return p3, p4, p5, p6, p7


class _Head(nn.Module):
    """4 x (3x3 conv 256 + ReLU), then the 3x3 output conv."""

    def __init__(self, out_ch: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(4):
            self.add_module(f"Conv_{i}", Conv(256, 256, 3, bias=True,
                                              dtype=dtype))
        self.Conv_4 = Conv(256, out_ch, 3, bias=True, dtype=dtype)

    def forward(self, x):
        for i in range(4):
            x = F.relu(getattr(self, f"Conv_{i}")(x))
        return self.Conv_4(x)


class RetinaNet(nn.Module):
    """The two heads are shared: one module each, applied to every level."""

    def __init__(self, num_classes: int, num_anchors: int = 9,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.ResNetFPN_0 = ResNetFPN(dtype=dtype)
        self.add_module("_Head_0", _Head(num_anchors * 4, dtype=dtype))
        self.add_module("_Head_1", _Head(num_anchors * num_classes,
                                         dtype=dtype))

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)    # NHWC -> NCHW view
        B = x.shape[0]
        locs, clss = [], []
        for fm in self.ResNetFPN_0(x):
            # NCHW -> NHWC, then (y, x, anchor) rows as the flax reshape
            locs.append(self._Head_0(fm).permute(0, 2, 3, 1)
                        .reshape(B, -1, 4))
            clss.append(self._Head_1(fm).permute(0, 2, 3, 1)
                        .reshape(B, -1, self.num_classes))
        return torch.cat(locs, 1), torch.cat(clss, 1)
