"""RetinaNet (Lin et al., "Focal Loss for Dense Object Detection",
arXiv:1708.02002): ResNet-50-FPN P3-P7 with 4-conv 256-wide shared box
and class heads, 9 anchors a level, in plain float32 PyTorch.

The frozen reference of the port's ``models/retinanet.py``, with its
submodule names.  Input NHWC ``[B, S, S, 3]`` floats; output ``(loc [B,
A, 4], cls [B, A, C])``, anchors ordered P3..P7, row-major over (y, x,
anchor) a level.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.layers import (F32, Conv, ConvBN, Numerics,
                                        max_pool, resize_bilinear)

BLOCKS = (3, 4, 6, 3)


class Bottleneck(nn.Module):
    def __init__(self, c1, planes, stride=1, numerics=F32):
        super().__init__()
        out_ch = 4 * planes
        kw = dict(numerics=numerics)
        self.ConvBN_0 = ConvBN(c1, planes, 1, act="relu", **kw)
        self.ConvBN_1 = ConvBN(planes, planes, 3, stride, act="relu", **kw)
        self.ConvBN_2 = ConvBN(planes, out_ch, 1, act="linear", **kw)
        self.ConvBN_3 = (ConvBN(c1, out_ch, 1, stride, act="linear", **kw)
                         if stride != 1 or c1 != out_ch else None)
        self.numerics = numerics

    def forward(self, x):
        h = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        if self.ConvBN_3 is not None:
            x = self.ConvBN_3(x)
        return self.numerics.operand(F.relu(h + x))


class ResNetFPN(nn.Module):
    def __init__(self, numerics=F32):
        super().__init__()
        self.ConvBN_0 = ConvBN(3, 64, 7, 2, act="relu", numerics=numerics)
        self.stages, c, n = [], 64, 0
        for i, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                 BLOCKS)):
            stage = []
            for b in range(blocks):
                stride = 2 if i > 0 and b == 0 else 1
                self.add_module(f"Bottleneck_{n}", Bottleneck(
                    c, planes, stride, numerics=numerics))
                stage.append(f"Bottleneck_{n}")
                c, n = 4 * planes, n + 1
            self.stages.append(stage)
        conv = lambda c1, k, s=1: Conv(c1, 256, k, s, bias=True,
                                       numerics=numerics)
        self.Conv_0 = conv(2048, 3, 2)          # p6
        self.Conv_1 = conv(256, 3, 2)           # p7
        self.Conv_2 = conv(2048, 1)             # lateral c5
        self.Conv_3 = conv(256, 3)              # smooth p4
        self.Conv_4 = conv(1024, 1)             # lateral c4
        self.Conv_5 = conv(256, 3)              # smooth p3
        self.Conv_6 = conv(512, 1)              # lateral c3
        self.numerics = numerics

    def forward(self, x):
        q = self.numerics.operand
        x = max_pool(self.ConvBN_0(x), 3, 2, 1)
        feats = []
        for stage in self.stages:
            for name in stage:
                x = getattr(self, name)(x)
            feats.append(x)
        _, c3, c4, c5 = feats
        p6 = self.Conv_0(c5)
        p7 = self.Conv_1(q(F.relu(p6)))
        p5 = self.Conv_2(c5)
        p4 = self.Conv_3(q(resize_bilinear(p5, c4.shape[2:])
                           + self.Conv_4(c4)))
        p3 = self.Conv_5(q(resize_bilinear(p4, c3.shape[2:])
                           + self.Conv_6(c3)))
        return p3, p4, p5, p6, p7


class Head(nn.Module):
    def __init__(self, out_ch, numerics=F32):
        super().__init__()
        for i in range(4):
            self.add_module(f"Conv_{i}", Conv(256, 256, 3, bias=True,
                                              numerics=numerics))
        self.Conv_4 = Conv(256, out_ch, 3, bias=True, numerics=numerics)
        self.numerics = numerics

    def forward(self, x):
        for i in range(4):
            x = self.numerics.operand(F.relu(getattr(self, f"Conv_{i}")(x)))
        return self.Conv_4(x)


class RetinaNet(nn.Module):
    def __init__(self, num_classes: int, num_anchors: int = 9,
                 numerics: Numerics = F32):
        super().__init__()
        self.num_classes = num_classes
        self.ResNetFPN_0 = ResNetFPN(numerics)
        self.add_module("_Head_0", Head(num_anchors * 4, numerics))
        self.add_module("_Head_1", Head(num_anchors * num_classes, numerics))

    def forward(self, x):
        x = x.float().permute(0, 3, 1, 2)
        B = x.shape[0]
        locs, clss = [], []
        for fm in self.ResNetFPN_0(x):
            locs.append(self._Head_0(fm).permute(0, 2, 3, 1).reshape(B, -1, 4))
            clss.append(self._Head_1(fm).permute(0, 2, 3, 1)
                        .reshape(B, -1, self.num_classes))
        return torch.cat(locs, 1), torch.cat(clss, 1)


def build(cfg: dict, numerics: Numerics = F32) -> RetinaNet:
    m = cfg["model"]
    return RetinaNet(m["num_classes"], m["anchors_per_level"],
                     numerics=numerics)


def head_bias_priors(cfg: dict) -> dict:
    """The paper's class-head prior: the last class conv's bias
    ``-log((1 - pi) / pi)``, pi = 0.01; every other bias 0."""
    m = cfg["model"]
    pi = m["prior_probability"]
    n = m["anchors_per_level"] * m["num_classes"]
    return {"_Head_1.Conv_4.bias": [-math.log((1 - pi) / pi)] * n}


def anchor_wh(areas=(32 * 32.0, 64 * 64.0, 128 * 128.0, 256 * 256.0,
                     512 * 512.0), aspect_ratios=(0.5, 1.0, 2.0),
              scale_ratios=(1.0, 2 ** (1 / 3.0), 2 ** (2 / 3.0))
              ) -> np.ndarray:
    """[levels, 9, 2] anchor widths and heights in input pixels."""
    wh = []
    for s in areas:
        for ar in aspect_ratios:
            h = math.sqrt(s / ar)
            w = ar * h
            for sr in scale_ratios:
                wh.append([w * sr, h * sr])
    return np.asarray(wh, dtype=np.float32).reshape(len(areas), -1, 2)


def anchors(input_size: int) -> np.ndarray:
    """[A, 4] center-form anchors in input pixels over P3..P7, cell centres
    at ``(i + 0.5) * input_size / ceil(input_size / stride)``."""
    wh_table = anchor_wh()
    out = []
    for i in range(wh_table.shape[0]):
        fm = math.ceil(input_size / 2 ** (i + 3))
        grid = input_size / fm
        ar = np.arange(fm, dtype=np.float32)
        xs = np.tile(ar[None, :], (fm, 1))
        ys = np.tile(ar[:, None], (1, fm))
        xy = (np.stack([xs, ys], axis=-1) + 0.5) * grid
        xy = np.broadcast_to(xy[:, :, None, :], (fm, fm, 9, 2))
        wh = np.broadcast_to(wh_table[i][None, None], (fm, fm, 9, 2))
        out.append(np.concatenate([xy, wh], axis=-1).reshape(-1, 4))
    return np.concatenate(out, axis=0)


def loss(outputs, labels, boxes, mask, cfg: dict) -> torch.Tensor:
    """The focal loss and box regression (``losses.retinanet_loss``) over
    the configuration's anchors."""
    from perfbench.reference import losses
    anc = torch.from_numpy(anchors(cfg["model"]["img_size"])).to(
        outputs[0].device)
    return losses.retinanet_loss(outputs, labels, boxes, mask, cfg, anc)
