"""YOLOv5 (ultralytics/yolov5 v2.0 ``models/yolov5s.yaml``) in plain
float32 PyTorch: Focus stem, BottleneckCSP, SPP, the PANet head and
LeakyReLU(0.1).

The frozen reference of the port's ``models/yolov5.py``, with its
submodule names.  Input NHWC ``[B, S, S, 3]`` floats in [0, 1]; output the
three maps ``[B, 3, g, g, 5+C]`` at strides (8, 16, 32).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.layers import (F32, BatchNorm, Conv, ConvBN,
                                        Numerics, max_pool, space_to_depth,
                                        upsample2x)

STRIDES = (8, 16, 32)
HEADS = {8: "Conv_2", 16: "Conv_1", 32: "Conv_0"}


def scale_ch(c: int, wm: float) -> int:
    return int(round(c * wm, 1))


def scale_depth(n: int, dm: float) -> int:
    return max(1, int(round(n * dm, 1)))


class BottleneckV5(nn.Module):
    def __init__(self, c1, c2, shortcut=True, e=0.5, numerics=F32):
        super().__init__()
        c_ = int(c2 * e)
        self.ConvBN_0 = ConvBN(c1, c_, 1, numerics=numerics)
        self.ConvBN_1 = ConvBN(c_, c2, 3, numerics=numerics)
        self.add = shortcut and c1 == c2
        self.numerics = numerics

    def forward(self, x):
        h = self.ConvBN_1(self.ConvBN_0(x))
        return self.numerics.operand(x + h) if self.add else h


class BottleneckCSP(nn.Module):
    def __init__(self, c1, c2, n=1, shortcut=True, e=0.5, numerics=F32):
        super().__init__()
        c_ = int(c2 * e)
        self.ConvBN_0 = ConvBN(c1, c_, 1, numerics=numerics)
        self.n = n
        for i in range(n):
            self.add_module(f"BottleneckV5_{i}", BottleneckV5(
                c_, c_, shortcut, e=1.0, numerics=numerics))
        self.Conv_0 = Conv(c_, c_, 1, numerics=numerics)
        self.Conv_1 = Conv(c1, c_, 1, numerics=numerics)
        self.BatchNorm_0 = BatchNorm(2 * c_, numerics=numerics)
        self.ConvBN_1 = ConvBN(2 * c_, c2, 1, numerics=numerics)
        self.numerics = numerics

    def forward(self, x):
        y1 = self.ConvBN_0(x)
        for i in range(self.n):
            y1 = getattr(self, f"BottleneckV5_{i}")(y1)
        y = torch.cat([self.Conv_0(y1), self.Conv_1(x)], dim=1)
        return self.ConvBN_1(self.numerics.operand(
            F.leaky_relu(self.BatchNorm_0(y), 0.1)))


class SPP(nn.Module):
    def __init__(self, c1, c2, kernels=(5, 9, 13), numerics=F32):
        super().__init__()
        c_ = c1 // 2
        self.kernels = tuple(kernels)
        self.ConvBN_0 = ConvBN(c1, c_, 1, numerics=numerics)
        self.ConvBN_1 = ConvBN(c_ * (len(kernels) + 1), c2, 1,
                               numerics=numerics)

    def forward(self, x):
        x = self.ConvBN_0(x)
        return self.ConvBN_1(torch.cat(
            [x] + [max_pool(x, k, 1, k // 2) for k in self.kernels], dim=1))


class Focus(nn.Module):
    def __init__(self, c1, c2, kernel=3, numerics=F32):
        super().__init__()
        self.ConvBN_0 = ConvBN(4 * c1, c2, kernel, numerics=numerics)

    def forward(self, x):
        return self.ConvBN_0(space_to_depth(x, 2))


class YOLOv5(nn.Module):
    def __init__(self, num_classes: int, depth_multiple: float,
                 width_multiple: float, num_anchors: int = 3,
                 numerics: Numerics = F32):
        super().__init__()
        C = lambda c: scale_ch(c, width_multiple)
        D = lambda n: scale_depth(n, depth_multiple)
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        no = (5 + num_classes) * num_anchors
        kw = dict(numerics=numerics)

        def csp(c1, c2, n, sc=True):
            return BottleneckCSP(C(c1), C(c2), D(n), shortcut=sc, **kw)

        self.Focus_0 = Focus(3, C(64), 3, **kw)
        self.ConvBN_0 = ConvBN(C(64), C(128), 3, 2, **kw)
        self.BottleneckV5_0 = BottleneckV5(C(128), C(128), **kw)
        self.ConvBN_1 = ConvBN(C(128), C(256), 3, 2, **kw)
        self.BottleneckCSP_0 = csp(256, 256, 9)
        self.ConvBN_2 = ConvBN(C(256), C(512), 3, 2, **kw)
        self.BottleneckCSP_1 = csp(512, 512, 9)
        self.ConvBN_3 = ConvBN(C(512), C(1024), 3, 2, **kw)
        self.SPP_0 = SPP(C(1024), C(1024), **kw)
        self.BottleneckCSP_2 = csp(1024, 1024, 6)
        self.BottleneckCSP_3 = csp(1024, 1024, 3, sc=False)
        self.Conv_0 = Conv(C(1024), no, 1, bias=True, **kw)
        self.ConvBN_4 = ConvBN(C(1024) + C(512), C(512), 1, **kw)
        self.BottleneckCSP_4 = csp(512, 512, 3, sc=False)
        self.Conv_1 = Conv(C(512), no, 1, bias=True, **kw)
        self.ConvBN_5 = ConvBN(C(512) + C(256), C(256), 1, **kw)
        self.BottleneckCSP_5 = csp(256, 256, 3, sc=False)
        self.Conv_2 = Conv(C(256), no, 1, bias=True, **kw)

    def forward(self, x):
        x = x.float().permute(0, 3, 1, 2)
        x = self.ConvBN_1(self.BottleneckV5_0(self.ConvBN_0(self.Focus_0(x))))
        rt0 = self.BottleneckCSP_0(x)
        rt1 = self.BottleneckCSP_1(self.ConvBN_2(rt0))
        x = self.SPP_0(self.ConvBN_3(rt1))
        route = self.BottleneckCSP_3(self.BottleneckCSP_2(x))
        out0 = self.Conv_0(route)
        route = self.BottleneckCSP_4(self.ConvBN_4(
            torch.cat([upsample2x(route), rt1], dim=1)))
        out1 = self.Conv_1(route)
        out2 = self.Conv_2(self.BottleneckCSP_5(self.ConvBN_5(
            torch.cat([upsample2x(route), rt0], dim=1))))
        return [self._reshape(o) for o in (out2, out1, out0)]

    def _reshape(self, t):
        B, _, H, W = t.shape
        t = t.reshape(B, self.num_anchors, 5 + self.num_classes, H, W)
        return t.permute(0, 1, 3, 4, 2)


def build(cfg: dict, numerics: Numerics = F32) -> YOLOv5:
    """The reference model of a configuration file's ``model`` section."""
    m = cfg["model"]
    return YOLOv5(m["num_classes"], m["depth_multiple"], m["width_multiple"],
                  len(m["anchors"][0]), numerics=numerics)


def head_bias_priors(cfg: dict) -> dict:
    """ultralytics' ``Detect._initialize_biases``: each head's objectness
    bias ``log(8 / (img / stride)^2)`` and class biases ``log(0.6 / (C -
    0.99))``, box biases 0.  ``{state-dict key: [A*(5+C)] list}``."""
    m = cfg["model"]
    C, A, img = m["num_classes"], len(m["anchors"][0]), m["img_size"]
    out = {}
    for stride, head in HEADS.items():
        b = [0.0] * (A * (5 + C))
        for a in range(A):
            b[a * (5 + C) + 4] = math.log(8.0 / (img / stride) ** 2)
            for c in range(C):
                b[a * (5 + C) + 5 + c] = math.log(0.6 / (C - 0.99))
        out[f"{head}.bias"] = b
    return out


def score_channels(cfg: dict) -> dict:
    """``{detect conv: [objectness channel of each anchor]}``."""
    m = cfg["model"]
    C, A = m["num_classes"], len(m["anchors"][0])
    return {head: [a * (5 + C) + 4 for a in range(A)]
            for head in HEADS.values()}


def input_scale(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> float32 in [0, 1]."""
    return images.float() / 255.0


def forward_blocks(model: YOLOv5, images: torch.Tensor, rows: int
                   ) -> Sequence[torch.Tensor]:
    """Eval-mode forward of uint8 ``images`` in blocks of ``rows``."""
    parts = []
    with torch.no_grad():
        for i in range(0, images.shape[0], rows):
            parts.append(model(input_scale(images[i:i + rows])))
    return [torch.cat([p[k] for p in parts]) for k in range(3)]


def loss(outputs, labels, boxes, mask, cfg: dict) -> torch.Tensor:
    """The configuration's YOLOv5 loss (``losses.yolov5_loss``)."""
    from perfbench.reference import losses
    return losses.yolov5_loss(outputs, labels, boxes, mask, cfg)
