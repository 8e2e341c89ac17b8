"""YOLOv5 s/m/l/x: Focus stem + CSPDarknet + SPP + top-down PANet head.

The PyTorch counterpart of ``objectdetectionpl_tpu/models/yolov5.py``, with
the same submodule names as the flax module so weights carry over one to one
(``utils/weights.py``).  Input NHWC ``[B, S, S, 3]`` of any dtype (cast to
the compute dtype; a uint8 batch works when the stem carries the /255,
``utils/fuse.fold_input_scale``).  Output: list of 3 maps
``[B, 3, g, g, 5+C]`` at strides (8, 16, 32), channel ``a*(5+C) + k`` of the
1x1 head split into anchor ``a`` and field ``k``.  ``model.train()`` is the
flax ``train=True``: every BatchNorm normalizes with its batch moments and
updates its running statistics (``nn/blocks.py``).

``remat`` recomputes block activations in the backward pass instead of
keeping them (``blocks.remat``), as the JAX module's ``nn.remat`` does:
"early" the blocks at strides 2-8 (``EARLY``), whose activations are the
largest and cheapest to recompute, "all" every block but the three 1x1
heads, "none" none.  It changes neither the module tree nor the
``state_dict`` keys, and only acts when gradients are being recorded.
"""

from __future__ import annotations

import torch
from torch import nn

from objectdetectionpl_tpu_torch.nn.blocks import (
    SPP, BottleneckCSP, BottleneckV5, Conv, ConvBN, Focus, remat,
    scale_ch, scale_depth, upsample2x)

VARIANTS = {
    "Yolov5s": (0.33, 0.50),
    "Yolov5m": (0.67, 0.75),
    "Yolov5l": (1.00, 1.00),
    "Yolov5x": (1.33, 1.25),
}

# the blocks the JAX module marks ``late=False``
EARLY = frozenset({"Focus_0", "ConvBN_0", "BottleneckV5_0", "ConvBN_1",
                   "BottleneckCSP_0", "ConvBN_5", "BottleneckCSP_5"})
HEADS = ("Conv_0", "Conv_1", "Conv_2")
REMAT = ("none", "early", "all")

class YOLOv5(nn.Module):
    def __init__(self, num_classes: int, variant: str = "Yolov5s",
                 num_anchors: int = 3, dtype: torch.dtype = torch.float32,
                 remat: str = "none"):
        super().__init__()
        if remat not in REMAT:
            raise ValueError(f"remat={remat!r}: expected one of {REMAT}")
        dm, wm = VARIANTS[variant]
        C = lambda c: scale_ch(c, wm)
        D = lambda n: scale_depth(n, dm)
        self.num_classes = num_classes
        self.num_anchors = num_anchors
        self.dtype = dtype
        self.remat = remat
        no = (5 + num_classes) * num_anchors

        def csp(c1, c2, n, sc=True):
            return BottleneckCSP(C(c1), C(c2), D(n), shortcut=sc, dtype=dtype)

        self.Focus_0 = Focus(3, C(64), 3, dtype=dtype)                 # /2
        self.ConvBN_0 = ConvBN(C(64), C(128), 3, 2, dtype=dtype)        # /4
        self.BottleneckV5_0 = BottleneckV5(C(128), C(128), dtype=dtype)
        self.ConvBN_1 = ConvBN(C(128), C(256), 3, 2, dtype=dtype)       # /8
        self.BottleneckCSP_0 = csp(256, 256, 9)
        self.ConvBN_2 = ConvBN(C(256), C(512), 3, 2, dtype=dtype)       # /16
        self.BottleneckCSP_1 = csp(512, 512, 9)
        self.ConvBN_3 = ConvBN(C(512), C(1024), 3, 2, dtype=dtype)      # /32
        self.SPP_0 = SPP(C(1024), C(1024), dtype=dtype)
        self.BottleneckCSP_2 = csp(1024, 1024, 6)
        self.BottleneckCSP_3 = csp(1024, 1024, 3, sc=False)
        self.Conv_0 = Conv(C(1024), no, 1, bias=True, dtype=dtype)      # s32
        self.ConvBN_4 = ConvBN(C(1024) + C(512), C(512), 1, dtype=dtype)
        self.BottleneckCSP_4 = csp(512, 512, 3, sc=False)
        self.Conv_1 = Conv(C(512), no, 1, bias=True, dtype=dtype)       # s16
        self.ConvBN_5 = ConvBN(C(512) + C(256), C(256), 1, dtype=dtype)
        self.BottleneckCSP_5 = csp(256, 256, 3, sc=False)
        self.Conv_2 = Conv(C(256), no, 1, bias=True, dtype=dtype)       # s8

    def _recomputed(self, name: str) -> bool:
        return (self.remat == "all" and name not in HEADS
                or self.remat == "early" and name in EARLY)

    def _block(self, name: str, x):
        block = getattr(self, name)
        if torch.is_grad_enabled() and self._recomputed(name):
            return remat(block, x)
        return block(x)

    def forward(self, x):
        b = self._block
        x = x.to(self.dtype).permute(0, 3, 1, 2)    # NHWC -> NCHW view
        x = b("Focus_0", x)
        x = b("ConvBN_0", x)
        x = b("BottleneckV5_0", x)
        x = b("ConvBN_1", x)
        rt0 = b("BottleneckCSP_0", x)
        rt1 = b("BottleneckCSP_1", b("ConvBN_2", rt0))
        x = b("SPP_0", b("ConvBN_3", rt1))
        route = b("BottleneckCSP_3", b("BottleneckCSP_2", x))
        out0 = self.Conv_0(route)

        x = b("ConvBN_4", torch.cat([upsample2x(route), rt1], dim=1))
        route = b("BottleneckCSP_4", x)
        out1 = self.Conv_1(route)

        x = b("ConvBN_5", torch.cat([upsample2x(route), rt0], dim=1))
        out2 = self.Conv_2(b("BottleneckCSP_5", x))
        return [self._reshape(out2), self._reshape(out1),
                self._reshape(out0)]

    def _reshape(self, t):
        B, _, H, W = t.shape
        t = t.reshape(B, self.num_anchors, 5 + self.num_classes, H, W)
        return t.permute(0, 1, 3, 4, 2)              # [B, 3, g, g, 5+C]
