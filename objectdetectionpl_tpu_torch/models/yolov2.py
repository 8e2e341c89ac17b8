"""YOLOv2: Darknet19 with the passthrough (reorg) connection.

The PyTorch counterpart of ``objectdetectionpl_tpu/models/yolov2.py``, with
the flax submodule names (``ConvBN_0`` .. ``ConvBN_21``, ``Conv_0``) so
weights carry over one to one (``utils/weights.py``).  Input NHWC
``[B, S, S, 3]`` of any dtype (cast to the compute dtype).  Output: the raw
map ``[B, A*(5+C), S/32, S/32]`` (A=5), as ``ops.losses.region_loss`` and
``ops.nms.decode_yolo_predictions`` take it.
"""

from __future__ import annotations

import torch
from torch import nn

from objectdetectionpl_tpu_torch.nn.blocks import (Conv, ConvBN, max_pool,
                                                   reorg_darknet_bug,
                                                   space_to_depth)

# (features, kernel) per conv; "M" = 2x2/2 max-pool.
_STAGE1 = [(32, 3), "M", (64, 3), "M", (128, 3), (64, 1), (128, 3), "M",
           (256, 3), (128, 1), (256, 3), "M", (512, 3), (256, 1), (512, 3),
           (256, 1), (512, 3)]
_STAGE2A = [(1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3), (1024, 3),
            (1024, 3)]


class YOLOv2(nn.Module):
    """``reorg="s2d"`` (default) passes the 26x26 features through a true
    space-to-depth; ``"darknet"`` through darknet's scrambled reorg."""

    def __init__(self, num_classes: int, num_anchors: int = 5,
                 dtype: torch.dtype = torch.float32, reorg: str = "s2d"):
        super().__init__()
        if reorg not in ("s2d", "darknet"):
            raise ValueError(f"reorg={reorg!r}: expected 's2d' or 'darknet'")
        self.dtype = dtype
        self.reorg = reorg
        convs, c = [], 3
        for spec in _STAGE1 + [None] + _STAGE2A:
            if spec in ("M", None):
                continue
            convs.append(ConvBN(c, spec[0], spec[1], dtype=dtype))
            c = spec[0]
        convs.append(ConvBN(512, 64, 1, dtype=dtype))            # passthrough
        convs.append(ConvBN(1024 + 256, 1024, 3, dtype=dtype))   # fuse
        for i, m in enumerate(convs):
            self.add_module(f"ConvBN_{i}", m)
        self.Conv_0 = Conv(1024, num_anchors * (5 + num_classes), 1,
                           dtype=dtype)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)    # NHWC -> NCHW view
        i = 0

        def run(specs, x):
            nonlocal i
            for spec in specs:
                if spec == "M":
                    x = max_pool(x, 2, 2)
                else:
                    x = getattr(self, f"ConvBN_{i}")(x)
                    i += 1
            return x

        residual = run(_STAGE1, x)                    # S/16, 512 channels
        h = run(_STAGE2A, max_pool(residual, 2, 2))
        p = getattr(self, f"ConvBN_{i}")(residual)
        p = (reorg_darknet_bug(p) if self.reorg == "darknet"
             else space_to_depth(p, 2))
        h = getattr(self, f"ConvBN_{i + 1}")(torch.cat([h, p], dim=1))
        return self.Conv_0(h)
