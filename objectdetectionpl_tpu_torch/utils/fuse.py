"""Conv+BatchNorm folding and input-scale folding on the port's state_dict.

The PyTorch counterpart of ``objectdetectionpl_tpu/utils/fuse.py``: the same
weight transforms, with kernels in torch's [O, I, kh, kw] layout.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

BN_EPS = 1e-5

STEM_CONV = "Focus_0.ConvBN_0.Conv_0"

# the first conv of each family, the one an input scale folds into
STEM_CONVS = {
    "YOLOv2": "ConvBN_0.Conv_0",
    "YOLOv3": "Darknet53_0.ConvBN_0.Conv_0",
    "YOLOv4": "DownSample1_0.ConvBN_0.Conv_0",
    "YOLOv5": STEM_CONV,
    "SSD": "_VGGStack_0.ConvBN_0.Conv_0",
    "RetinaNet": "ResNetFPN_0.ConvBN_0.Conv_0",
}


def fuse_conv_bn(weight: torch.Tensor, bn_scale: torch.Tensor,
                 bn_bias: torch.Tensor, bn_mean: torch.Tensor,
                 bn_var: torch.Tensor, eps: float = BN_EPS
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold BN statistics into a conv weight [O, I, kh, kw].

    Returns (fused_weight, fused_bias) with
    ``conv(x, fused_weight) + fused_bias == BN(conv(x, weight))`` under
    running statistics.
    """
    factor = bn_scale / torch.sqrt(bn_var + eps)      # [O]
    return weight * factor[:, None, None, None], bn_bias - bn_mean * factor


def fold_input_scale(state_dict: Dict[str, torch.Tensor], scale: float,
                     path: str = STEM_CONV) -> Dict[str, torch.Tensor]:
    """Fold an input normalization ``x * scale`` into the stem conv weight.

    ``conv(x * scale, W) == conv(x, W * scale)``, so a serving path can feed
    raw uint8 (cast only) to the model.  Returns a new dict; the input is
    not modified.
    """
    key = path + ".weight"
    return {**state_dict, key: state_dict[key] * scale}
