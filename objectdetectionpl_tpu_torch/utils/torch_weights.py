"""Reference torch checkpoints -> the port's state_dict.

The port of ``objectdetectionpl_tpu/utils/torch_weights.py``, definition
for definition.  The reference builds SSD from torchvision's pretrained
VGG16 (model/SSD.py:46); ``cfg.torch_ckpt`` is how a YAML or the CLI reaches
these loaders (``train/loop.py``).

The port's modules carry the flax auto-names (``utils/weights.py``), so
each loader is the JAX loader's name map applied to the port's own
state_dict: flax ``A/B/Conv_0/kernel`` is ``A.B.Conv_0.weight``,
``BatchNorm_0/scale`` is ``BatchNorm_0.weight``, the statistics ``mean`` /
``var`` are ``running_mean`` / ``running_var``.  Torch checkpoints hold
OIHW convs like the port, so no kernel is transposed.

A loader takes ``target`` (the model's ``state_dict()``, or any dict of
its keys) and the checkpoint's ``{key: tensor or array}``, and returns a
new dict of the same keys with the loaded entries replaced (copied into
each target's dtype and device: float32 parameters stay float32, whatever
the file holds) and the count ``n`` as JAX counts it.  Load the result
with ``load_state_dict(strict=True)``.  Errors are JAX's, at the same
points: a missing checkpoint key of a full-model route ``KeyError``, a
conv of another shape ``AssertionError``, an unknown family
``ValueError``; the VGG16 and ResNet-50 routes skip a conv the
checkpoint lacks.  Where JAX writes a vector without a check, the port
also checks that the target holds the key at that shape (``KeyError``,
``AssertionError``), since a state_dict has no room for a new key.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# torchvision vgg16.features conv layer indices ('D' config).
VGG16_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]

StateDict = Dict[str, torch.Tensor]


def _tensor(v) -> torch.Tensor:
    return v.detach() if torch.is_tensor(v) else torch.from_numpy(
        np.ascontiguousarray(v))


def conv_to_flax(w) -> torch.Tensor:
    """A torch conv weight as the port holds it: OIHW on both sides, so the
    identity (as a tensor), checked to be a 4-D kernel."""
    w = _tensor(w)
    assert w.dim() == 4, ("conv weight", tuple(w.shape))
    return w


class _Target:
    """A copy of the target state_dict that the loaders write into."""

    def __init__(self, target: Mapping[str, torch.Tensor]):
        self.sd: StateDict = dict(target)

    def __contains__(self, key: str) -> bool:
        return key in self.sd

    def _put(self, key: str, value: torch.Tensor) -> None:
        have = self.sd[key]                  # KeyError: no such target
        assert have.shape == value.shape, (key, tuple(have.shape),
                                           tuple(value.shape))
        self.sd[key] = value.to(device=have.device, dtype=have.dtype,
                                copy=True)

    def conv(self, base: str, w) -> None:
        """``<base>.weight`` <- a torch conv weight."""
        self._put(f"{base}.weight", conv_to_flax(w))

    def vec(self, key: str, v) -> None:
        self._put(key, _tensor(v))

    def bn(self, base: str, sd: Mapping, bn_key: str) -> None:
        """``<base>.BatchNorm_0`` <- torch BN ``<bn_key>.*``."""
        self.vec(f"{base}.BatchNorm_0.weight", sd[f"{bn_key}.weight"])
        self.vec(f"{base}.BatchNorm_0.bias", sd[f"{bn_key}.bias"])
        self.vec(f"{base}.BatchNorm_0.running_mean",
                 sd[f"{bn_key}.running_mean"])
        self.vec(f"{base}.BatchNorm_0.running_var",
                 sd[f"{bn_key}.running_var"])


def load_vgg16_into_ssd(target: Mapping[str, torch.Tensor],
                        state_dict: Mapping) -> Tuple[StateDict, int]:
    """Copy torchvision vgg16.features weights into SSD's VGG stacks.

    ``state_dict`` holds ``features.<i>.weight/bias`` (a whole torchvision
    vgg16 state_dict works too).  The port's SSD splits VGG into
    ``_VGGStack_0`` (10 convs, through conv4_3) and ``_VGGStack_1`` (3
    convs, conv5_x), each conv in a ``ConvBN_<j>`` holding one ``Conv_0``.
    A conv the checkpoint lacks is skipped; a bias goes where the target
    has one (``ssd_bn`` convs have none, and their BN stays as it was).
    Returns (state_dict, n_loaded).
    """
    out = _Target(target)
    prefix = "features."
    sd = {k[len(prefix):] if k.startswith(prefix) else k: v
          for k, v in state_dict.items()}

    stacks = [("_VGGStack_0", VGG16_CONV_IDX[:10]),
              ("_VGGStack_1", VGG16_CONV_IDX[10:])]
    n_loaded = 0
    for stack_name, conv_ids in stacks:
        for j, ti in enumerate(conv_ids):
            w = sd.get(f"{ti}.weight")
            b = sd.get(f"{ti}.bias")
            if w is None:
                continue
            base = f"{stack_name}.ConvBN_{j}.Conv_0"
            if f"{base}.weight" not in out:
                raise KeyError(f"port parameter {base}.weight not found; "
                               f"have {sorted(k for k in out.sd if stack_name in k)[:5]}")
            out.conv(base, w)
            if b is not None and f"{base}.bias" in out:
                out.vec(f"{base}.bias", b)
            n_loaded += 1
    return out.sd, n_loaded


RESNET50_BLOCKS = [3, 4, 6, 3]


def load_resnet50_into_retinanet(target: Mapping[str, torch.Tensor],
                                 state_dict: Mapping
                                 ) -> Tuple[StateDict, int]:
    """Copy torchvision resnet50 weights into RetinaNet's ResNetFPN.

    conv1/bn1 -> ``ResNetFPN_0.ConvBN_0``; ``layer{L}.{i}`` ->
    ``Bottleneck_{offset+i}`` with conv1..3 -> ``ConvBN_0..2`` and
    downsample.(0 conv, 1 bn) -> ``ConvBN_3``; BN running statistics into
    the buffers.  The ``ResNetFPN_0.`` prefix is used when the target has
    it (a RetinaNet), not for a bare ResNetFPN.  A conv the checkpoint
    lacks is skipped.  Returns (state_dict, n_loaded).
    """
    out = _Target(target)
    prefix = ("ResNetFPN_0." if any(k.startswith("ResNetFPN_0.")
                                    for k in out.sd) else "")
    n = 0

    def put(base: str, conv_key: str, bn_key: str = None):
        nonlocal n
        w = state_dict.get(f"{conv_key}.weight")
        if w is None:
            return
        out.conv(f"{prefix}{base}.Conv_0", w)
        n += 1
        if bn_key is None:
            return
        out.bn(f"{prefix}{base}", state_dict, bn_key)

    put("ConvBN_0", "conv1", "bn1")
    block = 0
    for L, n_blocks in enumerate(RESNET50_BLOCKS, start=1):
        for i in range(n_blocks):
            base = f"Bottleneck_{block}"
            for c in range(1, 4):
                put(f"{base}.ConvBN_{c - 1}", f"layer{L}.{i}.conv{c}",
                    f"layer{L}.{i}.bn{c}")
            if f"layer{L}.{i}.downsample.0.weight" in state_dict:
                put(f"{base}.ConvBN_3", f"layer{L}.{i}.downsample.0",
                    f"layer{L}.{i}.downsample.1")
            block += 1
    return out.sd, n


# --- full-model transplants ------------------------------------------------

# reference SSD module -> the port's submodule (models/ssd.py creation
# order).  f1 = torchvision new_layers[:23] (model/SSD.py:46-50); base1 =
# [23:] with pool5 -> MaxPool2d(3,1,1); extras f2-f6 and the cl/bbx heads
# per model/SSD.py:69-155.
_SSD_F1_CONV_IDX = VGG16_CONV_IDX[:10]          # conv1_1 .. conv4_3
_SSD_BASE1_CONV_IDX = [1, 3, 5]                 # conv5_1..3 inside base1
_SSD_EXTRAS = [("f2.0", "ConvBN_0"), ("f2.2", "ConvBN_1"),
               ("f3.0", "ConvBN_2"), ("f3.2", "ConvBN_3"),
               ("f4.0", "ConvBN_4"), ("f4.2", "ConvBN_5"),
               ("f5.0", "ConvBN_6"), ("f5.2", "Conv_0"),
               ("f6.0", "ConvBN_7"), ("f6.2", "Conv_1")]


def load_reference_ssd(target: Mapping[str, torch.Tensor],
                       state_dict: Mapping) -> Tuple[StateDict, int]:
    """Transplant a complete reference-SSD state_dict (model/SSD.py:40-160):
    backbone, extras and all 12 cl/bbx heads.  The reference's class count
    includes the background and the port's SSD adds its own background
    channel, so build the port's SSD with ``num_classes = C_ref - 1``.
    Returns (state_dict, n_loaded)."""
    out = _Target(target)
    n = 0

    def put_conv(tk: str, fk: str):
        nonlocal n
        out.conv(fk, state_dict[f"{tk}.weight"])
        if f"{tk}.bias" in state_dict:
            out.vec(f"{fk}.bias", state_dict[f"{tk}.bias"])
        n += 1

    for j, ti in enumerate(_SSD_F1_CONV_IDX):
        put_conv(f"f1.{ti}", f"_VGGStack_0.ConvBN_{j}.Conv_0")
    for j, ti in enumerate(_SSD_BASE1_CONV_IDX):
        put_conv(f"base1.{ti}", f"_VGGStack_1.ConvBN_{j}.Conv_0")
    for tk, fk in _SSD_EXTRAS:
        put_conv(tk, fk if fk.startswith("Conv_") else f"{fk}.Conv_0")
    for i in range(1, 7):       # heads: cl_i -> Conv_{2i}, bbx_i -> Conv_{2i+1}
        put_conv(f"cl{i}.0", f"Conv_{2 * i}")
        put_conv(f"bbx{i}.0", f"Conv_{2 * i + 1}")
    return out.sd, n


# reference YOLOv2 module -> the port's submodule (models/yolov2.py
# creation order): stage1_conv1..13 -> ConvBN_0..12, stage2_a_conv1..7 ->
# ConvBN_13..19, stage2_b_conv -> ConvBN_20, stage3_conv1 -> ConvBN_21,
# stage3_conv2 -> Conv_0 (model/YOLOV2.py:42-102).
def load_reference_yolov2(target: Mapping[str, torch.Tensor],
                          state_dict: Mapping) -> Tuple[StateDict, int]:
    """Transplant a complete reference-YOLOv2 state_dict (build the port's
    YOLOv2 with ``reorg='darknet'`` for the reference's forward).  Returns
    (state_dict, n_loaded)."""
    out = _Target(target)
    n = 0

    def put(tk: str, base: str):
        nonlocal n
        out.conv(f"{base}.Conv_0", state_dict[f"{tk}.0.weight"])
        out.bn(base, state_dict, f"{tk}.1")
        n += 1

    for i in range(1, 14):
        put(f"stage1_conv{i}", f"ConvBN_{i - 1}")
    for i in range(1, 8):
        put(f"stage2_a_conv{i}", f"ConvBN_{12 + i}")
    put("stage2_b_conv", "ConvBN_20")
    put("stage3_conv1", "ConvBN_21")
    out.conv("Conv_0", state_dict["stage3_conv2.weight"])
    n += 1
    return out.sd, n


def _convbn_putter(out: _Target, state_dict: Mapping, conv_suffix: str,
                   bn_suffix: str):
    """Shared ConvBN transplant closure: torch ``<tk><conv_suffix>.weight``
    + BN at ``<tk><bn_suffix>.*`` into the port's ``<base>.Conv_0`` +
    ``BatchNorm_0``.  Returns (put, count) where count() reads the running
    tally."""
    n = [0]

    def put(tk: str, base: str, bias: bool = False):
        out.conv(f"{base}.Conv_0", state_dict[f"{tk}{conv_suffix}.weight"])
        if bias:
            out.vec(f"{base}.Conv_0.bias",
                    state_dict[f"{tk}{conv_suffix}.bias"])
        bnk = f"{tk}{bn_suffix}"
        if f"{bnk}.weight" in state_dict:
            out.bn(base, state_dict, bnk)
        n[0] += 1

    return put, lambda: n[0]


def _put_plain_conv(out: _Target, state_dict: Mapping, tk: str, fk: str):
    """torch plain nn.Conv2d (weight + optional bias) -> the port's ``<fk>``."""
    out.conv(fk, state_dict[f"{tk}.weight"])
    if f"{tk}.bias" in state_dict:
        out.vec(f"{fk}.bias", state_dict[f"{tk}.bias"])


def load_reference_yolov5(target: Mapping[str, torch.Tensor],
                          state_dict: Mapping,
                          prefix: str = "backbone_head."
                          ) -> Tuple[StateDict, int]:
    """Transplant a complete reference-YOLOv5 state_dict
    (model/YOLOV5.py:20-102, backbone_head seq0-seq21).

    The only non-identity remap is the Focus stem: the reference slices
    (even,even),(odd,even),(even,odd),(odd,odd) pixel phases into channel
    blocks (YoloV5Utils.py:120-125) while ``nn/blocks.py::space_to_depth``
    emits (even,even),(even,odd),(odd,even),(odd,odd), so the stem conv's
    input channels (axis 1 of OIHW) are permuted blockwise ([0,2,1,3]).

    Returns (state_dict, n_loaded).
    """
    out = _Target(target)
    sd = {k[len(prefix):] if k.startswith(prefix) else k: v
          for k, v in state_dict.items()}
    put, count = _convbn_putter(out, sd, ".conv", ".bn")

    def put_csp(tk: str, base: str):
        # BottleneckCSP (YoloV5Utils.py:71-94): cv1/m/cv3/cv2/bn/cv4 ->
        # ConvBN_0 / BottleneckV5_i / Conv_0 / Conv_1 / BatchNorm_0 / ConvBN_1
        put(f"{tk}.cv1", f"{base}.ConvBN_0")
        i = 0
        while f"{tk}.m.{i}.cv1.conv.weight" in sd:
            put(f"{tk}.m.{i}.cv1", f"{base}.BottleneckV5_{i}.ConvBN_0")
            put(f"{tk}.m.{i}.cv2", f"{base}.BottleneckV5_{i}.ConvBN_1")
            i += 1
        _put_plain_conv(out, sd, f"{tk}.cv3", f"{base}.Conv_0")
        _put_plain_conv(out, sd, f"{tk}.cv2", f"{base}.Conv_1")
        out.bn(base, sd, f"{tk}.bn")
        put(f"{tk}.cv4", f"{base}.ConvBN_1")

    # Focus stem with the phase-block input permutation
    put("seq0_Focus.conv", "Focus_0.ConvBN_0")
    key = "Focus_0.ConvBN_0.Conv_0.weight"
    k = out.sd[key]
    C = k.shape[1] // 4
    order = torch.cat([torch.arange(t * C, (t + 1) * C)
                       for t in (0, 2, 1, 3)])
    out.sd[key] = k[:, order].contiguous()

    put("seq1_Conv", "ConvBN_0")
    put("seq2_Bottleneck.cv1", "BottleneckV5_0.ConvBN_0")
    put("seq2_Bottleneck.cv2", "BottleneckV5_0.ConvBN_1")
    put("seq3_Conv", "ConvBN_1")
    put_csp("seq4_BottleneckCSP", "BottleneckCSP_0")
    put("seq5_Conv", "ConvBN_2")
    put_csp("seq6_BottleneckCSP", "BottleneckCSP_1")
    put("seq7_Conv", "ConvBN_3")
    put("seq8_SPP.cv1", "SPP_0.ConvBN_0")
    put("seq8_SPP.cv2", "SPP_0.ConvBN_1")
    put_csp("seq9_BottleneckCSP", "BottleneckCSP_2")
    put_csp("seq10_BottleneckCSP", "BottleneckCSP_3")
    _put_plain_conv(out, sd, "seq11_Conv2d", "Conv_0")
    put("seq14_Conv", "ConvBN_4")
    put_csp("seq15_BottleneckCSP", "BottleneckCSP_4")
    _put_plain_conv(out, sd, "seq16_Conv2d", "Conv_1")
    put("seq19_Conv", "ConvBN_5")
    put_csp("seq20_BottleneckCSP", "BottleneckCSP_5")
    _put_plain_conv(out, sd, "seq21_Conv2d", "Conv_2")
    # plain convs: 6 CSP blocks x (cv2, cv3) + 3 detection heads
    return out.sd, count() + 15


# YOLOv3 extractor layout (model/YOLOV3.py:73-175): conv numbers per group
# with residual letters a..w interleaved exactly as built.
_V3_GROUPS = [  # (group ConvBN number, [(res cb1, res cb2), ...])
    (2, [(3, 4)]),
    (5, [(6, 7), (8, 9)]),
    (10, [(11, 12), (13, 14), (15, 16), (17, 18), (19, 20), (21, 22),
          (23, 24), (25, 26)]),
    (27, [(28, 29), (30, 31), (32, 33), (34, 35), (36, 37), (38, 39),
          (40, 41), (42, 43)]),
    (44, [(45, 46), (47, 48), (49, 50), (51, 52)]),
]
_V3_LETTERS = "abcdefghijklmnopqrstuvw"


def load_reference_yolov3(target: Mapping[str, torch.Tensor],
                          state_dict: Mapping) -> Tuple[StateDict, int]:
    """Transplant a complete reference-YOLOv3 state_dict
    (model/YOLOV3.py:73-234: extractor SelectiveSequential + 5 detector
    sequences).  Returns (state_dict, n_loaded)."""
    out = _Target(target)
    put, count = _convbn_putter(out, state_dict, ".layers.0", ".layers.1")

    dk = "Darknet53_0"
    put("extractor.1_convbatch", f"{dk}.ConvBN_0")
    res_i, letter_i = 0, 0
    for gi, (conv_no, residuals) in enumerate(_V3_GROUPS, start=1):
        put(f"extractor.{conv_no}_convbatch", f"{dk}.ConvBN_{gi}")
        for cb1, cb2 in residuals:
            letter = _V3_LETTERS[letter_i]
            put(f"extractor.{letter}_residual.{cb1}_convbatch",
                f"{dk}.Residual_{res_i}.ConvBN_0")
            put(f"extractor.{letter}_residual.{cb2}_convbatch",
                f"{dk}.Residual_{res_i}.ConvBN_1")
            res_i += 1
            letter_i += 1

    # detector sequences -> (_DetectSeq_0, ConvBN_0, _DetectSeq_1, ConvBN_1,
    # _DetectSeq_2); each _DetectSeq holds ConvBN_0..5 + Conv_0
    seqs = [("detector.0", "_DetectSeq_0", 53),
            ("detector.2", "_DetectSeq_1", 62),
            ("detector.4", "_DetectSeq_2", 71)]
    for tbase, fbase, start in seqs:
        for j in range(6):
            put(f"{tbase}.{start + j}_convbatch", f"{fbase}.ConvBN_{j}")
        _put_plain_conv(out, state_dict, f"{tbase}.{start + 6}_conv",
                        f"{fbase}.Conv_0")
    put("detector.1.60_convbatch", "ConvBN_0")
    put("detector.3.69_convbatch", "ConvBN_1")
    return out.sd, count() + 3


def load_reference_yolov4(target: Mapping[str, torch.Tensor],
                          state_dict: Mapping) -> Tuple[StateDict, int]:
    """Transplant a complete reference-YOLOv4 state_dict (model/YOLOV4.py:
    136-283 down1-5/neek/head, YoloV4Utils.py:264-481).  Returns
    (state_dict, n_loaded)."""
    out = _Target(target)
    put, count = _convbn_putter(out, state_dict, ".conv.0", ".conv.1")

    for i in range(1, 9):                                   # DownSample1
        put(f"down1.conv{i}", f"DownSample1_0.ConvBN_{i - 1}")
    nblocks = {2: 2, 3: 8, 4: 8, 5: 4}
    for d in range(2, 6):                                   # DownSample2-5
        base = f"DownSampleCSP_{d - 2}"
        for i, fi in ((1, 0), (2, 1), (3, 2), (4, 3), (5, 4)):
            put(f"down{d}.conv{i}", f"{base}.ConvBN_{fi}")
        for r in range(nblocks[d]):
            put(f"down{d}.resblock.module_list.{r}.0",
                f"{base}.MishResBlock_0.ConvBN_{2 * r}")
            put(f"down{d}.resblock.module_list.{r}.1",
                f"{base}.MishResBlock_0.ConvBN_{2 * r + 1}")
    for i in range(1, 21):                                  # Neck conv1-20
        put(f"neek.conv{i}", f"Neck_0.ConvBN_{i - 1}")
    # Head: convs 2/10/18 are the plain (linear, bias) output convs
    head_map = [("conv1", "ConvBN_0"), ("conv3", "ConvBN_1"),
                ("conv4", "ConvBN_2"), ("conv5", "ConvBN_3"),
                ("conv6", "ConvBN_4"), ("conv7", "ConvBN_5"),
                ("conv8", "ConvBN_6"), ("conv9", "ConvBN_7"),
                ("conv11", "ConvBN_8"), ("conv12", "ConvBN_9"),
                ("conv13", "ConvBN_10"), ("conv14", "ConvBN_11"),
                ("conv15", "ConvBN_12"), ("conv16", "ConvBN_13"),
                ("conv17", "ConvBN_14")]
    for tk, fk in head_map:
        put(f"head.{tk}", fk)
    for tk, fk in [("conv2", "Conv_0"), ("conv10", "Conv_1"),
                   ("conv18", "Conv_2")]:
        _put_plain_conv(out, state_dict, f"head.{tk}.conv.0", fk)
    return out.sd, count() + 3


def load_reference_retinanet(target: Mapping[str, torch.Tensor],
                             state_dict: Mapping) -> Tuple[StateDict, int]:
    """Transplant a complete reference-RetinaNet state_dict
    (model/RetinaNet.py:44-115 + model/backbone/RetinaNetbone.py:8-76).
    Returns (state_dict, n_loaded)."""
    out = _Target(target)
    n = 0

    def put_convbn(conv_key, bn_key, base):
        nonlocal n
        out.conv(f"{base}.Conv_0", state_dict[f"{conv_key}.weight"])
        out.bn(base, state_dict, bn_key)
        n += 1

    fpn = "ResNetFPN_0"
    put_convbn("fpn.conv1", "fpn.bn1", f"{fpn}.ConvBN_0")
    block = 0
    for L, n_blocks in enumerate(RESNET50_BLOCKS, start=1):
        for i in range(n_blocks):
            base = f"{fpn}.Bottleneck_{block}"
            for c in range(1, 4):
                put_convbn(f"fpn.layer{L}.{i}.conv{c}",
                           f"fpn.layer{L}.{i}.bn{c}", f"{base}.ConvBN_{c - 1}")
            if f"fpn.layer{L}.{i}.downsample.0.weight" in state_dict:
                put_convbn(f"fpn.layer{L}.{i}.downsample.0",
                           f"fpn.layer{L}.{i}.downsample.1",
                           f"{base}.ConvBN_3")
            block += 1
    # FPN plain convs in the port's creation order (models/retinanet.py)
    fpn_convs = [("fpn.conv6", "Conv_0"), ("fpn.conv7", "Conv_1"),
                 ("fpn.latlayer1", "Conv_2"), ("fpn.toplayer1", "Conv_3"),
                 ("fpn.latlayer2", "Conv_4"), ("fpn.toplayer2", "Conv_5"),
                 ("fpn.latlayer3", "Conv_6")]
    for tk, fk in fpn_convs:
        _put_plain_conv(out, state_dict, tk, f"{fpn}.{fk}")
        n += 1
    # shared heads: Sequential conv indices 0,2,4,6 + output 8
    for tname, fname in (("loc_head", "_Head_0"), ("cls_head", "_Head_1")):
        for j, ti in enumerate((0, 2, 4, 6, 8)):
            _put_plain_conv(out, state_dict, f"{tname}.{ti}",
                            f"{fname}.Conv_{j}")
            n += 1
    return out.sd, n


def load_torch_checkpoint(model_name: str,
                          target: Mapping[str, torch.Tensor],
                          state_dict: Mapping
                          ) -> Tuple[StateDict, int, str]:
    """Route a torch state_dict into the right converter by key signature
    (the ``torch_ckpt:`` key; the reference builds SSD from pretrained
    VGG16 at init, model/SSD.py:46):

    - ``features.*``            torchvision vgg16 -> SSD backbone
    - ``f1.* / cl1.*``          full reference SSD state_dict
    - ``conv1./layer1.*``       torchvision resnet50 -> RetinaNet backbone
    - ``stage1_conv1.*``        full reference YOLOv2 state_dict

    Returns (state_dict, n_loaded, description).
    """
    keys = set(state_dict)

    def has(prefix):
        return any(k.startswith(prefix) for k in keys)

    if model_name == "SSD":
        if has("f1.") and has("cl1."):
            sd, n = load_reference_ssd(target, state_dict)
            return sd, n, "reference SSD (full model)"
        sd, n = load_vgg16_into_ssd(target, state_dict)
        return sd, n, "vgg16 backbone"
    if model_name == "RetinaNet":
        sd, n = load_resnet50_into_retinanet(target, state_dict)
        return sd, n, "resnet50 backbone"
    if model_name == "YOLOv2":
        sd, n = load_reference_yolov2(target, state_dict)
        return sd, n, "reference YOLOv2 (full model)"
    raise ValueError(
        f"no torch-checkpoint converter for model {model_name!r} "
        f"(supported: SSD, RetinaNet, YOLOv2)")


def read_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """``torch.load`` a checkpoint file -> {key: CPU tensor}: a pickled
    module gives its ``state_dict()``, a ``{"state_dict": ...}`` wrapper
    its inner dict, a plain dict itself.  The file is unpickled
    (``weights_only=False``, as JAX loads it): read only trusted files."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if "state_dict" in obj and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    return {k: v.detach().cpu() if torch.is_tensor(v)
            else torch.as_tensor(np.asarray(v)) for k, v in obj.items()}


def convert_generic_conv_bn(torch_prefix: str, state_dict: Mapping
                            ) -> Tuple[torch.Tensor, dict]:
    """Helper: (conv weight, {weight, bias, running_mean, running_var}) for
    a torch conv+bn pair named ``<prefix>.conv`` / ``<prefix>.bn``, under
    the port's names (JAX's scale/bias/mean/var)."""
    w = conv_to_flax(state_dict[f"{torch_prefix}.conv.weight"])
    bn = {name: _tensor(state_dict[f"{torch_prefix}.bn.{name}"])
          for name in ("weight", "bias", "running_mean", "running_var")}
    return w, bn
