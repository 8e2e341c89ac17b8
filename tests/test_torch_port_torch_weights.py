"""Reference torch checkpoints into the port (``utils/torch_weights.py``) against the JAX loaders.

Every route of ``load_torch_checkpoint`` and every ``load_reference_*``:
the test writes a state dict of random float32 tensors under exactly the
keys and shapes the JAX loader reads (the reference's names, the shapes of
the flax targets in OIHW), small models where the size is free (SSD-300
B=1, RetinaNet at 128 px, YOLOv2/v3/v4 and YOLOv5s at 64 px, 3 classes).
JAX loads it into zero-filled ``jax.eval_shape`` variables, the port into
``state_dict_from_flax`` of the same zeros; the port's result must equal
``state_dict_from_flax`` of JAX's bit for bit, with the same count ``n``
and description, and its keys must be the port model's own.  A recording
mapping shows that JAX's loader read every key the test wrote, so no
written tensor went unchecked.

Then the errors (``ValueError`` of the router for YOLOv5, v3 and v4, a
missing key, an unknown target, a conv of another shape: the same
exception types in both packages), a partial VGG16 dict (the missing
convs skipped), ``read_torch_state_dict`` on a pickled module, a
``{"state_dict": ...}`` wrapper and a plain dict, the Trainer's
``torch_ckpt`` (the file's first VGG conv in the port Trainer's SSD-300,
the ``[trainer] loaded`` line), and an observation kept in both packages:
with ``ema_decay > 0`` the checkpoint replaces the parameters only, and
the EMA copy keeps the random init (ROADMAP §C).
"""

import os
from collections.abc import Mapping

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from objectdetectionpl_tpu.models import build_model as jax_build
from objectdetectionpl_tpu.utils import torch_weights as jax_tw
from objectdetectionpl_tpu_torch.config import Config
from objectdetectionpl_tpu_torch.models import build_model
from objectdetectionpl_tpu_torch.train import loop
from objectdetectionpl_tpu_torch.utils import torch_weights as tw
from objectdetectionpl_tpu_torch.utils.weights import state_dict_from_flax

C = 3
IMG = {"SSD": 300, "RetinaNet": 128, "YOLOv2": 64, "YOLOv3": 64,
       "YOLOv4": 64, "YOLOv5": 64}


class Recording(Mapping):
    """A read-only dict that records every key whose value was read
    (membership tests are not reads)."""

    def __init__(self, data):
        self.data, self.read = data, set()

    def __getitem__(self, key):
        value = self.data[key]
        self.read.add(key)
        return value

    def __contains__(self, key):
        return key in self.data

    def __iter__(self):
        return iter(self.data)

    def __len__(self):
        return len(self.data)


def jax_zeros(name: str, ssd_bn: bool = False):
    """Zero-filled (params, batch_stats) of a JAX model, from eval_shape."""
    model = jax_build(name, C, ssd_bn=ssd_bn)
    x = jnp.zeros((1, IMG[name], IMG[name], 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), x, train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return dict(zeros["params"]), dict(zeros.get("batch_stats", {}))


class RefWriter:
    """Random float32 tensors under reference keys, shaped by the flax
    targets they map to (a kernel [kh, kw, I, O] as OIHW)."""

    def __init__(self, params, seed: int):
        self.flat = traverse_util.flatten_dict(params, sep="/")
        self.rng = np.random.default_rng(seed)
        self.out = {}

    def _draw(self, shape, positive=False):
        a = self.rng.standard_normal(shape, dtype=np.float32)
        return np.abs(a) + 0.5 if positive else a

    def conv(self, tk: str, fk: str, bias=None):
        """``tk.weight`` for the flax conv ``fk`` (and ``tk.bias`` where
        ``bias``, default: where ``fk`` has one)."""
        kh, kw, i, o = self.flat[f"{fk}/kernel"].shape
        self.out[f"{tk}.weight"] = self._draw((o, i, kh, kw))
        if bias is None:
            bias = f"{fk}/bias" in self.flat
        if bias:
            self.out[f"{tk}.bias"] = self._draw((o,))

    def bn(self, tk: str, base: str):
        """``tk.{weight,bias,running_mean,running_var}`` for
        ``base/BatchNorm_0``."""
        (n,) = self.flat[f"{base}/BatchNorm_0/scale"].shape
        for leaf in ("weight", "bias", "running_mean"):
            self.out[f"{tk}.{leaf}"] = self._draw((n,))
        self.out[f"{tk}.running_var"] = self._draw((n,), positive=True)

    def convbn(self, tk: str, base: str, conv_suffix: str, bn_suffix: str):
        self.conv(f"{tk}{conv_suffix}", f"{base}/Conv_0", bias=False)
        self.bn(f"{tk}{bn_suffix}", base)


# --- the reference state dicts, by route ------------------------------------


def ref_vgg16(w: RefWriter, convs=tw.VGG16_CONV_IDX):
    for j, ti in enumerate(tw.VGG16_CONV_IDX):
        if ti in convs:
            stack, k = ("_VGGStack_0", j) if j < 10 else ("_VGGStack_1",
                                                         j - 10)
            w.conv(f"features.{ti}", f"{stack}/ConvBN_{k}/Conv_0", bias=True)


def ref_resnet50(w: RefWriter, prefix: str = "", fpn: str = ""):
    w.conv(f"{prefix}conv1", f"{fpn}ConvBN_0/Conv_0", bias=False)
    w.bn(f"{prefix}bn1", f"{fpn}ConvBN_0")
    block = 0
    for L, n_blocks in enumerate(tw.RESNET50_BLOCKS, start=1):
        for i in range(n_blocks):
            base = f"{fpn}Bottleneck_{block}"
            for c in range(1, 4):
                w.conv(f"{prefix}layer{L}.{i}.conv{c}",
                       f"{base}/ConvBN_{c - 1}/Conv_0", bias=False)
                w.bn(f"{prefix}layer{L}.{i}.bn{c}", f"{base}/ConvBN_{c - 1}")
            if f"{base}/ConvBN_3/Conv_0/kernel" in w.flat:
                w.conv(f"{prefix}layer{L}.{i}.downsample.0",
                       f"{base}/ConvBN_3/Conv_0", bias=False)
                w.bn(f"{prefix}layer{L}.{i}.downsample.1", f"{base}/ConvBN_3")
            block += 1


def ref_ssd(w: RefWriter):
    for j, ti in enumerate(jax_tw._SSD_F1_CONV_IDX):
        w.conv(f"f1.{ti}", f"_VGGStack_0/ConvBN_{j}/Conv_0")
    for j, ti in enumerate(jax_tw._SSD_BASE1_CONV_IDX):
        w.conv(f"base1.{ti}", f"_VGGStack_1/ConvBN_{j}/Conv_0")
    for tk, fk in jax_tw._SSD_EXTRAS:
        w.conv(tk, fk if fk.startswith("Conv_") else f"{fk}/Conv_0")
    for i in range(1, 7):
        w.conv(f"cl{i}.0", f"Conv_{2 * i}")
        w.conv(f"bbx{i}.0", f"Conv_{2 * i + 1}")


def ref_yolov2(w: RefWriter):
    names = ([f"stage1_conv{i}" for i in range(1, 14)]
             + [f"stage2_a_conv{i}" for i in range(1, 8)]
             + ["stage2_b_conv", "stage3_conv1"])
    for k, tk in enumerate(names):
        w.convbn(tk, f"ConvBN_{k}", ".0", ".1")
    w.conv("stage3_conv2", "Conv_0", bias=False)


def ref_yolov3(w: RefWriter):
    put = lambda tk, base: w.convbn(tk, base, ".layers.0", ".layers.1")
    dk = "Darknet53_0"
    put("extractor.1_convbatch", f"{dk}/ConvBN_0")
    res = 0
    for gi, (conv_no, residuals) in enumerate(jax_tw._V3_GROUPS, start=1):
        put(f"extractor.{conv_no}_convbatch", f"{dk}/ConvBN_{gi}")
        for cb1, cb2 in residuals:
            letter = jax_tw._V3_LETTERS[res]
            put(f"extractor.{letter}_residual.{cb1}_convbatch",
                f"{dk}/Residual_{res}/ConvBN_0")
            put(f"extractor.{letter}_residual.{cb2}_convbatch",
                f"{dk}/Residual_{res}/ConvBN_1")
            res += 1
    for tbase, fbase, start in (("detector.0", "_DetectSeq_0", 53),
                                ("detector.2", "_DetectSeq_1", 62),
                                ("detector.4", "_DetectSeq_2", 71)):
        for j in range(6):
            put(f"{tbase}.{start + j}_convbatch", f"{fbase}/ConvBN_{j}")
        w.conv(f"{tbase}.{start + 6}_conv", f"{fbase}/Conv_0")
    put("detector.1.60_convbatch", "ConvBN_0")
    put("detector.3.69_convbatch", "ConvBN_1")


def ref_yolov4(w: RefWriter):
    put = lambda tk, base: w.convbn(tk, base, ".conv.0", ".conv.1")
    for i in range(1, 9):
        put(f"down1.conv{i}", f"DownSample1_0/ConvBN_{i - 1}")
    for d, blocks in ((2, 2), (3, 8), (4, 8), (5, 4)):
        base = f"DownSampleCSP_{d - 2}"
        for i in range(1, 6):
            put(f"down{d}.conv{i}", f"{base}/ConvBN_{i - 1}")
        for r in range(blocks):
            for k in range(2):
                put(f"down{d}.resblock.module_list.{r}.{k}",
                    f"{base}/MishResBlock_0/ConvBN_{2 * r + k}")
    for i in range(1, 21):
        put(f"neek.conv{i}", f"Neck_0/ConvBN_{i - 1}")
    plain = {2: "Conv_0", 10: "Conv_1", 18: "Conv_2"}
    k = 0
    for i in range(1, 19):
        if i in plain:
            w.conv(f"head.conv{i}.conv.0", plain[i])
        else:
            put(f"head.conv{i}", f"ConvBN_{k}")
            k += 1


def ref_yolov5(w: RefWriter, prefix="backbone_head."):
    put = lambda tk, base: w.convbn(f"{prefix}{tk}", base, ".conv", ".bn")

    def csp(tk, base):
        put(f"{tk}.cv1", f"{base}/ConvBN_0")
        i = 0
        while f"{base}/BottleneckV5_{i}/ConvBN_0/Conv_0/kernel" in w.flat:
            put(f"{tk}.m.{i}.cv1", f"{base}/BottleneckV5_{i}/ConvBN_0")
            put(f"{tk}.m.{i}.cv2", f"{base}/BottleneckV5_{i}/ConvBN_1")
            i += 1
        w.conv(f"{prefix}{tk}.cv3", f"{base}/Conv_0")
        w.conv(f"{prefix}{tk}.cv2", f"{base}/Conv_1")
        w.bn(f"{prefix}{tk}.bn", base)
        put(f"{tk}.cv4", f"{base}/ConvBN_1")

    put("seq0_Focus.conv", "Focus_0/ConvBN_0")
    put("seq1_Conv", "ConvBN_0")
    put("seq2_Bottleneck.cv1", "BottleneckV5_0/ConvBN_0")
    put("seq2_Bottleneck.cv2", "BottleneckV5_0/ConvBN_1")
    put("seq3_Conv", "ConvBN_1")
    csp("seq4_BottleneckCSP", "BottleneckCSP_0")
    put("seq5_Conv", "ConvBN_2")
    csp("seq6_BottleneckCSP", "BottleneckCSP_1")
    put("seq7_Conv", "ConvBN_3")
    put("seq8_SPP.cv1", "SPP_0/ConvBN_0")
    put("seq8_SPP.cv2", "SPP_0/ConvBN_1")
    csp("seq9_BottleneckCSP", "BottleneckCSP_2")
    csp("seq10_BottleneckCSP", "BottleneckCSP_3")
    w.conv(f"{prefix}seq11_Conv2d", "Conv_0")
    put("seq14_Conv", "ConvBN_4")
    csp("seq15_BottleneckCSP", "BottleneckCSP_4")
    w.conv(f"{prefix}seq16_Conv2d", "Conv_1")
    put("seq19_Conv", "ConvBN_5")
    csp("seq20_BottleneckCSP", "BottleneckCSP_5")
    w.conv(f"{prefix}seq21_Conv2d", "Conv_2")


def ref_retinanet(w: RefWriter):
    ref_resnet50(w, prefix="fpn.", fpn="ResNetFPN_0/")
    for tk, fk in (("fpn.conv6", "Conv_0"), ("fpn.conv7", "Conv_1"),
                   ("fpn.latlayer1", "Conv_2"), ("fpn.toplayer1", "Conv_3"),
                   ("fpn.latlayer2", "Conv_4"), ("fpn.toplayer2", "Conv_5"),
                   ("fpn.latlayer3", "Conv_6")):
        w.conv(tk, f"ResNetFPN_0/{fk}")
    for tname, fname in (("loc_head", "_Head_0"), ("cls_head", "_Head_1")):
        for j, ti in enumerate((0, 2, 4, 6, 8)):
            w.conv(f"{tname}.{ti}", f"{fname}/Conv_{j}")


# --- the comparisons ---------------------------------------------------------


def _as_torch(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _port_keys(name, ssd_bn=False):
    return set(build_model(name, C, ssd_bn=ssd_bn, device="cpu")
               .state_dict())


ROUTES = {   # case: (family, ssd_bn, writer, n, description)
    "ssd_vgg16": ("SSD", False, ref_vgg16, 13, "vgg16 backbone"),
    "ssd_bn_vgg16": ("SSD", True, ref_vgg16, 13, "vgg16 backbone"),
    "ssd_reference": ("SSD", False, ref_ssd, 35,
                      "reference SSD (full model)"),
    "retinanet_resnet50": ("RetinaNet", False,
                           lambda w: ref_resnet50(w, fpn="ResNetFPN_0/"), 53,
                           "resnet50 backbone"),
    "yolov2_reference": ("YOLOv2", False, ref_yolov2, 23,
                         "reference YOLOv2 (full model)"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_router_loads_as_jax_does(case):
    """``load_torch_checkpoint`` by key signature: the port's state equals
    JAX's loaded variables bit for bit, same ``n`` and description."""
    name, ssd_bn, write, want_n, want_desc = ROUTES[case]
    params, stats = jax_zeros(name, ssd_bn)
    w = RefWriter(params, seed=len(case))
    write(w)
    rec = Recording(w.out)
    jp, js, jn, jdesc = jax_tw.load_torch_checkpoint(name, params, stats, rec)
    assert rec.read == set(w.out)
    got, n, desc = tw.load_torch_checkpoint(
        name, state_dict_from_flax(params, stats), _as_torch(w.out))
    assert (n, desc) == (jn, jdesc) == (want_n, want_desc)
    _assert_equal(got, state_dict_from_flax(jp, js))
    assert set(got) == _port_keys(name, ssd_bn)
    if case == "ssd_bn_vgg16":      # the convs loaded, their BN untouched
        assert not torch.equal(got["_VGGStack_0.ConvBN_0.Conv_0.weight"],
                               torch.zeros_like(
                                   got["_VGGStack_0.ConvBN_0.Conv_0.weight"]))
        assert "_VGGStack_0.ConvBN_0.Conv_0.bias" not in got
        assert torch.equal(got["_VGGStack_0.ConvBN_0.BatchNorm_0.weight"],
                           torch.zeros(64))


def _jax_ssd(params, stats, sd):
    """JAX's SSD transplant in the others' (params, stats, n) form."""
    params, n = jax_tw.load_reference_ssd(params, sd)
    return params, stats, n


TRANSPLANTS = {   # family: (writer, JAX loader, port loader)
    "SSD": (ref_ssd, _jax_ssd, tw.load_reference_ssd),
    "YOLOv2": (ref_yolov2, jax_tw.load_reference_yolov2,
               tw.load_reference_yolov2),
    "YOLOv3": (ref_yolov3, jax_tw.load_reference_yolov3,
               tw.load_reference_yolov3),
    "YOLOv4": (ref_yolov4, jax_tw.load_reference_yolov4,
               tw.load_reference_yolov4),
    "YOLOv5": (ref_yolov5, jax_tw.load_reference_yolov5,
               tw.load_reference_yolov5),
    "RetinaNet": (ref_retinanet, jax_tw.load_reference_retinanet,
                  tw.load_reference_retinanet),
}


@pytest.mark.parametrize("name", list(TRANSPLANTS))
def test_reference_transplant_equals_jax(name):
    """Each ``load_reference_*`` on a full reference state dict (YOLOv5:
    the Focus stem's input channels permuted blockwise [0, 2, 1, 3])."""
    write, jax_load, port_load = TRANSPLANTS[name]
    params, stats = jax_zeros(name)
    w = RefWriter(params, seed=7)
    write(w)
    rec = Recording(w.out)
    jp, js, jn = jax_load(params, stats, rec)
    assert rec.read == set(w.out)
    got, n = port_load(state_dict_from_flax(params, stats), _as_torch(w.out))
    assert n == jn
    _assert_equal(got, state_dict_from_flax(jp, js))
    assert set(got) == _port_keys(name)
    if name == "YOLOv5":
        ref = torch.from_numpy(w.out["backbone_head.seq0_Focus.conv.conv"
                                     ".weight"])
        stem = got["Focus_0.ConvBN_0.Conv_0.weight"]
        c = ref.shape[1] // 4
        assert torch.equal(stem[:, c:2 * c], ref[:, 2 * c:3 * c])
        assert torch.equal(stem[:, 2 * c:3 * c], ref[:, c:2 * c])


def test_resnet50_into_a_bare_fpn():
    """Without the ``ResNetFPN_0.`` prefix in the target (a bare
    ResNetFPN) the keys are unprefixed, as JAX detects it."""
    params, stats = jax_zeros("RetinaNet")
    params, stats = params["ResNetFPN_0"], stats["ResNetFPN_0"]
    w = RefWriter(params, seed=3)
    ref_resnet50(w)
    jp, js, jn = jax_tw.load_resnet50_into_retinanet(params, stats, w.out)
    got, n = tw.load_resnet50_into_retinanet(
        state_dict_from_flax(params, stats), _as_torch(w.out))
    assert n == jn == 53
    _assert_equal(got, state_dict_from_flax(jp, js))


def test_partial_vgg16_skips_missing_convs():
    params, stats = jax_zeros("SSD")
    w = RefWriter(params, seed=5)
    ref_vgg16(w, convs=(0, 10, 28))
    jp, jn = jax_tw.load_vgg16_into_ssd(params, w.out)
    got, n = tw.load_vgg16_into_ssd(state_dict_from_flax(params, stats),
                                    _as_torch(w.out))
    assert n == jn == 3
    _assert_equal(got, state_dict_from_flax(jp, stats))
    assert not got["_VGGStack_1.ConvBN_0.Conv_0.weight"].any()
    assert not got["_VGGStack_0.ConvBN_1.Conv_0.weight"].any()


def test_errors_match_jax():
    """The router's ValueError for the families it does not route; a
    missing key of a full-model route, an unknown VGG target and a conv of
    another shape raise the same types in both packages."""
    for name in ("YOLOv5", "YOLOv3", "YOLOv4"):
        with pytest.raises(ValueError, match="no torch-checkpoint"):
            jax_tw.load_torch_checkpoint(name, {}, {}, {"x": np.zeros(1)})
        with pytest.raises(ValueError, match="no torch-checkpoint"):
            tw.load_torch_checkpoint(name, {}, {"x": torch.zeros(1)})

    params, stats = jax_zeros("YOLOv2")
    w = RefWriter(params, seed=1)
    ref_yolov2(w)
    target = state_dict_from_flax(params, stats)
    missing = {k: v for k, v in w.out.items()
               if k != "stage2_a_conv3.1.running_var"}
    with pytest.raises(KeyError):
        jax_tw.load_torch_checkpoint("YOLOv2", params, stats, missing)
    with pytest.raises(KeyError):
        tw.load_torch_checkpoint("YOLOv2", target, _as_torch(missing))
    bad = dict(w.out, **{"stage1_conv3.0.weight": np.zeros((128, 64, 1, 1),
                                                           np.float32)})
    with pytest.raises(AssertionError):
        jax_tw.load_reference_yolov2(params, stats, bad)
    with pytest.raises(AssertionError):
        tw.load_reference_yolov2(target, _as_torch(bad))

    sp, ss = jax_zeros("SSD")
    v = RefWriter(sp, seed=2)
    ref_vgg16(v, convs=(0, 28))
    no_stack1 = {k: x for k, x in sp.items() if k != "_VGGStack_1"}
    with pytest.raises(KeyError, match="not found"):
        jax_tw.load_vgg16_into_ssd(no_stack1, v.out)
    port_no_stack1 = {k: x for k, x in state_dict_from_flax(sp, ss).items()
                      if not k.startswith("_VGGStack_1.")}
    with pytest.raises(KeyError, match="not found"):
        tw.load_vgg16_into_ssd(port_no_stack1, _as_torch(v.out))


def test_read_torch_state_dict_forms(tmp_path):
    """A pickled module, a ``{"state_dict": ...}`` wrapper and a plain
    dict read to the same tensors as JAX's reader gives as arrays."""
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.ReLU(),
                              torch.nn.BatchNorm2d(4))
    want = net.state_dict()
    forms = {"module.pt": net, "wrapped.pt": {"state_dict": want,
                                              "epoch": 3},
             "plain.pt": dict(want)}
    for fname, obj in forms.items():
        path = str(tmp_path / fname)
        torch.save(obj, path)
        got = tw.read_torch_state_dict(path)
        ref = jax_tw.read_torch_state_dict(path)
        assert got.keys() == want.keys() == ref.keys(), fname
        for k in want:
            assert torch.equal(got[k], want[k]), (fname, k)
            np.testing.assert_array_equal(got[k].numpy(), ref[k])


def test_convert_generic_conv_bn():
    rng = np.random.default_rng(0)
    sd = {"a.conv.weight": rng.standard_normal((4, 2, 3, 3), np.float32)}
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        sd[f"a.bn.{leaf}"] = rng.standard_normal(4, np.float32)
    jw, jbn = jax_tw.convert_generic_conv_bn("a", sd)
    w, bn = tw.convert_generic_conv_bn("a", sd)
    np.testing.assert_array_equal(w.numpy().transpose(2, 3, 1, 0), jw)
    for leaf, jleaf in (("weight", "scale"), ("bias", "bias"),
                        ("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_array_equal(bn[leaf].numpy(), jbn[jleaf])
    with pytest.raises(AssertionError):
        tw.conv_to_flax(np.zeros((4, 2), np.float32))


def _vgg_file(path, convs):
    params, _ = jax_zeros("SSD")
    w = RefWriter(params, seed=11)
    ref_vgg16(w, convs=convs)
    torch.save(_as_torch(w.out), path)
    return w.out


def test_trainer_loads_torch_ckpt(tmp_path, capsys):
    """``cfg.torch_ckpt`` in the port's Trainer (SSD-300, a whole VGG16
    ``features.*`` file): the first VGG conv equals the file's tensor, and
    JAX's line is printed."""
    path = str(tmp_path / "vgg16.pth")
    ref = _vgg_file(path, tw.VGG16_CONV_IDX)
    cfg = Config(data_module="Synthetic", synthetic_size=4, batch_size=1,
                 model_name="SSD", img_size=300, max_boxes=8,
                 log_dir=str(tmp_path / "log"), torch_ckpt=path,
                 mesh_shape=(1, 1))
    t = loop.Trainer(cfg, device="cpu")
    got = t.model._VGGStack_0.ConvBN_0.Conv_0
    assert torch.equal(got.weight.detach(),
                       torch.from_numpy(ref["features.0.weight"]))
    assert torch.equal(got.bias.detach(),
                       torch.from_numpy(ref["features.0.bias"]))
    assert (f"[trainer] loaded 13 tensors from {path} (vgg16 backbone)"
            in capsys.readouterr().out)


def test_ema_keeps_the_init_in_both_packages(tmp_path):
    """With ``ema_decay > 0`` both Trainers load the checkpoint into the
    parameters after the EMA copied the init (JAX ``train/loop.py:66-76``):
    the loaded conv's EMA differs from the file and equals the init, while
    an unloaded conv's EMA equals its parameter."""
    from objectdetectionpl_tpu.config import Config as JaxConfig
    from objectdetectionpl_tpu.train.loop import Trainer as JaxTrainer

    path = str(tmp_path / "vgg16_conv0.pth")
    ref = torch.from_numpy(_vgg_file(path, (0,))["features.0.weight"])
    kw = dict(data_module="Synthetic", synthetic_size=4, batch_size=1,
              model_name="SSD", img_size=300, max_boxes=8, torch_ckpt=path,
              ema_decay=0.999, mesh_shape=(1, 1))

    port = loop.Trainer(Config(log_dir=str(tmp_path / "port"), **kw),
                        device="cpu")
    init = build_model("SSD", port.num_classes, device="cpu", seed=0)
    name = "_VGGStack_0.ConvBN_0.Conv_0.weight"
    assert torch.equal(port.state.params[name].detach(), ref)
    assert torch.equal(port.state.ema_params[name],
                       init.state_dict()[name])
    assert not torch.equal(port.state.ema_params[name], ref)
    other = "_VGGStack_0.ConvBN_1.Conv_0.weight"
    assert torch.equal(port.state.ema_params[other],
                       port.state.params[other].detach())

    jt = JaxTrainer(JaxConfig(log_dir=str(tmp_path / "jax"), **kw))
    flat = lambda t: traverse_util.flatten_dict(t, sep="/")
    params, ema = flat(jt.state.params), flat(jt.state.ema_params)
    k = "_VGGStack_0/ConvBN_0/Conv_0/kernel"
    np.testing.assert_array_equal(np.asarray(params[k]),
                                  ref.numpy().transpose(2, 3, 1, 0))
    assert not np.array_equal(np.asarray(ema[k]), np.asarray(params[k]))
    o = "_VGGStack_0/ConvBN_1/Conv_0/kernel"
    np.testing.assert_array_equal(np.asarray(ema[o]), np.asarray(params[o]))
