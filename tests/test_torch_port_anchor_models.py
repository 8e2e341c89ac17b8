"""Port RetinaNet and SSD and their new blocks against the JAX package, on
weights carried over with ``state_dict_from_flax`` and loaded with
``strict=True``.

Variables: the flax tree's shapes from ``jax.eval_shape`` (no init
compile); kernels drawn with numpy at sqrt(2 / fan_in) (He: these are ReLU
stacks, and SSD's VGG has no BN to renormalise), biases N(0, 0.1), BN
scale/bias/mean/var drawn as in ``test_torch_port_blocks``.  Float32 on the
CPU on both sides.

- RetinaNet at 128 px, B=2 (p3..p7 16x16 .. 1x1); SSD at its 300 px, B=1,
  ``use_bn`` False and True.  Eval mode: every output within ``EVAL_REL`` =
  1e-5 of its largest |value| (max |diff| over max |ref|; measured: at most
  2.5e-6 for RetinaNet, 4e-6 for SSD).  Train mode (batch moments):
  outputs and the running statistics after the forward within
  ``TRAIN_REL`` = 1e-3 of each tensor's largest |value| (measured: outputs
  3.5e-4 for RetinaNet, whose c5 map (4x4) normalises 32 samples a channel,
  2e-5 for SSD with BN; statistics 1.1e-4); SSD without BN has nothing to
  normalise, and its train-mode forward is the eval one.
- ``resize_bilinear``: 19 -> 38 and 38 -> 75 (RetinaNet's FPN at 600 px,
  the second not an integer ratio), a tie of the contraction order
  (square) and a downscale (5 -> 3, JAX's antialiasing), in f32 within
  ``rtol=atol=1e-6`` of ``jax.image.resize`` everywhere, border rows and
  columns included (measured: within 2.4e-7 of values up to ~4), and in
  bf16 equal bit for bit.  ``F.interpolate`` is not: 6.7e-6 off on
  38 -> 75 in f32, and in bf16 up to one bf16 ulp of the input's largest
  value (it rounds once, JAX three times: the weights, the intermediate,
  the result).
- ``_ceil_pool`` on odd and even sizes, exactly.
- Initialisation: each initializer's sample moments against the JAX
  formula (flax ``variance_scaling``) and against JAX's own draw of the
  same shape: the standard deviation within 2 %, the truncated ones inside
  2 stddev of the un-truncated normal, the He fan-out normal not.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn
from flax import traverse_util

from objectdetectionpl_tpu.models import registry as jax_registry
from objectdetectionpl_tpu.models import ssd as jax_ssd
from objectdetectionpl_tpu.nn import blocks as jb
from objectdetectionpl_tpu_torch.models import MODELS, build_model
from objectdetectionpl_tpu_torch.models import ssd as port_ssd
from objectdetectionpl_tpu_torch.nn import blocks as pb
from objectdetectionpl_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(2)

C = 3
EVAL_REL = 1e-5
TRAIN_REL = 1e-3

CASES = {
    "RetinaNet": ("RetinaNet", {}, 128, 2),
    "SSD": ("SSD", {"ssd_bn": False}, 300, 1),
    "SSD_bn": ("SSD", {"ssd_bn": True}, 300, 1),
}


def he_variables(module, x, seed):
    """numpy (params, batch_stats) trees of ``module`` drawn at random."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    rng = np.random.RandomState(seed)
    draw = {
        "kernel": lambda s: rng.normal(0.0, (2.0 / np.prod(s[:-1])) ** 0.5,
                                       s),
        "bias": lambda s: rng.normal(0.0, 0.1, s),
        "scale": lambda s: rng.uniform(0.5, 1.5, s),
        "mean": lambda s: rng.normal(0.0, 0.1, s),
        "var": lambda s: rng.uniform(0.5, 2.0, s),
    }
    trees = []
    for name in ("params", "batch_stats"):
        flat = traverse_util.flatten_dict(dict(shapes.get(name, {})))
        trees.append(traverse_util.unflatten_dict({
            path: draw[path[-1]](s.shape).astype(np.float32)
            for path, s in flat.items()}))
    return tuple(trees)


def max_rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    name, kw, img, B = CASES[request.param]
    jm = jax_registry.build_model(name, C, **kw)
    x = np.random.RandomState(0).rand(B, img, img, 3).astype(np.float32)
    params, stats = he_variables(jm, x, seed=1)
    port = build_model(name, C, device="cpu", **kw)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return request.param, jm, port, params, stats, x


def test_eval_forward_matches_jax(case):
    _, jm, port, params, stats, x = case
    want = jax.jit(lambda v, i: jm.apply(v, i, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert max_rel(g.numpy(), w) < EVAL_REL


def test_train_forward_and_running_stats_match_jax(case):
    """SSD without BN: train mode is the eval forward, and there are no
    statistics to move."""
    name, jm, port, params, stats, x = case
    want, upd = jax.jit(lambda v, i: jm.apply(
        v, i, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x))
    port.eval()
    for g, w in zip(got, want):
        assert max_rel(g.numpy(), w) < TRAIN_REL
    want_sd = state_dict_from_flax(params, jax.tree.map(
        np.asarray, dict(upd.get("batch_stats", {}))))
    got_sd = port.state_dict()
    n = 0
    for k, w in want_sd.items():
        if "running" in k:
            assert max_rel(got_sd[k].numpy(), w.numpy()) < TRAIN_REL, k
            n += 1
    assert n == 2 * sum(1 for m in port.modules()
                        if isinstance(m, pb.BatchNorm))
    assert (n > 0) == (name != "SSD")


@pytest.mark.parametrize("name,kw,n_params,n_stats,heads", [
    ("RetinaNet", {}, 193, 106, 17),
    ("SSD", {"ssd_bn": False}, 70, 0, 35),
    ("SSD", {"ssd_bn": True}, 83, 26, 22),
])
def test_bridge_loads_strictly(name, kw, n_params, n_stats, heads):
    """Every flax leaf lands on a state_dict entry of the same shape: the
    FPN's ``Conv_0..6`` in flax's creation order, the shared heads
    ``_Head_0/1``, SSD's ``_VGGStack_0/1`` and its alternating class / box
    heads; ``build_model`` gives the output contract at the published
    sizes (RetinaNet 600 px: 67995 anchors)."""
    jm = jax_registry.build_model(name, C, **kw)
    img = 300 if name == "SSD" else 128
    params, stats = he_variables(jm, np.zeros((1, img, img, 3)), seed=0)
    assert (len(traverse_util.flatten_dict(params)),
            len(traverse_util.flatten_dict(stats))) == (n_params, n_stats)
    port = build_model(name, C, device="cpu", **kw)
    sd = state_dict_from_flax(params, stats)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in port.state_dict().items()}
    port.load_state_dict(sd, strict=True)
    biased = [k for k in sd if k.endswith(".bias") and "BatchNorm" not in k]
    assert len(biased) == heads
    if name == "SSD":       # class head then box head, per scale
        assert sd["Conv_2.weight"].shape[0] == 4 * (C + 1)
        assert sd["Conv_3.weight"].shape[0] == 4 * 4
        assert sd["Conv_4.weight"].shape[0] == 6 * (C + 1)
    else:                   # p6 on c5, laterals 1x1, smoothing 3x3
        fpn = {k: tuple(v.shape) for k, v in sd.items()
               if k.startswith("ResNetFPN_0.Conv_") and "weight" in k}
        assert [fpn[f"ResNetFPN_0.Conv_{i}.weight"][1:] for i in range(7)] \
            == [(2048, 3, 3), (256, 3, 3), (2048, 1, 1), (256, 3, 3),
                (1024, 1, 1), (256, 3, 3), (512, 1, 1)]
    size = 300 if name == "SSD" else 600
    with torch.no_grad():
        loc, cls = port(torch.zeros(1, size, size, 3))
    A = 8732 if name == "SSD" else 67995
    assert loc.shape == (1, A, 4)
    assert cls.shape == (1, A, C + 1 if name == "SSD" else C)


# --- blocks ------------------------------------------------------------------


def _resize_pair(x, size, dtype=jnp.float32):
    """(port, JAX) resizes of NHWC ``x`` in ``dtype``, as f32 numpy."""
    xj = jnp.asarray(x, dtype)
    want = np.asarray(jb.resize_bilinear(xj, size).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, jnp.dtype(dtype).name)).permute(0, 3, 1, 2)
    got = pb.resize_bilinear(xt, size)
    assert got.dtype == xt.dtype
    return got.permute(0, 2, 3, 1).float().numpy(), want


RESIZES = [((19, 19), (38, 38)), ((38, 38), (75, 75)), ((19, 20), (38, 39)),
           ((5, 6), (3, 4))]


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_bilinear_matches_jax(src, dst):
    x = np.random.RandomState(src[0]).randn(2, *src, 5).astype(np.float32)
    got, want = _resize_pair(x, dst)
    assert got.shape == want.shape == (2, *dst, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the border rows and columns take the edge pixels' weights as JAX does
    for sl in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_allclose(got[sl], want[sl], rtol=1e-6, atol=1e-6)
    if dst[0] == 2 * src[0]:    # half-pixel centres: the corner is a copy
        np.testing.assert_allclose(got[:, 0, 0], x[:, 0, 0], rtol=1e-6)
    if src == (38, 38):         # what F.interpolate would give instead
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        interp = torch.nn.functional.interpolate(
            xt, size=dst, mode="bilinear", align_corners=False)
        assert np.abs(interp.permute(0, 2, 3, 1).numpy() - want).max() \
            > 1e-6


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_bilinear_bf16_equals_jax(src, dst):
    x = np.random.RandomState(src[0]).randn(2, *src, 8).astype(np.float32)
    got, want = _resize_pair(x, dst, jnp.bfloat16)
    np.testing.assert_array_equal(got, want)


def test_resize_matrices_are_made_once_and_serve_a_backward():
    """The interpolation matrices are copied to a device once per size and
    dtype; one first made under inference mode (serving) still serves a
    training forward's backward, whose input gradient is each input
    pixel's total weight."""
    pb._RESIZE_MATRICES.clear()
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 5, 7, 9)
                         .astype(np.float32))
    with torch.inference_mode():
        served = pb.resize_bilinear(x, (13, 17))
    assert len(pb._RESIZE_MATRICES) == 2
    xg = x.clone().requires_grad_(True)
    out = pb.resize_bilinear(xg, (13, 17))
    assert len(pb._RESIZE_MATRICES) == 2
    torch.testing.assert_close(out.detach(), served, rtol=0, atol=0)
    out.sum().backward()
    wh = pb._resize_weights(7, 13).sum(1)
    ww = pb._resize_weights(9, 17).sum(1)
    want = np.broadcast_to(wh[:, None] * ww[None, :], (2, 5, 7, 9))
    np.testing.assert_allclose(xg.grad.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("h,w", [(75, 75), (38, 38), (5, 8), (1, 3)])
def test_ceil_pool_matches_jax(h, w):
    x = np.random.RandomState(h * w).randn(2, h, w, 4).astype(np.float32)
    want = np.asarray(jax_ssd._ceil_pool(jnp.asarray(x)))
    got = port_ssd._ceil_pool(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert want.shape == (2, -(-h // 2), -(-w // 2), 4)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_conv_dilation_padding_and_convbn_without_bn_match_jax():
    x = np.random.RandomState(3).randn(2, 11, 11, 6).astype(np.float32)
    cases = [
        (jb.ConvBN(8, 3, dilation=3, act="relu", use_bn=False),
         pb.ConvBN(6, 8, 3, dilation=3, act="relu", use_bn=False)),
        (jb.ConvBN(8, 1, stride=2, act="linear"),
         pb.ConvBN(6, 8, 1, 2, act="linear")),
        (jb.ConvBN(8, 7, stride=2, act="relu"),
         pb.ConvBN(6, 8, 7, 2, act="relu")),
    ]
    for jm, pm in cases:
        params, stats = he_variables(jm, x, seed=4)
        want = jm.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x), train=False)
        pm.load_state_dict(state_dict_from_flax(params, stats), strict=True)
        with torch.no_grad():
            got = pm.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
    assert cases[0][1].BatchNorm_0 is None
    # a VALID 3x3 (SSD's f5/f6): padding 0 shrinks 5 -> 3
    jm = fnn.Conv(4, (3, 3), padding="VALID")
    pm = pb.Conv(6, 4, 3, bias=True, padding=0)
    x5 = x[:, :5, :5]
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x5))["params"])
    pm.load_state_dict(state_dict_from_flax(params, {}), strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x5).permute(0, 3, 1, 2))
    want = jm.apply({"params": params}, jnp.asarray(x5))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_activations_relu_and_linear():
    x = torch.linspace(-3, 3, 61)
    torch.testing.assert_close(pb.ACTIVATIONS["relu"](x), x.clamp(min=0))
    assert pb.ACTIVATIONS["linear"](x) is x
    np.testing.assert_array_equal(
        pb.ACTIVATIONS["relu"](x).numpy(),
        np.asarray(jb.ACTIVATIONS["relu"](jnp.asarray(x.numpy()))))


# --- initialisation ------------------------------------------------------------


INITS = {
    # port name: (JAX initializer, truncated)
    "lecun_normal": (jax.nn.initializers.lecun_normal(), True),
    "xavier_normal": (jax.nn.initializers.xavier_normal(), True),
    "kaiming_fan_out": (jax.nn.initializers.variance_scaling(
        2.0, "fan_out", "normal"), False),
}


@pytest.mark.parametrize("init", sorted(INITS))
@pytest.mark.parametrize("shape", [(3, 3, 256, 128), (1, 1, 512, 64)])
def test_init_statistics_match_the_jax_formula(init, shape):
    jax_init, truncated = INITS[init]
    kh, kw, cin, cout = shape
    conv = pb.Conv(cin, cout, kh, init=init)
    pb.init_weights(conv, torch.Generator().manual_seed(0))
    w = conv.weight.detach().numpy()
    scale, mode, _ = pb.KERNEL_INITS[init]
    fan = {"fan_in": cin * kh * kw, "fan_out": cout * kh * kw,
           "fan_avg": (cin + cout) * kh * kw / 2}[mode]
    std = (scale / fan) ** 0.5                       # flax's target std
    jw = np.asarray(jax_init(jax.random.PRNGKey(0), shape, jnp.float32))
    for sample in (w, jw):
        assert abs(sample.mean()) < 0.02 * std
        assert abs(sample.std() / std - 1) < 0.02
    bound = 2 * std / 0.87962566103423978            # the truncation point
    if truncated:
        assert np.abs(w).max() <= bound and np.abs(jw).max() <= bound
    else:
        assert np.abs(w).max() > bound and np.abs(jw).max() > bound


def test_each_family_gets_its_init():
    ssd = MODELS["SSD"](num_classes=C)
    kinds = {n: m.init for n, m in ssd.named_modules()
             if isinstance(m, pb.Conv)}
    assert {kinds[n] for n in kinds if n.startswith("_VGGStack")} == {
        "kaiming_fan_out"}
    assert {kinds[n] for n in kinds if not n.startswith("_VGGStack")} == {
        "xavier_normal"}
    assert len(kinds) == 13 + 8 + 2 + 12
    retina = MODELS["RetinaNet"](num_classes=C)
    assert {m.init for m in retina.modules()
            if isinstance(m, pb.Conv)} == {"lecun_normal"}
    # biases start at 0, as flax's
    m = build_model("SSD", C, device="cpu", seed=3)
    assert all(float(b.detach().abs().max()) == 0.0
               for n, b in m.named_parameters()
               if n.endswith("bias"))
    with pytest.raises(ValueError, match="init="):
        pb.Conv(3, 4, 3, init="orthogonal")
