"""Port YOLOv2 (both reorgs), YOLOv3 and YOLOv4 and their new blocks
against the JAX package, on weights carried over with
``state_dict_from_flax`` and loaded with ``strict=True``.

Variables: the flax tree's shapes from ``jax.eval_shape`` (no init
compile), kernels drawn with numpy at 1/sqrt(fan_in), head biases
N(0, 0.1), BN scale/bias/mean/var drawn as in ``test_torch_port_blocks``.
Float32 on the CPU on both sides, 64 px, B=2.

- Eval mode: head maps within ``rtol=atol=1e-5`` (measured: <= 7e-6 over
  some 110 convolutions).
- Train mode (batch moments): head maps and the running statistics after
  the forward within ``TRAIN_REL`` = 2e-2 of the largest |value| of each
  tensor.  At 64 px the stride-32 maps are 2x2, so a BN there normalizes 8
  samples per channel; where a channel's variance is small,
  ``E[x^2] - E[x]^2`` cancels and amplifies the two frameworks'
  summation-order differences (measured: 1.7e-3 .. 7.2e-3 of the maximum
  for YOLOv4, 5e-4 for YOLOv2/v3; 3.5e-4 .. 1e-3 for YOLOv4 at 128 px).
  Mish is ``F.mish`` in the port: swapping in the JAX formula
  ``x * tanh(softplus(x))`` moves these errors by less than 10 %.
- ``mish`` elementwise within ``rtol=2e-6, atol=1e-7``; the reorgs, which
  only move values, exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from objectdetectionpl_tpu.models import registry as jax_registry
from objectdetectionpl_tpu.nn import blocks as jb
from objectdetectionpl_tpu_torch.models import MODELS, build_model
from objectdetectionpl_tpu_torch.nn import blocks as pb
from objectdetectionpl_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_port_blocks import _compare, _x

torch.set_num_threads(2)

C = 3
IMG = 64
EVAL_TOL = dict(rtol=1e-5, atol=1e-5)
TRAIN_REL = 2e-2

CASES = {
    "YOLOv2": ("YOLOv2", {}),
    "YOLOv2_darknet_reorg": ("YOLOv2", {"reorg": "darknet"}),
    "YOLOv3": ("YOLOv3", {}),
    "YOLOv4": ("YOLOv4", {}),
}


def drawn_variables(module, x, seed):
    """numpy (params, batch_stats) trees of ``module`` drawn at random."""
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    rng = np.random.RandomState(seed)
    draw = {
        "kernel": lambda s: rng.normal(0.0, np.prod(s[:-1]) ** -0.5, s),
        "bias": lambda s: rng.normal(0.0, 0.1, s),
        "scale": lambda s: rng.uniform(0.5, 1.5, s),
        "mean": lambda s: rng.normal(0.0, 0.1, s),
        "var": lambda s: rng.uniform(0.5, 2.0, s),
    }
    trees = []
    for name in ("params", "batch_stats"):
        flat = traverse_util.flatten_dict(dict(shapes[name]))
        trees.append(traverse_util.unflatten_dict({
            path: draw[path[-1]](s.shape).astype(np.float32)
            for path, s in flat.items()}))
    return tuple(trees)


def _as_list(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    name, kw = CASES[request.param]
    jm = jax_registry.MODELS[name][0](num_classes=C, **kw)
    x = np.random.RandomState(0).rand(2, IMG, IMG, 3).astype(np.float32)
    params, stats = drawn_variables(jm, x, seed=1)
    port = MODELS[name](num_classes=C, **kw)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return jm, port, params, stats, x


def test_eval_forward_matches_jax(case):
    jm, port, params, stats, x = case
    want = jax.jit(lambda v, i: jm.apply(v, i, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    want, got = _as_list(want), _as_list(got)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **EVAL_TOL)


def test_train_forward_and_running_stats_match_jax(case):
    jm, port, params, stats, x = case
    want, upd = jax.jit(lambda v, i: jm.apply(
        v, i, train=True, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x))
    port.eval()
    for g, w in zip(_as_list(got), _as_list(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=TRAIN_REL * np.abs(w).max())
    want_sd = state_dict_from_flax(params, jax.tree.map(
        np.asarray, upd["batch_stats"]))
    got_sd = port.state_dict()
    n = 0
    for k, w in want_sd.items():
        if "running" in k:
            np.testing.assert_allclose(got_sd[k].numpy(), w.numpy(), rtol=0,
                                       atol=TRAIN_REL * w.abs().max().item(),
                                       err_msg=k)
            n += 1
    assert n == 2 * sum(1 for m in port.modules()
                        if isinstance(m, pb.BatchNorm))


@pytest.mark.parametrize("name,n_params,n_stats", [
    ("YOLOv2", 67, 44), ("YOLOv3", 222, 144), ("YOLOv4", 327, 214)])
def test_bridge_loads_strictly(name, n_params, n_stats):
    """Every flax leaf lands on a state_dict entry of the same shape
    (auto-names such as ``_DetectSeq_0``, ``Residual_22``,
    ``MishResBlock_0`` and the YOLOv4 head ``Conv_0..2`` included), and
    ``build_model`` gives the output contract."""
    jm = jax_registry.build_model(name, C)
    params, stats = drawn_variables(jm, np.zeros((1, IMG, IMG, 3)), seed=0)
    assert (len(traverse_util.flatten_dict(params)),
            len(traverse_util.flatten_dict(stats))) == (n_params, n_stats)
    port = build_model(name, C, device="cpu")
    sd = state_dict_from_flax(params, stats)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in port.state_dict().items()}
    port.load_state_dict(sd, strict=True)
    heads = [k for k in sd if k.endswith(".bias") and "BatchNorm" not in k]
    assert len(heads) == {"YOLOv2": 0, "YOLOv3": 3, "YOLOv4": 3}[name]
    with torch.no_grad():
        out = _as_list(port(torch.zeros(1, IMG, IMG, 3)))
    grids = {"YOLOv2": [2], "YOLOv3": [2, 4, 8], "YOLOv4": [8, 4, 2]}[name]
    A = 5 if name == "YOLOv2" else 3
    assert [tuple(o.shape) for o in out] == [(1, A * (5 + C), g, g)
                                             for g in grids]


def test_unknown_reorg_raises():
    with pytest.raises(ValueError, match="reorg"):
        MODELS["YOLOv2"](num_classes=C, reorg="slices")


def test_mish_matches_jax():
    x = np.concatenate([np.linspace(-30, 30, 2001),
                        np.random.RandomState(0).randn(1000) * 4,
                        [-100.0, -20.0, 0.0, 20.0, 100.0]]).astype(np.float32)
    want = np.asarray(jb.mish(jnp.asarray(x)))
    got = pb.ACTIVATIONS["mish"](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)


def test_reorg_darknet_bug_matches_jax():
    x = _x((2, 8, 6, 12), seed=3)                      # NHWC
    want = np.asarray(jb.reorg_darknet_bug(jnp.asarray(x)))
    got = pb.reorg_darknet_bug(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    # not a space-to-depth: the channel blocks hold other positions
    s2d = pb.space_to_depth(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    assert not torch.equal(got, s2d)


def test_residual_matches_jax():
    _compare(jb.Residual(mid=4, out=8), pb.Residual(8, 4), _x((2, 6, 6, 8)))


@pytest.mark.parametrize("nblocks", [1, 2])
def test_mish_res_block_matches_jax(nblocks):
    _compare(jb.MishResBlock(ch=6, nblocks=nblocks),
             pb.MishResBlock(6, nblocks), _x((2, 5, 5, 6), seed=nblocks))
