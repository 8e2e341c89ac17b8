"""Port blocks (``objectdetectionpl_tpu_torch.nn.blocks``) and box ops against
the JAX package, on weights carried over with ``state_dict_from_flax``.

BN parameters and statistics are drawn at random before every comparison
(flax init leaves scale=1, bias=0, mean=0, var=1, which would hide a
mis-mapped BN).  Float32 on the CPU on both sides; tolerance
``rtol=atol=1e-5`` for single blocks (one to a dozen convs whose sums XLA
and torch order differently), exact where no arithmetic is involved.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from objectdetectionpl_tpu.nn import blocks as jb
from objectdetectionpl_tpu.ops import boxes as jax_boxes
from objectdetectionpl_tpu_torch.nn import blocks as pb
from objectdetectionpl_tpu_torch.ops import boxes as port_boxes
from objectdetectionpl_tpu_torch.utils.weights import state_dict_from_flax

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def randomized_variables(module, x, seed, jit=False):
    """flax init, then BN scale/bias/mean/var drawn at random; numpy trees.
    ``jit`` compiles the init, which pays off for a whole model."""
    init = lambda i: module.init(jax.random.PRNGKey(seed), i, train=False)
    variables = (jax.jit(init) if jit else init)(jnp.asarray(x))
    rng = np.random.RandomState(seed)
    params = traverse_util.flatten_dict(jax.tree.map(np.asarray,
                                                     variables["params"]))
    stats = traverse_util.flatten_dict(jax.tree.map(
        np.asarray, dict(variables.get("batch_stats", {}))))
    draw = {
        "scale": lambda n: rng.uniform(0.5, 1.5, n),
        "bias": lambda n: rng.normal(0.0, 0.1, n),
        "mean": lambda n: rng.normal(0.0, 0.1, n),
        "var": lambda n: rng.uniform(0.5, 2.0, n),
    }
    for tree in (params, stats):
        for path, v in tree.items():
            if path[-2].startswith("BatchNorm"):
                tree[path] = draw[path[-1]](v.shape).astype(np.float32)
    return (traverse_util.unflatten_dict(params),
            traverse_util.unflatten_dict(stats))


def _compare(jax_module, port_module, x, seed=0, tol=TOL):
    params, stats = randomized_variables(jax_module, x, seed)
    want = jax_module.apply({"params": params, "batch_stats": stats},
                            jnp.asarray(x), train=False)
    port_module.load_state_dict(state_dict_from_flax(params, stats),
                                strict=True)
    port_module.eval()
    with torch.no_grad():
        got = port_module(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **tol)


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_space_to_depth_matches_jax():
    x = _x((2, 8, 6, 5))
    want = np.asarray(jb.space_to_depth(jnp.asarray(x), 2, via="slices"))
    got = pb.space_to_depth(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_upsample2x_and_max_pool_match_jax():
    x = _x((2, 5, 7, 3))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(
        pb.upsample2x(xt).permute(0, 2, 3, 1).numpy(),
        np.asarray(jb.upsample2x(jnp.asarray(x))))
    for k in (5, 9, 13):
        np.testing.assert_array_equal(
            pb.max_pool(xt, k, 1, k // 2).permute(0, 2, 3, 1).numpy(),
            np.asarray(jb.max_pool(jnp.asarray(x), k, 1, k // 2)))


@pytest.mark.parametrize("c,wm,n,dm", [(64, 0.5, 9, 0.33), (1024, 1.25, 3, 1.33),
                                       (256, 0.75, 6, 0.67)])
def test_scale_ch_and_depth_match_jax(c, wm, n, dm):
    assert pb.scale_ch(c, wm) == jb.scale_ch(c, wm)
    assert pb.scale_depth(n, dm) == jb.scale_depth(n, dm)


@pytest.mark.parametrize("stride", [1, 2])
def test_convbn_matches_jax(stride):
    _compare(jb.ConvBN(12, 3, stride=stride), pb.ConvBN(8, 12, 3, stride),
             _x((2, 10, 10, 8)), seed=stride)


@pytest.mark.parametrize("c1,shortcut", [(16, True), (12, True), (16, False)])
def test_bottleneck_v5_matches_jax(c1, shortcut):
    _compare(jb.BottleneckV5(16, shortcut),
             pb.BottleneckV5(c1, 16, shortcut), _x((2, 8, 8, c1)), seed=c1)


@pytest.mark.parametrize("n,shortcut", [(1, False), (2, True)])
def test_bottleneck_csp_matches_jax(n, shortcut):
    _compare(jb.BottleneckCSP(32, n, shortcut),
             pb.BottleneckCSP(24, 32, n, shortcut), _x((2, 8, 8, 24)), seed=n)


def test_spp_matches_jax():
    _compare(jb.SPP(32), pb.SPP(32, 32), _x((2, 16, 16, 32)), seed=3)


def test_focus_matches_jax():
    _compare(jb.Focus(16, 3), pb.Focus(3, 16, 3), _x((2, 16, 16, 3)), seed=4)


def test_batchnorm_eval_affine_and_train_mode_raises():
    """Eval mode is the folded affine over running statistics; train mode
    (which raised before the training slice) normalizes with the biased
    batch moments and moves the running statistics by 0.1 toward them.
    The flax parity of train mode is in ``test_torch_port_train.py``."""
    bn = pb.BatchNorm(4)
    rng = np.random.RandomState(0)
    with torch.no_grad():
        for t, lo, hi in ((bn.weight, 0.5, 1.5), (bn.running_var, 0.5, 2.0)):
            t.copy_(torch.from_numpy(rng.uniform(lo, hi, 4).astype(np.float32)))
        bn.bias.normal_(0, 0.1)
        bn.running_mean.normal_(0, 0.1)
    x = torch.from_numpy(_x((2, 4, 3, 3)))
    old_mean, old_var = bn.running_mean.clone(), bn.running_var.clone()
    y = bn(x)                                  # a fresh module trains
    mean = x.mean((0, 2, 3))
    var = x.var((0, 2, 3), unbiased=False)
    want = ((x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-5)
            * bn.weight[:, None, None] + bn.bias[:, None, None])
    torch.testing.assert_close(y.detach(), want.detach(), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(bn.running_mean, 0.9 * old_mean + 0.1 * mean)
    torch.testing.assert_close(bn.running_var, 0.9 * old_var + 0.1 * var)
    bn.eval()
    a = bn.weight / torch.sqrt(bn.running_var + 1e-5)
    want = (x - bn.running_mean[:, None, None]) * a[:, None, None] \
        + bn.bias[:, None, None]
    torch.testing.assert_close(bn(x).detach(), want.detach(),
                               rtol=1e-5, atol=1e-6)
    # bf16 activations: the affine is cast once, statistics stay f32
    y = bn(x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and bn.running_var.dtype == torch.float32


def test_box_ops_match_jax():
    rng = np.random.RandomState(0)
    xywh = np.concatenate([rng.uniform(0, 100, (50, 2)),
                           rng.uniform(1, 40, (50, 2))], -1).astype(np.float32)
    got = port_boxes.xywh_to_xyxy(torch.from_numpy(xywh)).numpy()
    want = np.asarray(jax_boxes.xywh_to_xyxy(jnp.asarray(xywh)))
    np.testing.assert_array_equal(got, want)
    a, b = xywh[:, None], xywh[None]
    got = port_boxes.iou_plus1(torch.from_numpy(a), torch.from_numpy(b),
                               xyxy=False).numpy()
    want = np.asarray(jax_boxes.iou_plus1(jnp.asarray(a), jnp.asarray(b),
                                          xyxy=False))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
