"""Port YOLOv5 (``objectdetectionpl_tpu_torch.models``) against the JAX model,
and the weight transforms of ``utils/weights.py`` and ``utils/fuse.py``.

The Yolov5s eval forward runs in f32 on the CPU on both sides at 128 px,
B=2, on one set of flax variables with BN drawn at random, carried over with
``state_dict_from_flax`` and loaded with ``strict=True``.  Head maps agree
within ``rtol=atol=1e-4``: some 60 convolutions deep, XLA and torch sum in
different orders, and the differences grow to ~1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from objectdetectionpl_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from objectdetectionpl_tpu.utils import fuse as jax_fuse
from objectdetectionpl_tpu_torch.models import build_model
from objectdetectionpl_tpu_torch.models.yolov5 import YOLOv5
from objectdetectionpl_tpu_torch.utils import fuse as port_fuse
from objectdetectionpl_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_port_blocks import randomized_variables

torch.set_num_threads(2)

C = 3
IMG = 128


@pytest.fixture(scope="module")
def yolov5s():
    model = JaxYOLOv5(num_classes=C)
    x = np.random.RandomState(0).rand(2, IMG, IMG, 3).astype(np.float32)
    params, stats = randomized_variables(model, x, seed=0, jit=True)
    return model, params, stats, x


def test_bridge_has_every_leaf(yolov5s):
    _, params, stats = yolov5s[:3]
    n_params = len(traverse_util.flatten_dict(params))
    n_stats = len(traverse_util.flatten_dict(stats))
    assert (n_params, n_stats) == (165, 102)
    sd = state_dict_from_flax(params, stats)
    assert len(sd) == 165 + 102
    port = YOLOv5(C)
    port.load_state_dict(sd, strict=True)     # nothing missing or left over
    w = sd["Focus_0.ConvBN_0.Conv_0.weight"]
    k = params["Focus_0"]["ConvBN_0"]["Conv_0"]["kernel"]
    assert w.shape == (32, 12, 3, 3)
    np.testing.assert_array_equal(w.numpy(), k.transpose(3, 2, 0, 1))


def test_yolov5s_forward_matches_jax(yolov5s):
    model, params, stats, x = yolov5s
    want = jax.jit(lambda v, i: model.apply(v, i, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    port = build_model("YOLOv5", C, device="cpu")
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [
        (2, 3, 16, 16, 8), (2, 3, 8, 8, 8), (2, 3, 4, 4, 8)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", ["Yolov5m", "Yolov5l", "Yolov5x"])
def test_variant_layout_and_shapes(variant):
    """Every flax leaf of the variant maps onto the port's state_dict with
    the same shape (via ``jax.eval_shape``; no JAX compile), and the port's
    forward has the output contract at 64 px."""
    jm = JaxYOLOv5(num_classes=C, variant=variant)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 64, 64, 3)),
                                            train=False))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_flax(zeros["params"], zeros["batch_stats"])
    port = build_model("YOLOv5", C, yolov5_type=variant, device="cpu")
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    with torch.no_grad():
        out = port(torch.zeros(1, 64, 64, 3))
    assert [tuple(o.shape) for o in out] == [
        (1, 3, 8, 8, 5 + C), (1, 3, 4, 4, 5 + C), (1, 3, 2, 2, 5 + C)]


def test_fuse_conv_bn_matches_jax():
    rng = np.random.RandomState(0)
    kernel = rng.randn(3, 3, 4, 8).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(0, 0.1, 8).astype(np.float32)
    mean = rng.normal(0, 0.1, 8).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    jk, jbias = jax_fuse.fuse_conv_bn(*map(jnp.asarray,
                                           (kernel, scale, bias, mean, var)))
    pw, pbias = port_fuse.fuse_conv_bn(
        torch.from_numpy(kernel.transpose(3, 2, 0, 1)),
        *map(torch.from_numpy, (scale, bias, mean, var)))
    np.testing.assert_allclose(pw.numpy(),
                               np.asarray(jk).transpose(3, 2, 0, 1),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pbias.numpy(), np.asarray(jbias),
                               rtol=1e-6, atol=1e-7)


def test_fold_input_scale_matches_jax(yolov5s):
    _, params, stats, _ = yolov5s
    want = state_dict_from_flax(
        jax.tree.map(np.asarray, jax_fuse.fold_input_scale(params,
                                                           1.0 / 255.0)),
        stats)
    sd = state_dict_from_flax(params, stats)
    got = port_fuse.fold_input_scale(sd, 1.0 / 255.0)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-7, atol=0)
    stem = port_fuse.STEM_CONV + ".weight"
    assert not torch.equal(got[stem], sd[stem])       # input left as it was
    assert got[stem].data_ptr() != sd[stem].data_ptr()
