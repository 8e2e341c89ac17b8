"""Small helpers of the port against the JAX package.

- ``ops/boxes.py``'s ``xyxy_to_xywh`` and ``xyxy_to_xywh_plus1``: equal
  bit for bit in float32 on drawn corner boxes.
- ``train/state.py::param_count`` on SSD (with and without BN) and
  YOLOv5s: the JAX count over the flax init's ``params`` shapes
  (``jax.eval_shape``, no compile); the port's over its model's
  parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from objectdetectionpl_tpu.models.registry import build_model as jax_build
from objectdetectionpl_tpu.ops import boxes as jax_boxes
from objectdetectionpl_tpu.train import state as jax_state
from objectdetectionpl_tpu_torch.models import build_model
from objectdetectionpl_tpu_torch.ops import boxes
from objectdetectionpl_tpu_torch.train import state


@pytest.mark.parametrize("fn", ["xyxy_to_xywh", "xyxy_to_xywh_plus1"])
def test_box_order_equals_jax(fn):
    rng = np.random.RandomState(0)
    x1y1 = rng.uniform(-50, 600, (3, 5, 2)).astype(np.float32)
    wh = rng.uniform(0, 300, (3, 5, 2)).astype(np.float32)
    box = np.concatenate([x1y1, x1y1 + wh], -1)
    want = np.asarray(getattr(jax_boxes, fn)(jnp.asarray(box)))
    got = getattr(boxes, fn)(torch.from_numpy(box)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (3, 5, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,img,kw", [
    ("SSD", 300, {}), ("SSD", 300, {"ssd_bn": True}), ("YOLOv5", 64, {})])
def test_param_count_equals_jax(name, img, kw):
    model = jax_build(name, 3, **kw)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, img, img, 3)), train=False))
    params = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape),
                          shapes["params"])
    want = jax_state.param_count(params)
    got = state.param_count(build_model(name, 3, device="cpu", **kw))
    assert got == want > 1_000_000
