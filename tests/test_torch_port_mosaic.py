"""Port ``mosaic_batch`` (``objectdetectionpl_tpu_torch/data/augment.py``) against the JAX package's.

f32 on the CPU on both sides.

- ``scale_translate_weights`` against ``jax.image.scale_and_translate``
  (method "linear", antialias on, precision HIGHEST) applied to an
  identity matrix, which returns the transposed weight matrix exactly:
  scales from 0.3 to 0.7 (the quadrants, downscaled with the widened
  triangle), 1 and 1.7 (upscaled), translations 0 to 0.7 x the output,
  within ``atol=1e-6``.
- ``mosaic_batch`` on JAX's own draws (the centres and the apply
  uniforms of ``PRNGKey(seed)``, split as JAX's ``mosaic_batch`` splits
  it), B=4, S=64, M=6, at p=1 and p=0.5: images within ``atol=1e-5``;
  boxes, labels and masks equal (XLA fuses a quadrant's origin and the
  scaled box centre into one multiply-add, which the port reproduces).  The boxes include duplicates (ties of
  area, which ``lax.top_k`` breaks to the lower index) and padded rows
  (all of area -1).
- A centre on a pixel boundary: the column at ``x/S == cx`` belongs to
  the right-hand quadrants, as JAX's float32 comparison puts it.
- The invariants of ``tests/test_train.py::test_mosaic_batch`` on the
  port's own draws.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from objectdetectionpl_tpu.data.augment import mosaic_batch as jax_mosaic
from objectdetectionpl_tpu_torch.data.augment import (mosaic_batch,
                                                      scale_translate_weights)

B, S, M = 4, 64, 6


@pytest.mark.parametrize("n_in,n_out", [(64, 64), (40, 56), (64, 37)])
def test_weights_match_jax(n_in, n_out):
    cases = [(s, t * n_out) for s in (0.3, 0.4137, 0.5, 0.6621, 0.7, 1.0,
                                      1.7)
             for t in (0.0, 0.3, 0.4512, 0.7)]
    scale = np.asarray([c[0] for c in cases], np.float32)
    trans = np.asarray([c[1] for c in cases], np.float32)
    got = scale_translate_weights(n_in, n_out, torch.from_numpy(scale),
                                  torch.from_numpy(trans)).numpy()
    eye = jnp.eye(n_in, dtype=jnp.float32)
    for k, (s, t) in enumerate(zip(scale, trans)):
        want = np.asarray(jax.image.scale_and_translate(
            eye, (n_out, n_in), (0,), jnp.asarray([s]), jnp.asarray([t]),
            method="linear")).T                        # [n_in, n_out]
        np.testing.assert_allclose(got[k], want, rtol=0, atol=1e-6,
                                   err_msg=f"scale {s} translation {t}")
    assert (got.sum(-2) > 0).any() and (got == 0).any()


def _inputs(seed):
    rng = np.random.RandomState(seed)
    images = rng.rand(B, S, S, 3).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (B, M, 2)),
                            rng.uniform(0.05, 0.6, (B, M, 2))],
                           -1).astype(np.float32)
    boxes[:, 1] = boxes[:, 0]                     # equal areas: a tie
    boxes[2, 3] = boxes[0, 0]                     # a tie across sources
    labels = (np.arange(B * M).reshape(B, M) % 7).astype(np.int32)
    mask = rng.rand(B, M) < 0.7
    mask[:, 0] = True
    mask[1, 1:] = False                           # padded rows
    return images, boxes, labels, mask


def _jax_draws(key):
    """The centres and apply uniforms that JAX's ``mosaic_batch`` draws
    from ``key``."""
    r_center, r_apply = jax.random.split(key)
    centers = jax.random.uniform(r_center, (B, 2), minval=0.3, maxval=0.7)
    return np.array(centers), np.array(jax.random.uniform(r_apply, (B,)))


@pytest.mark.parametrize("p,seed", [(1.0, 0), (1.0, 5), (0.5, 3)])
def test_mosaic_matches_jax(p, seed):
    images, boxes, labels, mask = _inputs(seed)
    key = jax.random.PRNGKey(seed)
    want = [np.asarray(a) for a in jax_mosaic(
        key, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(labels),
        jnp.asarray(mask), p=p)]
    centers, u = _jax_draws(key)
    applied = u < p
    assert applied.any() and (p == 1.0 or not applied.all())
    got = [a.numpy() for a in mosaic_batch(
        *map(torch.from_numpy, (images, boxes, labels, mask)), p=p,
        centers=centers, u_apply=u)]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[3], want[3])
    v = want[3]
    np.testing.assert_array_equal(got[1][v], want[1][v])
    np.testing.assert_array_equal(got[2][v], want[2][v])
    # images not applied come back as they were
    np.testing.assert_array_equal(got[0][~applied], images[~applied])
    assert got[0].dtype == np.float32 and got[2].dtype == np.int32


def test_quadrant_edge_on_a_pixel_boundary():
    """cx = 30/64 and cy = 40/64 exactly: column 30 and row 40 belong to
    the right and bottom quadrants (``x >= cx``); each source image is a
    constant, which the normalized weights keep inside its quadrant."""
    images = torch.arange(1, B + 1, dtype=torch.float32)[:, None, None,
                                                           None]
    images = images.expand(B, S, S, 3).contiguous()
    boxes = torch.full((B, M, 4), 0.25)
    labels = torch.zeros(B, M, dtype=torch.int32)
    mask = torch.ones(B, M, dtype=torch.bool)
    centers = np.asarray([[30 / 64, 40 / 64]] * B, np.float32)
    out = mosaic_batch(images, boxes, labels, mask, p=1.0, centers=centers,
                       u_apply=np.zeros(B, np.float32))[0][0, ..., 0]
    # output 0 pastes sources 0, 1, 2, 3 (values 1..4) TL, TR, BL, BR
    np.testing.assert_allclose(out[:40, :30].numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(out[:40, 30:].numpy(), 2.0, atol=1e-6)
    np.testing.assert_allclose(out[40:, :30].numpy(), 3.0, atol=1e-6)
    np.testing.assert_allclose(out[40:, 30:].numpy(), 4.0, atol=1e-6)


def test_mosaic_invariants():
    """``tests/test_train.py::test_mosaic_batch`` on the port's draws."""
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(B, S, S, 3).astype(np.float32))
    boxes = torch.tensor([0.5, 0.5, 0.4, 0.4]).repeat(B, M, 1)
    labels = torch.from_numpy(rng.randint(0, 3, (B, M)).astype(np.int32))
    mask = torch.ones(B, M, dtype=torch.bool)
    gen = torch.Generator().manual_seed(0)
    mi, mb, ml, mm = mosaic_batch(images, boxes, labels, mask, p=1.0,
                                  generator=gen)
    assert mi.shape == images.shape and mi.is_contiguous()
    v = mb[mm]
    assert v.shape[0] > 0
    assert (v >= -1e-6).all() and (v <= 1 + 1e-6).all()
