"""Port warp (``objectdetectionpl_tpu_torch.ops.cuda.warp_kernel``) against the JAX package.

``affine_warp_plain`` -- what ``affine_warp`` runs for CPU tensors and what
the CUDA kernel ``csrc/affine_warp.cu`` is held against on the card -- is
the batched form of the JAX gather warp ``data/augment.py::_affine_warp``.

Tolerances:

- against ``_affine_warp``: equal.  Both sides run the same f32 operation
  sequence with IEEE rounding (the division by the image size included),
  so coordinates, truncations, inside/outside decisions and blends agree
  bit for bit (checked here up to 640x640);
- against the TPU kernel ``affine_warp_batch(interpret=True)``: ``atol=2e-6``
  on the source-interior mask with ramp images, as ``tests/test_warp_kernel.py``
  holds the TPU kernel against ``_affine_warp`` (its two-pass form differs
  in a ~2-texel border band);
- the identity matrix reproduces the image exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from objectdetectionpl_tpu.data.augment import (_affine_warp,
                                                _rot_shift_scale_matrix)
from objectdetectionpl_tpu.ops.pallas.warp_kernel import affine_warp_batch
from objectdetectionpl_tpu_torch.ops.cuda import warp_kernel
from test_warp_kernel import _ramp, _source_interior_mask

torch.set_num_threads(2)

# (degrees, scale, tx, ty): tests/test_warp_kernel.py's matrices, then a
# rotation of 60 deg at scale 0.5 (outside the TPU kernel's range) and a
# shift that maps every pixel outside.
PARAMS = [(20.0, 1.05, 0.03, -0.02), (-41.0, 0.92, -0.06, 0.05),
          (44.0, 1.1, 0.06, 0.06), (0.0, 1.0, 0.0, 0.0),
          (60.0, 0.5, 0.0, 0.0), (0.0, 1.0, 2.0, 0.0)]


def _inv(deg, scale, tx, ty):
    return np.asarray(jnp.linalg.inv(_rot_shift_scale_matrix(
        jnp.deg2rad(deg), scale, tx, ty)), np.float32)


@pytest.fixture(scope="module")
def invs():
    return np.stack([_inv(*p) for p in PARAMS])


@pytest.mark.parametrize("H,W", [(32, 32), (37, 53)])
def test_plain_matches_jax_gather_warp(invs, H, W):
    rng = np.random.RandomState(H)
    imgs = rng.rand(len(PARAMS), H, W, 3).astype(np.float32)
    got = warp_kernel.affine_warp_plain(torch.from_numpy(imgs),
                                        torch.from_numpy(invs)).numpy()
    want = np.asarray(jax.vmap(_affine_warp)(jnp.asarray(imgs),
                                             jnp.asarray(invs)))
    np.testing.assert_array_equal(got, want)
    assert not got[-1].any()                   # shifted wholly outside
    assert got[:-1].any(axis=(1, 2, 3)).all()


def test_plain_matches_tpu_kernel_interior(invs):
    S = 32
    k = 4                                      # the TPU kernel's own cases
    imgs = np.stack([_ramp(S) * (1.0 - 0.2 * i) for i in range(k)])
    got = warp_kernel.affine_warp_plain(torch.from_numpy(imgs),
                                        torch.from_numpy(invs[:k])).numpy()
    want = np.asarray(affine_warp_batch(jnp.asarray(imgs),
                                        jnp.asarray(invs[:k]),
                                        interpret=True))
    for i in range(k):
        safe = _source_interior_mask(S, invs[i])
        assert safe.sum() > 100
        np.testing.assert_allclose(got[i][safe], want[i][safe], atol=2e-6)


def test_identity_is_exact():
    img = torch.from_numpy(_ramp(32))[None]
    out = warp_kernel.affine_warp(img.contiguous(), torch.eye(3)[None])
    torch.testing.assert_close(out, img, rtol=0, atol=0)


def test_cpu_takes_plain_version_and_counts_no_launch(invs):
    imgs = torch.rand(len(PARAMS), 16, 24, 3,
                      generator=torch.Generator().manual_seed(0))
    inv = torch.from_numpy(invs)
    before = warp_kernel.LAUNCHES
    out = warp_kernel.affine_warp(imgs, inv)
    assert warp_kernel.LAUNCHES == before
    torch.testing.assert_close(out, warp_kernel.affine_warp_plain(imgs, inv),
                               rtol=0, atol=0)


@pytest.mark.parametrize("case,error,match", [
    ("f64_images", TypeError, "images must be torch.float32"),
    ("f64_inv", TypeError, "inv must be torch.float32"),
    ("strided_images", ValueError, "images must be contiguous"),
    ("three_dims", ValueError, r"images must be \[K, H, W, C\]"),
    ("inv_shape", ValueError, r"inv must have shape \(2, 3, 3\)"),
    ("inv_elsewhere", ValueError, "inv is on meta"),
    ("meta_device", ValueError, "unsupported device meta"),
])
def test_wrapper_checks_raise(case, error, match):
    imgs = torch.zeros(2, 8, 8, 3)
    inv = torch.eye(3).repeat(2, 1, 1)
    if case == "f64_images":
        imgs = imgs.double()
    elif case == "f64_inv":
        inv = inv.double()
    elif case == "strided_images":
        imgs = imgs.permute(0, 2, 1, 3)
    elif case == "three_dims":
        imgs = imgs[0]
    elif case == "inv_shape":
        inv = inv[:, :2]
    elif case == "inv_elsewhere":
        inv = inv.to("meta")
    else:
        imgs, inv = imgs.to("meta"), inv.to("meta")
    with pytest.raises(error, match=match):
        warp_kernel.affine_warp(imgs, inv)
