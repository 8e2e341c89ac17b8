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


# --- affine_warp_slots: the slot gather, the warp and the select ----------

B_SLOTS = 6


def _slot_case(case):
    """(images [B, H, W, 3], top [K] in coin order, inv [K, 3, 3], use [K])
    made with numpy from a seed."""
    H, W = (37, 53) if case == "mixed_37x53" else (32, 32)
    rng = np.random.RandomState(len(case))
    images = rng.rand(B_SLOTS, H, W, 3).astype(np.float32)
    top = np.array([4, 1, 5, 0], np.int64)        # not sorted
    inv = np.stack([_inv(*p) for p in PARAMS[:4]])
    use = {"mixed": [True, False, True, False], "all": [True] * 4,
           "none": [False] * 4, "mixed_37x53": [False, True, True, True]
           }[case]
    return images, top, inv, np.array(use)


@pytest.mark.parametrize("case", ["mixed", "all", "none", "mixed_37x53"])
def test_slots_plain_matches_jax_chain(case):
    """affine_warp_slots_plain is augment.py:205-210 before the scatter:
    jnp.where(use, vmap(_affine_warp)(images[top], inv), images[top])."""
    images, top, inv, use = _slot_case(case)
    got = warp_kernel.affine_warp_slots_plain(
        torch.from_numpy(images), torch.from_numpy(top),
        torch.from_numpy(inv), torch.from_numpy(use)).numpy()
    slots = jnp.asarray(images)[jnp.asarray(top)]
    want = np.asarray(jnp.where(
        jnp.asarray(use)[:, None, None, None],
        jax.vmap(_affine_warp)(slots, jnp.asarray(inv)), slots))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[~use], images[top[~use]])


def test_affine_warp_is_slots_with_every_slot_used(invs):
    imgs = torch.rand(len(PARAMS), 16, 24, 3,
                      generator=torch.Generator().manual_seed(1))
    K = len(PARAMS)
    got = warp_kernel.affine_warp_slots(imgs, torch.arange(K),
                                        torch.from_numpy(invs),
                                        torch.ones(K, dtype=torch.bool))
    torch.testing.assert_close(
        got, warp_kernel.affine_warp(imgs, torch.from_numpy(invs)),
        rtol=0, atol=0)


def test_slots_cpu_takes_plain_version_and_counts_no_launch():
    images, top, inv, use = map(torch.from_numpy, _slot_case("mixed"))
    before = warp_kernel.LAUNCHES
    out = warp_kernel.affine_warp_slots(images, top, inv, use)
    assert warp_kernel.LAUNCHES == before
    torch.testing.assert_close(
        out, warp_kernel.affine_warp_slots_plain(images, top, inv, use),
        rtol=0, atol=0)


@pytest.mark.parametrize("case,error,match", [
    ("top_int32", TypeError, "top must be torch.int64"),
    ("top_2d", ValueError, r"top must be \[K\]"),
    ("top_negative", IndexError, r"top must lie in \[0, 6\)"),
    ("top_past_end", IndexError, r"top must lie in \[0, 6\)"),
    ("top_elsewhere", ValueError, "top is on meta"),
    ("use_uint8", TypeError, "use must be torch.bool"),
    ("use_shape", ValueError, r"use must have shape \(4,\)"),
    ("use_elsewhere", ValueError, "use is on meta"),
    ("inv_count", ValueError, r"inv must have shape \(4, 3, 3\)"),
    ("images_3d", ValueError, r"images must be \[B, H, W, C\]"),
])
def test_slots_wrapper_checks_raise(case, error, match):
    images, top, inv, use = map(torch.from_numpy, _slot_case("mixed"))
    if case == "top_int32":
        top = top.int()
    elif case == "top_2d":
        top = top[None]
    elif case == "top_negative":
        top[1] = -1
    elif case == "top_past_end":
        top[1] = B_SLOTS
    elif case == "top_elsewhere":
        top = top.to("meta")
    elif case == "use_uint8":
        use = use.to(torch.uint8)
    elif case == "use_shape":
        use = use[:3]
    elif case == "use_elsewhere":
        use = use.to("meta")
    elif case == "inv_count":
        inv = inv[:3]
    else:
        images = images[0]
    with pytest.raises(error, match=match):
        warp_kernel.affine_warp_slots(images, top, inv, use)


# --- the kernel's tiles: footprints and paths (csrc/affine_warp.cu) --------


def _taps(H, W, inv):
    """Per output pixel of each slot: inside, x0, x1, y0, y1 in
    affine_warp_plain's arithmetic."""
    f = lambda n: torch.full((), float(n))
    ys = (torch.arange(H, dtype=torch.float32) + 0.5) / f(H)
    xs = (torch.arange(W, dtype=torch.float32) + 0.5) / f(W)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    m = inv[:, :, :, None, None]
    sx = (m[:, 0, 0] * xx + m[:, 0, 1] * yy + m[:, 0, 2]) * W - 0.5
    sy = (m[:, 1, 0] * xx + m[:, 1, 1] * yy + m[:, 1, 2]) * H - 0.5
    inside = (sx >= 0) & (sx <= W - 1) & (sy >= 0) & (sy <= H - 1)
    x0 = torch.where(inside, sx, 0.0).long()
    y0 = torch.where(inside, sy, 0.0).long()
    return (inside, x0, (x0 + 1).clamp(max=W - 1), y0,
            (y0 + 1).clamp(max=H - 1))


@pytest.mark.parametrize("H,W", [(640, 640), (37, 53), (70, 96)])
def test_tile_footprint_holds_every_tap(invs, H, W):
    """The footprint from a tile's four corners holds the four taps of
    every inside pixel of the tile, and a tile called outside has none."""
    rng = np.random.RandomState(H)
    extra = [_inv(rng.uniform(-180, 180), rng.uniform(0.3, 2.0),
                  rng.uniform(-0.3, 0.3), rng.uniform(-0.3, 0.3))
             for _ in range(10)]
    inv = torch.from_numpy(np.concatenate([invs, np.stack(extra)]))
    K = inv.shape[0]
    plan = warp_kernel.tile_plan(H, W, 3, inv, torch.ones(K, dtype=bool))
    inside, x0, x1, y0, y1 = _taps(H, W, inv)
    T = warp_kernel.TILE
    ty = torch.arange(H) // T
    tx = torch.arange(W) // T
    box = plan["box"][:, ty][:, :, tx]                    # [K, H, W, 4]
    path = plan["path"][:, ty][:, :, tx]
    held = ((x0 >= box[..., 0]) & (x1 <= box[..., 1]) & (y0 >= box[..., 2])
            & (y1 <= box[..., 3]))
    assert bool(held[inside].all())
    assert not bool(inside[path == warp_kernel.PATHS.index("outside")].any())
    if plan["vec"]:                                        # 16-byte aligned
        assert bool((plan["box"][..., 0] % warp_kernel.RUN == 0).all())
    assert inside.any() and (~inside).any()


def test_tile_plan_paths():
    from objectdetectionpl_tpu_torch.tools.kernel_ab import ssr_inverses
    inv = ssr_inverses(26, 24)
    yes = torch.ones(26, dtype=torch.bool)
    n = warp_kernel.path_counts(warp_kernel.tile_plan(640, 640, 3, inv, yes))
    assert n["staged"] > 0 and n["global"] == n["copy"] == 0  # SSR bounds
    n = warp_kernel.path_counts(warp_kernel.tile_plan(640, 640, 3, inv, ~yes))
    assert n["copy"] == 26 * 400
    rot = torch.from_numpy(_inv(60.0, 0.5, 0.0, 0.0).copy())[None]
    n = warp_kernel.path_counts(warp_kernel.tile_plan(
        640, 640, 3, rot, torch.ones(1, dtype=torch.bool)))
    assert n["global"] > 0
    bad = torch.full((1, 3, 3), float("nan"))
    n = warp_kernel.path_counts(warp_kernel.tile_plan(
        64, 64, 3, bad, torch.ones(1, dtype=torch.bool)))
    assert n == {"copy": 0, "staged": 0, "global": 4, "outside": 0}
    assert not warp_kernel.tile_plan(37, 53, 3, inv[:1], yes[:1])["vec"]


def test_tile_plan_constants_match_the_kernel():
    import re
    from pathlib import Path
    src = (Path(warp_kernel.__file__).resolve().parents[2] / "csrc"
           / "affine_warp.cu").read_text()
    const = lambda name: re.search(rf"constexpr int {name} = ([^;]+);",
                                   src).group(1)
    assert int(const("kTile")) == warp_kernel.TILE
    assert int(const("kRun")) == warp_kernel.RUN
    assert eval(const("kStageBytes")) == warp_kernel.STAGE_BYTES
