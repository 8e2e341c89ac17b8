"""Port augmentation (``objectdetectionpl_tpu_torch.data.augment``) against the JAX package.

JAX's ``augment_batch(rng, ...)`` first draws ``u = jax.random.uniform(rng,
(B, 14))``; the port's ``augment_batch(..., u=u)`` is handed that exact
draw, so both sides take the same decisions and are compared on their
outputs (JAX with ``use_pallas=False``, its gather warp, which the port's
kernel computes).  B=8 images of 32x32, M=6 boxes, so K=3 warp slots; the
seeds are chosen from the draws for three cases: SSR selects 1-3 images,
none, and more than K (the overflow skips SSR).

Tolerances (f32, CPU): masks equal; boxes ``atol=1e-6`` (the 3x3 matrix
products and the box einsum may sum in another order, last-bit
differences); images ``atol=1e-5``: flips and colour are the same f32
operations, and the warp gets inverses that ``torch.linalg.inv`` and
``jnp.linalg.inv`` may round a last bit apart, which moves a source
coordinate by ~1e-7 pixels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from objectdetectionpl_tpu.data import augment as jax_aug
from objectdetectionpl_tpu_torch.data import augment as port_aug

torch.set_num_threads(2)

B, S, M = 8, 32, 6
BOX_TOL = dict(rtol=0, atol=1e-6)
IMG_TOL = dict(rtol=0, atol=1e-5)


def _batch(seed):
    rng = np.random.RandomState(seed)
    images = rng.rand(B, S, S, 3).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.1, 0.9, (B, M, 2)),
                            rng.uniform(0.05, 0.5, (B, M, 2))],
                           -1).astype(np.float32)
    boxes[0, 0] = [0.98, 0.5, 0.02, 0.3]       # leaves the frame when shifted
    mask = rng.rand(B, M) < 0.7
    mask[0, 0] = True
    return images, boxes, mask


@pytest.fixture(scope="module")
def seeds():
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(400))
    coins = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (B, 14)))(keys))[:, :, 2]
    n = (coins < jax_aug.AugmentConfig().p_ssr).sum(axis=1)
    pick = lambda ok: int(np.flatnonzero(ok)[0])
    return {"ssr_fires": pick((n >= 1) & (n <= 3)), "no_ssr": pick(n == 0),
            "slots_overflow": pick(n >= 4)}


@pytest.mark.parametrize("case", ["ssr_fires", "no_ssr", "slots_overflow"])
def test_augment_batch_matches_jax(seeds, case):
    images, boxes, mask = _batch(seeds[case])
    rng = jax.random.PRNGKey(seeds[case])
    u = np.array(jax.random.uniform(rng, (B, 14)))
    want = jax_aug.augment_batch(rng, jnp.asarray(images), jnp.asarray(boxes),
                                 jnp.asarray(mask), use_pallas=False)
    got = port_aug.augment_batch(torch.from_numpy(images),
                                 torch.from_numpy(boxes),
                                 torch.from_numpy(mask), u=u)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **BOX_TOL)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **IMG_TOL)
    changed = ~np.isclose(got[0].numpy(), images).all(axis=(1, 2, 3))
    assert changed.any()                       # flips/colour always fire
    if case == "no_ssr":
        assert (u[:, 2] >= 0.2).all()


def _random_u(seed, n=64):
    return np.random.RandomState(seed).rand(n, 14).astype(np.float32)


def test_ssr_params_match_jax():
    u = _random_u(0)
    cfg = port_aug.AugmentConfig()
    fwd, do = port_aug._ssr_params(torch.from_numpy(u), cfg)
    jfwd, jdo = jax.vmap(lambda uu: jax_aug._ssr_params(
        uu, jax_aug.AugmentConfig()))(jnp.asarray(u))
    np.testing.assert_array_equal(do.numpy(), np.asarray(jdo))
    assert do.any() and not do.all()
    np.testing.assert_allclose(fwd.numpy(), np.asarray(jfwd), rtol=0,
                               atol=1e-6)


def test_transform_boxes_matches_jax():
    u = _random_u(1, n=B)
    u[:, 2] = 0.0                              # every image rotates/shifts
    u[0, 3:7] = [0.5, 0.5, 1.0, 0.5]           # image 0: shift right only
    fwd, _ = port_aug._ssr_params(torch.from_numpy(u),
                                  port_aug.AugmentConfig())
    _, boxes, mask = _batch(1)
    got_b, got_m = port_aug._transform_boxes(torch.from_numpy(boxes),
                                             torch.from_numpy(mask), fwd)
    want_b, want_m = jax.vmap(jax_aug._transform_boxes)(
        jnp.asarray(boxes), jnp.asarray(mask), jnp.asarray(fwd.numpy()))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert not got_m[0, 0] and got_m.sum() == mask.sum() - 1
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), **BOX_TOL)
    # padded rows come back as given
    np.testing.assert_array_equal(got_b.numpy()[~mask], boxes[~mask])


def test_augment_batch_warps_through_one_slot_call(seeds, monkeypatch):
    """augment_batch hands the slots to affine_warp_slots once (top in coin
    order, use = applied[top]) and writes its result back; the result is
    JAX's, as test_augment_batch_matches_jax shows."""
    from objectdetectionpl_tpu_torch.ops.cuda import warp_kernel
    calls = []

    def spy(images, top, inv, use):
        calls.append((top.clone(), use.clone()))
        return warp_kernel.affine_warp_slots_plain(images, top, inv, use)

    monkeypatch.setattr(warp_kernel, "affine_warp_slots", spy)
    monkeypatch.setattr(warp_kernel, "affine_warp", None)   # not called
    images, boxes, mask = _batch(seeds["ssr_fires"])
    u = _random_u(2, n=B)
    u[:, 2] = [0.5, 0.1, 0.9, 0.05, 0.3, 0.15, 0.7, 0.02]
    got = port_aug.augment_batch(torch.from_numpy(images),
                                 torch.from_numpy(boxes),
                                 torch.from_numpy(mask), u=u)
    assert len(calls) == 1
    top, use = calls[0]
    assert top.tolist() == [7, 3, 1]                 # the 3 smallest coins
    assert use.tolist() == [True, True, True]
    untouched = [i for i in range(B) if i not in top.tolist()]
    ref, _ = port_aug._augment_cheap(torch.from_numpy(u),
                                     torch.from_numpy(images),
                                     torch.from_numpy(boxes),
                                     port_aug.AugmentConfig())
    torch.testing.assert_close(got[0][untouched], ref[untouched], rtol=0,
                               atol=0)
