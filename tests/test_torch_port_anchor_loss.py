"""Port the SSD and RetinaNet anchors, box codecs, matching and losses
against the JAX package (``ops/anchors.py``, ``ops/boxes.py``,
``ops/assignment.py``, ``ops/losses.py``), on the same numpy inputs.

Float32 on the CPU on both sides.  Tolerances:

- anchor tables and default boxes: equal (the same numpy code);
- box codecs and IoUs: ``rtol=1e-6, atol=1e-6`` (one to a few f32 ops);
- matching (the JAX functions vmapped over the batch): the matched mask,
  target indices and classes equal; the encoded offsets within
  ``rtol=1e-5, atol=1e-5`` (a log and a division of the same f32 values);
- focal losses elementwise within ``rtol=1e-5, atol=1e-7``;
- the losses within ``rtol=1e-5`` and d(loss)/d(maps) within ``GRAD_TOL``
  (``rtol=1e-4, atol=1e-8``): sums over 8732 (SSD) or 3069 x 3 (RetinaNet
  at 128 px) terms, ordered differently by XLA and torch;
- bf16 maps: every metric float32 on both sides, within ``rtol=5e-3``
  (JAX and torch round the bf16 terms differently), the gradients bf16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from objectdetectionpl_tpu.ops import anchors as jax_anchors
from objectdetectionpl_tpu.ops import assignment as jax_assign
from objectdetectionpl_tpu.ops import boxes as jax_boxes
from objectdetectionpl_tpu.ops import losses as jax_losses
from objectdetectionpl_tpu_torch.ops import anchors as port_anchors
from objectdetectionpl_tpu_torch.ops import assignment as port_assign
from objectdetectionpl_tpu_torch.ops import boxes as port_boxes
from objectdetectionpl_tpu_torch.ops import losses as port_losses

torch.set_num_threads(2)

C = 3
RETINA_IMG = 128
CODEC_TOL = dict(rtol=1e-6, atol=1e-6)
OFFSET_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-8)


def _targets(seed, B=2, M=6):
    """labels [B, M] int32, boxes [B, M, 4] normalized xywh (centres in
    [0.2, 0.8], sizes in [0.05, 0.5]), mask [B, M] with the last two rows
    of image 0 padded (and zeroed, as the Loader pads)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, C, (B, M)).astype(np.int32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (B, M, 2)),
                            rng.uniform(0.05, 0.5, (B, M, 2))], -1
                           ).astype(np.float32)
    mask = np.ones((B, M), bool)
    mask[0, -2:] = False
    boxes[0, -2:] = 0.0
    labels[0, -2:] = 0
    return labels, boxes, mask


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# --- anchors and codecs --------------------------------------------------------


def test_anchor_tables_equal_jax():
    np.testing.assert_array_equal(port_anchors.ssd_dboxes(),
                                  jax_anchors.ssd_dboxes())
    assert port_anchors.ssd_dboxes().shape == (8732, 4)
    np.testing.assert_array_equal(port_anchors.retina_anchor_wh(),
                                  jax_anchors.retina_anchor_wh())
    for size, n in ((128, 3069), (600, 67995), (300, 17451)):
        a = port_anchors.retina_anchors(size)
        assert a.shape == (n, 4) and a.dtype == np.float32
        np.testing.assert_array_equal(a, jax_anchors.retina_anchors(size))


def test_box_codecs_match_jax():
    rng = np.random.RandomState(0)
    dbox = port_anchors.ssd_dboxes()[::37]
    matched = np.concatenate([rng.uniform(0, 1, (len(dbox), 2)),
                              rng.uniform(0.01, 0.9, (len(dbox), 2))], -1
                             ).astype(np.float32)
    pt_m, pt_d = _t(matched, dbox)
    for use_variance in (True, False):
        want = jax_boxes.ssd_encode(jnp.asarray(matched), jnp.asarray(dbox),
                                    use_variance)
        got = port_boxes.ssd_encode(pt_m, pt_d, use_variance)
        np.testing.assert_allclose(got.numpy(), want, **CODEC_TOL)
        back = port_boxes.ssd_decode(got, pt_d, use_variance)
        np.testing.assert_allclose(back.numpy(), jax_boxes.ssd_decode(
            want, jnp.asarray(dbox), use_variance), **CODEC_TOL)
        np.testing.assert_allclose(back.numpy(), matched, rtol=1e-5,
                                   atol=1e-6)
    anc = port_anchors.retina_anchors(RETINA_IMG)[::14]
    px = matched[: len(anc)] * RETINA_IMG
    want = jax_boxes.retina_encode(jnp.asarray(px), jnp.asarray(anc))
    got = port_boxes.retina_encode(*_t(px, anc))
    np.testing.assert_allclose(got.numpy(), want, **CODEC_TOL)
    np.testing.assert_allclose(
        port_boxes.retina_decode(got, torch.from_numpy(anc)).numpy(),
        jax_boxes.retina_decode(want, jnp.asarray(anc)), rtol=1e-6,
        atol=1e-4)
    np.testing.assert_allclose(
        port_boxes.center_to_points_clipped(pt_m).numpy(),
        jax_boxes.center_to_points_clipped(jnp.asarray(matched)), **CODEC_TOL)


def test_pairwise_ious_match_jax():
    _, boxes, _ = _targets(1)
    a = port_boxes.center_to_points_clipped(torch.from_numpy(boxes[1]))
    d = port_boxes.center_to_points_clipped(
        torch.from_numpy(port_anchors.ssd_dboxes()[:500]))
    want = jax_boxes.pairwise_iou_corner(jnp.asarray(a.numpy()),
                                         jnp.asarray(d.numpy()))
    np.testing.assert_allclose(port_boxes.pairwise_iou_corner(a, d).numpy(),
                               want, **CODEC_TOL)
    anc = port_boxes.xywh_to_xyxy(torch.from_numpy(
        port_anchors.retina_anchors(RETINA_IMG)))
    b = port_boxes.xywh_to_xyxy(torch.from_numpy(boxes[1] * RETINA_IMG))
    want = jax_boxes.pairwise_iou_plus1(jnp.asarray(anc.numpy()),
                                        jnp.asarray(b.numpy()))
    got = port_boxes.pairwise_iou_plus1(anc, b)
    assert got.shape == (3069, 6)
    np.testing.assert_allclose(got.numpy(), want, **CODEC_TOL)
    # batched: [B, N, 4] x [M, 4] -> [B, N, M]
    both = port_boxes.pairwise_iou_plus1(torch.stack([anc, anc]), b)
    torch.testing.assert_close(both[1], got)


# --- matching ------------------------------------------------------------------


def _ssd_match_both(labels, boxes, mask):
    dbox = port_anchors.ssd_dboxes()
    want = jax.vmap(lambda l, b, m: jax_assign.ssd_match(
        jnp.asarray(dbox), l, b, m))(*map(jnp.asarray, (labels, boxes, mask)))
    got = port_assign.ssd_match(torch.from_numpy(dbox), *_t(labels, boxes,
                                                           mask))
    np.testing.assert_array_equal(got.matched.numpy(), want.matched)
    np.testing.assert_array_equal(got.best_ann.numpy(), want.best_ann)
    np.testing.assert_array_equal(got.true_classes.numpy(), want.true_classes)
    np.testing.assert_allclose(got.true_offsets.numpy(), want.true_offsets,
                               **OFFSET_TOL)
    assert np.isfinite(got.true_offsets.numpy()).all()
    return got


def test_ssd_match_forced_collision_and_padding():
    """Targets 0 and 1 of image 1 are near copies of one box, so both claim
    the same best default box: the higher index (1) wins it, whatever
    order the scatter applies the claims in.  Image 0 has two padded rows
    (zero boxes), which claim nothing; a tiny target matches only by its
    forced claim."""
    labels, boxes, mask = _targets(2)
    boxes[1, 0] = [0.41, 0.52, 0.23, 0.31]
    boxes[1, 1] = [0.412, 0.521, 0.231, 0.309]
    labels[1, :2] = [1, 2]
    boxes[1, 2] = [0.9, 0.1, 0.02, 0.02]            # below 0.5 everywhere
    got = _ssd_match_both(labels, boxes, mask)
    dbox = torch.from_numpy(port_anchors.ssd_dboxes())
    ious = port_boxes.pairwise_iou_corner(
        port_boxes.center_to_points_clipped(torch.from_numpy(boxes[1])),
        port_boxes.center_to_points_clipped(dbox))
    best = ious.argmax(dim=1)
    assert best[0] == best[1]
    assert got.best_ann[1, best[0]] == 1 and got.true_classes[1, best[0]] == 3
    assert ious[2].max() < 0.5 and got.matched[1, best[2]]
    assert got.true_classes[1, best[2]] == 1 + labels[1, 2]
    assert (got.best_ann[0] < 4).all()              # padded rows never win


def test_ssd_match_without_targets():
    labels, boxes, mask = _targets(3)
    mask[1] = False
    got = _ssd_match_both(labels, boxes, mask)
    assert not got.matched[1].any() and (got.true_classes[1] == 0).all()


def _retina_match_both(labels, boxes, mask):
    anc = port_anchors.retina_anchors(RETINA_IMG)
    want = jax.vmap(lambda l, b, m: jax_assign.retina_match(
        jnp.asarray(anc), l, b, m, RETINA_IMG))(
        *map(jnp.asarray, (labels, boxes, mask)))
    got = port_assign.retina_match(torch.from_numpy(anc),
                                   *_t(labels, boxes, mask), RETINA_IMG)
    np.testing.assert_array_equal(got.cls_targets.numpy(), want.cls_targets)
    np.testing.assert_allclose(got.loc_targets.numpy(), want.loc_targets,
                               **OFFSET_TOL)
    return got


def test_retina_match_ignore_band_and_empty_image():
    """Image 0 holds anchors on both sides of the (0.4, 0.5) band and in it
    (-1); image 1 has no targets: every anchor background."""
    labels, boxes, mask = _targets(4)
    mask[1] = False
    got = _retina_match_both(labels, boxes, mask)
    cls0 = got.cls_targets[0]
    assert (cls0 == -1).any() and (cls0 > 0).any() and (cls0 == 0).any()
    assert (got.cls_targets[1] == 0).all()
    # the band itself, from the IoUs
    anc = port_boxes.xywh_to_xyxy(torch.from_numpy(
        port_anchors.retina_anchors(RETINA_IMG)))
    b = port_boxes.xywh_to_xyxy(torch.from_numpy(boxes[0] * RETINA_IMG))
    iou = torch.where(torch.from_numpy(mask[0]),
                      port_boxes.pairwise_iou_plus1(anc, b), -1.0).amax(1)
    band = (iou > 0.4) & (iou < 0.5)
    assert band.any() and ((cls0 == -1) == band).all()


# --- focal losses --------------------------------------------------------------


@pytest.mark.parametrize("kind", ["softmax_focal", "sigmoid_focal"])
def test_focal_losses_match_jax(kind):
    rng = np.random.RandomState(5)
    logits = (rng.randn(500, C) * 4).astype(np.float32)
    logits[:5] = [[30.0, -30.0, 0.0]] * 5            # saturated rows
    y = rng.randint(0, C + 1, 500).astype(np.int32)
    want = getattr(jax_losses, kind)(jnp.asarray(logits), jnp.asarray(y), C)
    got = getattr(port_losses, kind)(*_t(logits, y), C)
    assert got.dtype == torch.float32 and got.shape == (500, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


# --- the losses ----------------------------------------------------------------


def _maps(name, seed, B=2):
    A = 8732 if name == "SSD" else 3069
    ch = C + 1 if name == "SSD" else C
    rng = np.random.RandomState(seed)
    return (rng.randn(B, A, 4).astype(np.float32) * 0.5,
            (rng.randn(B, A, ch) * 2).astype(np.float32))


LOSSES = {
    "ssd_ce": ("SSD", {"cls_criterion": "ce_loss"}),
    "ssd_focal": ("SSD", {"cls_criterion": "focal_loss"}),
    "retina_sigmoid": ("RetinaNet", {}),
    "retina_softmax": ("RetinaNet", {"focal": "softmax"}),
}


def _make(lib, case):
    name, kw = LOSSES[case]
    img = 300 if name == "SSD" else RETINA_IMG
    return name, lib.make_loss(name, C, img, **kw)


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_anchor_losses_and_gradients_match_jax(case):
    name, jax_fn = _make(jax_losses, case)
    _, port_fn = _make(port_losses, case)
    labels, boxes, mask = _targets(6)
    loc, cls = _maps(name, 7)

    def jax_loss(maps):
        m = jax_fn(maps, *map(jnp.asarray, (labels, boxes, mask)))
        return m["loss"], m

    (_, want), grads = jax.value_and_grad(jax_loss, has_aux=True)(
        (jnp.asarray(loc), jnp.asarray(cls)))
    maps = [torch.from_numpy(a).requires_grad_() for a in (loc, cls)]
    got = port_fn(tuple(maps), *_t(labels, boxes, mask))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    got["loss"].backward()
    for m, g in zip(maps, grads):
        assert m.grad.abs().max() > 0
        np.testing.assert_allclose(m.grad.numpy(), np.asarray(g), **GRAD_TOL)


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_anchor_losses_bf16_promote_as_jax(case):
    """bf16 maps meet the f32 offsets and one-hot targets: every metric is
    f32 on both sides (SSD's cross-entropy sums stay bf16 until the f32
    division, as in JAX), and the gradients come back bf16."""
    name, jax_fn = _make(jax_losses, case)
    _, port_fn = _make(port_losses, case)
    labels, boxes, mask = _targets(8)
    loc, cls = _maps(name, 9)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (loc, cls)]
    want = jax_fn(tuple(bf), *map(jnp.asarray, (labels, boxes, mask)))
    maps = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_() for a in bf]
    got = port_fn(tuple(maps), *_t(labels, boxes, mask))
    for k in want:
        assert got[k].dtype == torch.float32 and want[k].dtype == jnp.float32
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=5e-3,
                                   err_msg=k)
    got["loss"].backward()
    assert all(m.grad.dtype == torch.bfloat16 for m in maps)


def test_ssd_loss_without_targets_is_finite():
    """An image without targets adds no localization and no mined
    negatives; a batch of them gives a zero, finite loss."""
    _, fn = _make(port_losses, "ssd_ce")
    labels, boxes, mask = _targets(10)
    mask[:] = False
    loc, cls = _maps("SSD", 11)
    maps = [torch.from_numpy(a).requires_grad_() for a in (loc, cls)]
    got = fn(tuple(maps), *_t(labels, boxes, mask))
    assert got["loss"].item() == 0.0
    got["loss"].backward()
    assert all(torch.isfinite(m.grad).all() for m in maps)
