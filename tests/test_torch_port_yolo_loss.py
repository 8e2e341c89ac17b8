"""The YOLOv2/v3/v4 assignment, region losses and per-grid statistics of the
port (``ops/assignment.py``, ``ops/losses.py``, ``ops/yolo_stats.py``)
against the JAX package, on seeded head maps and padded targets.

Targets (B=3, M=6): a cell and anchor hit by two targets with different
offsets, sizes and labels (the later one must win ``tx/ty/tw/th``,
``class_mask`` and ``iou_scores``; ``tcls`` keeps both labels); a center
on the grid's right and bottom edge (``gx == g``, clipped to ``g - 1``);
an image with no targets; padded rows holding garbage boxes, which must
drop.

Tolerances, float32 on the CPU:

- ``build_targets_yolo``: masks and integer-valued fields equal; float
  fields within ``rtol=1e-6, atol=1e-7`` (``log`` and the IoU divide may
  round differently in XLA and torch).
- Loss metrics and d(loss)/d(maps): ``rtol=1e-5, atol=1e-7`` (sums of a
  few thousand terms in other orders).
- bf16 maps: every metric is float32 on both sides and within
  ``rtol=2e-2`` (bf16 keeps 8 bits; both decode in bf16).
- ``yolo_statistics``: ``rtol=1e-5, atol=1e-6``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from objectdetectionpl_tpu.ops import anchors as jax_anchors
from objectdetectionpl_tpu.ops import assignment as jax_assign
from objectdetectionpl_tpu.ops import losses as jax_losses
from objectdetectionpl_tpu.ops import yolo_stats as jax_stats
from objectdetectionpl_tpu_torch.ops import anchors as port_anchors
from objectdetectionpl_tpu_torch.ops import assignment as port_assign
from objectdetectionpl_tpu_torch.ops import losses as port_losses
from objectdetectionpl_tpu_torch.ops import yolo_stats as port_stats

torch.set_num_threads(2)

C = 4
IMG = 128
B, M = 3, 6
TGT_TOL = dict(rtol=1e-6, atol=1e-7)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)
STAT_TOL = dict(rtol=1e-5, atol=1e-6)


def _targets():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, C, (B, M)).astype(np.int32)
    boxes = np.concatenate([rng.uniform(0.05, 0.95, (B, M, 2)),
                            rng.uniform(0.05, 0.6, (B, M, 2))],
                           -1).astype(np.float32)
    mask = np.zeros((B, M), bool)
    mask[0, :5] = True
    mask[2, :4] = True                   # image 1 has no targets
    # image 0: targets 1 and 3 share a cell (any grid of 4..16 cells) and
    # the best anchor, with other offsets, sizes and labels
    boxes[0, 1] = [0.55, 0.33, 0.30, 0.22]
    boxes[0, 3] = [0.56, 0.34, 0.31, 0.21]
    labels[0, 1], labels[0, 3] = 0, 2
    # a center on the right and bottom edges: gx == gy == g
    boxes[2, 2, :2] = [1.0, 1.0]
    # padded rows hold garbage that must drop
    boxes[0, 5] = [7.0, -3.0, 2.0, 0.5]
    boxes[1] = rng.uniform(-1, 2, (M, 4))
    labels[1] = 99
    return labels, boxes, mask


def _maps(shapes, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _family_shapes(name, A=None):
    strides = {"YOLOv2": (32,), "YOLOv3": port_anchors.YOLOV3_STRIDES,
               "YOLOv4": port_anchors.YOLOV4_STRIDES}[name]
    A = A or (5 if name == "YOLOv2" else 3)
    return [(B, A * (5 + C), IMG // s, IMG // s) for s in strides]


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(arrays, grad=False):
    return [torch.from_numpy(a).requires_grad_(grad) for a in arrays]


def test_anchor_tables_equal_jax():
    for name in ("YOLOV2_ANCHORS", "YOLOV3_ANCHORS", "YOLOV3_STRIDES",
                 "YOLOV4_ANCHORS", "YOLOV4_ANCH_MASKS", "YOLOV4_STRIDES"):
        np.testing.assert_array_equal(getattr(port_anchors, name),
                                      getattr(jax_anchors, name), name)
    np.testing.assert_array_equal(
        port_anchors.scale_anchors(port_anchors.YOLOV3_ANCHORS[1], 16),
        jax_anchors.scale_anchors(jax_anchors.YOLOV3_ANCHORS[1], 16))


def test_last_write_wins_equals_jax():
    rng = np.random.RandomState(1)
    idx = rng.randint(0, 20, 200)
    valid = rng.rand(200) < 0.7
    want = np.asarray(jax_assign._last_write_wins(jnp.asarray(idx),
                                                  jnp.asarray(valid)))
    got = port_assign._last_write_wins(torch.from_numpy(idx),
                                       torch.from_numpy(valid), 20)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.sum() == len(set(idx[valid]))


@pytest.mark.parametrize("g", [4, 13, 16])
def test_build_targets_yolo_equals_jax(g):
    labels, boxes, mask = _targets()
    A = 3
    rng = np.random.RandomState(g)
    pred_boxes = np.concatenate(
        [rng.uniform(0, g, (B, A, g, g, 2)),
         rng.uniform(0.2, 4, (B, A, g, g, 2))], -1).astype(np.float32)
    pred_cls = rng.rand(B, A, g, g, C).astype(np.float32)
    anchors = port_anchors.YOLOV3_ANCHORS[1] / (IMG / g)
    want = jax.jit(jax_assign.build_targets_yolo)(*_jax(
        [pred_boxes, pred_cls, labels, boxes, mask, anchors]))
    got = port_assign.build_targets_yolo(*_torch([pred_boxes, pred_cls,
                                                  labels, boxes, mask,
                                                  anchors]))
    for name in want._fields:
        w, t = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert t.shape == w.shape and t.dtype == w.dtype, name
        np.testing.assert_allclose(t, w, err_msg=name, **TGT_TOL)

    # the shared cell holds the later target; tcls holds both labels
    gx, gy = boxes[0, 3, :2] * g
    gi, gj = int(gx), int(gy)
    assert (int(boxes[0, 1, 0] * g), int(boxes[0, 1, 1] * g)) == (gi, gj)
    a = int(np.argmax(got.obj_mask[0, :, gj, gi].numpy()))
    assert got.obj_mask[0, :, gj, gi].sum() == 1
    np.testing.assert_allclose(got.tx[0, a, gj, gi].item(), gx - np.floor(gx),
                               rtol=1e-6)
    assert got.tcls[0, a, gj, gi].tolist() == [1.0, 0.0, 1.0, 0.0]
    # the edge target sits in the last cell with a zero offset
    assert got.obj_mask[2, :, g - 1, g - 1].sum() == 1
    assert got.tx[2, :, g - 1, g - 1].max() == 0.0
    # no target of image 1 (all padding) left a mark
    assert got.obj_mask[1].sum() == 0 and got.noobj_mask[1].all()
    assert int(got.obj_mask.sum()) == 8       # 9 targets, 2 share a cell


def test_bce_prob_saturates_like_jax():
    p = np.array([0.0, 1e-40, 1e-30, 0.3, 1.0 - 1e-7, 1.0], np.float32)
    t = np.array([1.0, 1.0, 0.0, 0.5, 0.0, 0.0], np.float32)
    want = jax_losses.bce_prob(jnp.asarray(p), jnp.asarray(t))
    want_g = jax.grad(lambda q: jax_losses.bce_prob(q, jnp.asarray(t)).sum())(
        jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_()
    got = port_losses.bce_prob(pt, torch.from_numpy(t))
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6)
    assert np.isfinite(pt.grad.numpy()).all()
    assert got[0].item() == 100.0             # log clamped at -100


def _assert_metrics_and_grads(got, got_maps, want_fn, maps):
    want, want_g = jax.jit(lambda ms: (want_fn(ms), jax.grad(
        lambda m: want_fn(m)["loss"])(ms)))(_jax(maps))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].item(), float(want[k]), err_msg=k,
                                   **LOSS_TOL)
    got["loss"].backward()
    for t, w in zip(got_maps, want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=LOSS_TOL["rtol"],
                                   atol=1e-6 * np.abs(w).max())


@pytest.mark.parametrize("coord", ["mse_loss", "smooth_l1_loss"])
def test_region_loss_and_grad_equal_jax(coord):
    labels, boxes, mask = _targets()
    maps = _maps(_family_shapes("YOLOv2"), seed=3, scale=2.0)
    anc = port_anchors.YOLOV2_ANCHORS
    crit_j = jax_losses.COORD_CRITERIA[coord]
    crit_p = port_losses.COORD_CRITERIA[coord]
    tm = _torch(maps, grad=True)
    got = port_losses.region_loss(tm[0], *_torch([labels, boxes, mask]),
                                  torch.from_numpy(anc), C,
                                  coord_criterion=crit_p)
    _assert_metrics_and_grads(
        got, tm, lambda ms: jax_losses.region_loss(
            ms[0], *_jax([labels, boxes, mask]), jnp.asarray(anc), C,
            coord_criterion=crit_j), maps)


@pytest.mark.parametrize("coord", ["mse_loss", "smooth_l1_loss"])
def test_multiscale_region_loss_and_grad_equal_jax(coord):
    labels, boxes, mask = _targets()
    maps = _maps(_family_shapes("YOLOv4"), seed=4)
    per_scale = [port_anchors.YOLOV4_ANCHORS[list(m)] / s for m, s in
                 zip(port_anchors.YOLOV4_ANCH_MASKS,
                     port_anchors.YOLOV4_STRIDES)]
    tm = _torch(maps, grad=True)
    got = port_losses.multiscale_region_loss(
        tm, *_torch([labels, boxes, mask]),
        [torch.from_numpy(a) for a in per_scale], C,
        coord_criterion=port_losses.COORD_CRITERIA[coord], noobj_scale=50.0)
    _assert_metrics_and_grads(
        got, tm, lambda ms: jax_losses.multiscale_region_loss(
            ms, *_jax([labels, boxes, mask]), _jax(per_scale), C,
            coord_criterion=jax_losses.COORD_CRITERIA[coord],
            noobj_scale=50.0), maps)


@pytest.mark.parametrize("name,double", [
    ("YOLOv2", False), ("YOLOv3", False), ("YOLOv3", True),
    ("YOLOv4", False), ("YOLOv4", True)])
def test_make_loss_equals_jax(name, double):
    """The factory's anchors per family; ``v3_double_stride`` divides
    YOLOv3's by the stride twice and leaves the others as they were."""
    labels, boxes, mask = _targets()
    maps = _maps(_family_shapes(name), seed=5)
    kw = dict(coord_criterion="mse_loss", cls_criterion="bce_loss",
              v3_double_stride=double)
    jfn = jax_losses.make_loss(name, C, IMG, **kw)
    pfn = port_losses.make_loss(name, C, IMG, **kw)
    one = name == "YOLOv2"
    tm = _torch(maps, grad=True)
    got = pfn(tm[0] if one else tm, *_torch([labels, boxes, mask]))
    _assert_metrics_and_grads(
        got, tm, lambda ms: jfn(ms[0] if one else ms,
                                *_jax([labels, boxes, mask])), maps)
    if name == "YOLOv3":
        per_scale = port_losses.yolo_anchors_grid(name,
                                                  v3_double_stride=double)
        s = port_anchors.YOLOV3_STRIDES[0]
        np.testing.assert_array_equal(
            per_scale[0], port_anchors.YOLOV3_ANCHORS[0] / (s * s if double
                                                            else s))


def test_make_loss_bf16_maps_equal_jax():
    labels, boxes, mask = _targets()
    maps = _maps(_family_shapes("YOLOv3"), seed=6)
    want = jax.jit(jax_losses.make_loss("YOLOv3", C, IMG))(
        [jnp.asarray(m, jnp.bfloat16) for m in maps],
        *_jax([labels, boxes, mask]))
    outs = [torch.from_numpy(m).to(torch.bfloat16).requires_grad_()
            for m in maps]
    got = port_losses.make_loss("YOLOv3", C, IMG)(
        outs, *_torch([labels, boxes, mask]))
    for k in want:
        assert got[k].dtype == torch.float32 and want[k].dtype == jnp.float32
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=2e-2,
                                   err_msg=k)
    got["loss"].backward()
    assert all(o.grad.dtype == torch.bfloat16 and o.grad.isfinite().all()
               for o in outs)


def test_region_loss_without_targets_is_finite():
    labels, boxes, mask = _targets()
    maps = _torch(_maps(_family_shapes("YOLOv2"), seed=7), grad=True)
    got = port_losses.region_loss(
        maps[0], torch.from_numpy(labels), torch.from_numpy(boxes),
        torch.zeros(B, M, dtype=torch.bool),
        torch.from_numpy(port_anchors.YOLOV2_ANCHORS), C)
    got["loss"].backward()
    assert all(v.isfinite() for v in got.values())
    assert got["Conf_obj"].item() == 0.0 and got["Localization"].item() == 0.0
    assert maps[0].grad.isfinite().all()


@pytest.mark.parametrize("name", ["YOLOv2", "YOLOv3", "YOLOv4"])
def test_yolo_statistics_equal_jax(name):
    labels, boxes, mask = _targets()
    maps = _maps(_family_shapes(name), seed=8, scale=1.5)
    per_scale = port_losses.yolo_anchors_grid(name)
    outs_j = _jax(maps) if name != "YOLOv2" else jnp.asarray(maps[0])
    outs_p = _torch(maps) if name != "YOLOv2" else torch.from_numpy(maps[0])
    want = jax.jit(lambda *a: jax_stats.yolo_statistics(*a, C))(
        outs_j, *_jax([labels, boxes, mask]), _jax(per_scale))
    got = port_stats.yolo_statistics(outs_p, *_torch([labels, boxes, mask]),
                                     per_scale, C)
    assert list(got) == [m.shape[2] for m in maps]
    assert sorted(want) == sorted(got)          # jit sorts the keys
    for g in want:
        assert got[g].keys() == want[g].keys()
        for k in want[g]:
            np.testing.assert_allclose(got[g][k].item(), float(want[g][k]),
                                       err_msg=f"{g}/{k}", **STAT_TOL)
