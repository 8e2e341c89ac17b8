"""The port's mAP path (``ops/metrics.py``), panels (``utils/viz.py``) and
palette against the JAX package.

The metrics are numpy in both packages and must agree exactly
(``assert_array_equal`` on statistics, ``==`` on the result dicts) on
random statistics: detections jittered around the GT boxes so that some
match at IoU >= 0.5, some miss, and some carry labels the image lacks.
The panels are drawn in numpy; their outlines must equal PIL's
``rectangle(width=2)`` -- the JAX panels without their class-name text --
on boxes at least 4 px wide and tall, inside the image or crossing its
edge.  A box wholly outside draws nothing (PIL clamps it onto the edge).
"""

import numpy as np
import pytest

from objectdetectionpl_tpu.data.palette import COLORS as JAX_COLORS
from objectdetectionpl_tpu.ops import metrics as jax_metrics
from objectdetectionpl_tpu.utils import viz as jax_viz
from objectdetectionpl_tpu_torch.data.palette import COLORS
from objectdetectionpl_tpu_torch.ops import metrics
from objectdetectionpl_tpu_torch.utils import viz


def _statistics_inputs(seed, B=4, K=16, M=6, C=4):
    rng = np.random.RandomState(seed)
    gt = rng.uniform(0, 200, (B, M, 2)).astype(np.float32)
    gt = np.concatenate([gt, gt + rng.uniform(10, 80, (B, M, 2))], -1)
    gt_labels = rng.randint(0, C, (B, M)).astype(np.int32)
    gt_valid = rng.rand(B, M) > 0.25
    src = rng.randint(0, M, (B, K))
    pred = np.take_along_axis(gt, src[..., None], 1)
    pred = pred + rng.normal(0, 8, pred.shape).astype(np.float32)
    labels = np.take_along_axis(gt_labels, src, 1)
    relabel = rng.rand(B, K) < 0.3
    labels = np.where(relabel, rng.randint(0, C, (B, K)), labels)
    scores = np.sort(rng.rand(B, K).astype(np.float32), 1)[:, ::-1].copy()
    valid = rng.rand(B, K) > 0.2
    valid[0] = False                     # an image without detections
    return (pred, scores, labels.astype(np.int32), valid, gt, gt_labels,
            gt_valid)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_batch_statistics_and_map_equal_jax(seed):
    args = _statistics_inputs(seed)
    got = metrics.batch_statistics(*args)
    want = jax_metrics.batch_statistics(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert 0 < got[0].sum() < len(got[0])          # hits and misses
    targets = args[5][args[6]]
    assert metrics.evaluate_map([got], targets) == \
        jax_metrics.evaluate_map([want], targets)


def test_ap_per_class_and_compute_ap_equal_jax():
    rng = np.random.RandomState(7)
    n = 300
    tp = (rng.rand(n) > 0.5).astype(np.float64)
    conf = rng.rand(n).astype(np.float32)
    pred_cls = rng.randint(0, 6, n).astype(np.float64)
    target_cls = rng.randint(0, 7, 90).astype(np.float64)
    for g, w in zip(metrics.ap_per_class(tp, conf, pred_cls, target_cls),
                    jax_metrics.ap_per_class(tp, conf, pred_cls, target_cls)):
        np.testing.assert_array_equal(g, w)
    recall, precision = np.sort(rng.rand(20)), rng.rand(20)
    assert metrics.compute_ap(recall, precision) == \
        jax_metrics.compute_ap(recall, precision)


def test_evaluate_map_without_statistics_equals_jax():
    assert metrics.evaluate_map([], np.zeros(0)) == \
        jax_metrics.evaluate_map([], np.zeros(0))
    empty = metrics.batch_statistics(*_statistics_inputs(4, B=1))
    assert [len(a) for a in empty] == [0, 0, 0]


def test_palette_equals_jax():
    assert COLORS == JAX_COLORS and len(COLORS) == 100


def _pil_outlines(image01, boxes, labels, valid):
    from PIL import Image, ImageDraw
    img = Image.fromarray((np.clip(image01, 0, 1) * 255).astype(np.uint8))
    drw = ImageDraw.Draw(img)
    for box, label, v in zip(boxes, labels, valid):
        if v:
            drw.rectangle([float(c) for c in box],
                          outline=tuple(JAX_COLORS[int(label) % 100]),
                          width=2)
    return np.asarray(img)


def test_draw_boxes_outlines_equal_pil():
    rng = np.random.RandomState(3)
    image = rng.rand(48, 64, 3).astype(np.float32) * 1.2 - 0.1
    xy = rng.uniform(-20, 60, (12, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 30, (12, 2))], -1)
    labels = rng.randint(0, 150, 12)
    valid = rng.rand(12) > 0.25
    corners = np.trunc(boxes)                 # as both draw them
    inside = ((corners[:, 2] >= 0) & (corners[:, 0] < 64)
              & (corners[:, 3] >= 0) & (corners[:, 1] < 48))
    assert valid.sum() > (valid & inside).sum() > 6
    got = viz.draw_boxes(image, boxes, labels, valid=valid & inside)
    assert got.dtype == np.uint8 and got.shape == (48, 64, 3)
    np.testing.assert_array_equal(got, _pil_outlines(image, boxes, labels,
                                                     valid & inside))
    np.testing.assert_array_equal(
        viz.draw_boxes(image, boxes, labels, valid=valid), got)
    untouched = viz.draw_boxes(image, boxes, labels, valid=np.zeros(12, bool))
    np.testing.assert_array_equal(
        untouched, (np.clip(image, 0, 1) * 255).astype(np.uint8))


def test_side_by_side_equals_jax():
    a = np.zeros((8, 5, 3), np.uint8)
    b = np.full((6, 7, 3), 9, np.uint8)
    np.testing.assert_array_equal(viz.side_by_side(a, b),
                                  jax_viz.side_by_side(a, b))
