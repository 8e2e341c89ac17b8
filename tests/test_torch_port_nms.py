"""Port NMS (``objectdetectionpl_tpu_torch.ops``) against the JAX package.

``greedy_nms_plain`` -- what ``greedy_nms`` runs for CPU tensors and what the
CUDA kernel is held against on the card -- is compared with all three JAX
formulations of the same function: the Pallas kernel in interpret mode,
``blocked_greedy_nms`` and the vmapped while-loop ``_greedy_nms_single``.

Tolerances: ``keep`` must be identical (the IoU is evaluated in the same f32
operation order on both sides, so threshold decisions agree).  Boxes agree
within ``rtol=1e-4, atol=1e-3`` on all rows (the JAX NMS tests' tolerance:
merges sum in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from objectdetectionpl_tpu.ops import anchors as jax_anchors
from objectdetectionpl_tpu.ops import boxes as jax_boxes
from objectdetectionpl_tpu.ops import nms as jax_nms
from objectdetectionpl_tpu.ops.pallas.nms_kernel import pallas_greedy_nms
from objectdetectionpl_tpu_torch.ops import anchors as port_anchors
from objectdetectionpl_tpu_torch.ops import nms as port_nms
from objectdetectionpl_tpu_torch.ops.cuda import nms_kernel

torch.set_num_threads(2)

BOX_TOL = dict(rtol=1e-4, atol=1e-3)


def _candidates(seed, B=2, K=64, C=5, dense=False, n_invalid=10):
    rng = np.random.RandomState(seed)
    cx = rng.uniform(50, 550, (B, K))
    cy = rng.uniform(50, 550, (B, K))
    w = rng.uniform(20, 120, (B, K))
    h = rng.uniform(20, 120, (B, K))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                     -1).astype(np.float32)
    if dense:           # small coordinate range: long suppression chains
        boxes /= 4.0
    scores = np.sort(rng.rand(B, K).astype(np.float32))[:, ::-1].copy()
    if n_invalid:
        scores[:, -n_invalid:] = jax_nms.NEG_INF
    labels = rng.randint(0, C, (B, K)).astype(np.int32)
    obj = rng.rand(B, K).astype(np.float32)
    obj = np.where(scores > jax_nms.NEG_INF, obj, 0.0).astype(np.float32)
    return boxes, scores, labels, obj


def _port(arrays, class_aware, merge):
    b, k = nms_kernel.greedy_nms_plain(
        *map(torch.from_numpy, arrays), nms_thresh=0.4,
        class_aware=class_aware, merge=merge, plus1=1.0)
    return b.numpy(), k.numpy()


def _jax(impl, arrays, class_aware, merge):
    boxes, scores, labels, obj = map(jnp.asarray, arrays)
    if impl == "pallas":
        b, k = pallas_greedy_nms(boxes, scores, labels, obj, nms_thresh=0.4,
                                 class_aware=class_aware, merge=merge,
                                 plus1=1.0, interpret=True)
    elif impl == "blocked":
        b, k = jax_nms.blocked_greedy_nms(boxes, scores, labels, obj,
                                          nms_thresh=0.4,
                                          class_aware=class_aware,
                                          merge=merge, plus1=1.0)
    else:
        import jax
        K = boxes.shape[1]
        b, k = jax.vmap(lambda b_, s, l, o: jax_nms._greedy_nms_single(
            b_, s, l, K, 0.4, lambda x, y: jax_boxes.iou_plus1(x, y),
            class_aware=class_aware, merge=merge, obj_conf=o))(
                boxes, scores, labels, obj)
    return np.asarray(b), np.asarray(k)


@pytest.mark.parametrize("impl", ["pallas", "blocked", "loop"])
@pytest.mark.parametrize("K", [64, 100])
@pytest.mark.parametrize("dense", [False, True], ids=["sparse", "dense"])
@pytest.mark.parametrize("class_aware,merge", [(True, True), (False, False)])
def test_greedy_nms_plain_matches_jax(impl, K, dense, class_aware, merge):
    arrays = _candidates(seed=K + dense, B=2, K=K, C=3, dense=dense)
    pb, pk = _port(arrays, class_aware, merge)
    jb, jk = _jax(impl, arrays, class_aware, merge)
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_allclose(pb, jb, **BOX_TOL)
    assert pk.any() and (~pk).any()


@pytest.mark.parametrize("case", ["all_invalid", "single_valid",
                                  "sparse_100", "mixed_flags"])
def test_greedy_nms_plain_edge_cases(case):
    class_aware, merge = True, True
    if case == "all_invalid":
        arrays = _candidates(seed=1, K=37, n_invalid=37)
    elif case == "single_valid":
        arrays = _candidates(seed=2, K=37, n_invalid=36)
    elif case == "sparse_100":
        arrays = _candidates(seed=3, K=100, C=80)
    else:   # merge without class awareness
        arrays = _candidates(seed=4, K=64, dense=True)
        class_aware = False
    pb, pk = _port(arrays, class_aware, merge)
    jb, jk = _jax("blocked", arrays, class_aware, merge)
    np.testing.assert_array_equal(pk, jk)
    np.testing.assert_allclose(pb, jb, **BOX_TOL)
    n_valid = (arrays[1] > jax_nms.NEG_INF).sum(axis=1)
    if case == "all_invalid":
        assert not pk.any()
        np.testing.assert_array_equal(pb, arrays[0])
    if case == "single_valid":
        np.testing.assert_array_equal(pk.sum(axis=1), n_valid)


def _lone_case(last_alone: bool):
    """Class-agnostic, image 0: A, B, then a shifted copy of A, or (with
    ``last_alone`` False) of B, then two invalid rows; B is the last kept
    box and the copy's first kept suppressor is A (B lone) or B.  Image 1:
    A, two copies of A, C, then a copy of A (C lone) or of C."""
    A = [10.0, 10.0, 60.0, 60.0]
    Bx = [200.0, 200.0, 260.0, 250.0]
    Cx = [400.0, 40.0, 450.0, 90.0]
    shift = lambda b, d: [b[0] + d, b[1], b[2] + d, b[3]]
    img0 = [A, Bx, shift(A if last_alone else Bx, 2.0), A, A]
    img1 = [A, shift(A, 1.0), shift(A, 3.0), Cx,
            shift(A, 4.0) if last_alone else shift(Cx, 2.0)]
    boxes = np.array([img0, img1], np.float32)
    scores = np.array([[0.9, 0.8, 0.7, jax_nms.NEG_INF, jax_nms.NEG_INF],
                       [0.9, 0.8, 0.7, 0.6, 0.5]], np.float32)
    labels = np.array([[0, 1, 2, 0, 0], [0, 1, 2, 3, 4]], np.int32)
    obj = np.where(scores > jax_nms.NEG_INF, 0.5, 0.0).astype(np.float32)
    return boxes, scores, labels, obj


@pytest.mark.parametrize("case", ["lone", "not_lone", "random_sparse",
                                  "random_dense", "all_invalid",
                                  "single_valid"])
@pytest.mark.parametrize("class_aware,merge", [(False, False), (True, True)])
def test_greedy_nms_plain_drop_lone_survivor_matches_jax(case, class_aware,
                                                         merge):
    """``drop_lone_survivor=True`` against ``blocked_greedy_nms``: the last
    kept row goes exactly when no valid later row has it as its first
    kept suppressor."""
    if case in ("lone", "not_lone"):
        arrays = _lone_case(case == "lone")
    elif case == "all_invalid":
        arrays = _candidates(seed=21, K=37, n_invalid=37)
    elif case == "single_valid":
        arrays = _candidates(seed=22, K=37, n_invalid=36)
    else:
        arrays = _candidates(seed=23, B=4, K=100, C=3,
                             dense=case == "random_dense")
    b, k = nms_kernel.greedy_nms_plain(
        *map(torch.from_numpy, arrays), nms_thresh=0.4,
        class_aware=class_aware, merge=merge, plus1=1.0,
        drop_lone_survivor=True)
    jb, jk = jax_nms.blocked_greedy_nms(
        *map(jnp.asarray, arrays), nms_thresh=0.4, class_aware=class_aware,
        merge=merge, plus1=1.0, drop_lone_survivor=True)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), **BOX_TOL)
    _, plain_k = _port(arrays, class_aware, merge)
    dropped = plain_k & ~k.numpy()
    assert dropped.sum(axis=1).max() <= 1        # at most the last kept row
    if case in ("lone", "not_lone") and not class_aware:
        # image 0: B is lone unless its copy follows; image 1: the last
        # kept box (C) is lone unless its copy follows
        assert dropped[:, 1].tolist() == [case == "lone", False]
        assert dropped[1, 3] == (case == "lone")
    if case == "single_valid":                   # alone: always dropped
        assert not k.numpy().any()


def test_greedy_nms_dispatch_has_no_fallback():
    arrays = [torch.from_numpy(a) for a in _candidates(seed=5, K=16)]
    b, k = nms_kernel.greedy_nms(*arrays)          # CPU -> plain version
    pb, pk = nms_kernel.greedy_nms_plain(*arrays)
    torch.testing.assert_close(b, pb, rtol=0, atol=0)
    assert torch.equal(k, pk)
    meta = [a.to("meta") for a in arrays]
    with pytest.raises(ValueError, match="unsupported device"):
        nms_kernel.greedy_nms(*meta)


def test_anchor_tables_match():
    np.testing.assert_array_equal(port_anchors.YOLOV5_ANCHORS,
                                  jax_anchors.YOLOV5_ANCHORS)
    assert port_anchors.YOLOV5_STRIDES == jax_anchors.YOLOV5_STRIDES
    np.testing.assert_array_equal(port_anchors.yolo_grid(5),
                                  jax_anchors.yolo_grid(5))


def _head_maps(seed, B=3, C=6, img=64):
    rng = np.random.RandomState(seed)
    outs = []
    for stride in jax_anchors.YOLOV5_STRIDES:
        g = img // stride
        x = rng.randn(B, 3, g, g, 5 + C).astype(np.float32) * 2.0
        x[..., 4] -= 2.0                    # thin the candidate field
        outs.append(x)
    return outs


def test_decode_yolov5_matches_jax():
    outs = _head_maps(seed=0)
    want = jax_nms.decode_yolov5_predictions(
        [jnp.asarray(o) for o in outs], jax_anchors.YOLOV5_ANCHORS,
        jax_anchors.YOLOV5_STRIDES, 6)
    got = port_nms.decode_yolov5_predictions(
        [torch.from_numpy(o) for o in outs], port_anchors.YOLOV5_ANCHORS,
        port_anchors.YOLOV5_STRIDES, 6)
    assert got.shape == want.shape == (3, 252, 11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("top_k", [64, 300, 2048])
def test_yolo_nms_matches_jax(top_k):
    """Decoded predictions -> yolo_nms on both sides, including a top-k cut
    (252 rows per image, 64 candidates) and no cut (300 and 2048 > 252:
    both sides cap top_k at the rows; K > 1024 itself is held in
    tests/test_torch_port_nms_wide.py)."""
    outs = _head_maps(seed=1)
    dec = np.array(jax_nms.decode_yolov5_predictions(
        [jnp.asarray(o) for o in outs], jax_anchors.YOLOV5_ANCHORS,
        jax_anchors.YOLOV5_STRIDES, 6))
    obj = dec[..., 4]
    assert np.abs(obj - 0.5).min() > 1e-4      # no row near conf_thres
    want = jax_nms.yolo_nms(jnp.asarray(dec), conf_thres=0.5, nms_thres=0.4,
                            top_k=top_k, exact_topk=True)
    got = port_nms.yolo_nms(torch.from_numpy(dec), conf_thres=0.5,
                            nms_thres=0.4, top_k=top_k)
    _assert_result_equal(got, want)
    assert got.valid.any()


def _assert_result_equal(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    v = np.asarray(want.valid)
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(want.boxes)[v],
                               **BOX_TOL)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.obj.numpy(), np.asarray(want.obj),
                               rtol=1e-6, atol=1e-7)


def _yolo_case(name):
    C = 8
    if name == "merge":
        p = np.zeros((1, 4, 5 + C), np.float32)
        p[0, 0] = [100, 100, 40, 40, 0.9] + [0] * C
        p[0, 0, 5 + 3] = 0.8
        p[0, 1] = [102, 102, 40, 40, 0.8] + [0] * C
        p[0, 1, 5 + 3] = 0.7
        p[0, 2] = [300, 300, 40, 40, 0.95] + [0] * C
        p[0, 2, 5 + 5] = 0.9
    elif name == "different_class":
        p = np.zeros((1, 2, 5 + C), np.float32)
        p[0, 0] = [100, 100, 40, 40, 0.9] + [0] * C
        p[0, 0, 5 + 1] = 0.8
        p[0, 1] = [100, 100, 40, 40, 0.8] + [0] * C
        p[0, 1, 5 + 2] = 0.7
    else:   # conf filter
        p = np.zeros((1, 3, 5 + C), np.float32)
        p[0, 0] = [100, 100, 40, 40, 0.4] + [0] * C
    return p


@pytest.mark.parametrize("name,n_valid", [("merge", 2),
                                          ("different_class", 2),
                                          ("conf_filter", 0)])
def test_yolo_nms_small_cases(name, n_valid):
    p = _yolo_case(name)
    K = p.shape[1]
    want = jax_nms.yolo_nms(jnp.asarray(p), conf_thres=0.5, top_k=K,
                            exact_topk=True)
    got = port_nms.yolo_nms(torch.from_numpy(p), conf_thres=0.5, top_k=K)
    _assert_result_equal(got, want)
    assert int(got.valid.sum()) == n_valid
    if name == "merge":     # merged box lies between the two candidates
        v = got.valid[0]
        kept3 = got.boxes[0][v][got.labels[0][v] == 3][0]
        assert 100 < float(kept3[0] + kept3[2]) / 2 < 102


def test_top_k_ties_keep_lower_index_first():
    score = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5]])
    values, idx = port_nms._select_top_k(score, 4)
    assert idx.tolist() == [[1, 3, 0, 2]]
    import jax
    jv, ji = jax.lax.top_k(jnp.asarray(score.numpy()), 4)
    assert np.asarray(ji).tolist() == idx.tolist()


@pytest.mark.parametrize("thresh", [-0.5, 0.0])
def test_greedy_nms_plain_threshold_edges_match_jax(thresh):
    """A negative threshold suppresses disjoint same-class pairs too (IoU 0
    > thresh), which the CUDA kernel's division shortcut must keep; at 0
    only intersecting pairs suppress.  The kernel is held against this
    plain version on the card (chip_smoke.py kernel_check)."""
    arrays = _candidates(seed=7, B=2, K=48, C=3)
    pb, pk = nms_kernel.greedy_nms_plain(*map(torch.from_numpy, arrays),
                                         nms_thresh=thresh)
    boxes, scores, labels, obj = map(jnp.asarray, arrays)
    jb, jk = pallas_greedy_nms(boxes, scores, labels, obj, nms_thresh=thresh,
                               class_aware=True, merge=True, plus1=1.0,
                               interpret=True)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), **BOX_TOL)
    if thresh < 0:                     # one kept box per class and image
        assert (pk.sum(dim=1) <= 3).all()


def test_nms_phase_probe_marks_every_phase():
    """tools/kernel_ab.py --phases stamps clock64() at the shipped kernel's
    phase comments; the source must keep all five marks."""
    from objectdetectionpl_tpu_torch.ops.cuda import _build
    from objectdetectionpl_tpu_torch.tools import kernel_ab
    text = kernel_ab.instrument((_build.CSRC / "greedy_nms.cu").read_text())
    assert [f"PHASE_STAMP({n});" in text for n in range(5)] == [True] * 5
    with pytest.raises(ValueError, match="found 0 of the 5 phase marks"):
        kernel_ab.instrument("__global__ void k() {\n}\n")


def _over_by_midpoint(a, b, t):
    """csrc/greedy_nms.cu's IoU test without a division, in numpy: for
    b > 0 and a, b finite, RN(a / b) > t iff a > m * b (or a == m * b
    where that tie rounds up to the next float), m the midpoint of t and
    the next float, compared in float64, where both sides are exact."""
    t = np.float32(t)
    t_next = np.nextafter(t, np.float32(np.inf))
    mid = (np.float64(t) + np.float64(t_next)) / 2
    tie_up = bool(np.array(t).view(np.uint32) & 1)
    lhs, rhs = a.astype(np.float64), mid * b.astype(np.float64)
    fast = (b > 0) & np.isfinite(b) & np.isfinite(a)
    with np.errstate(divide="ignore", invalid="ignore"):
        slow = (a / b) > t
    return np.where(fast, (lhs > rhs) | (tie_up & (lhs == rhs)), slow)


TINY = np.float32(1.4e-45)                     # the smallest subnormal


@pytest.mark.parametrize("t", [0.4, 0.5, 0.0, -0.5, 0.9, 0.45,
                               float(np.nextafter(np.float32(0.4), 1)),
                               float(3 * TINY)])
def test_division_free_iou_test_is_exact(t):
    """The kernel's midpoint test decides as the IEEE float32 division and
    compare that greedy_nms_plain runs, on quotients within a few ulps of
    the threshold, random ones, ties (possible only for a subnormal t),
    and zero, negative, infinite and NaN operands."""
    rng = np.random.RandomState(0)
    n = 200_000
    b = rng.uniform(1.0, 2e4, n).astype(np.float32)
    t32 = np.float32(t)
    near = (b.astype(np.float64) * float(t32)
            * (1 + rng.randint(-8, 9, n) * 2.0 ** -24)).astype(np.float32)
    a = np.concatenate([near, rng.uniform(0, 2e4, n).astype(np.float32),
                        np.float32([0, 0, 1, np.inf, np.nan, 1, 0, TINY,
                                    3 * TINY, 7 * TINY, 9 * TINY])])
    b = np.concatenate([b, b, np.float32([1, 0, 0, 1, 1, -2, -1, 2, 2, 2,
                                          2])])
    with np.errstate(divide="ignore", invalid="ignore"):
        want = (a / b) > t32
    got = _over_by_midpoint(a, b, t32)
    np.testing.assert_array_equal(got, want)
    assert want.any() and (~want).any()
    if t32 > 1e-30:                            # near samples on both sides
        assert want[:n].any() and (~want[:n]).any()
