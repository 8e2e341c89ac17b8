"""NMS split by label, as the CUDA route for K > 1024 computes it.

Above K=1024 ``csrc/greedy_nms.cu`` partitions each image's valid rows by
label (class-aware; one segment otherwise, or when the label range
exceeds the partition's histogram) and runs each segment's chain on its
own; ``drop_lone_survivor`` stays the image's rule.  Its plain PyTorch
twin is ``greedy_nms_segmented_plain``.  Here, at K = 1025 and 2048, B=2,
it is held against ``greedy_nms_plain`` (the contract, and the op's CPU
kernel) and against JAX's ``blocked_greedy_nms`` and, where the case has
no ``drop_lone_survivor`` (the Pallas kernel has no such flag),
``pallas_greedy_nms`` in interpret mode: ``keep`` identical, boxes within
``BOX_TOL`` (rtol 1e-4, atol 1e-3, ``tests/test_torch_port_nms.py``'s:
merges sum in another order on the JAX side).

Cases: 80 labels; 1 label (one segment above 1024 at K=2048); 2 labels
with one segment above 1024; labels with gaps and a range above the
histogram; near-threshold pairs; class-agnostic rows with and without
merge; ``drop_lone_survivor`` where one segment's last kept row is lone
while another segment's last kept row comes later in the image (kept,
since the rule is the image's), and where the image's last kept row is
lone (dropped, its input box returned); merge on and off.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from objectdetectionpl_tpu.ops import nms as jax_nms
from objectdetectionpl_tpu.ops.pallas.nms_kernel import pallas_greedy_nms
from objectdetectionpl_tpu_torch.ops.cuda import nms_kernel
from test_torch_port_nms import BOX_TOL, _candidates
from test_torch_port_nms_wide import _near_threshold

torch.set_num_threads(2)

THRESH = 0.4


def _labelled(seed, K, labels_of):
    """``_candidates`` at B=2 with labels drawn by ``labels_of(rng, shape)``."""
    boxes, scores, _, obj = _candidates(seed, B=2, K=K, C=1)
    rng = np.random.RandomState(seed + 1)
    return boxes, scores, labels_of(rng, (2, K)).astype(np.int32), obj


def _two_labels(seed, K):
    """95 % of the rows label 7, the rest label 8: at K=2048 a segment of
    ~1,900 rows (the tiled chain) beside a short one."""
    return _labelled(seed, K, lambda rng, shape:
                     np.where(rng.rand(*shape) < 0.95, 7, 8))


def _gaps(seed, K):
    """Labels from {-5, 3, 17, 500, 2000}: gaps, a negative label, and a
    range of 2,006, above the partition's 1,024-label histogram."""
    return _labelled(seed, K, lambda rng, shape:
                     np.array([-5, 3, 17, 500, 2000])[rng.randint(0, 5, shape)])


def _lone(K, image_last_lone):
    """Disjoint 20-px boxes on a grid, labels 0 and 1 alternating: every row
    is kept and every group is empty, so each segment's last kept row is
    lone within its segment.  With ``image_last_lone`` the image's last
    kept row K-1 is lone: the flag drops it and only it.  Otherwise row
    K-1 is row K-2 moved 1 px with its label: K-2 suppresses it, so the
    image's last kept row K-2 is not lone and nothing is dropped, though
    the other label's last kept row K-3 is lone in its own segment.
    Image 1 is image 0 moved by 7 px."""
    i = np.arange(K)
    x, y = 40.0 * (i % 50), 40.0 * (i // 50)
    one = np.stack([x, y, x + 20, y + 20], -1)
    labels = (i % 2).astype(np.int32)
    if not image_last_lone:
        one[K - 1] = one[K - 2] + [1.0, 0.0, 1.0, 0.0]
        labels[K - 1] = labels[K - 2]
    boxes = np.stack([one, one + 7.0]).astype(np.float32)
    scores = np.tile(np.linspace(0.99, 0.5, K, dtype=np.float32), (2, 1))
    obj = np.random.RandomState(K).rand(2, K).astype(np.float32)
    return boxes, scores, np.stack([labels, labels]), obj


AWARE = dict(class_aware=True, merge=True)
# case -> (inputs of K, flags, JAX implementations to hold it against)
CASES = {
    "c80": (lambda K: _candidates(K, B=2, K=K, C=80), AWARE,
            ("blocked", "pallas")),
    "c1": (lambda K: _candidates(K + 1, B=2, K=K, C=1), AWARE,
           ("blocked", "pallas")),
    "c2_one_segment_above_1024": (lambda K: _two_labels(K + 2, K), AWARE,
                                  ("blocked",)),
    "labels_with_gaps": (lambda K: _gaps(K + 3, K), AWARE, ("blocked",)),
    "near_threshold": (lambda K: _near_threshold(K + 4, 2, K), AWARE,
                       ("blocked", "pallas")),
    "agnostic_merge": (lambda K: _candidates(K + 5, B=2, K=K, C=80),
                       dict(class_aware=False, merge=True), ("blocked",)),
    "agnostic_no_merge": (lambda K: _candidates(K + 6, B=2, K=K, C=80,
                                                dense=True),
                          dict(class_aware=False, merge=False),
                          ("blocked",)),
    "c80_no_merge_drop": (lambda K: _candidates(K + 7, B=2, K=K, C=80,
                                                dense=True),
                          dict(class_aware=True, merge=False,
                               drop_lone_survivor=True), ("blocked",)),
}
for _last_lone in (False, True):
    for _merge in (False, True):
        for _drop in (False, True):
            CASES[f"lone_last={_last_lone}_merge={_merge}_drop={_drop}"] = (
                lambda K, _l=_last_lone: _lone(K, _l),
                dict(class_aware=True, merge=_merge,
                     drop_lone_survivor=_drop), ("blocked",))


def _jax(impl, arrays, flags):
    boxes, scores, labels, obj = map(jnp.asarray, arrays)
    if impl == "pallas":
        return pallas_greedy_nms(boxes, scores, labels, obj,
                                 nms_thresh=THRESH, plus1=1.0,
                                 interpret=True, **flags)
    return jax_nms.blocked_greedy_nms(boxes, scores, labels, obj,
                                      nms_thresh=THRESH, plus1=1.0, **flags)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("K", [1025, 2048])
def test_segmented_matches_plain_and_jax(K, case):
    make, flags, impls = CASES[case]
    arrays = make(K)
    tensors = [torch.from_numpy(a) for a in arrays]
    sb, sk = nms_kernel.greedy_nms_segmented_plain(
        *tensors, nms_thresh=THRESH, **flags)
    pb, pk = nms_kernel.greedy_nms_plain(*tensors, nms_thresh=THRESH,
                                         **flags)
    assert torch.equal(sk, pk)
    torch.testing.assert_close(sb, pb, **BOX_TOL)
    for impl in impls:
        jb, jk = _jax(impl, arrays, flags)
        np.testing.assert_array_equal(sk.numpy(), np.asarray(jk), impl)
        np.testing.assert_allclose(sb.numpy(), np.asarray(jb), **BOX_TOL,
                                   err_msg=impl)
    kept = sk.sum(dim=1)
    if not case.startswith("lone_last"):
        assert (kept > 0).all() and (kept < K).all()
        return
    # every row kept but K-1: suppressed by K-2, or dropped as lone
    dropped = flags["drop_lone_survivor"] and case.startswith("lone_last=True")
    if case.startswith("lone_last=True") and not dropped:
        assert (kept == K).all()
        return
    assert (kept == K - 1).all() and not sk[:, K - 1].any()
    assert sk[:, K - 2].all() and sk[:, K - 3].all()
    if dropped:                        # its input box back, not its merge
        assert torch.equal(sb[:, K - 1], tensors[0][:, K - 1])


def test_segments_take_any_grouping(monkeypatch):
    """One segment a call, or all of them together: the same result."""
    arrays = _two_labels(11, 1500)
    tensors = [torch.from_numpy(a) for a in arrays]
    want = nms_kernel.greedy_nms_segmented_plain(*tensors)
    for pairs in (1, 1 << 30):
        monkeypatch.setattr(nms_kernel, "SEGMENT_PAIRS_PER_CALL", pairs)
        got = nms_kernel.greedy_nms_segmented_plain(*tensors)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_segments_without_valid_rows():
    boxes, scores, labels, obj = map(torch.from_numpy,
                                     _candidates(3, B=2, K=1100, C=80))
    scores[0] = nms_kernel.NEG_INF                  # image 0: no valid row
    flags = dict(nms_thresh=THRESH, drop_lone_survivor=True)
    sb, sk = nms_kernel.greedy_nms_segmented_plain(boxes, scores, labels,
                                                   obj, **flags)
    pb, pk = nms_kernel.greedy_nms_plain(boxes, scores, labels, obj, **flags)
    assert not sk[0].any() and torch.equal(sb[0], boxes[0])
    assert torch.equal(sk, pk)
    torch.testing.assert_close(sb, pb, **BOX_TOL)
