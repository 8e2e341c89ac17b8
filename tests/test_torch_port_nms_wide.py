"""NMS past K=1024 (the tiled CUDA kernel's domain) against the JAX package.

The CUDA kernel ``csrc/greedy_nms.cu`` takes K up to 1024 in one tile and
any larger K in tiles; its CPU counterpart, the op's CPU kernel, is
``greedy_nms_plain`` for every K.  Here, at K = 1025 and 2048 (B=2):

- ``greedy_nms_plain`` and the op ``objdet::greedy_nms`` on CPU tensors
  against JAX's ``blocked_greedy_nms`` and ``pallas_greedy_nms`` (interpret
  mode) for class-aware merge and for near-threshold pairs, and against
  ``blocked_greedy_nms`` for class-agnostic with ``drop_lone_survivor``
  (the Pallas kernel has no such flag): ``keep`` identical, boxes within
  ``rtol=1e-4, atol=1e-3`` (``tests/test_torch_port_nms.py``'s tolerance:
  merges sum in another order).
- The slice as a whole: ``make_postprocess("YOLOv5", ...)`` at 256 px
  (4,032 rows an image) with ``top_k=2048``, f32, on YOLOv5s maps from the
  same flax variables (``utils/weights.py``'s conversion) against JAX's:
  over 1,024 detections an image, equal as sets.
- The CUDA implementation of the op, through a fake library on CPU
  tensors: at K=4096 it asks the library for the workspace, allocates
  the size the library gives on the tensors' device, launches once,
  counts a tiled launch and never calls the plain version.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from objectdetectionpl_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from objectdetectionpl_tpu.ops import anchors as jax_anchors
from objectdetectionpl_tpu.ops import nms as jax_nms
from objectdetectionpl_tpu.ops.pallas.nms_kernel import pallas_greedy_nms
from objectdetectionpl_tpu.train.step import make_postprocess as jax_post
from objectdetectionpl_tpu_torch.models import build_model
from objectdetectionpl_tpu_torch.ops.cuda import nms_kernel
from objectdetectionpl_tpu_torch.train.state import create_train_state
from objectdetectionpl_tpu_torch.train.step import (make_postprocess,
                                                    make_predict_step)
from objectdetectionpl_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_port_blocks import randomized_variables
from test_torch_port_nms import BOX_TOL, _candidates

torch.set_num_threads(2)

THRESH = 0.4


def _near_threshold(seed, B, K, C=5):
    """Pairs (2m, 2m + 1) of one label whose IoU+1 lies within a few ulps
    of THRESH on either side: a box and its copy shifted right by s, (w +
    1 - s) / (w + 1 + s) = THRESH, s moved by up to 64 * 2**-26 of itself
    (``chip_smoke.py::near_threshold``, in numpy); K odd cuts the last
    pair."""
    rng = np.random.RandomState(seed)
    n = (K + 1) // 2
    u = lambda lo, hi: rng.uniform(lo, hi, (B, n))
    x, y, w, h = u(50, 500), u(50, 500), u(20, 120), u(20, 120)
    s = (w + 1) * (1 - THRESH) / (1 + THRESH) * (
        1 + rng.randint(-64, 65, (B, n)) * 2.0 ** -26)
    first = np.stack([x, y, x + w, y + h], -1)
    second = np.stack([x + s, y, x + w + s, y + h], -1)
    boxes = np.stack([first, second], 2).reshape(B, 2 * n, 4)[:, :K]
    labels = np.repeat(rng.randint(0, C, (B, n)), 2, axis=1)[:, :K]
    scores = np.sort(rng.rand(B, K))[:, ::-1]
    obj = rng.rand(B, K)
    return (boxes.astype(np.float32), scores.astype(np.float32).copy(),
            labels.astype(np.int32), obj.astype(np.float32))


# case -> (inputs of K, flags, JAX implementations to hold it against)
CASES = {
    "class_aware_merge": (lambda K: _candidates(K, B=2, K=K, C=80),
                          dict(class_aware=True, merge=True),
                          ("blocked", "pallas")),
    "agnostic_drop_lone": (lambda K: _candidates(K + 1, B=2, K=K, C=80,
                                                 dense=True),
                           dict(class_aware=False, merge=False,
                                drop_lone_survivor=True), ("blocked",)),
    "near_threshold": (lambda K: _near_threshold(K + 2, 2, K),
                       dict(class_aware=True, merge=True),
                       ("blocked", "pallas")),
}


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
def test_wide_greedy_nms_matches_jax(K, case):
    make, flags, impls = CASES[case]
    arrays = make(K)
    tensors = [torch.from_numpy(a) for a in arrays]
    pb, pk = nms_kernel.greedy_nms_plain(*tensors, nms_thresh=THRESH,
                                         **flags)
    ob, ok = nms_kernel.greedy_nms(*tensors, nms_thresh=THRESH, **flags)
    assert torch.equal(ok, pk) and torch.equal(ob, pb)     # the op's CPU
    for impl in impls:
        jb, jk = _jax(impl, arrays, flags)
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk), impl)
        np.testing.assert_allclose(pb.numpy(), np.asarray(jb), **BOX_TOL,
                                   err_msg=impl)
    kept = pk.sum(dim=1)
    assert (kept > 0).all() and (kept < K).all()
    if case == "near_threshold":       # the pairs decide both ways
        pair = pk[:, 0:K - 1:2] & pk[:, 1::2]
        assert pair.any() and (~pair).any()


IMG = 256
C = 3
TOP_K = 2048
CONF = 0.5


def test_wide_postprocess_matches_jax():
    """YOLOv5s at 256 px: 4,032 rows an image, the top 2048 into the NMS on
    both sides.  One anchor of three has its obj logit at +3, so ~1,350
    rows an image pass conf_thres and ~700 invalid rows ride along: the
    top-k cut then lies among rows at NEG_INF, whose order both sides take
    by index, and not between valid scores closer together than the
    forward's ~1e-5 relative differences between XLA and torch (at +3 for
    two anchors of three, ~2,700 rows pass and the 2048th and 2049th
    scores are ~1e-6 apart)."""
    model = JaxYOLOv5(num_classes=C)
    images = np.random.RandomState(2).rand(2, IMG, IMG, 3).astype(np.float32)
    params, stats = randomized_variables(model, images, seed=1, jit=True)
    rng = np.random.RandomState(1)
    for head in ("Conv_0", "Conv_1", "Conv_2"):
        bias = rng.normal(0.0, 1.0, (3, 5 + C)).astype(np.float32)
        bias[:, 4] = [3.0, -3.0, -3.0]         # obj logit per anchor
        params[head]["bias"] = bias.reshape(-1)
    out = jax.jit(lambda v, i: model.apply(v, i, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(images))
    dec = np.asarray(jax_nms.decode_yolov5_predictions(
        out, jax_anchors.YOLOV5_ANCHORS, jax_anchors.YOLOV5_STRIDES, C))
    assert dec.shape[1] == 4032
    obj = dec[..., 4]
    assert np.abs(obj - CONF).min() > 1e-4                  # precondition
    passed = (obj >= CONF).sum(axis=1)
    assert ((passed > 1024) & (passed < TOP_K)).all()
    want = jax_post("YOLOv5", C, IMG, conf_thres=CONF, top_k=TOP_K)(out)

    port = build_model("YOLOv5", C, device="cpu")
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    step = make_predict_step(port, make_postprocess(
        "YOLOv5", C, IMG, conf_thres=CONF, top_k=TOP_K))
    got = step(create_train_state(port), torch.from_numpy(images))
    assert np.asarray(want.valid).sum(axis=1).min() > 1024
    assert got.valid.shape == (2, TOP_K)
    for i in range(2):
        _assert_same_detection_sets(got, want, i)


def _assert_same_detection_sets(got, want, i):
    """Image i's valid detections equal as sets: each of JAX's matched to
    one of the port's of the same label with boxes within rtol=1e-4,
    atol=1e-3 and score and obj within rtol=1e-4, atol=1e-6.  Rows whose
    scores lie closer together than the forward's differences take another
    order on the two sides (and, when they overlap, another of them is the
    kept head of the same merged group), so positions are not compared."""
    def rows(r):
        v = np.asarray(r.valid[i])
        return [np.asarray(getattr(r, n)[i])[v]
                for n in ("labels", "boxes", "scores", "obj")]
    (gl, gb, gs, go), (wl, wb, ws, wo) = rows(got), rows(want)
    assert len(gl) == len(wl) > 0
    free = np.ones(len(gl), bool)
    for label, box, score, obj in zip(wl, wb, ws, wo):
        match = (free & (gl == label)
                 & np.isclose(gb, box, rtol=1e-4, atol=1e-3).all(axis=1)
                 & np.isclose(gs, score, rtol=1e-4, atol=1e-6)
                 & np.isclose(go, obj, rtol=1e-4, atol=1e-6))
        assert match.any(), (label, box, score, obj)
        free[np.argmax(match)] = False


class _Lib:
    """A kernel library that records its calls and launches nothing."""

    def __init__(self):
        self.calls = []

    def greedy_nms_max_k(self):
        return 1024

    def greedy_nms_workspace_bytes(self, B, K):
        """A size of the split route's order (~94 bytes a row at K=4096)
        that only the library knows."""
        size = 94 * B * K + 48
        self.calls.append(("workspace_bytes", B, K, size))
        return size

    def greedy_nms_launch(self, *args):
        self.calls.append(("launch",) + args)
        return 0


class _Stream:
    cuda_stream = 0


def test_cuda_op_takes_wide_k_with_its_workspace_on_the_device(monkeypatch):
    lib, allocated = _Lib(), []
    empty = torch.empty

    def recording_empty(*args, **kwargs):
        t = empty(*args, **kwargs)
        allocated.append(t)
        return t

    def no_plain(*args, **kwargs):
        raise AssertionError("the CUDA implementation called the plain "
                             "version")

    monkeypatch.setattr(nms_kernel, "_lib", lambda: lib)
    monkeypatch.setattr(nms_kernel, "greedy_nms_plain", no_plain)
    monkeypatch.setattr(torch, "empty", recording_empty)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(nms_kernel, "LAUNCHES", 0)
    monkeypatch.setattr(nms_kernel, "TILED_LAUNCHES", 0)
    B, K = 2, 4096
    boxes = empty(B, K, 4)
    out, keep = nms_kernel._greedy_nms_cuda(
        boxes, empty(B, K), torch.zeros(B, K, dtype=torch.int32),
        empty(B, K), 0.4, False, False, 1.0, True)
    assert out.shape == (B, K, 4) and keep.shape == (B, K)
    assert [c[0] for c in lib.calls] == ["workspace_bytes", "launch"]
    assert lib.calls[0][1:3] == (B, K)
    launch = lib.calls[1][1:]
    assert launch[6:8] == (B, K) and launch[-2] == 1         # drop_lone
    workspace = [t for t in allocated if t.dtype == torch.uint8]
    assert len(workspace) == 1
    assert workspace[0].numel() == lib.calls[0][3]       # the library's size
    assert workspace[0].device == boxes.device
    assert launch[-1] == workspace[0].data_ptr()
    assert (nms_kernel.LAUNCHES, nms_kernel.TILED_LAUNCHES) == (1, 1)
    # K at the single-tile limit: no workspace, not a tiled launch
    lib.calls.clear()
    nms_kernel._greedy_nms_cuda(
        empty(B, 1024, 4), empty(B, 1024),
        torch.zeros(B, 1024, dtype=torch.int32), empty(B, 1024), 0.4, True,
        True, 1.0, False)
    assert [c[0] for c in lib.calls] == ["launch"]
    assert lib.calls[0][-1] is None
    assert (nms_kernel.LAUNCHES, nms_kernel.TILED_LAUNCHES) == (2, 1)

