"""The SSD and RetinaNet serving and test paths against the JAX package.

- ``anchor_nms`` on the same head maps as JAX's (``ops/nms.py``), for both
  decodes (SSD's without the variances at D=8732, RetinaNet's at the 3069
  anchors of 128 px), ``drop_lone_survivor`` off and on, a class
  threshold that most rows pass and one that leaves fewer than 100
  candidates (masked rows then enter the scan), f32 and bf16 maps:
  ``valid``, ``labels`` and the top-k order equal; boxes within
  ``rtol=1e-5, atol=1e-4`` (pixels), scores within ``rtol=1e-6``.  The
  f32 class logits are a shuffled grid over [-4, 3], so no two candidate
  scores lie within the two frameworks' f32 sigmoid differences.  In bf16
  the scores tie often, and both break ties by the lower index; there the
  logits are drawn from the bf16 values whose sigmoid XLA:CPU and torch
  round alike: torch rounds the sigmoid correctly, XLA:CPU computes it in
  bf16 and is up to 2 ulps off on 2.7 % of the bf16 values in [-4, 3]
  (ROADMAP §C).
- ``make_postprocess`` on the same maps, and ``predict_step`` on weights
  bridged from flax (``strict=True``; RetinaNet at 128 px, B=2; SSD at
  300 px, B=1, without and with BN): the same detections.  For the model
  path the class convs have a zero kernel and a bias drawn per channel,
  so every candidate score is the same f32 number on both sides (the
  forward's differences, 2e-6 of the largest offset, move only the
  boxes: within ``rtol=1e-4, atol=1e-3`` pixels); asserted: no pair of
  candidate boxes has an IoU within 1e-4 of the 0.5 threshold.

``Trainer.test`` and the CLI of these families:
``test_torch_port_anchor_trainer.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from objectdetectionpl_tpu.models import registry as jax_registry
from objectdetectionpl_tpu.ops import anchors as jax_anchors
from objectdetectionpl_tpu.ops import boxes as jax_boxes
from objectdetectionpl_tpu.ops import nms as jax_nms
from objectdetectionpl_tpu.train.step import make_postprocess as jax_post
from objectdetectionpl_tpu_torch.models import build_model
from objectdetectionpl_tpu_torch.ops import anchors as port_anchors
from objectdetectionpl_tpu_torch.ops import boxes as port_boxes
from objectdetectionpl_tpu_torch.ops import nms as port_nms
from objectdetectionpl_tpu_torch.ops.cuda import nms_kernel
from objectdetectionpl_tpu_torch.train.state import create_train_state
from objectdetectionpl_tpu_torch.train.step import (make_postprocess,
                                                    make_predict_step)
from objectdetectionpl_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_port_anchor_models import he_variables

torch.set_num_threads(2)

C = 3
RETINA_IMG = 128
BOX_TOL = dict(rtol=1e-5, atol=1e-4)
MODEL_BOX_TOL = dict(rtol=1e-4, atol=1e-3)


def _bf16_logits_sigmoid_agrees():
    """The bf16 values in [-4, 3] whose sigmoid JAX (XLA:CPU) and torch
    round to the same bf16 number, as f32."""
    bits = torch.arange(65536, dtype=torch.int32).to(torch.int16)
    v = bits.view(torch.bfloat16)
    v = v[torch.isfinite(v) & (v >= -4) & (v <= 3)]
    j = np.asarray(jax.nn.sigmoid(jnp.asarray(v.float().numpy(),
                                              jnp.bfloat16)
                                  ).astype(jnp.float32))
    agree = torch.sigmoid(v).float().numpy() == j
    assert agree.mean() > 0.95
    return v.float().numpy()[agree]


def _maps(name, seed, B=2, dtype="float32"):
    """(loc, cls) numpy maps: offsets N(0, 0.3); f32 class logits a
    shuffled grid over [-4, 3] (sigmoids 3e-6 apart or more), bf16 ones
    drawn from :func:`_bf16_logits_sigmoid_agrees`."""
    A = 8732 if name == "SSD" else 3069
    ch = C + 1 if name == "SSD" else C
    rng = np.random.RandomState(seed)
    loc = (rng.randn(B, A, 4) * 0.3).astype(np.float32)
    n = B * A * ch
    if dtype == "bfloat16":
        cls = rng.choice(_bf16_logits_sigmoid_agrees(), n)
    else:
        cls = -4.0 + 7.0 / n * rng.permutation(n)
    return loc, cls.reshape(B, A, ch).astype(np.float32)


def _anchor_args(name):
    if name == "SSD":
        return port_anchors.ssd_dboxes(), dict(scale=300.0), dict(scale=300.0)
    return (port_anchors.retina_anchors(RETINA_IMG),
            {"decode": jax_boxes.retina_decode},
            {"decode": port_boxes.retina_decode})


def _assert_same(got, want, box_tol=BOX_TOL):
    want = [np.asarray(getattr(want, f).astype(jnp.float32)
                       if getattr(want, f).dtype == jnp.bfloat16
                       else getattr(want, f)) for f in got._fields]
    got = [t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
           for t in got]
    boxes, obj, scores, labels, valid = got
    np.testing.assert_array_equal(valid, want[4])
    np.testing.assert_array_equal(labels, want[3])
    np.testing.assert_allclose(boxes, want[0], **box_tol)
    np.testing.assert_allclose(scores, want[2], rtol=1e-6)
    np.testing.assert_array_equal(obj, 0.0)
    assert valid.any() and (~valid).any()


@pytest.mark.parametrize("name", ["SSD", "RetinaNet"])
@pytest.mark.parametrize("drop", [False, True], ids=["keep_lone", "drop_lone"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", ["many", "few"])
def test_anchor_nms_matches_jax(name, drop, dtype, pool):
    thresh = 0.2 if pool == "many" else {"float32": 0.952,
                                         "bfloat16": 0.93}[dtype]
    loc, cls = _maps(name, seed=1, dtype=dtype)
    anchors, jkw, pkw = _anchor_args(name)
    jd = getattr(jnp, dtype)
    jloc, jcls = jnp.asarray(loc, jd), jnp.asarray(cls, jd)
    want = jax_nms.anchor_nms(jloc, jcls, jnp.asarray(anchors),
                              class_thresh=thresh, exact_topk=True,
                              drop_lone_survivor=drop, **jkw)
    tloc, tcls = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in (jloc, jcls)]
    got = port_nms.anchor_nms(tloc, tcls, anchors, class_thresh=thresh,
                              drop_lone_survivor=drop, **pkw)
    n_cand = (torch.sigmoid(tcls).amax(-1) > thresh).sum(dim=1)
    assert (n_cand < 100).all() == (thresh > 0.5)
    assert got.boxes.dtype == torch.float32 and got.boxes.shape == (2, 100, 4)
    assert got.scores.dtype == getattr(torch, dtype)
    assert got.labels.dtype == torch.int32
    _assert_same(got, want)
    # the flag changes at most the last kept row of an image
    plain = port_nms.anchor_nms(tloc, tcls, anchors, class_thresh=thresh,
                                **pkw)
    assert (plain.valid & ~got.valid).sum(dim=1).max() <= int(drop)


@pytest.mark.parametrize("name", ["SSD", "RetinaNet"])
def test_make_postprocess_matches_jax_on_the_same_maps(name):
    """Both families' postprocess (SSD: background channel dropped, boxes
    scaled by the image size; RetinaNet: its decode, scale 1) at a
    ``conf_thres`` below 0.45, which lowers the class threshold with it."""
    img = 300 if name == "SSD" else RETINA_IMG
    loc, cls = _maps(name, seed=2)
    cls -= 4.0                  # sigmoids up to 0.27: all below 0.45
    want = jax_post(name, C, img, conf_thres=0.1)(
        (jnp.asarray(loc), jnp.asarray(cls)))
    got = make_postprocess(name, C, img, conf_thres=0.1)(
        (torch.from_numpy(loc), torch.from_numpy(cls)))
    _assert_same(got, want)
    assert float(got.scores[got.valid].min()) < 0.45
    if name == "SSD":       # pixels of a 300-px image
        assert float(got.boxes[got.valid].abs().max()) > 1.0


@pytest.mark.parametrize("name", ["SSD", "RetinaNet"])
def test_make_postprocess_copies_its_anchors_once(name, monkeypatch):
    """The anchor table reaches ``anchor_nms`` as one f32 tensor on the
    maps' device, made on the first batch (here under inference mode, as
    ``predict_step`` runs) and handed again to every later batch, so no
    batch copies it from the host."""
    img = 300 if name == "SSD" else RETINA_IMG
    want = (port_anchors.ssd_dboxes() if name == "SSD"
            else port_anchors.retina_anchors(img))
    seen = []
    monkeypatch.setattr(port_nms, "anchor_nms",
                        lambda loc, cls, anchors, **kw: seen.append(anchors))
    post = make_postprocess(name, C, img)
    maps = tuple(torch.from_numpy(m) for m in _maps(name, seed=5))
    with torch.inference_mode():
        post(maps)
    post(maps)
    assert len(seen) == 2 and seen[0] is seen[1]
    assert seen[0].dtype == torch.float32 and not seen[0].is_inference()
    np.testing.assert_array_equal(seen[0].numpy(), want)


def _serving_variables(name, kw, x, seed):
    """Bridged flax variables whose class convs have a zero kernel and a
    bias per channel, so the scores are the same numbers on both sides,
    and whose box convs are scaled so the offsets stay O(1)."""
    jm = jax_registry.build_model(name, C, **kw)
    params, stats = he_variables(jm, x, seed)
    rng = np.random.RandomState(seed)
    if name == "RetinaNet":
        cls_heads, loc_heads = [params["_Head_1"]["Conv_4"]], [
            params["_Head_0"]["Conv_4"]]
    else:                   # per scale: class Conv_2, 4, .., box Conv_3, ..
        cls_heads = [params[f"Conv_{i}"] for i in range(2, 14, 2)]
        loc_heads = [params[f"Conv_{i}"] for i in range(3, 14, 2)]
    for head in cls_heads:
        head["kernel"] = np.zeros_like(head["kernel"])
        head["bias"] = rng.uniform(-3, 1, head["bias"].shape).astype(
            np.float32)
    for head in loc_heads:      # offsets up to ~4 (RetinaNet), ~0.3 (SSD)
        head["kernel"] = head["kernel"] * np.float32(
            0.001 if name == "RetinaNet" else 0.01)
    return jm, params, stats


def _assert_no_iou_at(name, out, img, thresh=0.5, margin=1e-4):
    """No two of the candidates that JAX's ``anchor_nms`` hands its scan
    (the top 100 rows above the class threshold) have an IoU within
    ``margin`` of ``thresh``: the frameworks' box differences cannot flip
    a suppression."""
    loc, cls = out
    if name == "SSD":
        anchors, cls = jax_anchors.ssd_dboxes(), cls[..., 1:]
        decode = lambda o, a: jax_boxes.ssd_decode(o, a, False)
        scale = float(img)
    else:
        anchors, decode, scale = (jax_anchors.retina_anchors(img),
                                  jax_boxes.retina_decode, 1.0)
    score = jax.nn.sigmoid(cls).max(-1)
    score = jnp.where(score > 0.3, score, jax_nms.NEG_INF)
    top, idx = jax.lax.top_k(score, 100)
    boxes = jax.vmap(lambda l, i: jax_boxes.xywh_to_xyxy(
        decode(l[i], jnp.asarray(anchors)[i])) * scale)(loc, idx)
    assert np.isfinite(np.asarray(boxes)).all()
    iou = jax.vmap(lambda b: jax_boxes.iou_plus1(b[:, None], b[None, :]))(
        boxes)
    cand = np.asarray(top > jax_nms.NEG_INF)
    pair = cand[:, :, None] & cand[:, None, :]
    assert pair.sum() > 2 * len(cand)
    assert np.abs(np.asarray(iou) - thresh)[pair].min() > margin


@pytest.mark.parametrize("name,kw,img,B", [
    ("RetinaNet", {}, RETINA_IMG, 2),
    ("SSD", {"ssd_bn": False}, 300, 1),
    ("SSD", {"ssd_bn": True}, 300, 1),
])
def test_predict_step_matches_jax_chain(name, kw, img, B):
    x = np.random.RandomState(3).rand(B, img, img, 3).astype(np.float32)
    jm, params, stats = _serving_variables(name, kw, x, seed=4)
    out = jax.jit(lambda v, i: jm.apply(v, i, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    want = jax_post(name, C, img, conf_thres=0.3)(out)
    _assert_no_iou_at(name, out, img)
    port = build_model(name, C, device="cpu", **kw)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    step = make_predict_step(port, make_postprocess(name, C, img,
                                                    conf_thres=0.3))
    got = step(create_train_state(port), torch.from_numpy(x))
    _assert_same(got, want, MODEL_BOX_TOL)


def test_predict_step_runs_the_nms_wrapper_once_per_batch(monkeypatch):
    model = build_model("RetinaNet", C, device="cpu")
    step = make_predict_step(model, make_postprocess("RetinaNet", C, 64))
    calls = []
    real = nms_kernel.greedy_nms

    def counting(*args, **kwargs):
        calls.append((args[0].shape, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(nms_kernel, "greedy_nms", counting)
    res = step(create_train_state(model),
               torch.zeros(3, 64, 64, 3, dtype=torch.uint8))
    assert len(calls) == 1 and calls[0][0] == torch.Size([3, 100, 4])
    assert calls[0][1] == dict(nms_thresh=0.5, class_aware=False,
                               merge=False, plus1=1.0,
                               drop_lone_survivor=False)
    assert res.boxes.shape == (3, 100, 4) and res.labels.dtype == torch.int32
