"""Port YOLOv5 assignment and loss (``objectdetectionpl_tpu_torch.ops``) against the JAX package.

Head maps for a 64 px input (grids 8/4/2), B=2, M=8 padded targets, C=3
classes, drawn from numpy seeds and fed to both sides.

Tolerances: ``build_targets_v5`` equal field by field (the same f32
operations on exact grid arithmetic); ``iou_v5`` ``rtol=1e-6, atol=1e-7``;
the elementwise criteria ``rtol=1e-6, atol=1e-7``; loss values and
d(loss)/d(head maps) in f32 ``rtol=1e-5, atol=1e-7`` (sums of a few hundred
terms in another order); in bf16 the loss terms within ``rtol=5e-3``,
about one bf16 ulp (2**-8 relative): the head maps are rounded alike, but
XLA may keep f32 between fused bf16 ops where torch rounds each op to bf16
(measured: up to 1.5e-3).
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
from objectdetectionpl_tpu_torch.ops import assignment as port_assign
from objectdetectionpl_tpu_torch.ops import boxes as port_boxes
from objectdetectionpl_tpu_torch.ops import losses as port_losses

torch.set_num_threads(2)

B, M, C, IMG = 2, 8, 3, 64
TIGHT = dict(rtol=1e-6, atol=1e-7)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)


def _targets(seed, case="random"):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, C, (B, M)).astype(np.int32)
    boxes = np.concatenate([rng.uniform(0.05, 0.95, (B, M, 2)),
                            rng.uniform(0.05, 0.6, (B, M, 2))],
                           -1).astype(np.float32)
    mask = rng.rand(B, M) < 0.75
    if case == "empty":
        mask[:] = False
    elif case == "duplicate_cells":
        # same centers, other sizes: the same cells get different GIoUs
        boxes[:, 4:, :2] = boxes[:, :4, :2]
        mask[:] = True
    return labels, boxes, mask


def _head_maps(seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [(rng.randn(B, 3, IMG // s, IMG // s, 5 + C) * 1.5).astype(dtype)
            for s in jax_anchors.YOLOV5_STRIDES]


def test_build_targets_v5_matches_jax():
    labels, boxes, mask = _targets(0)
    n_valid = []
    for layer, stride in enumerate(jax_anchors.YOLOV5_STRIDES):
        g = IMG // stride
        anc = jax_anchors.YOLOV5_ANCHORS[layer] / stride
        want = jax_assign.build_targets_v5(
            jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(mask),
            jnp.asarray(anc), g)
        got = port_assign.build_targets_v5(
            torch.from_numpy(labels), torch.from_numpy(boxes),
            torch.from_numpy(mask), torch.from_numpy(anc), g)
        assert got._fields == want._fields
        for name, w, t in zip(got._fields, want, got):
            np.testing.assert_array_equal(t.numpy(), np.asarray(w),
                                          err_msg=name)
        assert got.valid.shape == (B * M * 3 * 3,)
        n_valid.append(int(got.valid.sum()))
    assert min(n_valid[:2]) > 0, n_valid       # neighbours and centers


@pytest.mark.parametrize("variant", ["iou", "giou", "diou", "ciou"])
def test_iou_v5_matches_jax(variant):
    rng = np.random.RandomState(1)
    b1 = np.concatenate([rng.uniform(0, 10, (64, 2)),
                         rng.uniform(0.5, 5, (64, 2))], -1).astype(np.float32)
    b2 = b1 + rng.normal(0, 1.0, b1.shape).astype(np.float32)
    b2[..., 2:] = np.abs(b2[..., 2:]) + 0.1
    kw = {variant: True} if variant != "iou" else {}
    want = jax_boxes.iou_v5(jnp.asarray(b1), jnp.asarray(b2), xyxy=False,
                            **kw)
    got = port_boxes.iou_v5(torch.from_numpy(b1), torch.from_numpy(b2),
                            xyxy=False, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


def test_criteria_match_jax():
    rng = np.random.RandomState(2)
    x = (rng.randn(200) * 6).astype(np.float32)
    t = rng.rand(200).astype(np.float32)
    for port_fn, jax_fn in ((port_losses.bce_logits, jax_losses.bce_logits),
                            (port_losses.focal_bce_logits,
                             jax_losses.focal_bce_logits)):
        np.testing.assert_allclose(
            port_fn(torch.from_numpy(x), torch.from_numpy(t)).numpy(),
            np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(t))), **TIGHT)
    for eps in (0.0, 0.1):
        assert (port_losses.smooth_bce_targets(eps)
                == jax_losses.smooth_bce_targets(eps))


@pytest.fixture(scope="module")
def jax_loss_and_grad():
    loss = jax_losses.make_loss("YOLOv5", C, IMG)
    return jax.jit(jax.value_and_grad(
        lambda outs, l, b, m: (lambda d: (d["loss"], d))(loss(outs, l, b, m)),
        has_aux=True))


@pytest.mark.parametrize("case", ["random", "empty", "duplicate_cells"])
def test_yolov5_loss_and_grad_match_jax(jax_loss_and_grad, case):
    labels, boxes, mask = _targets(3, case)
    maps = _head_maps(4)
    (_, want), want_g = jax_loss_and_grad(
        [jnp.asarray(m) for m in maps], jnp.asarray(labels),
        jnp.asarray(boxes), jnp.asarray(mask))
    outs = [torch.from_numpy(m).requires_grad_() for m in maps]
    got = port_losses.make_loss("YOLOv5", C, IMG)(
        outs, torch.from_numpy(labels), torch.from_numpy(boxes),
        torch.from_numpy(mask))
    got["loss"].backward()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   err_msg=k, **LOSS_TOL)
        assert got[k].dtype == torch.float32
    for o, w in zip(outs, want_g):
        assert torch.isfinite(o.grad).all()
        np.testing.assert_allclose(o.grad.numpy(), np.asarray(w), **LOSS_TOL)
    if case == "empty":
        assert got["Localization"].item() == 0.0
        assert got["Classification"].item() == 0.0
        assert got["Conf_obj"].item() > 0.0    # every cell is a negative


def test_yolov5_loss_bf16_dtype_flow_matches_jax():
    labels, boxes, mask = _targets(5)
    maps = _head_maps(6)
    want = jax_losses.yolov5_loss(
        [jnp.asarray(m, jnp.bfloat16) for m in maps], jnp.asarray(labels),
        jnp.asarray(boxes), jnp.asarray(mask), num_classes=C)
    outs = [torch.from_numpy(m).to(torch.bfloat16).requires_grad_()
            for m in maps]
    got = port_losses.yolov5_loss(outs, torch.from_numpy(labels),
                                  torch.from_numpy(boxes),
                                  torch.from_numpy(mask), num_classes=C)
    for k in want:
        assert got[k].dtype == torch.float32 and want[k].dtype == jnp.float32
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=5e-3,
                                   err_msg=k)
    got["loss"].backward()
    assert all(o.grad.dtype == torch.bfloat16 for o in outs)


@pytest.mark.parametrize("name,error,match", [
    ("RetinaNet", KeyError, "l3_loss"),
    ("SSD", KeyError, "l3_loss"),
    ("YOLOv9", ValueError, "unknown model"),
])
def test_make_loss_other_families_raise(name, error, match):
    """An unknown family raises ValueError; SSD and RetinaNet, ported since,
    raise KeyError on an unknown coord criterion, as the JAX factory does."""
    coord = "l3_loss" if error is KeyError else "smooth_l1_loss"
    with pytest.raises(error, match=match):
        port_losses.make_loss(name, C, IMG, coord_criterion=coord)


def test_make_loss_takes_the_trainer_keywords():
    """C2: the JAX Trainer's call (``train/loop.py:56-60``): every family
    gets ``coord_criterion``, ``cls_criterion`` and ``v3_double_stride``;
    YOLOv5 ignores the last, and an unknown criterion raises KeyError."""
    labels, boxes, mask = _targets(7)
    maps = _head_maps(8)
    kw = dict(coord_criterion="smooth_l1_loss", cls_criterion="bce_loss",
              v3_double_stride=False)
    want = jax_losses.make_loss("YOLOv5", C, IMG, **kw)(
        [jnp.asarray(m) for m in maps], jnp.asarray(labels),
        jnp.asarray(boxes), jnp.asarray(mask))
    got = port_losses.make_loss("YOLOv5", C, IMG, **kw)(
        [torch.from_numpy(m) for m in maps], torch.from_numpy(labels),
        torch.from_numpy(boxes), torch.from_numpy(mask))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]),
                                   err_msg=k, **LOSS_TOL)
    for make in (jax_losses.make_loss, port_losses.make_loss):
        with pytest.raises(KeyError, match="l3_loss"):
            make("YOLOv5", C, IMG, coord_criterion="l3_loss")


@pytest.mark.parametrize("name", ["mse_loss", "smooth_l1_loss"])
def test_coord_criteria_match_jax(name):
    rng = np.random.RandomState(9)
    x, t = (rng.randn(64).astype(np.float32) * 2 for _ in range(2))
    np.testing.assert_allclose(
        port_losses.COORD_CRITERIA[name](torch.from_numpy(x),
                                         torch.from_numpy(t)).numpy(),
        np.asarray(jax_losses.COORD_CRITERIA[name](jnp.asarray(x),
                                                   jnp.asarray(t))), **TIGHT)
