"""The port's serving slice as a whole against the JAX chain.

JAX: ``model.apply(..., train=False)`` + ``make_postprocess("YOLOv5", C,
128)``.  Port: ``make_predict_step(model, make_postprocess(...))``.  Both
run YOLOv5s in f32 on the CPU at 128 px, B=2, on the same flax variables
(BN drawn at random); 1008 rows per image, of which ~670 pass conf_thres,
so the top-k cut to 300 is exercised.  The uint8 variant feeds raw pixels
with the /255 folded into the stem conv on both sides.

The EMA case (C1 of ROADMAP §C) bridges a second, distinct parameter set,
the JAX ``ema_params`` = params x 1.1, into the port's ``TrainState``; both
``predict_step(state, images)`` must detect with it, not with the live
parameters.  Precondition there, asserted: the 300th and 301st scores
differ by more than 1e-4 of their value, so the top-k cut cannot move
(at x 0.9 they differ by 5e-6, below the forward's differences).

``valid`` and ``labels`` must be equal.  Boxes agree within ``rtol=1e-4,
atol=1e-3`` (merged pixel coordinates), scores and obj within ``rtol=1e-4,
atol=1e-6`` (the forward differs by ~1e-5 relative between XLA and torch).

Precondition, asserted: no row's obj lies within 1e-4 of conf_thres.  The
head biases put obj logits at +-3 per anchor so that the forward's f32
differences cannot move a row across the threshold.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from objectdetectionpl_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from objectdetectionpl_tpu.ops import anchors as jax_anchors
from objectdetectionpl_tpu.ops import nms as jax_nms
from objectdetectionpl_tpu.train.state import TrainState as JaxTrainState
from objectdetectionpl_tpu.train.step import make_postprocess as jax_post
from objectdetectionpl_tpu.train.step import \
    make_predict_step as jax_predict_step
from objectdetectionpl_tpu.utils.fuse import fold_input_scale as jax_fold
from objectdetectionpl_tpu_torch.models import MODELS, build_model
from objectdetectionpl_tpu_torch.ops.cuda import nms_kernel
from objectdetectionpl_tpu_torch.train.state import create_train_state
from objectdetectionpl_tpu_torch.train.step import (make_postprocess,
                                                    make_predict_step)
from objectdetectionpl_tpu_torch.utils.fuse import fold_input_scale
from objectdetectionpl_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_port_blocks import randomized_variables

torch.set_num_threads(2)

C = 3
IMG = 128
CONF = 0.5


@pytest.fixture(scope="module")
def variables():
    model = JaxYOLOv5(num_classes=C)
    x = np.zeros((2, IMG, IMG, 3), np.float32)
    params, stats = randomized_variables(model, x, seed=1, jit=True)
    rng = np.random.RandomState(1)
    for head in ("Conv_0", "Conv_1", "Conv_2"):
        bias = rng.normal(0.0, 1.0, (3, 5 + C)).astype(np.float32)
        bias[:, 4] = [3.0, 3.0, -3.0]          # obj logit per anchor
        params[head]["bias"] = bias.reshape(-1)
    return model, params, stats


def _images(uint8):
    rng = np.random.RandomState(2)
    raw = rng.randint(0, 256, (2, IMG, IMG, 3)).astype(np.uint8)
    return raw if uint8 else (raw / 255.0).astype(np.float32)


@pytest.mark.parametrize("uint8", [False, True], ids=["f32", "uint8_folded"])
def test_predict_step_matches_jax_chain(variables, uint8):
    model, params, stats = variables
    images = _images(uint8)
    jparams = jax_fold(params, 1.0 / 255.0) if uint8 else params
    out = jax.jit(lambda v, i: model.apply(v, i, train=False))(
        {"params": jparams, "batch_stats": stats}, jnp.asarray(images))
    dec = jax_nms.decode_yolov5_predictions(
        out, jax_anchors.YOLOV5_ANCHORS, jax_anchors.YOLOV5_STRIDES, C)
    obj = np.asarray(dec)[..., 4]
    assert np.abs(obj - CONF).min() > 1e-4           # precondition
    assert ((obj >= CONF).sum(axis=1) > 300).all()   # top-k cut exercised
    want = jax_post("YOLOv5", C, IMG, conf_thres=CONF)(out)

    port = build_model("YOLOv5", C, device="cpu")
    sd = state_dict_from_flax(params, stats)
    port.load_state_dict(fold_input_scale(sd, 1.0 / 255.0) if uint8 else sd,
                         strict=True)
    step = make_predict_step(port, make_postprocess("YOLOv5", C, IMG,
                                                    conf_thres=CONF))
    got = step(create_train_state(port), torch.from_numpy(images))
    _assert_same_detections(got, want)


def _assert_same_detections(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert got.valid.shape == (2, 300) and 0 < int(got.valid.sum()) < 600
    v = np.asarray(want.valid)
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(want.boxes)[v],
                               rtol=1e-4, atol=1e-3)
    for name in ("scores", "obj"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-4, atol=1e-6)


def test_predict_step_runs_the_nms_wrapper_once_per_batch(monkeypatch):
    model = build_model("YOLOv5", C, device="cpu")
    step = make_predict_step(model, make_postprocess("YOLOv5", C, 64))
    calls = []
    real = nms_kernel.greedy_nms

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(nms_kernel, "greedy_nms", counting)
    res = step(create_train_state(model),
               torch.zeros(3, 64, 64, 3, dtype=torch.uint8))
    assert calls == [torch.Size([3, 252, 4])]        # top_k capped at N
    assert res.boxes.shape == (3, 252, 4) and res.boxes.dtype == torch.float32
    assert res.labels.dtype == torch.int32 and res.valid.dtype == torch.bool


def test_predict_step_bf16_keeps_f32_nms():
    model = build_model("YOLOv5", C, dtype=torch.bfloat16, device="cpu")
    conv = model.Focus_0.ConvBN_0.Conv_0
    bn = model.Focus_0.ConvBN_0.BatchNorm_0
    assert conv.weight.dtype == bn.running_var.dtype == torch.float32
    heads = model(torch.zeros(1, 64, 64, 3, dtype=torch.uint8))
    assert all(h.dtype == torch.bfloat16 for h in heads)
    res = make_predict_step(model, make_postprocess("YOLOv5", C, 64))(
        create_train_state(model), torch.zeros(1, 64, 64, 3,
                                               dtype=torch.uint8))
    assert res.boxes.dtype == torch.float32 and res.obj.dtype == torch.bfloat16
    assert torch.isfinite(res.boxes).all()


def test_predict_step_refuses_train_mode():
    model = build_model("YOLOv5", C, device="cpu").train()
    step = make_predict_step(model, make_postprocess("YOLOv5", C, 64))
    with pytest.raises(RuntimeError, match="eval mode"):
        step(create_train_state(model), torch.zeros(1, 64, 64, 3))
    # the model itself runs in train mode (batch statistics), and its
    # running statistics move
    stat = model.Focus_0.ConvBN_0.BatchNorm_0.running_var
    before = stat.clone()
    heads = model(torch.rand(2, 64, 64, 3,
                             generator=torch.Generator().manual_seed(0)))
    assert [tuple(h.shape) for h in heads] == [
        (2, 3, 8, 8, 5 + C), (2, 3, 4, 4, 5 + C), (2, 3, 2, 2, 5 + C)]
    assert not torch.equal(stat, before)


def test_predict_step_serves_the_ema_params(variables):
    model, params, stats = variables
    images = _images(False)
    ema = jax.tree.map(lambda p: p * np.float32(1.1), params)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=stats, opt_state=None, rng=None,
                           ema_params=ema)
    post = jax_post("YOLOv5", C, IMG, conf_thres=CONF)
    want = jax_predict_step(model, post)(jstate, jnp.asarray(images))
    out = model.apply({"params": ema, "batch_stats": stats},
                      jnp.asarray(images), train=False)
    dec = np.asarray(jax_nms.decode_yolov5_predictions(
        out, jax_anchors.YOLOV5_ANCHORS, jax_anchors.YOLOV5_STRIDES, C))
    obj = dec[..., 4]
    assert np.abs(obj - CONF).min() > 1e-4           # preconditions
    score = np.sort(np.where(obj >= CONF, obj * dec[..., 5:].max(-1), 0))
    assert ((score[:, -300] - score[:, -301]) > 1e-4 * score[:, -300]).all()

    port = build_model("YOLOv5", C, device="cpu")
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    state = create_train_state(port, ema_decay=0.999)
    names = dict(port.named_parameters())
    state.ema_params = {k: v for k, v in
                        state_dict_from_flax(ema, stats).items()
                        if k in names}
    assert state.ema_params.keys() == names.keys()
    step = make_predict_step(port, make_postprocess("YOLOv5", C, IMG,
                                                    conf_thres=CONF))
    got = step(state, torch.from_numpy(images))
    _assert_same_detections(got, want)
    # the live parameters detect otherwise, and stay the module's own
    live = step(create_train_state(port), torch.from_numpy(images))
    assert not torch.equal(live.boxes, got.boxes)
    assert all(p is names[n] for n, p in port.named_parameters())


@pytest.mark.parametrize("name", ["SSD", "RetinaNet"])
def test_unported_families_raise(name):
    """SSD and RetinaNet build and postprocess (ported since), and accept
    ``remat`` and ignore it, as in JAX: the same weights, the same tree."""
    plain = build_model(name, C, device="cpu")
    assert isinstance(plain, MODELS[name])
    remat = build_model(name, C, device="cpu", remat="all")
    assert remat.state_dict().keys() == plain.state_dict().keys()
    for k, v in remat.state_dict().items():
        assert torch.equal(v, plain.state_dict()[k]), k
    assert callable(make_postprocess(name, C, 416))
