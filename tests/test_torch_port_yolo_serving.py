"""YOLOv2/v3/v4 serving in the port against the JAX chain: the decode
(``ops/nms.py::decode_yolo_predictions``), ``make_postprocess`` and
``make_predict_step`` on bridged weights.  The NMS runs its plain version
(CPU tensors) on the port's side and the blocked matrix NMS on JAX's.

- Decode, f32 seeded maps: ``rtol=1e-6, atol=1e-4`` (pixel coordinates up
  to ~1e3, exp and sigmoid may round differently); bf16 maps: the port
  decodes in bf16 as JAX does, within one bf16 ulp (``rtol=8e-3``).
- ``make_postprocess`` on the same seeded maps: ``valid`` and labels
  equal, boxes within ``rtol=1e-5, atol=1e-4``, scores and obj within
  ``rtol=1e-5, atol=1e-7``.
- ``make_predict_step`` at 64 px, B=2, on weights drawn as in
  ``test_torch_port_yolo_models`` with the head biases set so obj is
  +-3 logits per anchor: ``valid`` and labels equal, boxes within
  ``rtol=1e-4, atol=1e-3``, scores and obj within ``rtol=1e-4,
  atol=1e-6`` (the forwards differ by ~1e-6 relative).  Preconditions,
  asserted: no obj within 1e-4 of ``conf_thres`` and every image keeps a
  detection.  At 64 px an image has 20 (v2) or 252 (v3, v4) rows, fewer
  than ``top_k``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from objectdetectionpl_tpu.models import registry as jax_registry
from objectdetectionpl_tpu.ops import anchors as jax_anchors
from objectdetectionpl_tpu.ops import nms as jax_nms
from objectdetectionpl_tpu.train.step import make_postprocess as jax_post
from objectdetectionpl_tpu.utils.fuse import fold_input_scale as jax_fold
from objectdetectionpl_tpu_torch.models import MODELS
from objectdetectionpl_tpu_torch.ops import nms
from objectdetectionpl_tpu_torch.ops.cuda import nms_kernel
from objectdetectionpl_tpu_torch.train.state import create_train_state
from objectdetectionpl_tpu_torch.train.step import (make_postprocess,
                                                    make_predict_step)
from objectdetectionpl_tpu_torch.utils.fuse import (STEM_CONVS,
                                                    fold_input_scale)
from objectdetectionpl_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_port_yolo_models import drawn_variables

torch.set_num_threads(2)

C = 3
CONF = 0.5
FAMILIES = ["YOLOv2", "YOLOv3", "YOLOv4"]
STRIDES = {"YOLOv2": (32,), "YOLOv3": jax_anchors.YOLOV3_STRIDES,
           "YOLOv4": jax_anchors.YOLOV4_STRIDES}


def _maps(name, img, seed, B=2):
    A = 5 if name == "YOLOv2" else 3
    rng = np.random.RandomState(seed)
    return [rng.randn(B, A * (5 + C), img // s, img // s).astype(np.float32)
            for s in STRIDES[name]]


def _anchors_px(name):
    if name == "YOLOv2":
        return [jax_anchors.YOLOV2_ANCHORS * 32]
    if name == "YOLOv3":
        return jax_anchors.YOLOV3_ANCHORS
    return [jax_anchors.YOLOV4_ANCHORS[list(m)]
            for m in jax_anchors.YOLOV4_ANCH_MASKS]


def _assert_same_detections(got, want, box_tol, score_tol):
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert valid.any(axis=1).all()                # detections on every image
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], **box_tol)
    for name in ("scores", "obj"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   **score_tol)


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_yolo_predictions_equals_jax(name):
    maps = _maps(name, 128, seed=1)
    anc, strides = _anchors_px(name), STRIDES[name]
    want = jax.jit(lambda ms: jax_nms.decode_yolo_predictions(
        ms, anc, strides, C, 128))([jnp.asarray(m) for m in maps])
    got = nms.decode_yolo_predictions([torch.from_numpy(m) for m in maps],
                                      anc, strides, C)
    assert got.shape == want.shape == (2, sum(
        m.shape[1] // (5 + C) * m.shape[2] ** 2 for m in maps), 5 + C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-4)
    # bf16: decoded in bf16 on both sides
    want = jax_nms.decode_yolo_predictions(
        [jnp.asarray(m, jnp.bfloat16) for m in maps], anc, strides, C, 128)
    got = nms.decode_yolo_predictions(
        [torch.from_numpy(m).to(torch.bfloat16) for m in maps], anc, strides,
        C)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=8e-3,
                               atol=1e-2)


@pytest.mark.parametrize("name", FAMILIES)
def test_make_postprocess_equals_jax(name):
    maps = _maps(name, 128, seed=2)
    want = jax.jit(jax_post(name, C, 128, conf_thres=CONF))(
        [jnp.asarray(m) for m in maps])
    post = make_postprocess(name, C, 128, conf_thres=CONF)
    got = post([torch.from_numpy(m) for m in maps])
    assert got.valid.shape == (2, 300 if name != "YOLOv2" else 80)
    _assert_same_detections(got, want, dict(rtol=1e-5, atol=1e-4),
                            dict(rtol=1e-5, atol=1e-7))
    if name == "YOLOv2":                         # a bare map, as served
        again = post(torch.from_numpy(maps[0]))
        assert torch.equal(again.boxes, got.boxes)


@pytest.fixture(scope="module", params=FAMILIES)
def served(request):
    """(name, JAX model, params with the head biases set, stats)."""
    name = request.param
    jm = jax_registry.build_model(name, C)
    params, stats = drawn_variables(jm, np.zeros((1, 64, 64, 3)), seed=3)
    rng = np.random.RandomState(3)
    A = 5 if name == "YOLOv2" else 3
    heads = ([params["Conv_0"]] if name == "YOLOv2" else
             [params[f"_DetectSeq_{i}"]["Conv_0"] for i in range(3)]
             if name == "YOLOv3" else [params[f"Conv_{i}"] for i in range(3)])
    for head in heads:
        bias = rng.normal(0.0, 1.0, (A, 5 + C)).astype(np.float32)
        bias[:, 4] = np.where(np.arange(A) % 3 == 2, -3.0, 3.0)
        if name == "YOLOv2":          # its head has no bias: spread instead
            head["kernel"] = head["kernel"] * np.float32(4.0)
        else:
            head["bias"] = bias.reshape(-1)
    return name, jm, params, stats


@pytest.mark.parametrize("uint8", [False, True], ids=["f32", "uint8_folded"])
def test_predict_step_equals_jax_chain(served, uint8):
    name, jm, params, stats = served
    rng = np.random.RandomState(4)
    raw = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    images = raw if uint8 else (raw / 255.0).astype(np.float32)
    jparams = (jax_fold(params, 1.0 / 255.0,
                        path=tuple(STEM_CONVS[name].split("."))) if uint8
               else params)
    post = jax_post(name, C, 64, conf_thres=CONF)

    @jax.jit
    def chain(v, i):
        out = jm.apply(v, i, train=False)
        outs = out if isinstance(out, (list, tuple)) else [out]
        return jax_nms.decode_yolo_predictions(
            outs, _anchors_px(name), STRIDES[name], C, 64), post(out)

    dec, want = chain({"params": jparams, "batch_stats": stats},
                      jnp.asarray(images))
    assert np.abs(np.asarray(dec)[..., 4] - CONF).min() > 1e-4  # precondition

    port = MODELS[name](num_classes=C).eval()
    sd = state_dict_from_flax(params, stats)
    port.load_state_dict(
        fold_input_scale(sd, 1.0 / 255.0, STEM_CONVS[name]) if uint8 else sd,
        strict=True)
    step = make_predict_step(port, make_postprocess(name, C, 64,
                                                    conf_thres=CONF))
    got = step(create_train_state(port), torch.from_numpy(images))
    _assert_same_detections(got, want, dict(rtol=1e-4, atol=1e-3),
                            dict(rtol=1e-4, atol=1e-6))


def test_predict_step_runs_the_nms_wrapper_once(monkeypatch):
    calls = []
    real = nms_kernel.greedy_nms

    def counting(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return real(*args, **kwargs)

    monkeypatch.setattr(nms_kernel, "greedy_nms", counting)
    for name, rows in (("YOLOv2", 20), ("YOLOv3", 252), ("YOLOv4", 252)):
        model = MODELS[name](num_classes=C).eval()
        for p in model.parameters():
            torch.nn.init.zeros_(p)
        step = make_predict_step(model, make_postprocess(name, C, 64))
        step(create_train_state(model), torch.zeros(2, 64, 64, 3))
        assert calls.pop() == (2, rows, 4) and not calls
