"""The port's serving export (``utils/export.py``), the NMS op it captures
(``objdet::greedy_nms``) and ``cli.predict --export``, on the CPU.

- The round trip of ``tests/test_export.py``: YOLOv2 at 96 px, 3 classes,
  top_k 16; the loaded ``.pt2`` program equals the module bit for bit, and
  the file holds no example input.
- The port's loaded program against JAX's ``build_inference_fn`` through
  JAX's own save and load, on weights carried over by
  ``utils/weights.py``, B=2: YOLOv2 at 96 px (the /255 divided) and
  YOLOv5s at 64 px (the /255 folded into the stem).  ``valid`` and
  ``labels`` equal, boxes within ``rtol=1e-5, atol=1e-4``, scores and obj
  within ``rtol=1e-5, atol=1e-6``.  Preconditions, asserted on JAX's
  decoded rows: no obj within 1e-4 of ``conf_thres``, passing scores more
  than 1e-5 of their value apart (so the orders cannot differ), and every
  image keeps a detection; weights drawn as
  ``test_torch_port_yolo_serving.py`` and ``test_torch_port_serving.py``
  draw them (YOLOv5: 20 rows an image pass, so that no two scores tie).
- Each of the six families exports and round-trips, and its eager chain
  stays real after the export: ``tests/test_torch_port_export_families.py``.
- The fold rule: auto folds YOLOv5 only, ``fold_preproc=True`` on another
  family raises ``KeyError``; the given model is left as it was.
- ``cli.predict --export`` on a checkpoint with an EMA: the program serves
  the EMA weights, not the live ones; with no ``--images`` it returns.
- A fresh interpreter that imports only ``utils.export`` loads and runs
  the program, equal, without importing the model code.
- ``torch.library.opcheck`` on ``objdet::greedy_nms``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from objectdetectionpl_tpu.models import registry as jax_registry
from objectdetectionpl_tpu.ops import anchors as jax_anchors
from objectdetectionpl_tpu.ops import nms as jax_nms
from objectdetectionpl_tpu.train.step import make_postprocess as jax_post
from objectdetectionpl_tpu.utils import export as jax_export
from objectdetectionpl_tpu_torch.cli import predict
from objectdetectionpl_tpu_torch.config import load_config
from objectdetectionpl_tpu_torch.models import MODELS, build_model
from objectdetectionpl_tpu_torch.train import loop
from objectdetectionpl_tpu_torch.train.step import make_postprocess
from objectdetectionpl_tpu_torch.utils import export as export_lib
from objectdetectionpl_tpu_torch.utils.fuse import fold_input_scale
from objectdetectionpl_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_port_blocks import randomized_variables
from test_torch_port_yolo_models import drawn_variables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "config.yaml")
C = 3
CONF = 0.5
STEM = export_lib.STEM_KEY


def _raw(B, S, seed=0):
    return torch.randint(0, 256, (B, S, S, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(seed))


def _equal(got, want):
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert type(g) is torch.Tensor and torch.equal(g, w)


def test_export_roundtrip(tmp_path):
    S = 96
    model = build_model("YOLOv2", C, device="cpu", seed=0)
    fn = export_lib.build_inference_fn(
        model, model.state_dict(), make_postprocess("YOLOv2", C, S,
                                                    top_k=16))
    raw = _raw(1, S)
    direct = fn(raw)
    path = str(tmp_path / "m.pt2")
    export_lib.save(path, fn, batch=1, img_size=S)
    _equal(export_lib.load(path, "cpu")(raw), direct)
    assert direct[0].shape == (1, 16, 4) and direct[4].dtype == torch.bool
    assert torch.export.load(path).example_inputs is None


def _jax_case(name):
    """(S, JAX model, params, stats, JAX decode of a map list)."""
    jm = jax_registry.build_model(name, C)
    rng = np.random.RandomState(3)
    if name == "YOLOv2":
        S = 96
        params, stats = drawn_variables(jm, np.zeros((1, S, S, 3)), seed=3)
        params["Conv_0"]["kernel"] = params["Conv_0"]["kernel"] * 4.0
        decode = lambda out: jax_nms.decode_yolo_predictions(
            [out], [jax_anchors.YOLOV2_ANCHORS * 32], (32,), C, S)
    else:
        S = 64
        params, stats = randomized_variables(
            jm, np.zeros((1, S, S, 3), np.float32), seed=1, jit=True)
        for head in ("Conv_0", "Conv_1", "Conv_2"):
            bias = rng.normal(0.0, 1.0, (3, 5 + C)).astype(np.float32)
            # obj logits: the first anchor of the two coarse maps passes,
            # 20 rows an image, whose scores stay apart
            bias[:, 4] = [3.0 * (head != "Conv_2") - 3.0 * (head == "Conv_2"),
                          -3.0, -3.0]
            params[head]["bias"] = bias.reshape(-1)
        decode = lambda out: jax_nms.decode_yolov5_predictions(
            out, jax_anchors.YOLOV5_ANCHORS, jax_anchors.YOLOV5_STRIDES, C)
    return S, jm, params, stats, decode


@pytest.mark.parametrize("name", ["YOLOv2", "YOLOv5"])
def test_loaded_program_equals_jax_export(tmp_path, name):
    S, jm, params, stats, decode = _jax_case(name)
    variables = {"params": params, "batch_stats": stats}
    raw = np.random.RandomState(5).randint(0, 256, (2, S, S, 3)).astype(
        np.uint8)
    dec = np.asarray(decode(jm.apply(variables, jnp.asarray(raw / 255.0,
                                                            jnp.float32),
                                     train=False)))
    obj = dec[..., 4]
    assert np.abs(obj - CONF).min() > 1e-4                # preconditions
    score = np.where(obj >= CONF, obj * dec[..., 5:].max(-1), 0.0)
    for s in score:
        s = np.sort(s[s > 0])
        assert s.size and (np.diff(s) / s[1:]).min() > 1e-5

    jfn = jax_export.build_inference_fn(
        jm, variables, jax_post(name, C, S, conf_thres=CONF))
    jax_export.save(str(tmp_path / "m.shlo"), jfn, batch=2, img_size=S)
    want = jax_export.load(str(tmp_path / "m.shlo"))(jnp.asarray(raw))

    port = MODELS[name](num_classes=C).eval()
    fn = export_lib.build_inference_fn(
        port, state_dict_from_flax(params, stats),
        make_postprocess(name, C, S, conf_thres=CONF))
    assert fn.fold == (name == "YOLOv5")
    path = str(tmp_path / "m.pt2")
    export_lib.save(path, fn, batch=2, img_size=S)
    got = export_lib.load(path, "cpu")(torch.from_numpy(raw))

    boxes, obj, scores, labels, valid = (np.asarray(w) for w in want)
    assert 0 < valid.sum(axis=1).min()
    np.testing.assert_array_equal(got[4].numpy(), valid)
    np.testing.assert_array_equal(got[3].numpy(), labels)
    np.testing.assert_allclose(got[0].numpy()[valid], boxes[valid],
                               rtol=1e-5, atol=1e-4)
    for g, w in ((got[1], obj), (got[2], scores)):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-6)


def test_fold_rule():
    model = build_model("YOLOv5", C, device="cpu", seed=0)
    sd = model.state_dict()
    before = sd[STEM].clone()
    post = make_postprocess("YOLOv5", C, 64)
    auto = export_lib.build_inference_fn(model, sd, post)
    assert auto.fold
    assert torch.equal(auto.model.state_dict()[STEM],
                       fold_input_scale(sd, 1.0 / 255.0)[STEM])
    assert torch.equal(model.state_dict()[STEM], before)
    assert auto.model is not model and not auto.model.training
    divide = export_lib.build_inference_fn(model, sd, post,
                                           fold_preproc=False)
    assert not divide.fold and torch.equal(divide.model.state_dict()[STEM],
                                           before)
    raw = _raw(2, 64)
    a, d = auto(raw), divide(raw)
    torch.testing.assert_close(a[2], d[2], rtol=1e-4, atol=1e-5)

    v2 = build_model("YOLOv2", C, device="cpu", seed=0)
    post2 = make_postprocess("YOLOv2", C, 64)
    assert not export_lib.build_inference_fn(v2, v2.state_dict(),
                                             post2).fold
    with pytest.raises(KeyError, match="stem"):
        export_lib.build_inference_fn(v2, v2.state_dict(), post2,
                                      fold_preproc=True)


def test_cli_export_serves_the_ema_weights(tmp_path, capsys):
    S = 64
    over = {"model_name": "YOLOv5", "img_size": S, "ema_decay": 0.999,
            "conf_thres": 0.3, "log_dir": str(tmp_path / "logs")}
    trainer = loop.Trainer(load_config(YAML, over), device="cpu")
    with torch.no_grad():                    # EMA and live weights differ
        for name, p in trainer.model.named_parameters():
            trainer.state.ema_params[name].copy_(p * 1.1)
    trainer.ckpt.save(0, trainer.state, 1.0)
    trainer.ckpt.wait()
    sd = trainer.model.state_dict()
    ema = export_lib.build_inference_fn(
        trainer.model, {**sd, **trainer.state.ema_params},
        trainer.postprocess)
    live = export_lib.build_inference_fn(trainer.model, sd,
                                         trainer.postprocess)
    trainer.ckpt.close()
    trainer.writer.close()
    capsys.readouterr()

    path = str(tmp_path / "m.pt2")
    sets = [a for k, v in over.items() for a in ("--set", k, str(v))]
    assert predict.main([YAML, *sets, "--device", "cpu",
                         "--export", path]) == []
    out = capsys.readouterr().out
    assert "restored best checkpoint" in out
    assert out.strip().splitlines()[-1] == (
        f"[predict] exported serving graph to {path}")
    raw = _raw(1, S, seed=2)
    got = export_lib.load(path, "cpu")(raw)
    _equal(got, ema(raw))
    assert int(got[4].sum()) > 0
    assert not torch.equal(got[0], live(raw)[0])


_LOAD_PROBE = r"""
import json, sys
import torch
from objectdetectionpl_tpu_torch.utils import export
torch.set_num_threads(2)
program, raw_path, out_path = sys.argv[1:]
torch.save(export.load(program, "cpu")(torch.load(raw_path)), out_path)
print(json.dumps(sorted(k for k in sys.modules
                        if k.startswith("objectdetectionpl_tpu"))))
"""


def test_fresh_interpreter_loads_without_the_model_code(tmp_path):
    S = 64
    model = build_model("YOLOv5", C, device="cpu", seed=1)
    fn = export_lib.build_inference_fn(model, model.state_dict(),
                                       make_postprocess("YOLOv5", C, S))
    raw = _raw(1, S, seed=3)
    paths = {k: str(tmp_path / k) for k in ("m.pt2", "raw.pt", "out.pt")}
    export_lib.save(paths["m.pt2"], fn, batch=1, img_size=S)
    torch.save(raw, paths["raw.pt"])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _LOAD_PROBE, *paths.values()],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert "objectdetectionpl_tpu_torch.utils.export" in modules
    assert not [m for m in modules
                if m.startswith("objectdetectionpl_tpu_torch.models")
                or m == "objectdetectionpl_tpu"
                or m.startswith("objectdetectionpl_tpu.")]
    _equal(torch.load(paths["out.pt"]), fn(raw))


def _candidates(seed, B=2, K=24):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 50, (B, K, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (B, K, 2))], -1)
    scores = -np.sort(-rng.uniform(0, 1, (B, K)), axis=1)
    scores[:, -3:] = -1e9                       # invalid rows
    labels = rng.randint(0, 3, (B, K))
    obj = rng.uniform(0.2, 1, (B, K))
    return (torch.tensor(boxes, dtype=torch.float32),
            torch.tensor(scores, dtype=torch.float32),
            torch.tensor(labels, dtype=torch.int32),
            torch.tensor(obj, dtype=torch.float32))


@pytest.mark.parametrize("class_aware,merge,drop", [
    (True, True, False), (False, False, False), (False, False, True)])
def test_greedy_nms_opcheck(class_aware, merge, drop):
    args = _candidates(seed=int(class_aware) + 2 * int(drop))
    torch.library.opcheck(torch.ops.objdet.greedy_nms.default,
                          (*args, 0.4, class_aware, merge, 1.0, drop))
