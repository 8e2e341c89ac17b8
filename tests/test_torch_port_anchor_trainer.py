"""The port's ``Trainer.test`` and CLI for the anchor families against the
JAX package.

- ``Trainer.test`` for RetinaNet at 128 px against a JAX ``Trainer`` on
  the same bridged weights (``strict=True``; two Synthetic test batches of
  2): what each hands to ``batch_statistics`` (ranked by ``scores``:
  ``valid`` and labels equal, boxes within ``rtol=1e-4, atol=1e-3``
  pixels, scores within ``rtol=1e-6``), the statistics it returns and the
  mAP table (``rtol=1e-6``).  The weights are those of
  ``test_torch_port_anchor_serving.py``'s model path (class convs with a
  zero kernel: scores equal on both sides), with its IoU precondition
  asserted on every test batch.  Both comparisons wait for the JAX
  package's native library (``test_torch_port_data.jax_library``).
- ``cli.run`` on ``configs/config.yaml`` with ``--set model_name
  RetinaNet --device cpu`` for one epoch at the YAML's ``yaml_test`` caps
  (128 px, B=2, 4 train batches): a finite mAP table, no per-grid YOLO
  statistics, one checkpoint.  SSD's fit runs on the card only
  (``chip_smoke.py`` ``trainer_ssd``): it is shape-locked to 300 px, too
  slow for tier-1 on the CPU.
"""

import math
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from objectdetectionpl_tpu.config import Config as JaxConfig
from objectdetectionpl_tpu.ops import metrics as jax_metrics
from objectdetectionpl_tpu.train import loop as jax_loop
from objectdetectionpl_tpu.train import state as jax_state
from objectdetectionpl_tpu_torch.cli import run as cli_run
from objectdetectionpl_tpu_torch.config import Config
from objectdetectionpl_tpu_torch.ops import metrics
from objectdetectionpl_tpu_torch.train import loop
from objectdetectionpl_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_port_anchor_serving import (MODEL_BOX_TOL, RETINA_IMG,
                                            _assert_no_iou_at,
                                            _serving_variables)
from test_torch_port_data import jax_library  # noqa: F401  (a fixture)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "config.yaml")


def _recording(fn, calls):
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(([np.asarray(a) for a in args], out))
        return out
    return wrapper


def _create_train_state_jit_init(model, tx, rng, img_size, batch_size=1,
                                 dtype=jnp.float32, ema_decay=0.0):
    """JAX's ``create_train_state`` with the model's init compiled: run
    eagerly, the init of ResNet-50-FPN takes ~30 s on the CPU."""
    init_rng, state_rng = jax.random.split(rng)
    x = jnp.zeros((batch_size, img_size, img_size, 3), dtype)
    variables = jax.jit(lambda r, i: model.init(r, i, train=False))(
        init_rng, x)
    params = variables["params"]
    return jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=variables["batch_stats"], opt_state=tx.init(params),
        rng=state_rng, ema_params=None)


def test_trainer_test_retinanet_equals_jax(tmp_path, monkeypatch,
                                           jax_library):
    monkeypatch.setattr(jax_loop.summary_lib, "save_summary",
                        lambda *a, **k: None)
    monkeypatch.setattr(jax_loop.state_lib, "create_train_state",
                        _create_train_state_jit_init)
    kw = dict(data_module="Synthetic", synthetic_size=8, batch_size=2,
              img_size=RETINA_IMG, model_name="RetinaNet", mesh_shape=(1, 1),
              max_boxes=8, conf_thres=0.3)
    jt = jax_loop.Trainer(JaxConfig(log_dir=str(tmp_path / "jax"), **kw))
    pt = loop.Trainer(Config(log_dir=str(tmp_path / "port"), **kw),
                      device="cpu")
    images = np.concatenate([b.images for b in jt.dm.test_dataloader()])
    _, params, stats = _serving_variables("RetinaNet", {}, images[:2],
                                          seed=9)
    jt.state = jt.state.replace(params=params, batch_stats=stats)
    apply = jax.jit(lambda v, i: jt.model.apply(v, i, train=False))
    for b in jt.dm.test_dataloader():
        _assert_no_iou_at("RetinaNet", apply(
            {"params": params, "batch_stats": stats},
            jnp.asarray(b.images)), RETINA_IMG)
    pt.model.load_state_dict(state_dict_from_flax(params, stats),
                             strict=True)

    def no_augment(*args, **kwargs):
        raise AssertionError("the test path augmented")

    monkeypatch.setattr(loop, "augment_batch", no_augment)
    got_calls, want_calls = [], []
    monkeypatch.setattr(jax_metrics, "batch_statistics",
                        _recording(jax_metrics.batch_statistics, want_calls))
    monkeypatch.setattr(metrics, "batch_statistics",
                        _recording(metrics.batch_statistics, got_calls))
    want = jt.test()
    got = pt.test()

    assert len(got_calls) == len(want_calls) == 2
    for (g_in, g_out), (w_in, w_out) in zip(got_calls, want_calls):
        boxes, conf, labels, valid = g_in[:4]
        np.testing.assert_array_equal(valid, w_in[3])
        assert valid.any(axis=1).all()
        np.testing.assert_array_equal(labels[valid], w_in[2][valid])
        np.testing.assert_allclose(boxes[valid], w_in[0][valid],
                                   **MODEL_BOX_TOL)
        np.testing.assert_allclose(conf, w_in[1], rtol=1e-6)   # scores
        for g, w in zip(g_in[4:], w_in[4:]):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g_out[0], w_out[0])           # tp
        np.testing.assert_allclose(g_out[1], w_out[1], rtol=1e-6)
        np.testing.assert_array_equal(g_out[2], w_out[2])
    assert got.keys() == want.keys() and "4/cls_acc" not in got
    for k in ("mAP", "precision", "recall", "f1"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    for c, ap in want["per_class_AP"].items():
        np.testing.assert_allclose(got["per_class_AP"][c], ap, rtol=1e-6)


def test_cli_fits_retinanet(tmp_path, capsys):
    results = cli_run.main([YAML, "--set", "model_name", "RetinaNet",
                            "--device", "cpu", "--set", "log_dir",
                            str(tmp_path), "--set", "max_epochs", "1"])
    out = capsys.readouterr().out
    assert "[run] model=RetinaNet dataset=Synthetic img_size=128" in out
    assert "---- mAP per class ----" in out
    assert "YOLO statistics" not in out
    for k in ("mAP", "precision", "recall", "f1"):
        assert math.isfinite(results[k]) and 0.0 <= results[k] <= 1.0, k
    run_dir = tmp_path / "Synthetic" / "RetinaNet"
    assert sorted(p.name for p in (run_dir / "checkpoints").iterdir()) == [
        "0", "best_model_path.txt"]
