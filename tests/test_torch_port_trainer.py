"""The port's Trainer, checkpoints and CLI (``train/loop.py``,
``train/checkpoint.py``, ``cli/run.py``) against the JAX package.

- ``Trainer.test`` on weights bridged from a JAX ``Trainer`` (YOLOv5s,
  64 px, B=2, two Synthetic test batches, an EMA copy = params x 0.9 that
  both must detect with): the detections handed to ``batch_statistics``
  (``valid`` and labels equal, boxes within ``rtol=1e-4, atol=1e-3``,
  obj within ``rtol=1e-4, atol=1e-6``, as in the serving test), the
  statistics it returns (tp and classes equal, conf as obj) and the mAP,
  precision, recall, f1 and per-class AP (``rtol=1e-6``).  Random init
  leaves obj within 5e-4 of 0.5 on every row, and its scores tie within
  the two forwards' f32 differences, which reorders the NMS.  So the BN
  scales and biases are drawn at random, the BN running statistics are
  the test images' own moments under the EMA weights (a momentum-0
  train-mode forward) with 0.03 added to each variance, and the head
  biases are 0: obj then varies by image and cell (without the 0.03 the
  BN of near-constant channels amplifies f32 rounding until the two
  forwards differ by 2e-4 of the head maps' largest value, with it by
  2e-5).  ``conf_thres`` 0.75 keeps 7-12 candidates per image, none of
  them within 1e-3 of the threshold and their scores at least 3e-4 of
  their value apart (all asserted).  At 64 px an image has 252 rows, fewer than
  ``nms_top_k``, so no top-k cut can differ.
- The same for YOLOv2 at 128 px (80 rows an image; ``conf_thres`` 0.65,
  the same margins asserted), and its per-grid statistics ``4/{key}``
  against the JAX Trainer's within ``STAT_TOL`` (``rtol=1e-4,
  atol=1e-6``).  Both comparisons wait for the JAX package's native
  library (``test_torch_port_data.jax_library``): without it JAX's Loader
  resizes with cv2 or PIL, up to 1/255 off.
- Checkpoints: save -> restore gives identical tensors; top-k retention,
  the best step and ``best_model_path.txt`` follow the JAX (orbax) manager
  on the same val_loss sequence, ties included; ``EarlyStopping`` equals
  JAX's.
- The partial-window flush calls ``train_step`` with weights [1, 0].
- The metric writer without TensorBoard, parameter histograms, the
  summary table and the profiler's trace.
- The CLI on ``configs/config.yaml`` (its ``yaml_test`` caps: 128 px, B=2,
  accumulation 2, 4 train batches, 2 epochs) with ``--device cpu``, then
  an eval-only run that restores the best checkpoint; and on the YAML's
  own model, YOLOv2, for one epoch (its checkpoint is ~0.6 GB).
"""

import json
import math
import os
import re
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from objectdetectionpl_tpu.config import Config as JaxConfig
from objectdetectionpl_tpu.ops import metrics as jax_metrics
from objectdetectionpl_tpu.ops import nms as jax_nms
from objectdetectionpl_tpu.ops import anchors as jax_anchors
from objectdetectionpl_tpu.train import checkpoint as jax_ckpt
from objectdetectionpl_tpu.train import loop as jax_loop
from objectdetectionpl_tpu_torch.cli import run as cli_run
from objectdetectionpl_tpu_torch.config import Config
from objectdetectionpl_tpu_torch.nn.blocks import BatchNorm
from objectdetectionpl_tpu_torch.ops import metrics
from objectdetectionpl_tpu_torch.train import checkpoint, loop
from objectdetectionpl_tpu_torch.train.state import create_train_state
from objectdetectionpl_tpu_torch.utils import profiler, summary
from objectdetectionpl_tpu_torch.utils.logging import (MetricWriter,
                                                       log_param_histograms)
from objectdetectionpl_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_port_data import jax_library  # noqa: F401  (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "config.yaml")
CONF = 0.75
VAR_FLOOR = 0.03
BOX_TOL = dict(rtol=1e-4, atol=1e-3)
OBJ_TOL = dict(rtol=1e-4, atol=1e-6)
STAT_TOL = dict(rtol=1e-4, atol=1e-6)


def _draw_variables(params, seed):
    """Random BN scale and bias, zero head biases; a numpy tree."""
    rng = np.random.RandomState(seed)
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, dict(params)))
    draw = {"scale": lambda n: rng.uniform(0.5, 1.5, n),
            "bias": lambda n: rng.normal(0.0, 0.1, n)}
    for path, v in flat.items():
        if path[-2].startswith("BatchNorm"):
            flat[path] = draw[path[-1]](v.shape).astype(np.float32)
    return traverse_util.unflatten_dict(flat)


def _calibrated_stats(model, stats, images):
    """BN running statistics = the batch moments of ``images`` under the
    port model's weights (momentum 0), the variances raised by VAR_FLOOR,
    as a flax ``batch_stats`` tree."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.MOMENTUM = 0.0
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(images))
    model.eval()
    for m in model.modules():
        if isinstance(m, BatchNorm):
            del m.MOMENTUM
    sd = model.state_dict()
    leaf = {"mean": "running_mean", "var": "running_var"}
    flat = traverse_util.flatten_dict(jax.tree.map(np.asarray, dict(stats)))
    return traverse_util.unflatten_dict({
        path: sd[".".join(path[:-1] + (leaf[path[-1]],))].numpy()
        + np.float32(VAR_FLOOR if path[-1] == "var" else 0.0)
        for path in flat})


def _recording(fn, calls):
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(([np.asarray(a) for a in args], out))
        return out
    return wrapper


def _decode(model_name, out):
    """JAX's decoded rows [B, N, 5+C] of a model's head maps (C=3)."""
    if model_name == "YOLOv5":
        return jax_nms.decode_yolov5_predictions(
            out, jax_anchors.YOLOV5_ANCHORS, jax_anchors.YOLOV5_STRIDES, 3)
    return jax_nms.decode_yolo_predictions(
        [out], [jax_anchors.YOLOV2_ANCHORS * 32], (32,), 3, 0)


def _test_both(tmp_path, monkeypatch, model_name, img_size, conf):
    """``Trainer.test`` of the JAX package and of the port on bridged
    weights (EMA = params x 0.9); returns (got, want) after comparing what
    each handed to ``batch_statistics``."""
    # the JAX summary inits the model a second time to tabulate it
    monkeypatch.setattr(jax_loop.summary_lib, "save_summary",
                        lambda *a, **k: None)
    kw = dict(data_module="Synthetic", synthetic_size=8, batch_size=2,
              img_size=img_size, model_name=model_name, mesh_shape=(1, 1),
              ema_decay=0.9, max_boxes=8, conf_thres=conf)
    jt = jax_loop.Trainer(JaxConfig(log_dir=str(tmp_path / "jax"), **kw))
    pt = loop.Trainer(Config(log_dir=str(tmp_path / "port"), **kw),
                      device="cpu")
    params = _draw_variables(jt.state.params, seed=5)
    ema = jax.tree.map(lambda p: p * np.float32(0.9), params)
    test_images = np.concatenate([b.images for b in jt.dm.test_dataloader()])
    pt.model.load_state_dict(state_dict_from_flax(ema, jt.state.batch_stats))
    stats = _calibrated_stats(pt.model, jt.state.batch_stats, test_images)
    jt.state = jt.state.replace(params=params, batch_stats=stats,
                                ema_params=ema)
    pt.model.load_state_dict(state_dict_from_flax(params, stats),
                             strict=True)
    names = dict(pt.model.named_parameters())
    pt.state.ema_params = {k: v for k, v in
                           state_dict_from_flax(ema, stats).items()
                           if k in names}
    assert pt.state.ema_params.keys() == names.keys()

    # preconditions under the EMA weights, per image: candidates above
    # conf_thres, none within 1e-3 of it, their scores 3e-4 apart
    for b in jt.dm.test_dataloader():
        out = jt.model.apply({"params": ema, "batch_stats": stats},
                             jnp.asarray(b.images), train=False)
        dec = np.asarray(_decode(model_name, out))
        obj = dec[..., 4]
        assert np.abs(obj - conf).min() > 1e-3
        for o, score in zip(obj, obj * dec[..., 5:].max(-1)):
            s = np.sort(score[o >= conf])[::-1]
            assert len(s) >= 2 and (-np.diff(s) > 3e-4 * s[1:]).all()

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
        boxes, obj, labels, valid, gt, gt_labels, gt_mask = g_in
        np.testing.assert_array_equal(valid, w_in[3])
        assert valid.any(axis=1).all()          # detections on every image
        np.testing.assert_array_equal(labels[valid], w_in[2][valid])
        np.testing.assert_allclose(boxes[valid], w_in[0][valid], **BOX_TOL)
        np.testing.assert_allclose(obj, w_in[1], **OBJ_TOL)
        for g, w in zip((gt, gt_labels, gt_mask), w_in[4:]):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g_out[0], w_out[0])          # tp
        np.testing.assert_allclose(g_out[1], w_out[1], **OBJ_TOL)  # conf
        np.testing.assert_array_equal(g_out[2], w_out[2])          # class
    assert got.keys() == want.keys()
    for k in ("mAP", "precision", "recall", "f1"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert got["per_class_AP"].keys() == want["per_class_AP"].keys()
    for c, ap in want["per_class_AP"].items():
        np.testing.assert_allclose(got["per_class_AP"][c], ap, rtol=1e-6)
    return got, want


def test_trainer_test_equals_jax(tmp_path, monkeypatch, jax_library):
    _test_both(tmp_path, monkeypatch, "YOLOv5", 64, CONF)


def test_trainer_test_yolov2_equals_jax(tmp_path, monkeypatch, jax_library):
    """YOLOv2 at 128 px (a 4x4 grid, 80 rows per image), ``conf_thres``
    0.65 (its obj tops out near 0.7 under these weights): the detections,
    the mAP and the per-grid statistics ``4/{key}`` (within ``STAT_TOL``),
    means over the test batches as the JAX Trainer takes them."""
    got, want = _test_both(tmp_path, monkeypatch, "YOLOv2", 128, 0.65)
    keys = [f"4/{k}" for k in ("cls_acc", "recall50", "recall75",
                               "precision", "conf_obj", "conf_noobj")]
    assert keys == [k for k in got if "/" in k]
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **STAT_TOL)
    assert got["4/conf_obj"] > 0 and got["4/conf_noobj"] > 0
    rows = [json.loads(line) for line in (tmp_path / "port" / "Synthetic" /
                                          "YOLOv2" / "metrics.jsonl")
            .read_text().splitlines()]
    assert {f"Test/{k}" for k in keys} <= {r["tag"] for r in rows}


# --- checkpoints -----------------------------------------------------------


def _tiny_state(seed, ema=True):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    state = create_train_state(model, opt, ema_decay=0.9 if ema else 0.0)
    return state


def _train_a_step(state):
    state.model.train()
    state.optimizer.zero_grad()
    state.model(torch.randn(8, 3)).square().mean().backward()
    state.optimizer.step()
    for k, p in state.model.named_parameters():
        state.ema_params[k].mul_(0.9).add_(p.detach() * 0.1)
    state.step += 1


def _tensors(state):
    out = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    for i, s in state.optimizer.state_dict()["state"].items():
        out.update({f"opt.{i}.{k}": v for k, v in s.items()})
    out.update({f"ema.{k}": v for k, v in state.ema_params.items()})
    out["step"] = state.step
    return out


def test_checkpoint_save_restore_is_exact(tmp_path):
    saved = _tiny_state(0)
    for _ in range(3):
        _train_a_step(saved)
    mgr = checkpoint.CheckpointManager(str(tmp_path), save_top_k=2)
    assert mgr.restore(_tiny_state(1)) is None          # nothing saved yet
    assert mgr.save(4, saved, 0.5)
    fresh = _tiny_state(1)
    assert not torch.equal(fresh.model[0].weight, saved.model[0].weight)
    restored = mgr.restore(fresh)
    assert restored is fresh
    want, got = _tensors(saved), _tensors(restored)
    assert got.keys() == want.keys() and int(got["step"]) == 3
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert restored.optimizer.param_groups[0]["lr"] == 1e-2
    # the restored optimizer goes on as the saved one does
    torch.manual_seed(9)
    _train_a_step(saved)
    torch.manual_seed(9)
    _train_a_step(restored)
    for k, v in _tensors(saved).items():
        assert torch.equal(_tensors(restored)[k], v), k
    # a checkpoint that does not fit the state is refused, untouched
    other = create_train_state(torch.nn.Linear(3, 5), None, ema_decay=0.9)
    before = {k: v.clone() for k, v in other.model.state_dict().items()}
    with pytest.raises(ValueError, match="another model"):
        mgr.restore(other)
    assert all(torch.equal(other.model.state_dict()[k], v)
               for k, v in before.items())
    with pytest.raises(ValueError, match="EMA"):
        mgr.restore(_tiny_state(2, ema=False))
    # the same model under an optimizer of other parameter groups
    split = _tiny_state(3)
    split.optimizer = torch.optim.Adam(
        [{"params": list(split.model[0].parameters())},
         {"params": list(split.model[1].parameters())}], lr=1e-2)
    before = {k: v.clone() for k, v in _tensors(split).items()}
    with pytest.raises(ValueError, match="parameter groups"):
        mgr.restore(split)
    assert all(torch.equal(_tensors(split)[k], v) for k, v in before.items())


def test_checkpoint_retention_follows_orbax(tmp_path):
    """The same val_loss sequence (ties, a step not after the latest) into
    the JAX manager and the port's: the same steps kept after each save,
    the same best step and best_model_path.txt."""
    seq = [(0, 0.9), (1, 0.7), (2, 0.8), (3, 0.7), (4, 0.95), (5, 0.6),
           (5, 0.1), (3, 0.1), (6, 0.6), (7, 0.65)]
    jax_mgr = jax_ckpt.CheckpointManager(str(tmp_path / "jax"), 3,
                                         async_save=False)
    port_mgr = checkpoint.CheckpointManager(str(tmp_path / "port"), 3)
    state = _tiny_state(0)
    tiny = {"w": jnp.zeros(2)}

    def kept(root):
        return sorted(int(n) for n in os.listdir(root) if n.isdigit())

    for step, val_loss in seq:
        jax_mgr.save(step, tiny, val_loss)
        port_mgr.save(step, state, val_loss)
        jax_mgr.wait()
        assert kept(tmp_path / "port") == kept(tmp_path / "jax"), step
        assert port_mgr.steps() == kept(tmp_path / "port")
        assert port_mgr.best_step() == jax_mgr.best_step(), step
        for mgr, name in ((jax_mgr, "jax"), (port_mgr, "port")):
            assert mgr.read_best_model_path() == str(
                tmp_path / name / str(mgr.best_step()))
    jax_mgr.close()
    assert kept(tmp_path / "port") == [5, 6, 7]
    # a new manager over the directory finds the same checkpoints
    again = checkpoint.CheckpointManager(str(tmp_path / "port"), 3)
    assert again.steps() == [5, 6, 7] and again.best_step() == 6


def test_early_stopping_equals_jax():
    seq = [1.0, 0.9, 0.95, 0.9, 0.91, 0.5, 0.6, 0.7, 0.8, 0.4]
    for patience in (1, 2, 3):
        got, want = (checkpoint.EarlyStopping(patience),
                     jax_ckpt.EarlyStopping(patience))
        assert [got.update(v) for v in seq] == [want.update(v) for v in seq]


# --- the Trainer and the CLI -------------------------------------------------


def test_partial_window_flush_weights(tmp_path, monkeypatch):
    cfg = Config(data_module="Synthetic", synthetic_size=8, batch_size=2,
                 img_size=64, model_name="YOLOv5", max_epochs=1,
                 accumulate_grad_batches=2, limit_train_batches=3,
                 limit_val_batches=1, max_boxes=8, test=False,
                 log_dir=str(tmp_path))
    trainer = loop.Trainer(cfg, device="cpu")
    calls = []

    def train_step(state, images, labels, boxes, mask, weights=None):
        calls.append((tuple(images.shape), weights))
        return state, {"loss": torch.tensor(1.0)}

    monkeypatch.setattr(trainer, "train_step", train_step)
    trainer.fit()
    assert calls == [((2, 2, 64, 64, 3), None),
                     ((2, 2, 64, 64, 3), [1.0, 0.0])]
    assert trainer.global_step == 2


def test_fit_error_ends_the_loader_thread(tmp_path, monkeypatch):
    cfg = Config(data_module="Synthetic", synthetic_size=8, batch_size=2,
                 img_size=64, model_name="YOLOv5", max_epochs=1,
                 accumulate_grad_batches=1, max_boxes=8, test=False,
                 log_dir=str(tmp_path))
    trainer = loop.Trainer(cfg, device="cpu")

    def train_step(*args, **kwargs):
        raise FloatingPointError("step")

    monkeypatch.setattr(trainer, "train_step", train_step)
    before = threading.active_count()
    with pytest.raises(FloatingPointError, match="step") as err:
        trainer.fit()
    # the traceback keeps fit's frame, and with it the generator, alive:
    # only the loop's own close has ended the thread
    assert err.tb is not None and threading.active_count() == before


def test_unported_options_raise(tmp_path):
    """Nothing is left unported: the options that raise are the meshes
    other than the process group's (2 ranks asked, 1 there, on either
    axis: ValueError); ``mesh_shape`` (1, 1), mosaic, remat, the tuner and
    RMSprop build a Trainer (torch checkpoints:
    ``test_torch_port_torch_weights.py``)."""
    base = dict(data_module="Synthetic", synthetic_size=4, img_size=64,
                model_name="YOLOv5", log_dir=str(tmp_path))
    for shape in ((2, 1), (1, 2)):
        with pytest.raises(ValueError, match="needs 2 ranks"):
            loop.Trainer(Config(**base, mesh_shape=shape), device="cpu")
    assert loop.Trainer(Config(**base, mesh_shape=(1, 1)),
                        device="cpu").mesh == (1, 1)
    trainer = loop.Trainer(Config(**base, mosaic=0.5, tune=True,
                                  remat="all", optimizer="RMSprop"),
                           device="cpu")
    assert trainer.model.remat == "all"
    assert type(trainer.optimizer).__name__ == "RMSprop"


def _cli(tmp_path, *extra):
    return cli_run.main([YAML, "--set", "model_name", "YOLOv5", "--device",
                         "cpu", "--set", "log_dir", str(tmp_path), *extra])


def test_cli_fits_checkpoints_and_tests(tmp_path, capsys):
    results = _cli(tmp_path)
    assert results is not None
    for k in ("mAP", "precision", "recall", "f1"):
        assert math.isfinite(results[k]) and 0.0 <= results[k] <= 1.0, k
    assert results["per_class_AP"] and all(
        math.isfinite(v) for v in results["per_class_AP"].values())
    out = capsys.readouterr().out
    assert "img_size=128 batch=2 accum=2 device=cpu" in out
    assert "---- mAP per class ----" in out and "mAP: " in out
    assert "YOLO statistics" not in out          # YOLOv2/v3/v4 only

    run_dir = tmp_path / "Synthetic" / "YOLOv5"
    ckpt_dir = run_dir / "checkpoints"
    best = (ckpt_dir / "best_model_path.txt").read_text()
    assert os.path.isfile(os.path.join(best, "state.pt"))
    assert sorted(p.name for p in ckpt_dir.iterdir()) == [
        "0", "1", "best_model_path.txt"]
    assert (run_dir / "summary.txt").read_text().count("\n") > 10
    rows = [json.loads(line) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]
    tags = {r["tag"] for r in rows}
    assert {"Loss/loss/Train", "Loss/Localization/Train", "val_loss",
            "Test/mAP", "throughput/images_per_sec", "lr-Adam"} <= tags
    assert all(math.isfinite(r["value"]) for r in rows)
    epochs = [r["step"] for r in rows if r["tag"] == "time/epoch_seconds"]
    assert epochs == [0, 1]

    # eval only: max_epochs 0 restores the best checkpoint, then tests
    best_step = int(os.path.basename(best))
    again = _cli(tmp_path, "--set", "max_epochs", "0")
    assert f"restored best checkpoint (step {best_step})" in \
        capsys.readouterr().out
    if best_step == 1:                    # the weights the first test used
        assert again == results


# the per-parameter state each optimizer checkpoints
OPTIMIZER_STATE = {"SGD": {"momentum_buffer"},
                   "RMSprop": {"square_avg", "momentum_buffer"},
                   "Adagrad": {"sum", "step"}}


def cli_with_options(tmp_path, capsys, optimizer, remat, *extra):
    """YOLOv5 at the ``yaml_test`` caps with ``optimizer``, mosaic 0.5,
    ``remat`` and the tuner: both ``[tune]`` lines, then the fit (every
    microbatch, the tuner's included, through mosaic and the warp path),
    checkpoints holding the optimizer's state, and the test's mAP table."""
    calls = {"mosaic": 0}
    mosaic = loop.mosaic_batch

    def counted(*args, **kwargs):
        calls["mosaic"] += 1
        return mosaic(*args, **kwargs)

    loop.mosaic_batch = counted
    try:
        results = _cli(tmp_path, "--set", "optimizer", optimizer, "--set",
                       "mosaic", "0.5", "--set", "remat", remat, "--set",
                       "tune", "true", *extra)
    finally:
        loop.mosaic_batch = mosaic
    out = capsys.readouterr().out
    lr = re.search(r"\[tune\] auto_lr_find suggests lr=(\S+)", out)
    bs = re.search(r"\[tune\] auto_scale_batch_size suggests "
                   r"batch_size=(\d+)", out)
    assert lr and 1e-8 <= float(lr.group(1)) <= 1.0
    assert bs and int(bs.group(1)) >= 2
    assert "img_size=128 batch=2 accum=2 device=cpu" in out
    assert "---- mAP per class ----" in out
    for k in ("mAP", "precision", "recall", "f1"):
        assert math.isfinite(results[k]) and 0.0 <= results[k] <= 1.0, k
    # the fit's 2 x 4 microbatches and the tuner's (at least 3 steps of
    # 2, at most 25) all went through mosaic
    assert 8 + 2 * 3 <= calls["mosaic"] <= 8 + 2 * 25
    run_dir = tmp_path / "Synthetic" / "YOLOv5"
    best = (run_dir / "checkpoints" / "best_model_path.txt").read_text()
    ckpt = torch.load(os.path.join(best, "state.pt"), weights_only=True)
    per_param = list(ckpt["optimizer"]["state"].values())
    assert len(per_param) == 165
    for st in per_param:
        assert set(st) == OPTIMIZER_STATE[optimizer]
        assert all(torch.isfinite(v).all() for v in st.values())
    tags = {json.loads(line)["tag"] for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()}
    assert f"lr-{optimizer}" in tags and "lr-Adam" not in tags


def test_cli_fits_with_the_training_options(tmp_path, capsys):
    cli_with_options(tmp_path, capsys, "SGD", "early")


def test_cli_trains_the_yaml_default_model(tmp_path, capsys):
    """The YAML's own ``model_name`` (YOLOv2) with ``--device cpu``: one
    epoch at the ``yaml_test`` caps (128 px, so a 4x4 grid) and one
    checkpoint (~0.6 GB), then the mAP table with the per-grid
    statistics."""
    results = cli_run.main([YAML, "--device", "cpu", "--set", "log_dir",
                            str(tmp_path), "--set", "max_epochs", "1"])
    out = capsys.readouterr().out
    assert "[run] model=YOLOv2 dataset=Synthetic img_size=128" in out
    assert "---- mAP per class ----" in out
    assert "---- YOLO statistics per grid ----" in out
    keys = [f"4/{k}" for k in ("cls_acc", "recall50", "recall75",
                               "precision", "conf_obj", "conf_noobj")]
    for k in ["mAP", "precision", "recall", "f1"] + keys:
        assert math.isfinite(results[k]), k
        assert k.startswith("4/") or 0.0 <= results[k] <= 1.0, k
        assert not k.startswith("4/") or f"  {k}: {results[k]:.4f}" in out
    run_dir = tmp_path / "Synthetic" / "YOLOv2"
    assert sorted(p.name for p in (run_dir / "checkpoints").iterdir()) == [
        "0", "best_model_path.txt"]
    tags = {json.loads(line)["tag"] for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()}
    assert {"Loss/Size/Train", "Loss/Conf_noobj/Train", "val_loss",
            "Test/mAP", "Test/4/recall50"} <= tags


def test_cli_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_run.main([YAML, "--set", "model_name", "YOLOv5", "--set",
                      "log_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


# --- logging, summary, profiler ---------------------------------------------


def test_metric_writer_without_tensorboard(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    writer = MetricWriter(str(tmp_path))
    writer.scalar("a/b", 1.5, 3)
    writer.scalars("Epoch", {"loss/Train": 2.0}, 4)
    writer.histogram("w", torch.ones(3), 0)
    writer.image("img", np.zeros((4, 4, 3), np.uint8), 0)
    writer.text("t", "x")
    writer.close()
    rows = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [(r["tag"], r["value"], r["step"]) for r in rows] == [
        ("a/b", 1.5, 3), ("Epoch/loss/Train", 2.0, 4)]


def test_param_histograms_walk_named_parameters():
    class Recorder:
        def __init__(self):
            self.seen = []

        def histogram(self, tag, values, step):
            self.seen.append((tag, tuple(values.shape), step))

    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    rec = Recorder()
    log_param_histograms(rec, model, 7)
    assert rec.seen == [("0.weight", (4, 3), 7), ("0.bias", (4,), 7),
                        ("1.weight", (2, 4), 7), ("1.bias", (2,), 7)]
    rec = Recorder()
    log_param_histograms(rec, model, 7, max_tensors=3)
    assert len(rec.seen) == 3


def test_summary_and_profiler(tmp_path):
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.ReLU())
    path = summary.save_summary(model, str(tmp_path))
    lines = open(path).read().splitlines()
    assert lines[-1].split()[-1] == "16" and len(lines) == 4
    with profiler.trace(str(tmp_path / "trace")):
        model(torch.ones(2, 3))
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with profiler.trace(str(tmp_path / "off"), enabled=False):
        pass
    assert not (tmp_path / "off").exists()
    if not torch.cuda.is_initialized():
        assert profiler.device_memory_stats() == {}
