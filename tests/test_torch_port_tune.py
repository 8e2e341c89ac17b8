"""The port's tuner (``objectdetectionpl_tpu_torch/train/tune.py``) on the CPU.

- ``auto_lr_find`` on a YOLOv5 Trainer at 64 px, B=2, accumulation 2,
  after one live train step (so the optimizer has state): a suggestion
  inside the sweep's range, each sweep step fed by ``accumulate_grad_batches``
  augmented microbatches (``Trainer._device_batch``), and the live model's
  parameters, BN statistics and optimizer state bit-equal afterwards.
- ``auto_scale_batch_size(start=2, max_trials=3)`` returns 8 with an
  unbounded budget, with the host's ``MemAvailable`` as the JAX test has
  it, and 2 with a 1-byte budget (``tests/test_train.py::
  test_auto_scale_batch_size_is_aot_only``); the CPU count of peak bytes
  grows with the batch.  Resource failures (``torch.cuda.OutOfMemoryError``,
  an allocator's "can't allocate memory") mean "does not fit"; any other
  error inside the probe step propagates.
- ``cli.run`` at the ``yaml_test`` caps with RMSprop and ``remat all``,
  and with Adagrad (``lr_decay``), mosaic and the tuner on.
"""

import copy

import numpy as np
import pytest
import torch

from objectdetectionpl_tpu_torch.config import Config
from objectdetectionpl_tpu_torch.train import loop, tune
from test_torch_port_trainer import cli_with_options

torch.set_num_threads(2)


@pytest.fixture
def trainer(tmp_path):
    cfg = Config(data_module="Synthetic", synthetic_size=8, batch_size=2,
                 img_size=64, model_name="YOLOv5", max_epochs=1,
                 max_boxes=8, accumulate_grad_batches=2, mosaic=0.5,
                 log_dir=str(tmp_path), test=False)
    return loop.Trainer(cfg, device="cpu")


def _snapshot(t):
    return (copy.deepcopy(t.model.state_dict()),
            copy.deepcopy(t.optimizer.state_dict()))


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def test_auto_lr_find_leaves_the_live_state(trainer):
    batch = next(iter(trainer.dm.train_dataloader()))
    micro = [trainer._device_batch(batch, augment=True) for _ in range(2)]
    trainer.state, _ = trainer.train_step(
        trainer.state, *[torch.stack([m[i] for m in micro])
                         for i in range(4)])
    before = _snapshot(trainer)
    assert before[1]["state"]
    calls = []
    device_batch = trainer._device_batch

    def counted(b, augment):
        calls.append(augment)
        return device_batch(b, augment)

    trainer._device_batch = counted
    lr = tune.auto_lr_find(trainer, num_steps=6, min_lr=1e-6, max_lr=1e-1)
    assert 1e-6 <= lr <= 1e-1
    assert len(calls) % 2 == 0 and 6 <= len(calls) <= 12 and all(calls)
    _assert_same(_snapshot(trainer), before)


def test_auto_lr_find_with_too_few_steps_keeps_the_config_lr(trainer):
    assert tune.auto_lr_find(trainer, num_steps=2) == trainer.cfg.lr
    assert tune.auto_lr_find(trainer, deadline_s=-1.0) == trainer.cfg.lr


def _record_probes(monkeypatch):
    """Each (bs, peak) that ``probe_batch_size`` returns, in call order."""
    probe, trials = tune.probe_batch_size, []

    def recorded(trainer, bs):
        trials.append((bs, probe(trainer, bs)))
        return trials[-1][1]

    monkeypatch.setattr(tune, "probe_batch_size", recorded)
    return trials


def test_auto_scale_batch_size_power(trainer, monkeypatch):
    trials = _record_probes(monkeypatch)
    # the host's available memory, as the JAX test has it
    assert tune.auto_scale_batch_size(trainer, start=2, max_trials=3) == 8
    assert [t[0] for t in trials] == [2, 4, 8]
    peaks = [t[1] for t in trials]
    assert 0 < peaks[0] < peaks[1] < peaks[2]
    monkeypatch.setattr(tune, "_device_bytes_limit",
                        lambda device: float("inf"))
    assert tune.auto_scale_batch_size(trainer, start=2, max_trials=3) == 8
    monkeypatch.setattr(tune, "_device_bytes_limit", lambda device: 1.0)
    assert tune.auto_scale_batch_size(trainer, start=2, max_trials=3) == 2
    assert not tune.batch_fits(trainer, 2)


@pytest.mark.parametrize("error", [
    torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
    RuntimeError("[enforce fail at alloc_cpu.cpp:117] data. "
                 "DefaultCPUAllocator: can't allocate memory"),
    MemoryError()], ids=["cuda", "cpu", "python"])
def test_resource_failure_does_not_fit(trainer, monkeypatch, error):
    loss_fn = trainer.loss_fn

    def failing(out, labels, boxes, mask):
        if labels.shape[0] >= 8:
            raise error
        return loss_fn(out, labels, boxes, mask)

    monkeypatch.setattr(trainer, "loss_fn", failing)
    monkeypatch.setattr(tune, "_device_bytes_limit",
                        lambda device: float("inf"))
    trials = _record_probes(monkeypatch)
    assert tune.auto_scale_batch_size(trainer, start=2, max_trials=4) == 4
    assert trials[-1] == (8, None)


def test_other_errors_propagate(trainer, monkeypatch):
    def failing(*args):
        raise ValueError("a shape bug, not a resource failure")

    monkeypatch.setattr(trainer, "loss_fn", failing)
    with pytest.raises(ValueError, match="shape bug"):
        tune.auto_scale_batch_size(trainer, start=2, max_trials=3)


def test_device_bytes_limit_on_the_cpu():
    with open("/proc/meminfo") as f:
        assert "MemAvailable:" in f.read()
    limit = tune._device_bytes_limit(torch.device("cpu"))
    assert np.isfinite(limit) and limit > 2 ** 20


@pytest.mark.parametrize("optimizer,remat,extra", [
    ("RMSprop", "all", ()),
    ("Adagrad", "early", ("--set", "lr_decay", "0.01"))])
def test_cli_fits_with_the_training_options(tmp_path, capsys, optimizer,
                                            remat, extra):
    cli_with_options(tmp_path, capsys, optimizer, remat, *extra)
