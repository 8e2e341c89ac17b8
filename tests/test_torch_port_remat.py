"""YOLOv5 ``remat`` in the port (``models/yolov5.py``, ``nn/blocks.py::remat``) against ``remat="none"`` and the JAX package.

- A YOLOv5s train step at 64 px, B=2, 3 classes, f32 on the CPU, SGD
  with momentum, under "none", "early" and "all" from the same seeded
  weights and batch: loss, every gradient, the parameters after the step
  and the BN running statistics of "early" and "all" equal "none"'s bit
  for bit (tolerance 0: recomputation runs the same CPU kernels on the
  same inputs).  Forward hooks count the runs of two BatchNorms: the
  stem's runs twice under "early" and "all" (recomputed), a stride-16
  block's twice under "all" only, so the statistics above moved once
  although the forward ran twice.
- The ``state_dict`` keys and shapes are identical for the three
  settings, and one setting's weights load strictly into another's.
- ``accum_steps=2`` with weights [1, 0] under "early" and "all": the
  zero-weight microbatch leaves the BN statistics exactly as a "none"
  step on the first microbatch alone.
- One Adam step of the port's "early" against the JAX package's
  ``YOLOv5(remat="early")`` on bridged weights, with the tolerances of
  ``tests/test_torch_port_train.py``, whose docstring explains them: loss
  ``rtol=1e-4``; gradients through Adam's first moment, relative L2 at
  most 0.08 per tensor and 0.03 over all; BN statistics ``rtol=1e-3,
  atol=1e-4``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from objectdetectionpl_tpu.config import Config as JaxConfig
from objectdetectionpl_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from objectdetectionpl_tpu.ops import losses as jax_losses
from objectdetectionpl_tpu.train import optim as jax_optim
from objectdetectionpl_tpu.train import step as jax_step
from objectdetectionpl_tpu_torch.config import Config
from objectdetectionpl_tpu_torch.models import build_model
from objectdetectionpl_tpu_torch.models.yolov5 import EARLY, HEADS, REMAT
from objectdetectionpl_tpu_torch.ops import losses as port_losses
from objectdetectionpl_tpu_torch.train import optim as port_optim
from objectdetectionpl_tpu_torch.train.state import create_train_state
from objectdetectionpl_tpu_torch.train.step import make_train_step
from objectdetectionpl_tpu_torch.utils.weights import state_dict_from_flax
from test_torch_port_blocks import randomized_variables
from test_torch_port_train import (_adam_moments, _as_port, _jax_state,
                                   _rel_l2, _targets, _zero_mean_kernels)

torch.set_num_threads(2)

C, IMG, B = 3, 64, 2
LR, WD = 1e-3, 1e-5
SGD = Config(optimizer="SGD", lr=1e-2, momentum=0.9, weight_decay=WD)


def _batch(A, seed=11):
    rng = np.random.RandomState(seed)
    images = rng.rand(A, B, IMG, IMG, 3).astype(np.float32)
    return [torch.from_numpy(a) for a in (images,) + _targets(rng, A, B)]


def _step(remat, batch, accum=1, weights=None):
    model = build_model("YOLOv5", C, device="cpu", remat=remat, seed=4)
    opt = port_optim.build_optimizer(SGD, model.parameters())
    step = make_train_step(model, port_losses.make_loss("YOLOv5", C, IMG),
                           opt, accum_steps=accum)
    runs = {"Focus_0": 0, "BottleneckCSP_1": 0}

    def count(name):
        def hook(module, args, out):
            runs[name] += 1
        return hook

    model.Focus_0.ConvBN_0.BatchNorm_0.register_forward_hook(
        count("Focus_0"))
    model.BottleneckCSP_1.BatchNorm_0.register_forward_hook(
        count("BottleneckCSP_1"))
    _, metrics = step(create_train_state(model, opt), *batch, weights)
    return model, metrics, runs


@pytest.fixture(scope="module")
def one_step():
    batch = _batch(1)
    return {r: _step(r, batch) for r in REMAT}


def _assert_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("remat", ["early", "all"])
def test_remat_step_equals_none(one_step, remat):
    base, base_m, base_runs = one_step["none"]
    model, metrics, runs = one_step[remat]
    _assert_equal(metrics, base_m)
    _assert_equal({n: p.grad for n, p in model.named_parameters()},
                  {n: p.grad for n, p in base.named_parameters()})
    _assert_equal(model.state_dict(), base.state_dict())
    assert base_runs == {"Focus_0": 1, "BottleneckCSP_1": 1}
    assert runs == {"Focus_0": 2,
                    "BottleneckCSP_1": 2 if remat == "all" else 1}


def test_remat_blocks_follow_the_jax_module():
    model = build_model("YOLOv5", C, device="cpu", remat="early")
    blocks = [n for n, _ in model.named_children()]
    assert EARLY < set(blocks) and set(HEADS) < set(blocks)
    early = {n for n in blocks if model._recomputed(n)}
    model.remat = "all"
    every = {n for n in blocks if model._recomputed(n)}
    assert early == EARLY and every == set(blocks) - set(HEADS)
    with pytest.raises(ValueError, match="remat"):
        build_model("YOLOv5", C, device="cpu", remat="late")


def test_state_dict_keys_identical_for_every_setting():
    dicts = {r: build_model("YOLOv5", C, device="cpu", remat=r,
                            seed=5).state_dict() for r in REMAT}
    shapes = {r: {k: v.shape for k, v in d.items()} for r, d in dicts.items()}
    assert shapes["none"] == shapes["early"] == shapes["all"]
    other = build_model("YOLOv5", C, device="cpu", remat="all", seed=6)
    other.load_state_dict(dicts["early"], strict=True)
    _assert_equal(other.state_dict(), dicts["early"])


def test_remat_is_off_without_gradients():
    x = torch.from_numpy(np.random.RandomState(2).rand(1, IMG, IMG, 3)
                         .astype(np.float32))
    outs = {}
    for r in REMAT:
        model = build_model("YOLOv5", C, device="cpu", remat=r, seed=7)
        with torch.no_grad():
            model.train()
            outs[r] = model(x)
    for r in ("early", "all"):
        for a, b in zip(outs[r], outs["none"]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("remat", ["early", "all"])
def test_zero_weight_microbatch_leaves_statistics(remat):
    batch = _batch(2, seed=12)
    model, _, runs = _step(remat, batch, accum=2, weights=[1.0, 0.0])
    alone, _, _ = _step("none", [t[:1] for t in batch])
    _assert_equal(dict(model.named_buffers()), dict(alone.named_buffers()))
    assert runs["Focus_0"] == 4                     # 2 microbatches x 2 runs


def test_remat_early_step_matches_jax():
    jmodel = JaxYOLOv5(num_classes=C, remat="early")
    params, stats = randomized_variables(
        jmodel, np.zeros((1, IMG, IMG, 3), np.float32), seed=3, jit=True)
    params = _zero_mean_kernels(params)
    rng = np.random.RandomState(4)
    batch = (rng.rand(1, B, IMG, IMG, 3).astype(np.float32),) + \
        _targets(rng, 1, B)

    tx = jax_optim.build_optimizer(JaxConfig(optimizer="Adam", lr=LR,
                                             weight_decay=WD))
    step = jax_step.make_train_step(
        jmodel, jax_losses.make_loss("YOLOv5", C, IMG), tx)
    st, metrics = step(_jax_state(params, stats, tx),
                       *map(jnp.asarray, batch))
    mu = _as_port(_adam_moments(st.opt_state)[0], {})
    want_state = _as_port(st.params, st.batch_stats)

    port = build_model("YOLOv5", C, device="cpu", remat="early")
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    opt = port_optim.build_optimizer(Config(lr=LR, weight_decay=WD),
                                     port.parameters())
    pstep = make_train_step(port, port_losses.make_loss("YOLOv5", C, IMG),
                            opt)
    _, pm = pstep(create_train_state(port, opt), *map(torch.from_numpy,
                                                      batch))
    np.testing.assert_allclose(pm["loss"].item(), float(metrics["loss"]),
                               rtol=1e-4)
    port_mu = {n: opt.state[p]["exp_avg"].numpy()
               for n, p in port.named_parameters()}
    assert port_mu.keys() == mu.keys() and len(mu) == 165
    for k in mu:
        assert _rel_l2(port_mu[k], mu[k]) <= 0.08, k
    flat = lambda d: np.concatenate([d[k].ravel() for k in mu])
    assert _rel_l2(flat(port_mu), flat(mu)) <= 0.03
    got = port.state_dict()
    for k, want in want_state.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-3,
                                       atol=1e-4, err_msg=k)
