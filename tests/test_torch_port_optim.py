"""Port optimizers (``objectdetectionpl_tpu_torch/train/optim.py``) against the JAX package's optax chains.

Both sides run in f32 on the CPU from the same seeded parameters and the
same seeded gradients, five steps, with the learning rate rewritten
before step 4 as the host scheduler does.  SGD, RMSprop and Adagrad, with
and without momentum, ``lr_decay`` and weight decay, against
``objectdetectionpl_tpu.train.optim.build_optimizer``: parameters and
the optimizer's state after every step within ``rtol=1e-6``.  XLA's
``rsqrt`` on the CPU is within an ulp of torch's but differs on about a
third of float32 inputs, so a sum whose terms cancel would amplify that
ulp past any relative tolerance: each coordinate's gradients keep one
sign over the five steps, and its parameter starts on the side of zero
the updates move it away from, so that no sum cancels.

Coordinate 0 of the first tensor has a zero parameter and a zero gradient
at every step; coordinate 1 a zero parameter and a gradient of 1e-25,
whose square underflows to 0: there Adagrad's sum of squares is 0 and
optax's ``where(s > 0, ...)`` gives no update, where ``g*rsqrt(s + eps)``
alone would move the parameter.

A ``state_dict`` round trip through ``CheckpointManager`` after two steps:
three more steps of the resumed optimizer equal three more steps of the
uninterrupted one, bit for bit.
"""

import numpy as np
import optax
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from objectdetectionpl_tpu.config import Config as JaxConfig
from objectdetectionpl_tpu.train import optim as jax_optim
from objectdetectionpl_tpu_torch.config import Config
from objectdetectionpl_tpu_torch.train import optim as port_optim
from objectdetectionpl_tpu_torch.train.checkpoint import CheckpointManager
from objectdetectionpl_tpu_torch.train.state import create_train_state

SHAPES = [(4, 6), (7,), (2, 3, 3)]
STEPS = 5
LR, LR_LATER = 1e-2, 3e-3
RTOL = 1e-6

CASES = {
    "SGD-momentum-wd": dict(optimizer="SGD", momentum=0.9,
                            weight_decay=1e-5),
    "SGD-plain": dict(optimizer="SGD", momentum=0.0, weight_decay=0.0),
    "RMSprop-momentum-wd": dict(optimizer="RMSprop", alpha=0.95,
                                momentum=0.9, weight_decay=1e-5),
    "RMSprop-plain": dict(optimizer="RMSprop", alpha=0.9, momentum=0.0,
                          weight_decay=0.0),
    "Adagrad-wd": dict(optimizer="Adagrad", lr_decay=0.0,
                       weight_decay=1e-5),
    "Adagrad-lr_decay-wd": dict(optimizer="Adagrad", lr_decay=1e-2,
                                weight_decay=1e-5),
    "Adagrad-lr_decay": dict(optimizer="Adagrad", lr_decay=0.5,
                             weight_decay=0.0),
}


def _draws(seed):
    """Parameters and STEPS gradients, f32, with the two special
    coordinates of the module docstring."""
    rng = np.random.RandomState(seed)
    sign = [np.where(rng.rand(*s) < 0.5, -1.0, 1.0) for s in SHAPES]
    params = [(-sg * rng.uniform(0.5, 2.0, s)).astype(np.float32)
              for sg, s in zip(sign, SHAPES)]
    grads = [[(sg * rng.uniform(0.01, 0.2, s)).astype(np.float32)
              for sg, s in zip(sign, SHAPES)] for _ in range(STEPS)]
    params[0].flat[:2] = 0.0
    for g in grads:
        g[0].flat[0] = 0.0
        g[0].flat[1] = 1e-25
    return params, grads


def _jax_run(kw, params, grads):
    tx = jax_optim.build_optimizer(JaxConfig(lr=LR, **kw))
    p = [jnp.asarray(a) for a in params]
    state = tx.init(p)
    out = []
    for i, g in enumerate(grads):
        if i == 3:
            state = jax_optim.set_learning_rate(state, LR_LATER)
        updates, state = tx.update([jnp.asarray(a) for a in g], state, p)
        p = optax.apply_updates(p, updates)
        out.append([np.asarray(a) for a in p])
    return out, state


def _port_run(kw, params, grads):
    ps = [nn.Parameter(torch.from_numpy(a.copy())) for a in params]
    opt = port_optim.build_optimizer(Config(lr=LR, **kw), ps)
    out = []
    for i, g in enumerate(grads):
        if i == 3:
            port_optim.set_learning_rate(opt, LR_LATER)
        for p, a in zip(ps, g):
            p.grad = torch.from_numpy(a.copy())
        opt.step()
        out.append([p.detach().numpy().copy() for p in ps])
    return out, opt, ps


def _jax_moments(state):
    """The optax chain's state tensors the port also keeps, by port name."""
    found = {}
    for s in jax.tree_util.tree_leaves(
            state.inner_state, is_leaf=lambda x: hasattr(x, "_fields")):
        if isinstance(s, optax.TraceState):
            found["momentum_buffer"] = s.trace
        elif isinstance(s, optax.ScaleByRmsState):
            found["square_avg"] = s.nu
        elif isinstance(s, optax.ScaleByRssState):
            found["sum"] = s.sum_of_squares
    return found


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_optax(case):
    kw = CASES[case]
    params, grads = _draws(sum(map(ord, case)))
    want, jstate = _jax_run(kw, params, grads)
    got, opt, ps = _port_run(kw, params, grads)
    for step, (g_step, w_step) in enumerate(zip(got, want)):
        for k, (g, w) in enumerate(zip(g_step, w_step)):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0,
                                       err_msg=f"{case} step {step} "
                                               f"tensor {k}")
    # the moments the port keeps are optax's
    moments = _jax_moments(jstate)
    kept = {k for st in opt.state.values() for k in st} - {"step"}
    assert kept == set(moments)
    for name, tensors in moments.items():
        for p, w in zip(ps, tensors):
            np.testing.assert_allclose(opt.state[p][name].numpy(),
                                       np.asarray(w), rtol=RTOL, atol=0,
                                       err_msg=f"{case} {name}")
    # the zero coordinate never moves; the underflowing one moves except
    # under Adagrad, whose where() holds it
    final = got[-1][0].ravel()
    assert final[0] == 0.0
    assert (final[1] == 0.0) == (kw["optimizer"] == "Adagrad")


class _Params(nn.Module):
    def __init__(self, params):
        super().__init__()
        self.w = nn.ParameterList(
            [nn.Parameter(torch.from_numpy(a.copy())) for a in params])


@pytest.mark.parametrize("case", ["SGD-momentum-wd", "RMSprop-momentum-wd",
                                  "Adagrad-lr_decay-wd"])
def test_checkpoint_round_trip_resumes_the_same_steps(case, tmp_path):
    kw = CASES[case]
    params, grads = _draws(7)

    def make(init):
        model = _Params(init)
        opt = port_optim.build_optimizer(Config(lr=LR, **kw),
                                         model.parameters())
        return create_train_state(model, opt)

    def steps(state, gs):
        for g in gs:
            for p, a in zip(state.model.parameters(), g):
                p.grad = torch.from_numpy(a.copy())
            state.optimizer.step()
            state.step += 1

    whole = make(params)
    steps(whole, grads[:2])
    mgr = CheckpointManager(str(tmp_path / "ck"), save_top_k=1)
    assert mgr.save(1, whole, val_loss=1.0)
    resumed = make([np.zeros_like(a) for a in params])
    assert mgr.restore(resumed) is resumed and int(resumed.step) == 2
    for p, q in zip(resumed.model.parameters(), whole.model.parameters()):
        st, sw = resumed.optimizer.state[p], whole.optimizer.state[q]
        assert st.keys() == sw.keys() and st
        for k in st:
            assert st[k].device == sw[k].device
            torch.testing.assert_close(st[k], sw[k], rtol=0, atol=0)
    steps(whole, grads[2:])
    steps(resumed, grads[2:])
    for p, q in zip(resumed.model.parameters(), whole.model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)
