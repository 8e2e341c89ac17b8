"""The mesh's model axis (``parallel/mesh.py``) over gloo on the CPU.

The port of ``tests/test_train.py::test_model_axis_tensor_parallel_step``
and more.  Multi-rank cases start their ranks as processes of this file
(``parallel/dryrun.py::spawn``), which import torch, numpy and the port
only.

1. One train step on a (data=2, model=2) mesh, four ranks: YOLOv2, 3
   classes, 64 px, a global batch of 4 in each of 2 microbatches (JAX's
   test's draws), SGD lr 1.0 (momentum 0.9: its first step is plain SGD,
   and it leaves a buffer for the checkpoint to carry), an EMA of decay
   0.5, the state split by ``shard_model_parallel`` (JAX's rule: here every
   tensor, the 40-channel head too).  Against JAX's one-device
   ``make_train_step`` (optax ``sgd(1.0)``) on the same bridged weights
   and batch: every metric within rtol 1e-4, atol 1e-6, the BN statistics
   within 1e-4 (JAX's own tolerances).  Against the port's one-process
   step: the update of the gathered parameters (= the gradient, SGD lr 1)
   within 1e-4 relative L2, over the split tensors and over all, both
   sides computing in f64 (in f32 this gradient moves by 2.2 % when one
   process reverses the rows of its batch, so f32 is held to 5 %); a
   gradient ``model`` times too large, or a rank's share of an input
   gradient lost, is off by O(1).  Each rank holds half of
   ``ConvBN_13``'s output channels; all four gather the same state; a
   checkpoint of the split state is whole on disk, and a restore into a
   fresh split state gives each rank its own slices back, the momentum
   buffers and the EMA with them.
2. ``model_parallel_shardings`` on YOLOv2's state (3 and 80 classes, model
   axis 2, 4 and 3) against JAX's rule on the flax tree: the same arrays
   split, and with 80 classes the 425-channel head replicated.
3. Rank <-> (data, model) order on the four ranks, as JAX's row-major
   ``reshape`` (``mesh.coords``), each rank's data shard.
4. A Trainer with ``mesh_shape`` (1, 2) on two ranks, YOLOv2 at 64 px,
   one microbatch, SGD: the state is replicated over the model axis, as
   in JAX's Trainer, so both ranks' states equal one process's bit for
   bit.
5. ``make_mesh``'s ValueErrors.

About 60 s on one worker here (the JAX step's compile and four ranks).
"""

import functools
import hashlib
import os
import sys

import numpy as np
import pytest
import torch

from objectdetectionpl_tpu_torch.config import Config
from objectdetectionpl_tpu_torch.models import build_model
from objectdetectionpl_tpu_torch.ops import losses
from objectdetectionpl_tpu_torch.parallel import distributed, mesh
from objectdetectionpl_tpu_torch.parallel.dryrun import spawn
from objectdetectionpl_tpu_torch.train.checkpoint import CheckpointManager
from objectdetectionpl_tpu_torch.train.state import create_train_state
from objectdetectionpl_tpu_torch.train.step import make_train_step
from objectdetectionpl_tpu_torch.utils.weights import state_dict_from_flax

C, S, B, A = 3, 64, 4, 2
TP = (2, 2)
EMA = 0.5
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)
BN_TOL = 1e-4
GRAD_REL_L2 = 1e-4          # f64
F32_GRAD_REL_L2 = 5e-2


def _hash(sd: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode())
        h.update(sd[k].detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _sgd(model):
    return torch.optim.SGD(model.parameters(), lr=1.0, momentum=0.9)


def one_step(sd: dict, batch: list, data: int = 1, index: int = 0,
             split: bool = False, dtype: torch.dtype = torch.float32):
    """(state, metrics) after one step of YOLOv2 computing in ``dtype``
    from ``sd`` on the rows of data index ``index`` (of ``data``), split
    over the model axis when ``split``."""
    model = build_model("YOLOv2", C, device="cpu", dtype=dtype)
    model.load_state_dict(sd, strict=True)
    opt = _sgd(model)
    state = create_train_state(model, opt, ema_decay=EMA)
    if split:
        distributed.broadcast_state(state)
        mesh.shard_model_parallel(mesh.Mesh(*TP), state)
    b = B // data
    rows = [torch.from_numpy(a[:, index * b:(index + 1) * b]) for a in batch]
    step = make_train_step(model, losses.make_loss("YOLOv2", C, S), opt,
                           accum_steps=A, ema_decay=EMA)
    return step(state, *rows)


# --- the ranks: run as `python this_file.py CASE OUT_DIR` --------------------


def _worker_tp(out: str, rank: int) -> dict:
    grid = mesh.make_mesh(TP)
    a = distributed.axes()
    res = {"coords": (a.data_index, a.model_index),
           "shard": distributed.data_shard()}
    sd = torch.load(os.path.join(out, "yolov2.pt"))
    batch = list(np.load(os.path.join(out, "batch.npz")).values())
    state, metrics = one_step(sd, batch, TP[0], a.data_index, split=True)
    res["metrics"] = {k: float(v) for k, v in metrics.items()}
    res["conv13"] = tuple(state.model.ConvBN_13.Conv_0.weight.shape)
    whole = mesh.gather_state_dict(state)
    res["hash"] = _hash(whole)
    if rank == 0:
        torch.save(whole, os.path.join(out, "tp_state.pt"))

    # a checkpoint of the split state, restored into a fresh split state
    ckpt = CheckpointManager(os.path.join(out, "ckpt"))
    ckpt.save(1, state, res["metrics"]["loss"])
    fresh = build_model("YOLOv2", C, device="cpu", seed=1)
    restored = create_train_state(fresh, _sgd(fresh), ema_decay=EMA)
    mesh.shard_model_parallel(grid, restored)
    ckpt.restore(restored)
    distributed.broadcast_state(restored)   # within the data group
    mine = {**state.model.state_dict(),
            **{f"ema.{k}": v for k, v in state.ema_params.items()},
            **{f"mom.{n}": state.optimizer.state[p]["momentum_buffer"]
               for n, p in state.model.named_parameters()}}
    back = {**restored.model.state_dict(),
            **{f"ema.{k}": v for k, v in restored.ema_params.items()},
            **{f"mom.{n}": restored.optimizer.state[p]["momentum_buffer"]
               for n, p in restored.model.named_parameters()}}
    res["restored_equal"] = all(torch.equal(mine[k], back[k]) for k in mine)
    res["restored_keys"] = len(mine)

    state, _ = one_step(sd, batch, TP[0], a.data_index, split=True,
                        dtype=torch.float64)
    whole = mesh.gather_state_dict(state)
    res["hash64"] = _hash(whole)
    if rank == 0:
        torch.save(whole, os.path.join(out, "tp64_state.pt"))
    return res


def _trainer_cfg(log_dir: str, shape) -> Config:
    return Config(data_module="Synthetic", synthetic_size=8, img_size=S,
                  model_name="YOLOv2", batch_size=2, max_boxes=8,
                  max_epochs=1, accumulate_grad_batches=1,
                  limit_train_batches=1, limit_val_batches=1,
                  optimizer="SGD", momentum=0.0, lr=1e-2, test=False,
                  log_dir=log_dir,
                  mesh_shape=shape)


def trainer_fit(log_dir: str, shape) -> tuple:
    from objectdetectionpl_tpu_torch.train.loop import Trainer
    t = Trainer(_trainer_cfg(log_dir, shape), device="cpu")
    t.fit()
    return t, _hash(t.model.state_dict())


def _worker_trainer(out: str, rank: int) -> dict:
    t, h = trainer_fit(os.path.join(out, "run"), (1, 2))
    return {"hash": h, "mesh": tuple(t.mesh), "shard":
            distributed.data_shard(), "steps": t.ckpt.steps(),
            "replicated": t.state.model_axis is None}


WORKERS = {"tp": (_worker_tp, 4), "trainer": (_worker_trainer, 2)}


def _worker_main(case: str, out: str) -> None:
    torch.set_num_threads(2)
    rank = int(os.environ["RANK"])
    distributed.maybe_initialize("gloo")
    try:
        res = WORKERS[case][0](out, rank)
    finally:
        distributed.shutdown()
    torch.save(res, os.path.join(out, f"{case}_{rank}.pt"))


def run_ranks(case: str, out) -> list:
    spawn([os.path.abspath(__file__), case, str(out)], WORKERS[case][1],
          600.0, env={"OMP_NUM_THREADS": "2"})
    return [torch.load(os.path.join(out, f"{case}_{r}.pt"),
                       weights_only=False)
            for r in range(WORKERS[case][1])]


# --- 1: the (2, 2) step --------------------------------------------------------


@pytest.fixture(scope="module")
def tp_step(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import optax

    from objectdetectionpl_tpu.models import build_model as jax_build
    from objectdetectionpl_tpu.ops import losses as jax_losses
    from objectdetectionpl_tpu.train import state as jax_state
    from objectdetectionpl_tpu.train import step as jax_step
    from tests.conftest import make_padded_targets

    out = tmp_path_factory.mktemp("tp")
    rng = np.random.RandomState(0)              # JAX's test's draws
    im = rng.rand(A, B, S, S, 3).astype(np.float32)
    lb = rng.randint(0, C, (A, B, 4)).astype(np.int32)
    _, bx, mk = make_padded_targets(rng, A * B, 4, C)
    batch = [im, lb, bx.reshape(A, B, 4, 4), mk.reshape(A, B, 4)]
    np.savez(os.path.join(out, "batch.npz"), *batch)

    model = jax_build("YOLOv2", C)
    tx = optax.sgd(1.0)
    st0 = jax_state.create_train_state(model, tx, jax.random.PRNGKey(0), S,
                                       batch_size=2)
    sd0 = state_dict_from_flax(jax.tree.map(np.asarray, st0.params),
                               jax.tree.map(np.asarray, st0.batch_stats))
    torch.save(sd0, os.path.join(out, "yolov2.pt"))
    ranks = run_ranks("tp", out)

    step = jax_step.make_train_step(model, jax_losses.make_loss("YOLOv2", C,
                                                                S), tx,
                                    accum_steps=A)
    s1, m1 = step(st0, *(jnp.asarray(a) for a in batch))
    one = {dtype: one_step(sd0, batch, dtype=dtype)[0].model.state_dict()
           for dtype in (torch.float32, torch.float64)}
    return {"ranks": ranks, "sd0": sd0,
            "tp": torch.load(os.path.join(out, "tp_state.pt")),
            "tp64": torch.load(os.path.join(out, "tp64_state.pt")),
            "one": one[torch.float32], "one64": one[torch.float64],
            "jax_metrics": {k: float(v) for k, v in m1.items()},
            "jax_stats": state_dict_from_flax(
                {}, jax.tree.map(np.asarray, s1.batch_stats))}


def test_tp_step_matches_jax(tp_step):
    for r in tp_step["ranks"]:
        assert set(r["metrics"]) == set(tp_step["jax_metrics"])
        for k, v in tp_step["jax_metrics"].items():
            np.testing.assert_allclose(r["metrics"][k], v, err_msg=k,
                                       **METRIC_TOL)
    stats = tp_step["jax_stats"]
    assert stats
    diff = max(float((tp_step["tp"][k] - v).abs().max())
               for k, v in stats.items())
    assert diff < BN_TOL, diff
    # the step moved the statistics
    assert any(not torch.equal(tp_step["sd0"][k], v) for k, v in stats.items())


def _update(sd0, sd, keys):
    return torch.cat([(sd0[k] - sd[k]).double().ravel() for k in keys])


def _grad_errors(sd0, tp, one) -> list:
    """Relative L2 of the update (the gradient) over the split parameters
    and over all parameters."""
    params = [k for k in sd0 if not k.endswith(("running_mean",
                                                "running_var"))]
    split = [k for k, d in mesh.model_parallel_shardings(
        mesh.Mesh(*TP), sd0).items() if d == 0 and k in params]
    assert split == params          # 3 classes: the head splits too
    errs = []
    for keys in (split, params):
        want = _update(sd0, one, keys)
        errs.append(float((_update(sd0, tp, keys) - want).norm()
                          / want.norm()))
    return errs


def test_tp_gradients_match_one_process(tp_step):
    """In f64 (the model's ``dtype``, BN summing in f64) against one
    process in f64: 1e-4.  In f32 the step's gradient is ill-conditioned
    at this random init: one process with each microbatch's rows reversed
    moves it by 2.2 % relative L2 (measured here), so f32 is held to
    ``F32_GRAD_REL_L2`` only, which a gradient twice too large or one
    rank's input share lost (O(1) off) would still fail."""
    sd0 = tp_step["sd0"]
    for err in _grad_errors(sd0, tp_step["tp64"], tp_step["one64"]):
        assert err <= GRAD_REL_L2, err
    for err in _grad_errors(sd0, tp_step["tp"], tp_step["one"]):
        assert err <= F32_GRAD_REL_L2, err
    # the statistics after the step agree too
    for k in sd0:
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(tp_step["tp"][k], tp_step["one"][k],
                                       rtol=1e-4, atol=1e-5)


def test_tp_state_is_split_and_gathers_whole(tp_step):
    ranks = tp_step["ranks"]
    full = tuple(tp_step["sd0"]["ConvBN_13.Conv_0.weight"].shape)
    assert full[0] == 1024
    for r in ranks:
        assert r["conv13"] == (full[0] // 2, *full[1:])
    assert len({r["hash"] for r in ranks}) == 1
    assert len({r["hash64"] for r in ranks}) == 1
    for r in ranks:
        assert r["restored_equal"] and r["restored_keys"] > 200


# --- 2, 3: the rule and the layout -----------------------------------------


@functools.lru_cache(maxsize=None)
def jax_yolov2_shapes(classes: int):
    import jax
    import jax.numpy as jnp

    from objectdetectionpl_tpu.models import build_model as jax_build

    jm = jax_build("YOLOv2", classes)
    x = jnp.zeros((1, S, S, 3), jnp.float32)
    return jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x,
                                          train=False))


@functools.lru_cache(maxsize=None)
def port_yolov2(classes: int):
    return build_model("YOLOv2", classes, device="cpu")


@pytest.mark.parametrize("classes,model", [(3, 2), (3, 4), (80, 2), (80, 3)])
def test_shardings_follow_jax_rule(classes, model):
    import jax
    from jax.sharding import Mesh as JaxMesh

    from objectdetectionpl_tpu.parallel import model_parallel_shardings

    variables = jax_yolov2_shapes(classes)
    jmesh = JaxMesh(np.asarray(jax.devices()[:model]).reshape(1, model),
                    ("data", "model"))
    rule = model_parallel_shardings(jmesh, variables)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), variables)
    split_by_jax = jax.tree.map(lambda z, s: np.full(
        z.shape, "model" in tuple(s.spec), bool), zeros, rule)
    want = {k: bool(v.all()) for k, v in state_dict_from_flax_trees(
        split_by_jax).items()}
    got = mesh.model_parallel_shardings(mesh.Mesh(1, model),
                                        port_yolov2(classes))
    assert set(got) == set(want)
    assert {k for k, d in got.items() if d == 0} == {
        k for k, v in want.items() if v}
    assert (got["Conv_0.weight"] is None) == (classes == 80 or model == 3)
    if model == 4:
        assert got["ConvBN_0.Conv_0.weight"] == 0       # 32 channels


def state_dict_from_flax_trees(variables) -> dict:
    """A flax variables tree of per-element flags -> port keys (flags
    transposed like their arrays)."""
    sd = state_dict_from_flax(variables["params"],
                              variables.get("batch_stats", {}))
    return {k: v.bool() for k, v in sd.items()}


def test_ranks_sit_at_row_major_coords(tp_step):
    for r, res in enumerate(tp_step["ranks"]):
        assert res["coords"] == mesh.coords(mesh.Mesh(*TP), r) == \
            (r // TP[1], r % TP[1])
        assert res["shard"] == (TP[0], r // TP[1])


# --- 4: the Trainer on (1, 2) ----------------------------------------------


def test_trainer_on_a_model_axis_replicates(tmp_path):
    ranks = run_ranks("trainer", tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)            # the ranks' threads: their sums
    try:
        _, want = trainer_fit(str(tmp_path / "one"), (1, 1))
    finally:
        torch.set_num_threads(threads)
    for r in ranks:
        assert r["mesh"] == (1, 2) and r["shard"] == (1, 0)
        assert r["replicated"]          # nothing split
        assert r["hash"] == want
        assert r["steps"] == [0]


# --- 5: make_mesh's checks ----------------------------------------------------


def test_make_mesh_refuses_other_world_sizes():
    for shape, match in (((2, 1), "needs 2 ranks"), ((1, 2), "needs 2 ranks"),
                         ((2, 2), "needs 4 ranks"), ((1, 0), "at least 1"),
                         ((1,), "expected"), ((1, 1, 1), "expected")):
        with pytest.raises(ValueError, match=match):
            mesh.make_mesh(shape)
    assert mesh.make_mesh(None) == (1, 1)
    assert mesh.make_mesh((1, 1)) == (1, 1)


if __name__ == "__main__":
    _worker_main(sys.argv[1], sys.argv[2])
