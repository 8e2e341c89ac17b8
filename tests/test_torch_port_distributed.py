"""Data-parallel training of the port (``objectdetectionpl_tpu_torch/parallel/``) over gloo on the CPU.

Each case starts two ranks as processes of this file
(``parallel/dryrun.py::spawn``: torchrun's environment, a free localhost
port), which import torch, numpy and the port only, and holds what they
report against one process on the concatenation of their shards in rank
order: the port at world size 1, or the JAX package.

1. BatchNorm in train mode, 2 ranks of 2 images against 1 process of 4,
   plain and under ``remat``: outputs and input gradients (rows), weight
   and bias gradients (summed over the ranks), running statistics (every
   rank): f32, rtol 1e-5, atol 1e-6.
2. The six families' losses on drawn head maps (64 px, 3 classes),
   targets split unevenly -- 5 boxes on rank 0 (3 + 2), 1 on rank 1
   (1 + 0) -- the case a per-rank normaliser gets wrong: the ranks' losses
   and metrics add up to the concatenated batch's (rtol 1e-5, atol 1e-6),
   their map gradients are its rows (rtol 1e-5, atol 1e-6 of the largest).
3. One train step, 2 ranks each on its Loader shard (Synthetic, 1 image a
   microbatch), accumulation 2, Adam, against the JAX package's
   single-process ``make_train_step`` on the concatenated batch, YOLOv2
   and YOLOv5s at 64 px from the same drawn flax variables: loss, every
   metric and the post-step parameter norm at rtol 1e-4 (as
   ``tests/test_distributed_2proc.py`` holds JAX's own processes); the
   gradient through Adam's first moment (every 97th element) within 0.03
   relative L2, ``test_torch_port_train.py``'s bound for one process.
4. ``mosaic_batch`` then ``augment_batch`` (the warp), 2 ranks of 3
   images, so that mosaic's partners cross the rank boundary, against 1
   process of 6 drawing from a generator of the same seed, four calls
   (SSR probability 0.2 and 0.45): images, boxes, labels and mask equal
   bit for bit.
5. ``cli.run`` on 2 ranks (Synthetic, YOLOv5s at 64 px, 2 epochs, early
   stopping after one epoch without gain, test on): equal weights on both
   ranks at the end, the same checkpoint book and step count; only rank 0
   created or wrote a file under the log directory (an audit hook on
   ``open``, ``os.mkdir``, ``os.rename``, ``os.remove`` and
   ``shutil.rmtree``); the mAP table printed once.
6. The tuner on 2 ranks, inside case 5's ``cli.run`` (``tune`` on, the
   sweep cut to 4 steps and the scaling to 2 trials): the same
   suggestions on both ranks, the same ``[tune]`` lines.  And its memory
   probe steps each rank alone: with rank 1 out of memory at a batch of 4
   after its forward (a loss that raises) and rank 0 stepping in full,
   both ranks find that 2 fits and 4 does not.
7. Each kernel wrapper launches inside ``torch.cuda.device`` of its
   tensors (a monkeypatched launch reads it); one card cannot show a
   second device, so this is read on the CPU.

About 90 s on one worker here (case 3's JAX compiles take most of it).
"""

import hashlib
import math
import os
import sys

import numpy as np
import pytest
import torch

from objectdetectionpl_tpu_torch.config import Config
from objectdetectionpl_tpu_torch.data.augment import (AugmentConfig,
                                                      augment_batch,
                                                      mosaic_batch)
from objectdetectionpl_tpu_torch.nn import blocks
from objectdetectionpl_tpu_torch.ops import anchors as anchor_lib
from objectdetectionpl_tpu_torch.ops import losses
from objectdetectionpl_tpu_torch.ops.cuda import (conv_kernel, nms_kernel,
                                                  warp_kernel)
from objectdetectionpl_tpu_torch.parallel import distributed
from objectdetectionpl_tpu_torch.parallel.dryrun import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs", "config.yaml")
RANKS = 2
C, IMG = 3, 64
TIGHT = dict(rtol=1e-5, atol=1e-6)
STEP_RTOL = 1e-4


def _rows(t, rank, b):
    return t[rank * b:(rank + 1) * b]


# --- the ranks: run as `python this_file.py CASE OUT_DIR` --------------------


def bn_inputs():
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 5, 6, 6) * 2 + 1).astype(np.float32)      # NCHW
    r = rng.randn(*x.shape).astype(np.float32)
    sd = {"weight": rng.uniform(0.5, 1.5, 5), "bias": rng.normal(0, .1, 5),
          "running_mean": rng.normal(0, .1, 5),
          "running_var": rng.uniform(.5, 2., 5)}
    return x, r, {k: torch.tensor(v, dtype=torch.float32)
                  for k, v in sd.items()}


def bn_run(x, r, sd, remat: bool) -> dict:
    bn = blocks.BatchNorm(5)
    bn.load_state_dict(sd)
    bn.train()
    xt = torch.from_numpy(x).requires_grad_()
    y = blocks.remat(bn, xt) if remat else bn(xt)
    (y * torch.from_numpy(r)).sum().backward()
    return {"y": y.detach(), "dx": xt.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "mean": bn.running_mean.clone(),
            "var": bn.running_var.clone()}


LOSS_FAMILIES = ("YOLOv2", "YOLOv3", "YOLOv4", "YOLOv5", "SSD", "RetinaNet")
LOSS_COUNTS = (3, 2, 1, 0)          # boxes an image: 5 on rank 0, 1 on rank 1


def loss_inputs(name: str):
    """Drawn head maps of the 4-image global batch and its targets."""
    rng = np.random.RandomState(LOSS_FAMILIES.index(name))
    B, M = len(LOSS_COUNTS), 4
    if name == "YOLOv5":
        maps = [rng.randn(B, 3, g, g, 5 + C) for g in (8, 4, 2)]
    elif name in ("YOLOv2", "YOLOv3", "YOLOv4"):
        A = 5 if name == "YOLOv2" else 3
        grids = {"YOLOv2": (2,), "YOLOv3": (2, 4, 8),
                 "YOLOv4": (8, 4, 2)}[name]
        maps = [rng.randn(B, A * (5 + C), g, g) for g in grids]
    else:
        D = (len(anchor_lib.ssd_dboxes()) if name == "SSD"
             else len(anchor_lib.retina_anchors(IMG)))
        maps = [rng.randn(B, D, 4) * 0.5,
                rng.randn(B, D, C + (name == "SSD"))]
    labels = rng.randint(0, C, (B, M)).astype(np.int32)
    boxes = np.concatenate([rng.uniform(0.25, 0.75, (B, M, 2)),
                            rng.uniform(0.15, 0.5, (B, M, 2))], -1)
    mask = np.arange(M)[None] < np.asarray(LOSS_COUNTS)[:, None]
    return ([m.astype(np.float32) for m in maps], labels,
            boxes.astype(np.float32), mask)


def loss_run(name: str, rank: int, world: int) -> dict:
    """This rank's loss share and map gradients inside a train step's
    global batch."""
    maps, labels, boxes, mask = loss_inputs(name)
    b = len(LOSS_COUNTS) // world
    maps = [torch.from_numpy(_rows(m, rank, b)).requires_grad_()
            for m in maps]
    fn = losses.make_loss(name, C, IMG)
    with distributed.global_batch():
        metrics = fn(maps[0] if name == "YOLOv2" else maps,
                     *(torch.from_numpy(_rows(a, rank, b))
                       for a in (labels, boxes, mask)))
        metrics["loss"].backward()
    return {"metrics": {k: float(v.detach()) for k, v in metrics.items()},
            "grads": [m.grad for m in maps]}


AUG_CONFIGS = (AugmentConfig(), AugmentConfig(p_ssr=0.45, p_hflip=0.5),
               AugmentConfig(), AugmentConfig(p_ssr=0.45, p_vflip=0.5))


def augment_run(rank: int, world: int) -> list:
    """mosaic + augment of this rank's rows of a 6-image batch, four calls
    from one generator."""
    g = torch.Generator().manual_seed(1)
    B, S, M = 6, 32, 4
    images = torch.rand(B, S, S, 3, generator=g)
    boxes = torch.cat([0.3 + 0.4 * torch.rand(B, M, 2, generator=g),
                       0.1 + 0.3 * torch.rand(B, M, 2, generator=g)], -1)
    labels = torch.randint(0, C, (B, M), generator=g, dtype=torch.int32)
    mask = torch.rand(B, M, generator=g) < 0.7
    b = B // world
    local = [_rows(t, rank, b) for t in (images, boxes, labels, mask)]
    gen = torch.Generator().manual_seed(5)
    out = []
    for cfg in AUG_CONFIGS:
        im, bx, lb, mk = mosaic_batch(*local, p=0.7, generator=gen)
        im, bx, mk = augment_batch(im.contiguous(), bx, mk, cfg=cfg,
                                   generator=gen)
        out.append([im, bx, lb, mk])
    return out


def probe_run(rank: int) -> dict:
    """``batch_fits`` at 2 and 4 on a YOLOv2 Trainer's parts, rank 1 out
    of memory at 4 once its forward ran; rank 0's peaks."""
    from types import SimpleNamespace

    from objectdetectionpl_tpu_torch.models import build_model
    from objectdetectionpl_tpu_torch.train import tune
    from objectdetectionpl_tpu_torch.train.optim import build_optimizer

    cfg = Config(model_name="YOLOv2", img_size=IMG)
    model = build_model("YOLOv2", C, device="cpu")
    loss_fn = losses.make_loss("YOLOv2", C, IMG)

    def short_of_memory(out, labels, *rest):
        if rank == 1 and labels.shape[0] >= 4:
            raise MemoryError()
        return loss_fn(out, labels, *rest)

    trainer = SimpleNamespace(
        cfg=cfg, model=model, img_size=IMG, device=torch.device("cpu"),
        optimizer=build_optimizer(cfg, model.parameters()),
        loss_fn=short_of_memory)
    tune._device_bytes_limit = lambda device: float("inf")
    return {"fits": [tune.batch_fits(trainer, bs) for bs in (2, 4)],
            "peaks": [tune.probe_batch_size(trainer, bs) for bs in (2, 4)]}


def _worker_small(out: str, rank: int) -> dict:
    x, r, sd = bn_inputs()
    return {"bn": {remat: bn_run(_rows(x, rank, 2), _rows(r, rank, 2), sd,
                                 remat) for remat in (False, True)},
            "loss": {name: loss_run(name, rank, RANKS)
                     for name in LOSS_FAMILIES},
            "augment": augment_run(rank, RANKS),
            "probe": probe_run(rank)}


STEP_FAMILIES = ("YOLOv2", "YOLOv5")
LR, WD = 1e-3, 1e-5


def _worker_step(out: str, rank: int) -> dict:
    from objectdetectionpl_tpu_torch.data.pipeline import Loader
    from objectdetectionpl_tpu_torch.data.synthetic import SyntheticParser
    from objectdetectionpl_tpu_torch.models import build_model
    from objectdetectionpl_tpu_torch.train.optim import build_optimizer
    from objectdetectionpl_tpu_torch.train.state import create_train_state
    from objectdetectionpl_tpu_torch.train.step import make_train_step

    res = {}
    for name in STEP_FAMILIES:
        model = build_model(name, C, device="cpu")
        model.load_state_dict(torch.load(os.path.join(out, f"{name}.pt")),
                              strict=True)
        opt = build_optimizer(Config(lr=LR, weight_decay=WD),
                              model.parameters())
        state = create_train_state(model, opt)
        distributed.broadcast_state(state)
        shard = Loader(SyntheticParser(8, img_hw=IMG), img_size=IMG,
                       batch_size=1, max_boxes=8, shuffle=False,
                       num_shards=RANKS, shard_id=rank)
        it = iter(shard)
        micro = [next(it) for _ in range(2)]
        batch = [torch.from_numpy(np.stack([m[i] for m in micro]))
                 for i in range(4)]
        step = make_train_step(model, losses.make_loss(name, C, IMG), opt,
                               accum_steps=2)
        state, metrics = step(state, *batch)
        pnorm = math.sqrt(sum(float(p.detach().double().square().sum())
                              for p in model.parameters()))
        mu = {n: opt.state[p]["exp_avg"] for n, p in model.named_parameters()}
        res[name] = {"metrics": {k: float(v) for k, v in metrics.items()},
                     "pnorm": pnorm, "mu": _mu_sample(mu),
                     "batch": [t.numpy() for t in batch]}
    return res


def _mu_sample(mu: dict) -> np.ndarray:
    """Every 97th element of Adam's first moment, tensors in name order:
    0.1 * (summed gradient + wd * p) after the first step, on both sides."""
    return np.concatenate([np.asarray(mu[k]).ravel()[::97]
                           for k in sorted(mu)])


def _state_hash(model) -> str:
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _worker_cli(out: str, rank: int) -> dict:
    """``cli.run.main`` joins the group itself; the tuner runs inside it,
    its sweep and trials shortened."""
    from objectdetectionpl_tpu_torch.cli import run as cli_run
    from objectdetectionpl_tpu_torch.train import loop, tune

    found = {}
    lr_find, scale = tune.auto_lr_find, tune.auto_scale_batch_size
    tune.auto_lr_find = lambda trainer: found.setdefault(
        "lr", lr_find(trainer, num_steps=4))
    tune.auto_scale_batch_size = lambda trainer, start: found.setdefault(
        "batch_size", scale(trainer, start=start, max_trials=2))

    # every file event under the log_dir
    log_dir = os.path.join(out, "run")
    events = []

    def audit(event, args):
        if event in ("open", "os.mkdir", "os.rename", "os.remove",
                     "shutil.rmtree"):
            path = args[0]
            if not isinstance(path, (str, bytes, os.PathLike)):
                return
            path = os.path.abspath(os.fsdecode(path))
            if not path.startswith(log_dir):
                return
            if event == "open":
                mode, flags = args[1], args[2]
                writes = (any(c in str(mode or "") for c in "wax+")
                          or flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT))
                if not writes:
                    return
            events.append([event, path])

    sys.addaudithook(audit)
    fit, seen = loop.Trainer.fit, {}

    def fit_and_keep(self):
        seen["trainer"] = self
        return fit(self)

    loop.Trainer.fit = fit_and_keep
    results = cli_run.main([YAML, "--device", "cpu", "--set", "model_name",
                            "YOLOv5", "--set", "img_size", str(IMG),
                            "--set", "log_dir", log_dir,
                            "--set", "early_stop_patience", "1",
                            "--set", "tune", "true"])
    t = seen["trainer"]
    return {**found, "events": events, "hash": _state_hash(t.model),
            "steps": t.ckpt.steps(), "global_step": t.global_step,
            "mesh": tuple(t.mesh), "mAP": results["mAP"]}


WORKERS = {"small": _worker_small, "step": _worker_step}


def _worker_main(case: str, out: str) -> None:
    torch.set_num_threads(2)
    rank = int(os.environ["RANK"])
    if case == "cli":
        res = _worker_cli(out, rank)
    else:
        distributed.maybe_initialize("gloo")
        try:
            res = WORKERS[case](out, rank)
        finally:
            distributed.shutdown()
    torch.save(res, os.path.join(out, f"{case}_{rank}.pt"))


def run_ranks(case: str, out):
    """The ranks' results of ``case`` and their standard outputs."""
    outs = spawn([os.path.abspath(__file__), case, str(out)], RANKS, 600.0,
                 env={"OMP_NUM_THREADS": "2"})
    return [torch.load(os.path.join(out, f"{case}_{r}.pt"),
                       weights_only=False) for r in range(RANKS)], outs


# --- 1, 2, 4: BatchNorm, the losses, the augmentation ---------------------


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return run_ranks("small", tmp_path_factory.mktemp("small"))[0]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_batchnorm_two_ranks_match_one_process(small, remat):
    x, r, sd = bn_inputs()
    want = bn_run(x, r, sd, remat)
    got = [s["bn"][remat] for s in small]
    for key in ("y", "dx"):
        _close(torch.cat([g[key] for g in got]), want[key], **TIGHT)
    for key in ("dw", "db"):
        _close(sum(g[key] for g in got), want[key], **TIGHT)
    for g in got:                  # moved once, from the global moments
        for key in ("mean", "var"):
            _close(g[key], want[key], **TIGHT)
    assert not torch.allclose(want["mean"], sd["running_mean"])


@pytest.mark.parametrize("name", LOSS_FAMILIES)
def test_loss_shares_add_up_to_the_global_batch(small, name):
    want = loss_run(name, 0, 1)
    got = [s["loss"][name] for s in small]
    assert set(got[0]["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        assert math.isfinite(v)
        _close(sum(g["metrics"][k] for g in got), v, **TIGHT)
    for i, ref in enumerate(want["grads"]):
        cat = torch.cat([g["grads"][i] for g in got])
        _close(cat, ref, rtol=1e-5, atol=1e-6 * float(ref.abs().max()))
    # a per-rank normaliser would not add up: the shares differ from each
    # rank's own mean
    mean_alone = [loss_run_alone(name, r) for r in range(RANKS)]
    assert not np.isclose(sum(mean_alone), want["metrics"]["loss"],
                          rtol=1e-3)


def loss_run_alone(name: str, rank: int) -> float:
    """Rank ``rank``'s rows as a batch of their own (no group)."""
    maps, labels, boxes, mask = loss_inputs(name)
    b = len(LOSS_COUNTS) // RANKS
    maps = [torch.from_numpy(_rows(m, rank, b)) for m in maps]
    fn = losses.make_loss(name, C, IMG)
    return float(fn(maps[0] if name == "YOLOv2" else maps,
                    *(torch.from_numpy(_rows(a, rank, b))
                      for a in (labels, boxes, mask)))["loss"])


def test_mosaic_and_warp_draws_cross_ranks(small):
    want = augment_run(0, 1)
    for call, ref in enumerate(want):
        for i, field in enumerate(("images", "boxes", "labels", "mask")):
            got = torch.cat([s["augment"][call][i] for s in small])
            assert torch.equal(got, ref[i]), (call, field)
    # the draws mixed and warped something: not the inputs unchanged
    assert any(not torch.equal(w[0], want[0][0]) for w in want[1:])


# --- 3: one train step against JAX ------------------------------------------


@pytest.fixture(scope="module")
def step_vs_jax(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from objectdetectionpl_tpu.config import Config as JaxConfig
    from objectdetectionpl_tpu.models import build_model as jax_build
    from objectdetectionpl_tpu.ops import losses as jax_losses
    from objectdetectionpl_tpu.train import optim as jax_optim
    from objectdetectionpl_tpu.train import step as jax_step
    from objectdetectionpl_tpu_torch.utils.weights import state_dict_from_flax
    from test_torch_port_blocks import randomized_variables
    from test_torch_port_train import (_adam_moments, _as_port, _jax_state,
                                       _zero_mean_kernels)

    out = tmp_path_factory.mktemp("step")
    variables = {}
    for seed, name in enumerate(STEP_FAMILIES):
        model = jax_build(name, C, yolov5_type="Yolov5s")
        params, stats = randomized_variables(
            model, np.zeros((1, IMG, IMG, 3), np.float32), seed=seed,
            jit=True)
        params = _zero_mean_kernels(params)
        variables[name] = (model, params, stats)
        torch.save(state_dict_from_flax(params, stats),
                   os.path.join(out, f"{name}.pt"))
    ranks, _ = run_ranks("step", out)

    tx = jax_optim.build_optimizer(JaxConfig(optimizer="Adam", lr=LR,
                                             weight_decay=WD))
    res = {}
    for name in STEP_FAMILIES:
        model, params, stats = variables[name]
        step = jax_step.make_train_step(
            model, jax_losses.make_loss(name, C, IMG), tx, accum_steps=2)
        batch = [jnp.asarray(np.concatenate([r[name]["batch"][i]
                                             for r in ranks], axis=1))
                 for i in range(4)]
        st, metrics = step(_jax_state(params, stats, tx), *batch)
        pnorm = math.sqrt(sum(float(np.square(np.asarray(
            x, np.float64)).sum()) for x in jax.tree.leaves(st.params)))
        mu = _as_port(_adam_moments(st.opt_state)[0], {})
        res[name] = {"jax": {"metrics": {k: float(v)
                                         for k, v in metrics.items()},
                             "pnorm": pnorm, "mu": _mu_sample(mu)},
                     "ranks": [r[name] for r in ranks]}
    return res


@pytest.mark.parametrize("name", STEP_FAMILIES)
def test_train_step_two_ranks_match_jax_global_batch(step_vs_jax, name):
    ref = step_vs_jax[name]["jax"]
    ranks = step_vs_jax[name]["ranks"]
    # the shards are different images: the ranks' batches differ
    assert not np.array_equal(ranks[0]["batch"][0], ranks[1]["batch"][0])
    for r in ranks:
        assert set(r["metrics"]) == set(ref["metrics"])
        for k, v in ref["metrics"].items():
            assert r["metrics"][k] == pytest.approx(v, rel=STEP_RTOL), k
        assert r["pnorm"] == pytest.approx(ref["pnorm"], rel=STEP_RTOL)
        # the summed gradient, through Adam's first moment: as ill-
        # conditioned in f32 as test_torch_port_train.py's single-process
        # step (BN's x*a + b), held to that file's overall bound; a lost
        # or halved reduction is off by 0.5
        err = np.linalg.norm(r["mu"] - ref["mu"]) / np.linalg.norm(ref["mu"])
        assert err <= 0.03, err
    # every rank holds the same global numbers and the same weights
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert ranks[0]["pnorm"] == ranks[1]["pnorm"]


# --- 5, 6: cli.run and the tuner ------------------------------------------


@pytest.fixture(scope="module")
def cli_ranks(tmp_path_factory):
    return run_ranks("cli", tmp_path_factory.mktemp("cli"))


def test_cli_run_two_ranks(cli_ranks):
    ranks, outs = cli_ranks
    r0, r1 = ranks
    assert r0["hash"] == r1["hash"]
    assert r0["steps"] == r1["steps"] and r0["steps"]
    assert r0["global_step"] == r1["global_step"] > 0
    assert r0["mesh"] == r1["mesh"] == (RANKS, 1)     # all ranks on 'data'
    assert r0["mAP"] == r1["mAP"] and math.isfinite(r0["mAP"])
    assert r1["events"] == []
    written = {os.path.basename(p) for _, p in r0["events"]}
    assert {"metrics.jsonl", "summary.txt", "metrics.json",
            "best_model_path.txt"} <= written
    # each checkpoint went into place by a rename (torch.save's own write
    # of state.pt is not an audited open)
    assert sum(e == "os.rename" for e, _ in r0["events"]) >= len(r0["steps"])
    assert sum(line.startswith("mAP:") for out in outs
               for line in out.splitlines()) == 1
    assert sum("[run] distributed: process" in out for out in outs) == 2


def test_tuner_two_ranks_agree(cli_ranks):
    (r0, r1), outs = cli_ranks
    assert r0["lr"] == r1["lr"] and 1e-7 <= r0["lr"] <= 1.0
    assert r0["batch_size"] == r1["batch_size"] >= 2
    lines = [sorted(line for line in out.splitlines()
                    if line.startswith("[tune]")) for out in outs]
    assert lines[0] == lines[1] and len(lines[0]) == 2


def test_tuner_probe_steps_each_rank_alone(small):
    (r0, r1) = (s["probe"] for s in small)
    assert r0["fits"] == r1["fits"] == [True, False]
    assert 0 < r0["peaks"][0] < r0["peaks"][1]
    assert r1["peaks"][1] is None and r1["peaks"][0] > 0


# --- 7: the launches run on their tensors' card -----------------------------


class _Guard:
    """``torch.cuda.device`` stand-in: records the devices entered."""
    inside = None
    entered = []

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        _Guard.inside = self.device
        _Guard.entered.append(self.device)

    def __exit__(self, *exc):
        _Guard.inside = None


class _Lib:
    """A kernel library whose every launch records the current device."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            if name == "greedy_nms_max_k":
                return 1024
            self.calls.append((name, _Guard.inside))
            return 0
        return call


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("wrapper", ["warp", "nms", "conv", "conv_wgrad"])
def test_launch_runs_under_the_tensors_device(monkeypatch, wrapper):
    """The launch helpers, on CPU tensors, with a library whose launches
    record the device that ``torch.cuda.device`` made current."""
    lib = _Lib()
    _Guard.entered = []
    monkeypatch.setattr(torch.cuda, "device", _Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    x = torch.zeros(2, 8, 8, 4)
    if wrapper == "warp":
        monkeypatch.setattr(warp_kernel, "_lib", lambda: lib)
        warp_kernel._launch(x, torch.arange(2), torch.eye(3).repeat(2, 1, 1),
                            torch.ones(2, dtype=torch.bool))
    elif wrapper == "nms":
        monkeypatch.setattr(nms_kernel, "_lib", lambda: lib)
        nms_kernel._greedy_nms_cuda(
            torch.zeros(2, 5, 4), torch.zeros(2, 5),
            torch.zeros(2, 5, dtype=torch.int32), torch.zeros(2, 5), 0.4,
            True, True, 1.0, False)
    else:
        monkeypatch.setattr(conv_kernel, "_lib", lambda: lib)
        monkeypatch.setattr(conv_kernel, "_sms", lambda index: 132)
        if wrapper == "conv":
            conv_kernel._fwd_launch(x, torch.zeros(3, 3, 4, 8))
        else:
            conv_kernel._wgrad_launch(x, torch.zeros(2, 8, 8, 8))
    want = {"warp": 1, "nms": 1, "conv": 1, "conv_wgrad": 2}[wrapper]
    assert len(lib.calls) == want, lib.calls
    assert all(dev == x.device for _, dev in lib.calls), lib.calls
    assert _Guard.entered == [x.device]


if __name__ == "__main__":
    _worker_main(sys.argv[1], sys.argv[2])
