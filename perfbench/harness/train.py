"""The run of ``train`` traffic: the port's training step as the
Trainer runs it, upload -> /255 -> ``augment_batch`` -> ``train_step``.

Set-up draws the weights and builds the one training object (model,
Adam, ``make_train_step`` over ``make_loss``), draws the pools of images
(pinned host memory), targets and augmentation uniforms, and drives the
first ``checked_steps`` steps through the window's own call on pool
batches that all differ, keeping what the check compares: each step's
loss, each parameter's first gradient as Adam holds it after one step,
and each parameter's change after the last of them.  The window then
trains on from there with the same object.  A step's time runs from its
dispatch on the host to a CUDA event recorded after its update, read on
the host clock's scale from an event recorded when the window started.

Correctness, after the window and with the program freed: the float32
reference (forward, loss, backward and Adam, with the augmentation
replayed from the same uniforms) takes the same first steps from the
same weights.  Compared (``compare``): the first step's relative loss
gap, the median parameter's gap between the norms of the first
gradients, and the worst parameter's gap between the norms of the
changes, each gap over the larger of that parameter's reference norm
and the median parameter's.  The later steps' losses and the worst
parameter's first gradient are read by ``perfbench/calibrate.py`` and
not compared: after Adam's first step, whose update is about lr times
the sign of each gradient, they swing from seed to seed (``PERF.md``).
"""

from __future__ import annotations

import time
import types

import torch

from perfbench.harness import common, manifest, traffic, weights
from perfbench.harness import trace as trace_lib

TINY_GRAD = 1e-3     # leaves whose reference gradient is under this share
                     # of the median leaf's are left out of the change


@torch.no_grad()
def first_gradients(optimizer, beta1: float) -> torch.Tensor:
    """Each parameter's gradient norm as Adam got it on its first step,
    worked out from its first moment ``(1 - beta1) g``; 0 for a parameter
    that Adam holds no state for."""
    out = []
    for group in optimizer.param_groups:
        for p in group["params"]:
            m = optimizer.state.get(p, {}).get("exp_avg")
            out.append(torch.zeros((), device=p.device) if m is None
                       else (m / (1 - beta1)).norm())
    return torch.stack(out).cpu()


class TrainRun:
    """One run of a training cell: ``setup``, ``window``, ``check``."""

    def __init__(self, cell: dict, seed: int, device, traced: bool):
        self.cfg, self.tr = cell["config"], cell["traffic"]
        self.seed, self.device, self.traced = seed, device, traced
        self.reference = manifest.reference(self.cfg)
        self.profiling = False
        self.cuda = device.type == "cuda"

    # -- set-up ---------------------------------------------------------

    def setup(self) -> None:
        from objectdetectionpl_tpu_torch.data import augment
        from objectdetectionpl_tpu_torch.models import build_model
        from objectdetectionpl_tpu_torch.ops import losses
        from objectdetectionpl_tpu_torch.ops.cuda import warp_kernel
        from objectdetectionpl_tpu_torch.train.optim import build_optimizer
        from objectdetectionpl_tpu_torch.train.state import (
            create_train_state)
        from objectdetectionpl_tpu_torch.train.step import make_train_step
        cfg, tr, dev = self.cfg, self.tr, self.device
        m, port, opt = cfg["model"], cfg["port"], cfg["optimizer"]
        self.augment, self.warp_kernel = augment, warp_kernel
        self.aug_cfg = augment.AugmentConfig(**cfg["augment"])
        w = weights.draw(self.reference, cfg, self.seed, dev)
        model = build_model(port["model"], m["num_classes"],
                            dtype=getattr(torch, cfg["compute_dtype"]),
                            device=dev, **port["build"])
        model.load_state_dict(w)
        optimizer = build_optimizer(types.SimpleNamespace(
            optimizer=opt["name"], lr=opt["lr"],
            weight_decay=opt["weight_decay"], betas=tuple(opt["betas"]),
            momentum=0.0, alpha=0.0, lr_decay=0.0), model.parameters())
        if optimizer.defaults.get("eps", opt["eps"]) != opt["eps"]:
            raise ValueError("the port's Adam eps differs from the "
                             "configuration's")
        port_loss = losses.make_loss(port["model"], m["num_classes"],
                                     m["img_size"], **port["loss"])

        def loss_fn(*args):
            if not self.profiling:
                return port_loss(*args)
            with torch.profiler.record_function("loss"):
                return port_loss(*args)

        self.model, self.optimizer = model, optimizer
        self.step = make_train_step(model, loss_fn, optimizer)
        self.state = create_train_state(model, optimizer)
        n, B, S = tr["pool_batches"], tr["batch"], m["img_size"]
        self.pool = traffic.image_pool(self.seed, n, B, S, dev)
        labels, boxes, mask = traffic.targets(self.seed, n, B, S,
                                              tr["targets"], m["num_classes"])
        self.labels, self.boxes, self.mask = (labels.to(dev), boxes.to(dev),
                                              mask.to(dev))
        self.u = traffic.uniforms(self.seed, n, B, dev)
        self.copy_stream = torch.cuda.Stream(dev) if self.cuda else None
        self.expected_launches = 1 if self.cuda else 0
        self.failed_setup = 0

        names = [k for k, _ in model.named_parameters()]
        losses_seen, b1 = [], opt["betas"][0]
        for j in range(tr["checked_steps"]):
            metrics, bad = self.train_once(j)
            self.failed_setup += int(bad)
            losses_seen.append(metrics["loss"])
            if j == 0:
                self.first_grad = first_gradients(optimizer, b1)
        with torch.no_grad():
            self.change = torch.stack([(p - w[k]).norm() for k, p in
                                       model.named_parameters()]).cpu()
            self.losses = [float(v) for v in losses_seen]
        self.names = names
        del w

    def train_once(self, j: int):
        """Window step ``j``: pool batch ``j % n``; (metrics, failed?)."""
        bi = j % len(self.pool)
        host_in = self.pool[bi]
        if self.cuda:
            with torch.cuda.stream(self.copy_stream):
                dev_in = host_in.to(self.device, non_blocking=True)
            main = torch.cuda.current_stream(self.device)
            main.wait_stream(self.copy_stream)
            dev_in.record_stream(main)
        else:
            dev_in = host_in
        before = self.warp_kernel.LAUNCHES
        x = dev_in.float() / 255.0
        if self.profiling:
            with torch.profiler.record_function("augment"):
                x, bx, mk = self.augment.augment_batch(
                    x, self.boxes[bi], self.mask[bi], self.aug_cfg,
                    u=self.u[bi])
        else:
            x, bx, mk = self.augment.augment_batch(
                x, self.boxes[bi], self.mask[bi], self.aug_cfg, u=self.u[bi])
        self.state, metrics = self.step(self.state, x[None],
                                        self.labels[bi][None], bx[None],
                                        mk[None])
        bad = self.warp_kernel.LAUNCHES - before != self.expected_launches
        return metrics, bad

    # -- the window -------------------------------------------------------

    def window(self, seconds: float) -> dict:
        dev = self.device
        first = 3
        last = first + self.tr["profile_steps"]
        prof, span = None, None
        common.sync(dev)
        start_event = torch.cuda.Event(enable_timing=True) if self.cuda \
            else None
        t_start = time.perf_counter()
        if start_event is not None:
            start_event.record()
        dispatch, done, call_s, failed = [], [], [], 0
        j = 0
        while time.perf_counter() - t_start < seconds:
            step = self.tr["checked_steps"] + j
            if self.traced and j == first - 1:
                # started a step early, so that the traced span opens on
                # the loop's steady state and not on the profiler's start
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.start()
            elif self.traced and j == first:
                warps_before = self.warp_kernel.LAUNCHES
                span = torch.profiler.record_function(trace_lib.WINDOW)
                span.__enter__()
                self.profiling = True
            t0 = time.perf_counter()
            _, bad = self.train_once(step)
            t1 = time.perf_counter()
            failed += int(bad)
            if self.cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                done.append(ev)
            else:
                done.append(time.perf_counter())
            dispatch.append(t0 - t_start)
            call_s.append((j, t1 - t0))
            j += 1
            if self.traced and j == last:
                common.sync(dev)
                span.__exit__(None, None, None)
                self.profiling = False
                prof.stop()
                self.warp_kernels = self.warp_kernel.LAUNCHES - warps_before
        common.sync(dev)
        window_s = time.perf_counter() - t_start
        if self.profiling or (self.traced and span is None):
            raise RuntimeError(f"the window ended before step {last}: "
                               f"nothing was traced whole")
        if self.cuda:
            finish = [start_event.elapsed_time(e) / 1e3 for e in done]
        else:
            finish = [t - t_start for t in done]
        latency = [f - d for f, d in zip(finish, dispatch)]
        return {"steps": j, "window_s": window_s, "latency_s": latency,
                "failed": failed, "call_s": call_s, "profile": prof,
                "profiled": range(first, last)}

    # -- after the window ---------------------------------------------------

    def release(self) -> None:
        for name in ("step", "state", "model", "optimizer"):
            setattr(self, name, None)
        common.free(self.device)

    def reference_steps(self, numerics=None, rows=None) -> dict:
        """The reference's first steps from the seed's weights: losses,
        first gradient norms, change norms (per parameter, in the port's
        parameter order).  ``numerics`` and ``rows`` (a slice of the
        batch) give the control and a planted fault."""
        from perfbench.reference import augment as ref_aug
        from perfbench.reference.adam import Adam
        from perfbench.reference.layers import F32
        cfg, dev = self.cfg, self.device
        rows = slice(None) if rows is None else rows
        numerics = numerics or F32
        with common.float32_reference():
            w0 = weights.draw(self.reference, cfg, self.seed, dev)
            ref = self.reference.build(cfg, numerics).to(dev).train()
            ref.load_state_dict({k: numerics.store(v) for k, v in w0.items()})
            named = dict(ref.named_parameters())
            params = [named[k] for k in self.names]
            adam = Adam(params, cfg["optimizer"], numerics.store)
            out_losses = []
            for j in range(self.tr["checked_steps"]):
                bi = j % len(self.pool)
                x = self.pool[bi].to(dev).float() / 255.0
                x, bx, mk = ref_aug.augment(x, self.boxes[bi], self.mask[bi],
                                            self.u[bi], cfg["augment"])
                x = numerics.store(x)
                for p in params:
                    p.grad = None
                loss = self.reference.loss(ref(x[rows]),
                                           self.labels[bi][rows], bx[rows],
                                           mk[rows], cfg)
                loss.backward()
                adam.step()
                out_losses.append(float(loss.detach()))
            with torch.no_grad():
                first = torch.stack([g.norm() for g in
                                     adam.first_grads]).cpu()
                change = torch.stack([(p - w0[k]).norm() for k, p in
                                      zip(self.names, params)]).cpu()
        del ref, adam, w0, params, named
        common.free(dev)
        return {"losses": out_losses, "first_grad": first, "change": change}

    def program_readings(self) -> dict:
        return {"losses": self.losses, "first_grad": self.first_grad,
                "change": self.change}

    def check(self) -> dict:
        return compare(self.program_readings(), self.reference_steps())


def leaf_gaps(got: dict, want: dict, key: str) -> torch.Tensor:
    """Each parameter's gap of norms, ``|got - want|`` over the larger of
    its reference norm and the median parameter's."""
    w = want[key]
    return (got[key] - w).abs() / torch.maximum(w, w.median())


def moved(want: dict) -> torch.Tensor:
    """The parameters the change is compared on: those whose reference
    first gradient is at least ``TINY_GRAD`` of the median's."""
    return want["first_grad"] >= TINY_GRAD * want["first_grad"].median()


def compare(got: dict, want: dict) -> dict:
    """The numbers compared between two sets of readings: the first
    step's relative loss gap, the median parameter's gap of the first
    gradients, and the worst moved parameter's gap of the changes."""
    return {"loss_gap_first": abs(got["losses"][0] - want["losses"][0])
            / abs(want["losses"][0]),
            "grad_gap_median": float(leaf_gaps(got, want, "first_grad")
                                     .median()),
            "change_gap_worst": float(leaf_gaps(got, want, "change")
                                      [moved(want)].max())}


def end_to_end(out: dict, tr: dict, setup_s: float) -> dict:
    return {"train_img_per_s": tr["batch"] * out["steps"] / out["window_s"],
            "train_step_p95_ms": common.p95_ms(out["latency_s"]),
            "setup_s": setup_s}


def counts(run: TrainRun, out: dict) -> dict:
    """What the traced span did, for the per-layer readers: the warp
    plan of each profiled step (from the uniforms the benchmark drew) and
    the training FLOPs an image."""
    from perfbench.counts import flops
    from perfbench.reference import augment as ref_aug
    warps = []
    S = run.cfg["model"]["img_size"]
    for j in out["profiled"]:
        bi = (run.tr["checked_steps"] + j) % len(run.pool)
        top, applied, fwd = ref_aug.warp_plan(run.u[bi], run.cfg["augment"])
        inv = torch.linalg.inv(fwd[top][applied[top]])
        warps.append({"K": int(top.numel()), "H": S, "W": S, "C": 3,
                      "inv_used": inv})
    return {"warps": warps, "warp_kernels": run.warp_kernels,
            "flops_train": flops.train_flops(run.reference, run.cfg)}


Run = TrainRun
