"""The run of ``serve`` traffic: a closed loop of batched
offline inference through the port's ``make_predict_step``.

Set-up draws the weights once, in float32 with TF32 off, and keeps them
on the host for the check; it builds the serving model (bf16, the /255
folded into the stem, so that uint8 batches go in as they are), draws
the pool of batches into pinned host memory and runs the warm-up
batches through the window's own loop.  In the window each batch is uploaded on a stream of
its own, run through ``predict_step`` over ``make_postprocess`` at the
traffic's thresholds, and its ``NMSResult`` copied back to pinned host
memory; at most ``in_flight`` batches are outstanding.  A batch's
latency runs from its dispatch to its detections on the host.

Correctness, after the window and with the program freed: on batches
drawn from the seed among the window's first ``from_first``, (1) the
head maps the window's forward produced against the float32 reference's
forward of the same images (relative RMS error, the worst map), and (2)
the window's detections against the reference's decode, ranking and NMS
of those same maps (rows that differ; the largest box difference).
"""

from __future__ import annotations

import collections
import time

import torch

from perfbench.harness import common, manifest, seeds, traffic, weights
from perfbench.harness import trace as trace_lib


def serving_weights(reference, cfg: dict, tr: dict, seed: int, device):
    """The weights of a serving cell, drawn from the seed (and, where the
    configuration asks, rescaled on images of the seed)."""
    w = weights.draw(reference, cfg, seed, device)
    n = cfg["init"].get("eval_unit_variance_images")
    if n:
        S = cfg["model"]["img_size"]
        calib = traffic.image_pool(seeds.stream(seed, "calibration"), 1, n,
                                   S, device)[0].to(device)
        w = weights.unit_variance(reference, cfg, w, calib)
    return w


class ServeRun:
    """One run of a serving cell: ``setup``, ``window``, ``check``."""

    def __init__(self, cell: dict, seed: int, device, traced: bool):
        self.cfg, self.tr = cell["config"], cell["traffic"]
        self.seed, self.device, self.traced = seed, device, traced
        self.reference = manifest.reference(self.cfg)
        rng = seeds.numpy_rng(seed, "check")
        chk = self.tr["check"]
        self.sample = set(int(i) for i in rng.choice(
            chk["from_first"], chk["batches"], replace=False))
        self.captured = {}          # window batch -> head maps
        self.detections = {}        # window batch -> host NMSResult
        self.kept_counts = {}       # profiled batch -> detections kept
        self.index = None           # the window batch being dispatched
        self.profiling = False
        first = self.tr["check"]["from_first"]
        self.profiled = range(first, first + self.tr["profile_batches"])

    # -- set-up ---------------------------------------------------------

    def setup(self) -> None:
        from objectdetectionpl_tpu_torch.models import build_model
        from objectdetectionpl_tpu_torch.ops.cuda import nms_kernel
        from objectdetectionpl_tpu_torch.train.state import (
            create_train_state)
        from objectdetectionpl_tpu_torch.train.step import (
            make_postprocess, make_predict_step)
        from objectdetectionpl_tpu_torch.utils.fuse import (
            STEM_CONVS, fold_input_scale)
        cfg, tr, dev = self.cfg, self.tr, self.device
        m, port = cfg["model"], cfg["port"]
        self.nms_kernel = nms_kernel
        with common.float32_reference():
            w = serving_weights(self.reference, cfg, tr, self.seed, dev)
        self.weights = {k: v.cpu() for k, v in w.items()}
        model = build_model(port["model"], m["num_classes"],
                            dtype=getattr(torch, cfg["compute_dtype"]),
                            device=dev, **port["build"])
        model.load_state_dict(fold_input_scale(w, 1.0 / 255.0,
                                               STEM_CONVS[port["model"]]))
        del w
        post = make_postprocess(port["model"], m["num_classes"],
                                m["img_size"], conf_thres=tr["conf_thres"],
                                nms_thres=tr["nms_thres"], top_k=tr["top_k"])

        def postprocess(maps):
            i = self.index
            if i in self.sample:
                self.captured[i] = list(maps)
            if not self.profiling:
                return post(maps)
            with torch.profiler.record_function("postprocess"):
                return post(maps)

        self.model = model
        self.step = make_predict_step(model, postprocess)
        self.state = create_train_state(model)
        B, S = tr["batch"], m["img_size"]
        self.pool = traffic.image_pool(self.seed, tr["pool_batches"], B, S,
                                       dev)
        self.cuda = dev.type == "cuda"
        self.copy_stream = torch.cuda.Stream(dev) if self.cuda else None
        self.ring, self.ring_at = None, 0
        self.expected_launches = 1 if self.cuda else 0
        self.run_batches(tr["warmup_batches"], record=False)

    # -- the loop ---------------------------------------------------------

    def _host_buffers(self, res):
        pin = self.cuda
        return [torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                for t in res]

    def dispatch(self, i: int):
        """Upload window batch ``i``, run it, queue its copy back."""
        host_in = self.pool[i % len(self.pool)]
        t0 = time.perf_counter()
        if self.cuda:
            with torch.cuda.stream(self.copy_stream):
                dev_in = host_in.to(self.device, non_blocking=True)
            main = torch.cuda.current_stream(self.device)
            main.wait_stream(self.copy_stream)
            dev_in.record_stream(main)
        else:
            dev_in = host_in
        before = self.nms_kernel.LAUNCHES
        self.index = i
        t1 = time.perf_counter()
        res = self.step(self.state, dev_in)
        call_s = time.perf_counter() - t1
        launches = self.nms_kernel.LAUNCHES - before
        if self.ring is None:
            self.ring = [self._host_buffers(res)
                         for _ in range(self.tr["in_flight"] + 1)]
        slot = self.ring[self.ring_at]
        self.ring_at = (self.ring_at + 1) % len(self.ring)
        for dst, src in zip(slot, res):
            dst.copy_(src, non_blocking=self.cuda)
        done = None
        if self.cuda:
            done = torch.cuda.Event()
            done.record()
        return i, t0, done, slot, launches, call_s

    def complete(self, item) -> tuple:
        """Wait for a batch's detections; (latency s, failed?, call s)."""
        i, t0, done, slot, launches, call_s = item
        if done is not None:
            done.synchronize()
        latency = time.perf_counter() - t0
        if i in self.sample:
            self.detections[i] = [t.clone() for t in slot]
        if self.traced and i in self.profiled:
            self.kept_counts[i] = int(slot[4].sum())
        return latency, launches != self.expected_launches, call_s

    def run_batches(self, count: int, record: bool = True,
                    seconds: float = None, on_dispatch=None) -> dict:
        """``count`` batches, or as many as are dispatched in ``seconds``;
        returns the latencies, failures and host call times of all."""
        out = {"latency_s": [], "failed": 0, "call_s": [], "batches": 0}
        inflight = collections.deque()
        start = time.perf_counter()
        i = 0

        def finish(item):
            lat, bad, call = self.complete(item)
            out["latency_s"].append(lat)
            out["failed"] += int(bad)
            out["call_s"].append((item[0], call))

        while (i < count if seconds is None
               else time.perf_counter() - start < seconds):
            if on_dispatch is not None:
                on_dispatch(i, inflight, finish)
            inflight.append(self.dispatch(i if record else -1 - i))
            i += 1
            while len(inflight) >= self.tr["in_flight"]:
                finish(inflight.popleft())
        while inflight:
            finish(inflight.popleft())
        out["window_s"] = time.perf_counter() - start
        out["batches"] = i
        return out

    # -- the window -------------------------------------------------------

    def window(self, seconds: float) -> dict:
        prof, span = None, {}
        first, last = self.profiled.start, self.profiled.stop

        def on_dispatch(i, inflight, finish):
            nonlocal prof
            if not self.traced:
                return
            if i == first - 1:
                # started a batch early, so that the traced span opens on
                # the loop's steady state and not on the profiler's start
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.start()
            elif i == first:
                span["launches"] = self._nms_kernels()
                span["range"] = torch.profiler.record_function(
                    trace_lib.WINDOW)
                span["range"].__enter__()
                self.profiling = True
            elif i == last:
                while inflight:
                    finish(inflight.popleft())
                common.sync(self.device)
                span["range"].__exit__(None, None, None)
                self.profiling = False
                prof.stop()
                self.nms_kernels = self._nms_kernels() - span["launches"]

        out = self.run_batches(0, seconds=seconds, on_dispatch=on_dispatch)
        if self.profiling:
            raise RuntimeError(f"the window ended before batch {last}: "
                               f"nothing was traced whole")
        out["profile"] = prof
        out["profiled"] = self.profiled
        return out

    def _nms_kernels(self) -> int:
        """Kernels the NMS op has launched: one a call, two (partition
        and segments) a call of the K > 1024 route."""
        return self.nms_kernel.LAUNCHES + self.nms_kernel.TILED_LAUNCHES

    # -- after the window ---------------------------------------------------

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for name in ("step", "state", "model"):
            setattr(self, name, None)
        common.free(self.device)

    def check(self) -> dict:
        """The numbers compared (module docstring)."""
        from perfbench.reference import postprocess as ref_post
        cfg, tr, dev = self.cfg, self.tr, self.device
        missing = self.sample - set(self.captured) - set(self.detections)
        if missing or len(self.captured) != len(self.sample):
            return {}
        with common.float32_reference(), torch.no_grad():
            ref = self.reference.build(cfg).to(dev).eval()
            ref.load_state_dict(self.weights)
            heads, differ, box_err = 0.0, 0, 0.0
            for i in sorted(self.sample):
                images = self.pool[i % len(self.pool)].to(dev)
                want = self.reference.forward_blocks(
                    ref, images, tr["check"]["reference_rows"])
                got = self.captured[i]
                for g, r in zip(got, want):
                    heads = max(heads, float((g.float() - r).norm()
                                             / r.norm()))
                del want
                post = [t.cpu() for t in ref_post.yolo_nms(got, cfg, tr)]
                det = self.detections[i]
                both = det[4] & post[4]
                differ += int((det[4] != post[4]).sum())
                for k in (1, 2, 3):
                    differ += int((det[k][both] != post[k][both]).sum())
                if both.any():
                    box_err = max(box_err, float(
                        (det[0][both] - post[0][both]).abs().max()))
        return {"heads_rel_rms": heads, "post_rows_differ": float(differ),
                "post_box_err_px": box_err}

    def counts(self, out: dict) -> dict:
        """What the traced span did, for the per-layer readers.  The NMS
        bound counts each batch's kept rows as its valid rows and none as
        suppressed: a lower count of the operations, which at top-k 300
        stay under 3 % of the rows' bytes term even with every row valid
        and suppressed, so the bound is the bytes term exactly."""
        from perfbench.counts import flops
        K = self.tr["top_k"]
        nms = [{"rows": self.tr["batch"] * K, "valid": kept, "suppressed": 0}
               for i, kept in self.kept_counts.items() if i in out["profiled"]]
        return {"nms_batches": nms, "nms_kernels": self.nms_kernels,
                "flops_forward": flops.forward_flops(self.reference,
                                                     self.cfg)}


def end_to_end(out: dict, tr: dict, setup_s: float) -> dict:
    return {"serve_img_per_s": tr["batch"] * out["batches"] / out["window_s"],
            "serve_p95_ms": common.p95_ms(out["latency_s"]),
            "setup_s": setup_s}


def counts(run: ServeRun, out: dict) -> dict:
    return run.counts(out)


Run = ServeRun
