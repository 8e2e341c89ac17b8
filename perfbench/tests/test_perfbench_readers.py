"""The trace reading and each per-layer metric reader on a synthetic
event list."""

import pytest
import torch

from perfbench.counts import nms_bound, peaks, warp_bound
from perfbench.harness import manifest
from perfbench.harness import trace as tr

# a 1000 us window; host ranges on thread 1; kernels on the card
TRACE = {
    "window": (0.0, 1000.0),
    "host": [
        (tr.WINDOW, 0.0, 1000.0, 1),
        ("postprocess", 100.0, 200.0, 1),
        ("aten::sigmoid", 110.0, 120.0, 1),
        ("postprocess", 600.0, 700.0, 1),
        ("aten::mul", 610.0, 620.0, 1),
        ("cudaEventSynchronize", 800.0, 990.0, 1),
    ],
    "device": [
        ("void conv_kernel", 0.0, 300.0, None, None),
        ("sigmoid_kernel", 300.0, 350.0, 110.0, 1),
        ("greedy_nms_kernel", 350.0, 360.0, 115.0, 1),
        ("mul_kernel", 650.0, 700.0, 610.0, 1),
        ("greedy_nms_kernel", 700.0, 712.0, 615.0, 1),
        ("void conv_kernel", 712.0, 800.0, 50.0, 1),
        ("Memcpy DtoH", 900.0, 950.0, None, None),
    ],
}


def test_busy_and_idle():
    assert tr.busy_s(TRACE) == pytest.approx((360 + 150 + 50) / 1e6)
    assert tr.window_s(TRACE) == pytest.approx(1e-3)
    gaps = dict(tr.idle_by_host(TRACE))
    # idle 360-650 (host in postprocess? no: last op started at 200 ends
    # before 360, so the window range), 800-900 and 950-1000 (sync)
    assert gaps["cudaEventSynchronize"] == pytest.approx(150 / 1e6)
    assert gaps[tr.WINDOW] == pytest.approx(290 / 1e6)


def test_range_device_time():
    seconds, count = tr.range_device_s(TRACE, "postprocess")
    assert count == 2
    assert seconds == pytest.approx((50 + 10 + 50 + 12) / 1e6)
    assert tr.range_device_s(TRACE, "loss") is None


def test_kernel_time_takes_the_last_launches():
    assert tr.kernel_s(TRACE, "greedy_nms", 2) == pytest.approx(22 / 1e6)
    assert tr.kernel_s(TRACE, "greedy_nms", 1) == pytest.approx(12 / 1e6)
    assert tr.kernel_s(TRACE, "greedy_nms", 0) == 0.0
    t = dict(TRACE, window=(355.0, 1000.0))      # the first runs half in
    assert tr.kernel_s(t, "greedy_nms", 5) == pytest.approx(22 / 1e6)


def test_top_device_ops():
    top = tr.top_device_ops(TRACE, 2)
    assert top[0][0] == "void conv_kernel"
    assert top[0][1] == pytest.approx(388 / 1e6)
    assert len(top) == 2


def ctx(kind="serve", **counts):
    rate = {"serve": {"serve_img_per_s": 2000.0},
            "train": {"train_img_per_s": 500.0}}[kind]
    return {"trace": TRACE, "counts": counts, "end_to_end": rate,
            "out": {"profiled": range(2, 4),
                    "call_s": [(0, 0.010), (1, 0.012), (2, 0.5), (3, 0.5)]}}


def test_idle_share_readers():
    # busy 0-360, 650-800 and 900-950 of the 1000 us span
    want = 100 * (1 - 560 / 1000)
    for name in ("idle_share.serve", "idle_share.train",
                 "idle_share.train.card_bound"):
        assert manifest.reader(name).read(ctx()) == pytest.approx(want)
    empty = dict(ctx(), trace=dict(TRACE, device=[]))
    assert manifest.reader("idle_share.serve").read(empty) is None


def test_range_readers():
    assert manifest.reader("postprocess_ms.serve").read(ctx()) == \
        pytest.approx(1e3 * 122e-6 / 2)
    assert manifest.reader("loss_ms.train").read(ctx("train")) is None


def test_dispatch_readers_leave_the_profiled_span_out():
    assert manifest.reader("dispatch_ms.serve").read(ctx()) == \
        pytest.approx(11.0)
    assert manifest.reader("dispatch_ms.train").read(ctx("train")) == \
        pytest.approx(11.0)


def test_nms_roofline():
    batches = [{"rows": 64 * 300, "valid": 8000, "suppressed": 300}] * 2
    got = manifest.reader("nms_roofline.serve").read(
        ctx(nms_batches=batches, nms_kernels=2))
    want = 100 * 2 * nms_bound.bound_s(64 * 300, 8000, 300) / 22e-6
    assert got == pytest.approx(want)
    assert manifest.reader("nms_roofline.serve").read(ctx()) is None


def test_warp_roofline():
    inv = torch.eye(3)[None].repeat(3, 1, 1)
    warps = [{"K": 13, "H": 600, "W": 600, "C": 3, "inv_used": inv}]
    t = dict(TRACE, device=TRACE["device"] + [
        ("affine_warp_slots_kernel", 720.0, 760.0, 620.0, 1)])
    c = dict(ctx("train", warps=warps, warp_kernels=1), trace=t)
    got = manifest.reader("warp_roofline.train").read(c)
    want = 100 * warp_bound.bound_s(13, 600, 600, 3, inv) / 40e-6
    assert got == pytest.approx(want)


def test_mfu_readers():
    got = manifest.reader("mfu.serve").read(ctx(flops_forward=16e9))
    assert got == pytest.approx(100 * 16e9 * 2000 / peaks.BF16_FLOPS)
    got = manifest.reader("mfu.train").read(ctx("train", flops_train=48e9))
    assert got == pytest.approx(100 * 48e9 * 500 / peaks.BF16_FLOPS)
    assert manifest.reader("mfu.train").read(ctx("train")) is None
    assert manifest.reader("mfu.train.card_bound").read(
        ctx("train", flops_train=48e9)) == pytest.approx(got)


def test_tail_readers():
    c = dict(ctx(), end_to_end={"serve_p95_ms": 53.5,
                                "train_step_p95_ms": 320.0})
    assert manifest.reader("serve_p95_ms").read(c) == 53.5
    assert manifest.reader("train_step_p95_ms.card_bound").read(c) == 320.0
    assert manifest.reader("serve_p95_ms").read(ctx("train")) is None
