"""A/B: the port's 3x3/s1 conv kernels against cuDNN, on the card.

The twin of ``tools/pallas_conv_bench.py`` (Pallas against XLA on a TPU).
One shape per run; it prints one JSON line:

  python -m objectdetectionpl_tpu_torch.tools.conv_bench --shape H,C,Co
      [--batch 128] [--iters 20] [--grad] [--impl both|cudnn|kernel]
      [--device cuda|cpu]

x [B, H, H, C] and w [3, 3, C, Co] are bf16, made from numpy seed 0 as the
JAX tool makes them.  The kernel side is ``conv3x3_s1`` (with ``--grad``, a
forward and backward through ``conv3x3_s1_op``, cotangent 1 as the JAX
tool's ``sum``).  The cuDNN side, a yardstick the port calls nowhere else,
is ``F.conv2d`` on channels-last views of the same tensors and, with
``--grad``, ``aten.convolution_backward`` for dx and dw.  Device time per
call comes from CUDA events over ``--iters`` calls queued behind a spin
kernel (``utils/timing.py``); ``tc_ms`` and ``hbm_ms`` are the H100 bounds
(989 TFLOP/s bf16 dense, 3.35 TB/s) of the passes timed, from
:func:`pass_bounds`, ``*_mfu_pct`` the share of the first.

``--device cpu`` runs the plain versions on the CPU for a check of the
tool itself: its host-clock times go to ``*_host_ms`` and every device
field is null.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from objectdetectionpl_tpu_torch.ops.cuda import conv_kernel
from objectdetectionpl_tpu_torch.utils.timing import (BF16_OPS_PER_S,
                                                     HBM_BYTES_PER_S, card,
                                                     time_ms)

PASSES = ("fwd", "dgrad", "wgrad")


def pass_bounds(B: int, H: int, W: int, C: int, Co: int) -> dict:
    """Per pass in bf16, (seconds at the tensor-core rate, seconds at HBM
    bandwidth): 2*9*C*Co flops per output pixel; the bytes of x and w read
    and y written (fwd; dgrad the same with C and Co swapped), or of x and
    dy read and an f32 dw written (wgrad), each once."""
    t_ops = 2.0 * B * H * W * 9 * C * Co / BF16_OPS_PER_S
    x, y, w = 2.0 * B * H * W * C, 2.0 * B * H * W * Co, 9.0 * C * Co
    return {part: (t_ops, nbytes / HBM_BYTES_PER_S) for part, nbytes in (
        ("fwd", x + y + 2 * w), ("dgrad", x + y + 2 * w),
        ("wgrad", x + y + 4 * w))}


def bound_ms(t_ops: float, t_bytes: float) -> tuple:
    """(the larger of the two times in ms, which of them it is)."""
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bounds_ms(B: int, H: int, W: int, C: int, Co: int, grad: bool) -> dict:
    """The tool's bounds: :func:`pass_bounds` summed over the forward (and,
    with ``grad``, dgrad and wgrad)."""
    parts = PASSES if grad else PASSES[:1]
    b = pass_bounds(B, H, W, C, Co)
    return {"flops": 2.0 * B * H * W * 9 * C * Co * len(parts),
            "tc_ms": sum(b[p][0] for p in parts) * 1e3,
            "hbm_ms": sum(b[p][1] for p in parts) * 1e3}


def kernel_step(x: torch.Tensor, w: torch.Tensor, gy=None):
    """One forward through the kernels; with ``gy``, the backward too:
    (y, dx, dw)."""
    if gy is None:
        return conv_kernel.conv3x3_s1(x, w), None, None
    xg, wg = x.detach().requires_grad_(), w.detach().requires_grad_()
    y = conv_kernel.conv3x3_s1_op(xg, wg)
    dx, dw = torch.autograd.grad(y, (xg, wg), gy)
    return y, dx, dw


def nchw(t: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as the NCHW view cuDNN reads channels-last."""
    return t.permute(0, 3, 1, 2)


def oihw(w: torch.Tensor) -> torch.Tensor:
    """HWIO weights as a channels-last OIHW copy."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def cudnn_backward(gy_nchw, x_nchw, w_oihw, dx: bool, dw: bool):
    """cuDNN's (dx, dw, -) of the 3x3/s1 SAME conv, each where asked."""
    return torch.ops.aten.convolution_backward(
        gy_nchw, x_nchw, w_oihw, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
        1, [dx, dw, False])


def cudnn_step(x_nchw, w_oihw, gy_nchw=None):
    """The yardstick: ``F.conv2d``; with ``gy``, its dx and dw."""
    y = F.conv2d(x_nchw, w_oihw, padding=1)
    if gy_nchw is None:
        return y, None, None
    dx, dw, _ = cudnn_backward(gy_nchw, x_nchw, w_oihw, True, True)
    return y, dx, dw


def passes(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor) -> dict:
    """Each pass of the conv of x [B, H, W, C] and w [3, 3, C, Co] with the
    output gradient dy, as a call of no arguments, by implementation: the
    port's kernels, their plain versions, and cuDNN on channels-last views
    of the same tensors."""
    wr = conv_kernel.rot_w(w).contiguous()
    xc, wc, gc = nchw(x), oihw(w), nchw(dy)
    return {
        "kernel": {"fwd": lambda: conv_kernel.conv3x3_s1(x, w),
                   "dgrad": lambda: conv_kernel.conv3x3_s1(dy, wr),
                   "wgrad": lambda: conv_kernel.conv3x3_s1_wgrad(x, dy)},
        "plain": {"fwd": lambda: conv_kernel.conv3x3_s1_plain(x, w),
                  "dgrad": lambda: conv_kernel.conv3x3_s1_plain(dy, wr),
                  "wgrad": lambda: conv_kernel.conv3x3_s1_wgrad_plain(x, dy)},
        "cudnn": {"fwd": lambda: F.conv2d(xc, wc, padding=1),
                  "dgrad": lambda: cudnn_backward(gc, xc, wc, True, False),
                  "wgrad": lambda: cudnn_backward(gc, xc, wc, False, True)}}


def _host_ms(fn, iters: int) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def measure(x: torch.Tensor, w: torch.Tensor, *, iters: int, grad: bool,
            impl: str) -> dict:
    """The tool's fields for x [B, H, W, C] and w [3, 3, C, Co] on their
    device (see the module docstring)."""
    B, H, W, C = x.shape
    Co = w.shape[-1]
    b = bounds_ms(B, H, W, C, Co, grad)
    on_card = x.is_cuda
    out = {"shape": f"{H}x{W} {C}->{Co} k3s1", "batch": B, "grad": grad,
           "tc_ms": b["tc_ms"], "hbm_ms": b["hbm_ms"],
           "device": "cuda" if on_card else "cpu",
           "card": card() if on_card else None}
    gy = torch.ones(B, H, W, Co, dtype=x.dtype, device=x.device) \
        if grad else None
    fns = {}
    if impl in ("both", "cudnn"):
        xc, wc = nchw(x), oihw(w)
        gc = nchw(gy) if grad else None
        fns["cudnn"] = lambda: cudnn_step(xc, wc, gc)
    if impl in ("both", "kernel"):
        fns["kernel"] = lambda: kernel_step(x, w, gy)
    for side in ("cudnn", "kernel"):
        out.update({f"{side}_ms": None, f"{side}_mfu_pct": None})
        if side not in fns:
            continue
        if on_card:
            ms, call_ms = time_ms(fns[side], iters)
            out.update({f"{side}_ms": ms, f"{side}_call_ms": call_ms,
                        f"{side}_mfu_pct": b["flops"] / BF16_OPS_PER_S
                        / (ms * 1e-3) * 100})
        else:
            out[f"{side}_host_ms"] = _host_ms(fns[side], iters)
    out["speedup"] = (out["cudnn_ms"] / out["kernel_ms"]
                      if out["cudnn_ms"] and out["kernel_ms"] else None)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--shape", required=True,
                   help="H,Cin,Cout (stride-1 3x3, W == H)")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--grad", action="store_true")
    p.add_argument("--impl", default="both",
                   choices=["both", "cudnn", "kernel"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("conv_bench: CUDA is not available (--device cpu runs the "
              "plain versions)", file=sys.stderr)
        return 1
    H, C, Co = (int(v) for v in args.shape.split(","))
    rs = np.random.RandomState(0)
    x = torch.from_numpy((rs.rand(args.batch, H, H, C) - 0.5)
                         .astype(np.float32))
    w = torch.from_numpy((rs.rand(3, 3, C, Co) * 0.1 - 0.05)
                         .astype(np.float32))
    x, w = (t.to(args.device, torch.bfloat16) for t in (x, w))
    print(json.dumps(measure(x, w, iters=args.iters, grad=args.grad,
                             impl=args.impl)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
