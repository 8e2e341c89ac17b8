"""Port 3x3/s1 conv (``objectdetectionpl_tpu_torch.ops.cuda.conv_kernel``) against the JAX package.

The plain versions -- what the wrappers run for CPU tensors and what the
CUDA kernels of ``csrc/conv3x3.cu`` are held against on the card -- are fed
the same numpy-seeded inputs as the TPU kernels
``ops/pallas/conv_kernel.py`` in interpret mode.

Tolerances:

- f32 forward and wgrad: ``rtol=atol=1e-5``: the same exact products,
  summed in another order (nine per-tap products here, one [9C] dot there);
- bf16 forward: one bf16 ulp of the largest |y|, ``2**(floor(log2
  max|y|) - 7)``: both sides sum exact bf16 products in f32 and round once
  to bf16, so only an f32 sum lying next to a rounding boundary can differ,
  by one ulp of its own size;
- bf16 wgrad (f32 out): ``rtol=atol=1e-5``, as f32;
- gradients through ``conv3x3_s1_op`` against ``jax.grad``: ``rtol=atol=
  1e-4`` in f32 (``tests/test_pallas_conv.py``'s tolerance for the VJP);
  for bf16 x the input gradient is bf16 and held to the bf16 ulp above.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from objectdetectionpl_tpu.ops.pallas import conv_kernel as jax_conv
from objectdetectionpl_tpu_torch.ops.cuda import conv_kernel

import chip_smoke

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (B, H, W, C, Co): tests/test_pallas_conv.py's shapes, the stem's C=12 ->
# 32, and an odd non-square image
SHAPES = [(2, 8, 8, 8, 16), (4, 6, 6, 16, 8), (2, 5, 5, 4, 4),
          (2, 8, 8, 12, 32), (1, 5, 7, 3, 5)]
JAX_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(B, H, W, C, Co, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((B, H, W, C)).astype(np.float32)
    w = (rs.standard_normal((3, 3, C, Co)) * 0.1).astype(np.float32)
    g = rs.standard_normal((B, H, W, Co)).astype(np.float32)
    return x, w, g


def _pair(a: np.ndarray, dtype: torch.dtype):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    t = torch.from_numpy(a).to(dtype)
    return t, jnp.asarray(a).astype(JAX_DT[dtype])


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def bf16_ulp(ref: np.ndarray) -> float:
    return 2.0 ** (math.floor(math.log2(np.abs(ref).max())) - 7)


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_f32_matches_tpu_kernel(shape):
    x, w, _ = _inputs(*shape)
    before = dict(conv_kernel.LAUNCHES)
    got = conv_kernel.conv3x3_s1(torch.from_numpy(x), torch.from_numpy(w))
    want = jax_conv.conv3x3_s1(jnp.asarray(x), jnp.asarray(w),
                               interpret=True)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert conv_kernel.LAUNCHES == before       # the CPU runs the plain one


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[2], SHAPES[3]])
def test_forward_bf16_matches_tpu_kernel(shape):
    x, w, _ = _inputs(*shape, seed=1)
    xt, xj = _pair(x, torch.bfloat16)
    got = conv_kernel.conv3x3_s1(xt, torch.from_numpy(w))    # f32 w: cast
    want = jax_conv.conv3x3_s1(xj, jnp.asarray(w), interpret=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=bf16_ulp(want))


@pytest.mark.parametrize("shape,dtype", [
    (SHAPES[0], torch.float32), (SHAPES[2], torch.float32),
    (SHAPES[3], torch.float32), (SHAPES[4], torch.float32),
    (SHAPES[1], torch.bfloat16), (SHAPES[3], torch.bfloat16)])
def test_wgrad_matches_tpu_kernel(shape, dtype):
    x, _, g = _inputs(*shape, seed=2)
    (xt, xj), (gt, gj) = _pair(x, dtype), _pair(g, dtype)
    got = conv_kernel.conv3x3_s1_wgrad(xt, gt)
    want = np.asarray(jax_conv.conv3x3_s1_wgrad(xj, gj, interpret=True))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_autograd_matches_jax_grad(x_dtype, w_dtype):
    B, H, W, C, Co = 2, 6, 6, 8, 8
    x, w, ct = _inputs(B, H, W, C, Co, seed=3)
    (xt, xj), (wt, wj) = _pair(x, x_dtype), _pair(w, w_dtype)
    ctt, ctj = _pair(ct, x_dtype)
    xt.requires_grad_()
    wt.requires_grad_()
    y = conv_kernel.conv3x3_s1_op(xt, wt)
    dx, dw = torch.autograd.grad(y, (xt, wt), ctt)
    ex, ew = jax.grad(lambda a, b: jnp.vdot(jax_conv.conv3x3_s1_op(a, b),
                                            ctj), argnums=(0, 1))(xj, wj)
    assert y.dtype == dx.dtype == x_dtype and dw.dtype == w_dtype
    assert ex.dtype == JAX_DT[x_dtype] and ew.dtype == JAX_DT[w_dtype]
    for got, want in ((dx, _np(ex)), (dw, _np(ew))):
        if got.dtype == torch.float32:
            np.testing.assert_allclose(_np(got), want, rtol=1e-4, atol=1e-4)
        else:                   # both round the same f32 sum to bf16
            np.testing.assert_allclose(_np(got), want, rtol=0,
                                       atol=bf16_ulp(want))


def test_backward_only_where_needed():
    x, w, _ = _inputs(2, 5, 5, 4, 6)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w).requires_grad_()
    y = conv_kernel.conv3x3_s1_op(xt, wt)
    (dw,) = torch.autograd.grad(y.sum(), (wt,))
    torch.testing.assert_close(dw, conv_kernel.conv3x3_s1_wgrad_plain(
        xt, torch.ones_like(y)), rtol=1e-6, atol=1e-6)


def test_rot_w_matches_jax():
    w = np.random.RandomState(4).standard_normal((3, 3, 5, 7)) \
        .astype(np.float32)
    got = conv_kernel.rot_w(torch.from_numpy(w))
    assert got.shape == (3, 3, 7, 5)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_conv._rot_w(jnp.asarray(w))))


H100_SMS = 132           # streaming multiprocessors of an H100 SXM
# (H, C, Co): the YOLOv5s-640 B=64 3x3/s1 convs, then two tiny cases
SPLIT_CASES = [(320, 12, 32), (160, 32, 64), (80, 64, 64), (40, 128, 128),
                (20, 256, 256), (5, 4, 4), (1, 1, 1)]


def _yolo_shapes():
    """(B, H, W, C, Co) of the distinct YOLOv5s-640 B=64 3x3/s1 convs."""
    out = []
    for key in dict.fromkeys(chip_smoke.CONV_SHAPES):
        cc, hw = key.split("@")
        C, Co = (int(v) for v in cc.split("->"))
        H, W = (int(v) for v in hw.split("x"))
        out.append((chip_smoke.TRAIN_B, H, W, C, Co))
    return out


# the forward kernel's shapes: each YOLOv5s conv, its dgrad (the forward on
# rot_w(w): C and Co swapped), and chip_smoke's extra cases
PLAN_CASES = ([("fwd", s) for s in _yolo_shapes()]
              + [("dgrad", s[:3] + (s[4], s[3])) for s in _yolo_shapes()]
              + [(name, s) for name, s, *_ in chip_smoke.CONV_EXTRA])


@pytest.mark.parametrize("kind,shape", PLAN_CASES,
                         ids=[f"{k}-{'x'.join(map(str, s))}"
                              for k, s in PLAN_CASES])
def test_fwd_plan_tiles_the_output(kind, shape):
    B, H, W, C, Co = shape
    p = conv_kernel.fwd_plan(B, H, W, C, Co, H100_SMS)
    # tile columns: a wgmma width (a multiple of 8) covering Co up to 256,
    # or up to 64 for the window kernel
    assert p.bn % 8 == 0 and min(Co, 64 if p.window else 256) <= p.bn
    assert p.bn <= (64 if p.window else 256)
    assert p.bn < 2 * Co or p.bn == 8               # no wasted half tile
    # the MMAs run 9C rounded up to 16, inside the zero-padded k-tiles
    assert p.k_mma == -(-9 * C // 16) * 16 <= p.k_tiles * conv_kernel.STEP
    if C == 12:
        assert p.k_mma == 112                       # the stem's K = 108
    assert p.w_rows >= Co and p.w_rows % p.bn == 0
    assert p.w_cols == p.k_tiles * conv_kernel.STEP >= 9 * C
    assert p.vec == (8 if C % 8 == 0 else 4)
    assert p.smem <= conv_kernel.BLOCK_SMEM_MAX
    assert 1 <= conv_kernel.blocks_per_sm(p.smem) * (p.smem + 1024) \
        <= conv_kernel.SM_SMEM
    # the output tiles cover every pixel and channel (the window kernel's
    # every position of the [B*H, W+2] grid, its weights in one tile), and
    # the persistent blocks (block b takes tiles b, b + grid, ...) every
    # tile once
    assert p.window == (C in (32, 64, 128))     # its weight columns fit
    rows = B * H * (W + 2) if p.window else B * H * W
    assert p.tiles == -(-rows // conv_kernel.TILE_ROWS) * (p.w_rows // p.bn)
    assert 1 <= p.grid <= min(p.tiles, H100_SMS * 2)
    assert p.grid % (p.w_rows // p.bn) == 0         # blocks keep their columns
    taken = np.zeros(p.tiles, dtype=np.int64)
    for b in range(p.grid):
        taken[b::p.grid] += 1
    assert (taken == 1).all()


@pytest.mark.parametrize("kind,shape", PLAN_CASES,
                         ids=[f"{k}-{'x'.join(map(str, s))}"
                              for k, s in PLAN_CASES])
def test_wgrad_plan_splits_every_pixel_once(kind, shape):
    B, H, W, C, Co = shape
    p = conv_kernel.wgrad_plan(B, H, W, C, Co, H100_SMS)
    assert p.smem <= conv_kernel.BLOCK_SMEM_MAX
    # the window kernel reduces over the positions of the [B*H, W+2] grid,
    # 64 (or all 32) channels of all nine taps a tile
    assert p.window == ((C == 32 or C % 64 == 0) and Co % 8 == 0)
    if p.window:
        assert p.positions == B * H * (W + 2) and p.bn == 64
        assert p.tiles == max(1, C // 64) * -(-Co // 64)
    else:
        assert p.positions == B * H * W
        assert p.tiles == -(-9 * C // conv_kernel.TILE_ROWS) * -(-Co // p.bn)
    seen = np.zeros(p.positions, dtype=np.int8)
    for s in range(p.splits):                 # chunk s: [s*chunk, (s+1)*chunk)
        seen[s * p.chunk:(s + 1) * p.chunk] += 1
    assert (seen == 1).all() and p.splits * p.chunk < p.positions + p.chunk


def _bf16_case(B, H, W, C, Co, seed):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.standard_normal((B, H, W, C)).astype(np.float32))
    w = torch.from_numpy((rs.standard_normal((3, 3, C, Co)) * 0.1)
                         .astype(np.float32))
    return x.bfloat16(), w.bfloat16()


def _conv_f64(x, w):
    """The 3x3/s1 SAME conv in float64 on the CPU, NHWC x HWIO."""
    y = torch.nn.functional.conv2d(x.double().permute(0, 3, 1, 2),
                                   w.double().permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1)


@pytest.mark.parametrize("shape", [(2, 8, 8, 16, 8), (2, 12, 12, 12, 32),
                                   (4, 40, 40, 64, 64)])
def test_bf16_tolerance_accepts_exact_sums(shape):
    """chip_smoke's elementwise limit holds the float64 conv, rounded once
    to bf16, against the plain version (f32 sums rounded to bf16)."""
    x, w = _bf16_case(*shape, seed=5)
    ref, tol = chip_smoke.out_tol(conv_kernel.conv3x3_s1_plain, x, w,
                                  9 * shape[3])
    assert tol.shape == ref.shape and (tol > 0).all()
    exact = _conv_f64(x, w).to(torch.bfloat16)
    assert chip_smoke.tol_share(exact, ref, tol)[1] <= 1.0


@pytest.mark.parametrize("shape", [(2, 8, 8, 16, 8), (2, 12, 12, 12, 32)])
def test_bf16_tolerance_rejects_small_element_faults(shape):
    """A fault confined to the 1 % of outputs smallest in magnitude fails
    the elementwise limit, though it passes 2 ulps of the largest |y|."""
    x, w = _bf16_case(*shape, seed=6)
    ref, tol = chip_smoke.out_tol(conv_kernel.conv3x3_s1_plain, x, w,
                                  9 * shape[3])
    mag = ref.float().abs().flatten()
    small = mag.argsort()[:max(1, mag.numel() // 100)]
    bad = ref.clone().flatten()
    bad[small] = 0
    bad = bad.view_as(ref)
    top = float(mag.max())
    assert float((bad.float() - ref.float()).abs().max()) \
        <= 2 * 2.0 ** (math.floor(math.log2(top)) - 7)
    assert chip_smoke.tol_share(bad, ref, tol)[1] > 1.0


def test_smoke_cases_reach_both_bf16_kernels_of_every_pass():
    """chip_smoke's bf16 conv cases send fwd, dgrad and wgrad both to the
    wgmma kernels and to the simple ones (odd channel counts; x and dy off
    a 16-byte boundary), so the card checks every kernel CUDA bf16 inputs
    can reach."""
    seen = {part: set() for part in ("fwd", "dgrad", "wgrad")}
    for name, (B, H, W, C, Co), dtype, offset in chip_smoke.CONV_EXTRA:
        if dtype != torch.bfloat16:
            continue
        x, dy = (chip_smoke.at_offset(torch.randn(B, H, W, n).bfloat16(),
                                      offset) for n in (C, Co))
        assert x.is_contiguous() and dy.is_contiguous()
        assert (x.data_ptr() % 16 != 0) == (dy.data_ptr() % 16 != 0) \
            == bool(offset)
        w = torch.zeros(3, 3, C, Co, dtype=torch.bfloat16)
        for part, a, b in (("fwd", x, w),
                           ("dgrad", dy, conv_kernel.rot_w(w).contiguous()),
                           ("wgrad", x, dy)):
            seen[part].add(conv_kernel.wgmma_path(a, b))
    assert all(s == {True, False} for s in seen.values()), seen


@pytest.mark.parametrize("H,C,Co", SPLIT_CASES)
def test_wgrad_splits_cover_the_pixels(H, C, Co):
    for wgmma in (True, False):
        p = conv_kernel.wgrad_plan(64, H, H, C, Co, H100_SMS, wgmma)
        pixels = p.positions                # B*H*W, or B*H*(W+2): window
        assert p.chunk % conv_kernel.STEP == 0
        assert (p.splits - 1) * p.chunk < pixels <= p.splits * p.chunk
        assert p.splits <= 65535                    # grid z
        # chunks of at least MIN_SPLIT_PIXELS where there are that many
        assert p.chunk >= min(pixels, conv_kernel.MIN_SPLIT_PIXELS)
        # the blocks fill the card: a whole wave, or all the chunks there are
        slots = H100_SMS * (conv_kernel.blocks_per_sm(p.smem) if wgmma
                            else conv_kernel.SIMPLE_PER_SM)
        assert p.tiles * p.splits >= min(
            slots, p.tiles * (pixels // conv_kernel.MIN_SPLIT_PIXELS)) // 2
        assert p.splits * 9 * C * Co * 4 < 32e6     # scratch bytes


@pytest.mark.parametrize("case,error,match", [
    ("f64_x", TypeError, "x must be torch.float32 or torch.bfloat16"),
    ("int_w", TypeError, "w must be torch.float32 or torch.bfloat16"),
    ("three_dims", ValueError, r"x must be \[B, H, W, C\]"),
    ("w_shape", ValueError, r"w must be \[3, 3, 4, Co\]"),
    ("strided_x", ValueError, "x must be contiguous"),
    ("strided_w", ValueError, "w must be contiguous"),
    ("w_elsewhere", ValueError, "w is on meta"),
    ("meta_device", ValueError, "unsupported device meta"),
])
def test_forward_checks_raise(case, error, match):
    x, w = torch.zeros(2, 5, 5, 4), torch.zeros(3, 3, 4, 6)
    if case == "f64_x":
        x = x.double()
    elif case == "int_w":
        w = w.int()
    elif case == "three_dims":
        x = x[0]
    elif case == "w_shape":
        w = w[:2]
    elif case == "strided_x":
        x = x.transpose(1, 2)
    elif case == "strided_w":
        w = conv_kernel.rot_w(torch.zeros(3, 3, 6, 4))
    elif case == "w_elsewhere":
        w = w.to("meta")
    else:
        x, w = x.to("meta"), w.to("meta")
    with pytest.raises(error, match=match):
        conv_kernel.conv3x3_s1(x, w)


@pytest.mark.parametrize("case,error,match", [
    ("dtype_mismatch", TypeError, "g must be torch.float32, got torch.bfloat16"),
    ("f16", TypeError, "x must be torch.float32 or torch.bfloat16"),
    ("g_shape", ValueError, r"g must be \[2, 5, 5, Co\]"),
    ("strided_g", ValueError, "g must be contiguous"),
    ("g_elsewhere", ValueError, "g is on meta"),
])
def test_wgrad_checks_raise(case, error, match):
    x, g = torch.zeros(2, 5, 5, 4), torch.zeros(2, 5, 5, 6)
    if case == "dtype_mismatch":
        g = g.bfloat16()
    elif case == "f16":
        x, g = x.half(), g.half()
    elif case == "g_shape":
        g = torch.zeros(2, 5, 4, 6)
    elif case == "strided_g":
        g = torch.zeros(2, 6, 5, 5).permute(0, 2, 3, 1)
    else:
        g = g.to("meta")
    with pytest.raises(error, match=match):
        conv_kernel.conv3x3_s1_wgrad(x, g)


def test_conv_bench_cli_prints_one_json_line():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "objectdetectionpl_tpu_torch.tools.conv_bench",
         "--device", "cpu", "--shape", "6,8,8", "--batch", "2", "--iters",
         "1", "--grad", "--impl", "kernel"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    for key in ("shape", "batch", "grad", "tc_ms", "hbm_ms", "cudnn_ms",
                "cudnn_mfu_pct", "kernel_ms", "kernel_mfu_pct", "speedup",
                "card"):
        assert key in res, key
    assert res["shape"] == "6x6 8->8 k3s1" and res["batch"] == 2
    assert res["grad"] is True and res["device"] == "cpu"
    # 3 products of 2*9*C*Co flops per pixel at 989 TFLOP/s
    assert res["tc_ms"] == pytest.approx(3 * 2 * 72 * 9 * 64 / 989e12 * 1e3)
    # a CPU run fills no device field
    assert res["kernel_ms"] is None and res["card"] is None
    assert res["kernel_host_ms"] > 0 and res["cudnn_ms"] is None
