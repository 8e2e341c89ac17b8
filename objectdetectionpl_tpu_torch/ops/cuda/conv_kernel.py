"""3x3 stride-1 SAME convolution, forward and gradients: the Hopper kernels
of ``csrc/conv3x3.cu`` and their plain PyTorch versions.

The counterpart of ``objectdetectionpl_tpu/ops/pallas/conv_kernel.py``, in
its layouts: x ``[B, H, W, C]`` (NHWC), w ``[3, 3, C, Co]`` (HWIO), f32
accumulation, the output in x's dtype; ``conv3x3_s1_wgrad`` returns an f32
``[3, 3, C, Co]``.  :class:`Conv3x3S1` is the JAX custom VJP: the input
gradient is the same forward kernel on the flipped, transposed weights
(:func:`rot_w`), the weight gradient the wgrad kernel and its split-K
reduction.  The TPU kernel's VMEM-sizing knobs (``group``, ``interpret``,
the row strips) have no counterpart here.

bf16 with C and Co multiples of 4 (every YOLOv5s conv, the stem's C=12
included) runs on the wgmma kernels, each a 4-stage cp.async ring feeding
two or three warpgroups; :func:`fwd_plan` and :func:`wgrad_plan` pick the
kernel, its tiles and its grid from the shape:

- the window forward, for C of 32, 64 or 128: its weight columns stay in
  shared memory, and the output positions run over rows padded to W + 2,
  so the three dx taps of one dy read one window of x shifted by one
  position: x is read 3 times per pixel instead of 9, the weights once;
- the k-tile forward, for any other C (the stem's 12, 256): 128-pixel x
  ``bn`` tiles, ``bn`` = Co rounded up to a power of two in [8, 256], the
  k loop tap-major; C % 8 != 0 loads 8-byte pieces, one halo test each;
- the window wgrad, for C of 32 or a multiple of 64 and Co a multiple of
  8: one block per 64 channels x 64 columns x chunk of padded positions,
  a warpgroup per dy, the dx taps again one shifted window;
- the tile wgrad otherwise: 128 x 64 or 128 x 128 tiles of dw.

Both forwards take the weights as a zero-padded K-major ``[Co, 9C]`` copy
made here on every call, in persistent blocks; the wgrad kernels split the
reduction into chunks chosen to fill the card in the fewest waves.  f32,
odd channel counts and unaligned tensors take the simple kernels (128x64
tiles, one shared-memory stage).  What bounds each shape:
``csrc/conv3x3.cu``.

The model does not call these: its convolutions stay with cuDNN, as the JAX
package's stay with XLA.  ``tools/conv_bench.py`` drives them against cuDNN.

Every wrapper checks its inputs on every device, takes the plain version
only for tensors on the CPU, and for CUDA tensors launches its kernel or
raises; ``LAUNCHES`` counts the launches of each kernel: one
``conv3x3_s1`` per forward call, one ``conv3x3_s1_wgrad`` and one
``wgrad_reduce`` per weight-gradient call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from objectdetectionpl_tpu_torch.ops.cuda import _build

# kernel launches since import (or reset), by kernel
LAUNCHES = {"conv3x3_s1": 0, "conv3x3_s1_wgrad": 0, "wgrad_reduce": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}    # the kernels' dtype codes
# csrc/conv3x3.cu's wgmma kernels: ring stages, tile rows (forward: pixels;
# wgrad: rows of 9C), the k-tile / pixel step, bytes of a swizzled line
STAGES, TILE_ROWS, STEP, LINE = 4, 128, 64, 128
WINDOW_C = (32, 64, 128) # the window forward's channel counts
WIN_STRIDE = 137 * 16    # its window's bytes per chunk column
# the window wgrad's ring stage: three windows of x, 64 positions of g
GRAD_STAGE = 28672 + 64 * 128
# the simple kernels' wgrad tile: rows (9C) x columns (Co)
SIMPLE_TILE = (128, 64)
SIMPLE_PER_SM = 4        # simple wgrad blocks per streaming multiprocessor
SM_SMEM = 233472         # shared memory of one H100 SM (228 KB)
BLOCK_SMEM_MAX = 232448  # the most one block may take (227 KB)
MIN_SPLIT_PIXELS = 512   # a wgrad chunk's least pixels (8 ring steps)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv3x3")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv3x3_fwd_launch.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.conv3x3_wgrad_launch.argtypes = [p, p, p, i, i, i, i, i, i, ll, i, p]
    lib.conv3x3_wgrad_reduce_launch.argtypes = [p, p, i, i, p]
    # the wgmma launchers take the plan's shared memory (and refuse it where
    # it is not the kernel's own)
    lib.conv3x3_fwd_wgmma_launch.argtypes = [p, p, p] + [i] * 8 + [p]
    lib.conv3x3_fwd_window_launch.argtypes = [p, p, p] + [i] * 8 + [p]
    lib.conv3x3_wgrad_wgmma_launch.argtypes = [p, p, p] + [i] * 9 + [p]
    lib.conv3x3_wgrad_window_launch.argtypes = [p, p, p] + [i] * 8 + [p]
    for fn in (lib.conv3x3_fwd_launch, lib.conv3x3_wgrad_launch,
               lib.conv3x3_wgrad_reduce_launch, lib.conv3x3_fwd_wgmma_launch,
               lib.conv3x3_fwd_window_launch, lib.conv3x3_wgrad_wgmma_launch,
               lib.conv3x3_wgrad_window_launch):
        fn.restype = ctypes.c_int
    return lib


def rot_w(w: torch.Tensor) -> torch.Tensor:
    """The input-gradient kernel: both spatial taps flipped, C and Co
    swapped (a view)."""
    return w.flip((0, 1)).transpose(2, 3)


def _taps(x: torch.Tensor):
    """The nine shifted [B*H*W, C] f32 slices of zero-padded x, tap-major."""
    B, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    for dy in range(3):
        for dx in range(3):
            yield dy, dx, xp[:, dy:dy + H, dx:dx + W].reshape(-1, C)


def conv3x3_s1_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3/s1 SAME conv on any device: w cast to x's dtype, nine [M, C] x
    [C, Co] products accumulated in f32, the sum cast to x's dtype.  On the
    card the products are full f32 only with
    ``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default)."""
    B, H, W, _ = x.shape
    wf = w.to(x.dtype).float()
    acc = torch.zeros(B * H * W, w.shape[-1], dtype=torch.float32,
                      device=x.device)
    for dy, dx, a in _taps(x):
        acc += a @ wf[dy, dx]
    return acc.view(B, H, W, -1).to(x.dtype)


def conv3x3_s1_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dw of the 3x3/s1 conv on any device: per tap an f32 [C, M] x
    [M, Co] product -> [3, 3, C, Co] f32 (the f32 caveat of
    :func:`conv3x3_s1_plain` applies)."""
    C, Co = x.shape[-1], g.shape[-1]
    gf = g.float().reshape(-1, Co)
    out = torch.empty(3, 3, C, Co, dtype=torch.float32, device=x.device)
    for dy, dx, a in _taps(x):
        out[dy, dx] = a.T @ gf
    return out


def _check(fn: str, x: torch.Tensor, other: torch.Tensor, other_name: str,
           other_dtypes) -> None:
    if x.dim() != 4:
        raise ValueError(f"{fn}: x must be [B, H, W, C], got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{fn}: x must be torch.float32 or torch.bfloat16, "
                        f"got {x.dtype}")
    if other.dtype not in other_dtypes:
        raise TypeError(f"{fn}: {other_name} must be "
                        f"{' or '.join(map(str, other_dtypes))}, got "
                        f"{other.dtype}")
    for name, t in (("x", x), (other_name, other)):
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if other.device != x.device:
        raise ValueError(f"{fn}: {other_name} is on {other.device}, x on "
                         f"{x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {x.device}")


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def block_smem(bn: int) -> int:
    """Dynamic shared memory of a wgmma block with ``bn`` tile columns: the
    ring of A (128 lines) and B (``bn`` lines) tiles, plus 1 KB to align
    it to the 1024-byte swizzle atoms."""
    return STAGES * (TILE_ROWS + bn) * LINE + 1024


def blocks_per_sm(smem: int) -> int:
    """Resident wgmma blocks per SM (at most 2) by shared memory, which the
    SM also reserves 1 KB of per block."""
    return max(1, min(2, SM_SMEM // (smem + 1024)))


def wgmma_path(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the conv of a [..., C] with b [..., Co] (w [3, 3, C, Co] or g
    [B, H, W, Co]) runs on the wgmma kernels: bf16, C and Co multiples of
    4 (pixels 8-byte aligned), both tensors 16-byte aligned."""
    return (a.dtype == torch.bfloat16 and a.shape[-1] % 4 == 0
            and b.shape[-1] % 4 == 0 and a.data_ptr() % 16 == 0
            and b.data_ptr() % 16 == 0)


class FwdPlan(NamedTuple):
    window: bool     # the weights-resident window kernel (else the k-tiles')
    bn: int          # tile columns: Co rounded up to a power of two in [8,
                     # 256] (window: in [8, 64])
    vec: int         # elements per cp.async piece: 8 (16 B), or 4 for C % 8
    k_tiles: int     # 64-wide k-tiles over 9C, tap-major
    k_mma: int       # the depth the MMAs run: 9C rounded up to 16 (stem: 112)
    w_rows: int      # the weight copy [w_rows, w_cols]: Co, 9C zero-padded
    w_cols: int
    tiles: int       # 128-row x bn output tiles (rows: pixels, or window
                     # positions of the [B*H, W+2] grid)
    grid: int        # persistent blocks
    smem: int        # dynamic shared memory per block, bytes


def window_smem(C: int, bn: int) -> int:
    """Dynamic shared memory of a window-forward block: its weight columns
    (9 taps x channel blocks of 64, or the 32, x ``bn`` lines) and the ring
    of windows, plus 1 KB of alignment."""
    blocks, chunks = (1, 4) if C == 32 else (C // 64, 8)
    return 9 * blocks * bn * LINE + STAGES * chunks * WIN_STRIDE + 1024


def fwd_plan(B: int, H: int, W: int, C: int, Co: int, sms: int) -> FwdPlan:
    """The wgmma forward kernels' tiles and grid for x [B, H, W, C] and Co
    output channels on a card of ``sms`` SMs: the window kernel where C is
    32, 64 or 128 (its weight columns for tiles of up to 64 columns then
    fit in shared memory beside the ring), else the k-tile kernel with
    tiles of Co columns, up to 256."""
    K = 9 * C
    k_tiles = _cdiv(K, STEP)
    bn = min(256, max(8, 1 << (Co - 1).bit_length()))
    window = C in WINDOW_C
    if window:
        bn = min(bn, 64)
        smem = window_smem(C, bn)
        rows = B * H * (W + 2)
    else:
        smem = block_smem(bn)
        rows = B * H * W
    tiles_n = _cdiv(Co, bn)
    tiles = _cdiv(rows, TILE_ROWS) * tiles_n
    # the window kernel's blocks keep their columns: a multiple of tiles_n
    grid = min(tiles, sms * blocks_per_sm(smem)) // tiles_n * tiles_n
    return FwdPlan(window=window, bn=bn, vec=8 if C % 8 == 0 else 4,
                   k_tiles=k_tiles, k_mma=_cdiv(K, 16) * 16,
                   w_rows=tiles_n * bn, w_cols=k_tiles * STEP, tiles=tiles,
                   grid=grid, smem=smem)


class WgradPlan(NamedTuple):
    window: bool     # the window kernel (else the tile kernels)
    bn: int          # dw tile columns (of Co)
    tiles: int       # dw tiles: 128 rows of 9C; window: 64 (or 32) channels
                     # of all nine taps
    positions: int   # the reduction: B*H*W pixels; window: B*H*(W+2)
    splits: int      # chunks of it, one block per (tile, chunk)
    chunk: int       # positions per chunk, a multiple of 64
    smem: int        # dynamic shared memory per block (0: the simple kernel)


@functools.lru_cache(maxsize=256)
def wgrad_plan(B: int, H: int, W: int, C: int, Co: int, sms: int,
               wgmma: bool = True) -> WgradPlan:
    """The wgrad kernel's tiles and split of the reduction for x [B, H, W,
    C] and Co output channels on a card of ``sms`` SMs: with ``wgmma``, the
    window kernel where C is 32 or a multiple of 64 and Co a multiple of 8
    (64 x 64 tiles of channels and columns, all nine taps, over positions
    of the padded grid), else the wgmma tile kernel's 128 x 64 (Co <= 64)
    or 128 x 128 tiles; without, the simple kernel's 128 x 64; then the
    split whose blocks take the least time when as many run at once as
    fit."""
    window = wgmma and (C == 32 or C % 64 == 0) and Co % 8 == 0
    positions = B * H * (W + 2 if window else W)
    if window:
        bn, smem = 64, STAGES * GRAD_STAGE + 1024
        tiles = max(1, C // 64) * _cdiv(Co, bn)
        slots = sms * blocks_per_sm(smem)
    else:
        if wgmma:
            bn = 64 if Co <= 64 else 128
            smem = block_smem(bn)
            rows, slots = TILE_ROWS, sms * blocks_per_sm(smem)
        else:
            (rows, bn), smem = SIMPLE_TILE, 0
            slots = sms * SIMPLE_PER_SM
        tiles = _cdiv(9 * C, rows) * _cdiv(Co, bn)
    splits, chunk = wgrad_splits(positions, tiles, slots)
    return WgradPlan(window=window, bn=bn, tiles=tiles, positions=positions,
                     splits=splits, chunk=chunk, smem=smem)


def wgrad_splits(pixels: int, tiles: int, slots: int) -> tuple:
    """(splits, chunk) of the wgrad reduction over ``pixels`` positions:
    chunks of a multiple of ``STEP``, at least ``MIN_SPLIT_PIXELS`` (or
    all), chosen to minimise waves x (steps per block + 2, the ring's
    fill), a wave being ``slots`` blocks at once; ties go to fewer chunks
    (less partial-sum traffic).  Chunk s is the positions [s * chunk, (s +
    1) * chunk) of the reduction (the pixels of x flattened to [B*H*W, C],
    or the window kernel's [B*H, W+2] grid)."""
    best = None
    for want in range(1, max(1, min(pixels // MIN_SPLIT_PIXELS,
                                    4 * slots)) + 1):
        chunk = _cdiv(_cdiv(pixels, want), STEP) * STEP
        splits = _cdiv(pixels, chunk)
        cost = _cdiv(tiles * splits, slots) * (chunk // STEP + 2)
        if best is None or cost < best[0]:
            best = (cost, splits, chunk)
    return best[1], best[2]


def _weight_copy(w: torch.Tensor, p: FwdPlan) -> torch.Tensor:
    """w [3, 3, C, Co] as the forward kernel's K-major [p.w_rows, p.w_cols]
    copy, zero beyond Co and 9C, its k in the kernel's k-tile order: for C
    a multiple of 64, channel block-major (tile kt = tap kt % 9 of channels
    kt // 9 * 64..), else tap-major (k = tap * C + c)."""
    C, Co = w.shape[2], w.shape[3]
    if C % STEP == 0:
        wt = w.reshape(9, C // STEP, STEP, Co).permute(3, 1, 0, 2)
    else:
        wt = w.reshape(9 * C, Co).t()
    return F.pad(wt.reshape(Co, 9 * C),
                 (0, p.w_cols - 9 * C, 0, p.w_rows - Co)).contiguous()


@functools.lru_cache(maxsize=8)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv3x3_s1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv, x [B, H, W, C] (f32 or bf16) @ w [3, 3, C,
    Co] (f32 or bf16, cast to x's dtype) -> [B, H, W, Co] in x's dtype, f32
    accumulation.  Both contiguous on one device; CPU tensors go to
    :func:`conv3x3_s1_plain`, CUDA tensors to the kernel on the current
    stream.  No VJP: use :func:`conv3x3_s1_op` for gradients."""
    _check("conv3x3_s1", x, w, "w", tuple(DTYPES))
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[-1]):
        raise ValueError(f"conv3x3_s1: w must be [3, 3, {x.shape[-1]}, Co], "
                         f"got shape {tuple(w.shape)}")
    if x.device.type == "cpu":
        return conv3x3_s1_plain(x, w)
    return _fwd_launch(x, w.to(x.dtype))


def _fwd_launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    Co = w.shape[-1]
    y = torch.empty(B, H, W, Co, dtype=x.dtype, device=x.device)
    if y.numel() == 0 or C == 0:
        return y.zero_()
    # the launch acts on the current device: make it the tensors' card
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if wgmma_path(x, w):
            p = fwd_plan(B, H, W, C, Co, _sms(x.device.index))
            wk = _weight_copy(w, p)
            launch = (_lib().conv3x3_fwd_window_launch if p.window
                      else _lib().conv3x3_fwd_wgmma_launch)
            err = launch(x.data_ptr(), wk.data_ptr(), y.data_ptr(), B, H, W,
                         C, Co, p.bn, p.grid, p.smem, stream)
        else:
            err = _lib().conv3x3_fwd_launch(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), B, H, W, C, Co,
                DTYPES[x.dtype], stream)
    _launched("conv3x3_s1", err)
    return y


def conv3x3_s1_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dw of the 3x3/s1 conv: x [B, H, W, C], g [B, H, W, Co], both f32
    or both bf16 -> [3, 3, C, Co] f32, summed over the batch.  CPU tensors
    go to :func:`conv3x3_s1_wgrad_plain`; for CUDA tensors the wgrad kernel
    writes per-chunk f32 partials and the reduction kernel sums them in
    chunk order (the same result on every run)."""
    _check("conv3x3_s1_wgrad", x, g, "g", (x.dtype,))
    if g.dim() != 4 or g.shape[:3] != x.shape[:3]:
        raise ValueError(f"conv3x3_s1_wgrad: g must be "
                         f"[{', '.join(map(str, x.shape[:3]))}, Co], got "
                         f"shape {tuple(g.shape)}")
    if x.device.type == "cpu":
        return conv3x3_s1_wgrad_plain(x, g)
    return _wgrad_launch(x, g)


def _wgrad_launch(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    B, H, W, C = x.shape
    Co = g.shape[-1]
    dw = torch.empty(3, 3, C, Co, dtype=torch.float32, device=x.device)
    if dw.numel() == 0 or x.numel() == 0:
        return dw.zero_()
    fast = wgmma_path(x, g)
    p = wgrad_plan(B, H, W, C, Co, _sms(x.device.index), fast)
    partial = torch.empty(p.splits, 9 * C, Co, dtype=torch.float32,
                          device=x.device)
    lib = _lib()
    # the launches act on the current device: make it the tensors' card
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if p.window:
            err = lib.conv3x3_wgrad_window_launch(
                x.data_ptr(), g.data_ptr(), partial.data_ptr(), B, H, W, C,
                Co, p.splits, p.chunk, p.smem, stream)
        elif fast:
            err = lib.conv3x3_wgrad_wgmma_launch(
                x.data_ptr(), g.data_ptr(), partial.data_ptr(), B, H, W, C,
                Co, p.bn, p.splits, p.chunk, p.smem, stream)
        else:
            err = lib.conv3x3_wgrad_launch(
                x.data_ptr(), g.data_ptr(), partial.data_ptr(), B, H, W, C,
                Co, p.splits, p.chunk, DTYPES[x.dtype], stream)
        _launched("conv3x3_s1_wgrad", err)
        _launched("wgrad_reduce", lib.conv3x3_wgrad_reduce_launch(
            partial.data_ptr(), dw.data_ptr(), dw.numel(), p.splits, stream))
    return dw


class Conv3x3S1(torch.autograd.Function):
    """Differentiable 3x3/s1 SAME conv: :func:`conv3x3_s1` forward; the
    backward of the JAX VJP, g cast to x's dtype, then ``dx =
    conv3x3_s1(g, rot_w(w))`` and ``dw = conv3x3_s1_wgrad(x, g)`` in w's
    dtype (each only where its input needs a gradient)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3_s1(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_s1(g, rot_w(w).to(x.dtype).contiguous())
        if ctx.needs_input_grad[1]:
            dw = conv3x3_s1_wgrad(x, g).to(w.dtype)
        return dx, dw


def conv3x3_s1_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`conv3x3_s1` with gradients (:class:`Conv3x3S1`)."""
    return Conv3x3S1.apply(x, w)
