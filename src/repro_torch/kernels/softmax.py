"""Scaled softmax, plain and masked: the ports of the reference's
``_softmax_kernel`` and ``_softmax_masked_kernel``
(``src/repro/kernels/softmax.py:18``, ``:25``).

What it computes: ``softmax(x * scale)`` over the last axis with f32
statistics; the masked variant first sets masked lanes to ``-inf``,
replaces a non-finite row max by 0 and divides by ``max(sum, 1e-30)``, so a
fully masked row is 0.  The plain variant keeps the reference's NaN on a
row that is all ``-inf``.

The masked softmax on rows the one-pass layout takes whole (``d`` up to
``MAX_ONE_PASS``) is CUDA C++ for ``sm_90a`` (``repro_torch/csrc/
softmax.cu``, built by :mod:`.build` at first use and bound with
``ctypes``); its source note gives the bound and the design: the mask
first, x read only where the mask keeps a lane, fully masked rows written
as 0 without reading x, persistent blocks with the next rows' loads in
flight.  It computes what the Triton one-pass kernel's masked path
computed, bit for bit: each row summed over the same lanes in the same
order (the layout :func:`masked_plan` derives from Triton's view of the
operand) with the same rounded operations.  That Triton path is gone;
:func:`_launch_cuda` launches the CUDA kernel with the op's checks and no
launch counted, for timing.

The rest is Triton, bound by bytes: a launch reads x once and writes the
output once.  Design:

* unmasked rows that fit one register block (``next_pow2(d) <=
  MAX_ONE_PASS``): whole-row programs, ``BLOCK_R`` rows a program (about a thousand
  elements), one pass: ``x * scale`` in f32, the row max, ``exp(x - max)``,
  the sum and the division, one cast out; lanes past the row are ``-inf``
  and never enter the max;
* wider rows (a vocabulary row, 151936 columns), masked or not, split
  across the card: a grid of (row, chunk of ``SPLIT_BLOCK`` columns)
  programs, so 4 rows of 151936 take 300 programs where one program a row
  took 4 of 132 SMs.
  Pass 1 (``_softmax_partials_kernel``) writes each chunk's f32 max m_c
  and sum l_c of ``exp(x - m_c)`` into scratch.  Pass 2
  (``_softmax_split_kernel``), on the same grid, folds its row's partials
  to ``M = max m_c`` and ``L = sum l_c * exp(m_c - M)`` with one fixed
  reduction over the chunk index, the same in every program of a row (so
  the row's programs agree bit for bit), then writes ``exp(x - M) / L``
  for its chunk.  x is read twice; no atomics, so the result does not
  depend on scheduling.  The masked variant's rules hold in the fold: a
  non-finite M becomes 0 and L is floored at 1e-30.

They are the custom ops ``repro_torch::softmax(x, scale)`` and
``repro_torch::softmax_masked(x, mask, scale)`` over ``(rows, d)``: the CPU
implementation is the plain version, the CUDA implementation launches the
kernel.  :func:`softmax` broadcasts the mask to x's shape and reshapes both
to ``(rows, d)`` outside the op, as the reference wrapper does.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import NamedTuple

import torch

from . import build
from . import ref as _ref

__all__ = ["MaskedPlan", "bind", "masked_plan", "sm_count", "softmax",
           "softmax_plain", "softmax_masked_plain", "softmax_split_plain",
           "split_plan", "launches", "masked_launches"]

_FLOAT = {torch.float32: 0, torch.bfloat16: 1}
MAX_ONE_PASS = 8192   # the widest row block of the one-pass layout
SPLIT_BLOCK = 2048    # columns a program of the split layout
MIN_THREADS = 128     # a CUDA block's threads at least: rows side by side
BLOCKS_PER_SM = 8     # the masked kernel's grid: blocks an SM at most

# kernel launches since the last reset, by build.signature of the arguments
launches: Counter = Counter()               # _softmax_kernel
masked_launches: Counter = Counter()        # _softmax_masked_kernel
_JIT = None           # _softmax_kernel
_PART_JIT = None      # _softmax_partials_kernel
_SPLIT_JIT = None     # _softmax_split_kernel
_LIB: ctypes.CDLL | None = None
tl = None             # triton.language, bound by build.triton_jit at launch


def _softmax_kernel(x_ptr, o_ptr, rows, d, stride_x, scale,
                    BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
    r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)[:, None]
    c = tl.arange(0, BLOCK_D)[None, :]
    inb = (r < rows) & (c < d)
    r64 = r.to(tl.int64)
    x = tl.load(x_ptr + r64 * stride_x + c, mask=inb,
                other=0.0).to(tl.float32) * scale
    x = tl.where(inb, x, float("-inf"))
    mx = tl.max(x, axis=1)[:, None]
    e = tl.exp(x - mx)
    s = tl.sum(e, axis=1)[:, None]
    tl.store(o_ptr + r64 * d + c, tl.div_rn(e, s).to(o_ptr.dtype.element_ty),
             mask=inb)


def _softmax_partials_kernel(x_ptr, m_ptr, part_ptr, d, n_chunks, stride_x,
                             stride_m, scale, HAS_MASK: tl.constexpr,
                             BLOCK_D: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    chunk = tl.program_id(1)
    c = chunk * BLOCK_D + tl.arange(0, BLOCK_D)
    inb = c < d
    x = tl.load(x_ptr + row * stride_x + c, mask=inb,
                other=0.0).to(tl.float32) * scale
    valid = inb
    if HAS_MASK:
        valid = valid & (tl.load(m_ptr + row * stride_m + c, mask=inb,
                                 other=0) != 0)
    x = tl.where(valid, x, float("-inf"))
    m = tl.max(x, axis=0)
    # the shift of a chunk of -inf (a masked chunk's non-finite max): its
    # lanes then add exp(-inf) = 0, not NaN
    if HAS_MASK:
        ms = tl.where(tl.abs(m) < float("inf"), m, 0.0)
    else:
        ms = tl.where(m == float("-inf"), 0.0, m)
    l = tl.sum(tl.exp(x - ms), axis=0)
    at = part_ptr + (row * n_chunks + chunk) * 2
    tl.store(at, m)
    tl.store(at + 1, l)


def _softmax_split_kernel(x_ptr, m_ptr, part_ptr, o_ptr, d, n_chunks,
                          stride_x, stride_m, scale, HAS_MASK: tl.constexpr,
                          BLOCK_D: tl.constexpr, BLOCK_C: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    chunk = tl.program_id(1)
    k = tl.arange(0, BLOCK_C)
    kin = k < n_chunks
    at = part_ptr + (row * n_chunks + k) * 2
    mc = tl.load(at, mask=kin, other=float("-inf"))
    lc = tl.load(at + 1, mask=kin, other=0.0)
    M = tl.max(mc, axis=0)
    if HAS_MASK:
        M = tl.where(tl.abs(M) < float("inf"), M, 0.0)
    L = tl.sum(tl.where(kin, lc * tl.exp(mc - M), 0.0), axis=0)
    if HAS_MASK:
        L = tl.maximum(L, 1e-30, propagate_nan=tl.PropagateNan.ALL)
    c = chunk * BLOCK_D + tl.arange(0, BLOCK_D)
    inb = c < d
    x = tl.load(x_ptr + row * stride_x + c, mask=inb,
                other=0.0).to(tl.float32) * scale
    valid = inb
    if HAS_MASK:
        valid = valid & (tl.load(m_ptr + row * stride_m + c, mask=inb,
                                 other=0) != 0)
    x = tl.where(valid, x, float("-inf"))
    y = tl.div_rn(tl.exp(x - M), L)
    tl.store(o_ptr + row * d + c, y.to(o_ptr.dtype.element_ty), mask=inb)


def softmax_plain(x, scale: float):
    """The plain version: the reference's ``ref`` oracle."""
    return _ref.softmax(x, scale)


def softmax_masked_plain(x, mask, scale: float):
    """The plain version of the masked kernel: the reference's
    ``_softmax_masked_kernel`` step for step (its ``ref`` oracle gives NaN
    on a fully masked row; the kernel gives 0)."""
    xf = torch.where(mask, x.to(torch.float32) * scale, -torch.inf)
    mx = torch.amax(xf, dim=-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    e = torch.exp(xf - mx)
    s = torch.sum(e, dim=-1, keepdim=True)
    return (e / torch.maximum(s, s.new_tensor(1e-30))).to(x.dtype)


def softmax_split_plain(x, scale: float, mask=None,
                        block: int = SPLIT_BLOCK):
    """The split layout's algorithm on tensors, every value in f32: each
    chunk's max and sum of ``exp(x - m_c)``, their fold to (M, L) over the
    chunk index, then ``exp(x - M) / L``, with the masked variant's rules
    when ``mask`` is given.  x (rows, d); ``mask`` bool (rows, d)."""
    rows, d = x.shape
    n = -(-d // block)
    xf = x.to(torch.float32) * scale
    if mask is not None:
        xf = torch.where(mask, xf, -torch.inf)
    pad = torch.full((rows, n * block - d), -torch.inf, dtype=torch.float32,
                     device=x.device)
    xc = torch.cat([xf, pad], dim=1).reshape(rows, n, block)
    m = torch.amax(xc, dim=-1)
    if mask is not None:
        ms = torch.where(torch.isfinite(m), m, 0.0)
    else:
        ms = torch.where(m == -torch.inf, 0.0, m)
    l = torch.sum(torch.exp(xc - ms[..., None]), dim=-1)
    M = torch.amax(m, dim=-1, keepdim=True)
    if mask is not None:
        M = torch.where(torch.isfinite(M), M, 0.0)
    L = torch.sum(l * torch.exp(m - M), dim=-1, keepdim=True)
    if mask is not None:
        L = torch.maximum(L, L.new_tensor(1e-30))
    return (torch.exp(xf - M) / L).to(x.dtype)


def split_plan(d: int) -> tuple[int, int] | None:
    """(columns a program, chunks a row) of the split layout for rows of
    ``d`` columns; None for rows the one-pass layout takes whole."""
    if build.next_pow2(d) <= MAX_ONE_PASS:
        return None
    return SPLIT_BLOCK, -(-d // SPLIT_BLOCK)


def _layout(rows: int, d: int) -> tuple[int, int, int]:
    """(BLOCK_R, BLOCK_D, num_warps) of ``_softmax_kernel`` for rows of at
    most ``MAX_ONE_PASS`` columns: whole rows, about a thousand elements a
    program."""
    block_d = build.next_pow2(d)
    block_r = min(max(1, 1024 // block_d), build.next_pow2(rows))
    return block_r, block_d, 4 if block_r * block_d <= 2048 else 8


class MaskedPlan(NamedTuple):
    """An operand's layout as the Triton kernel took it (``vec``
    consecutive columns a lane, a row over ``lanes`` lanes of ``warps``
    warps, so ``elems`` = BLOCK_D / (lanes * warps) elements a lane) and
    the CUDA kernel's launch: blocks of ``threads``, one row each lanes *
    warps of them, ``blocks`` of them walking the row groups."""
    vec: int
    lanes: int
    warps: int
    elems: int
    threads: int
    blocks: int


def masked_plan(rows: int, d: int, dtype: torch.dtype, x_ptr: int,
                x_stride: int, m_ptr: int, m_stride: int,
                sms: int) -> MaskedPlan:
    """The plan of a masked operand x (rows, d) of ``dtype`` at address
    ``x_ptr`` with rows ``x_stride`` elements apart, its byte mask at
    ``m_ptr`` with rows ``m_stride`` apart, on a card of ``sms`` SMs
    (:func:`sm_count`).  Triton's coalescing gives every load and store of
    the program one vector: the widest that one of x, the mask and the
    output (16-byte aligned, row stride d) allows,
    at most the program's elements over its threads (the store's own
    vector may be narrower; the reductions take the loads' layout).  Its
    blocked layout then spreads a row over the threads that fill
    ``BLOCK_D / vec`` columns: the lanes of a warp first, then warps.  The
    CUDA block runs at least ``MIN_THREADS`` threads, rows side by side,
    and the grid at most ``BLOCKS_PER_SM`` blocks an SM."""
    return _masked_plan(rows, d, dtype.itemsize, x_ptr % 16 == 0,
                        x_stride % 16 == 0, m_ptr % 16 == 0,
                        m_stride % 16 == 0, sms)


@functools.lru_cache(maxsize=1024)
def _masked_plan(rows: int, d: int, itemsize: int, x16: bool, xs16: bool,
                 m16: bool, ms16: bool, sms: int) -> MaskedPlan:
    if rows < 1 or split_plan(d) is not None or d < 1:
        raise ValueError(f"softmax_masked: {rows} rows of {d}: the one-pass "
                         f"kernel takes rows of 1 to {MAX_ONE_PASS} columns")
    block_r, block_d, nw = _layout(rows, d)
    vec = max(build.triton_vector(itemsize, x16, xs16, block_d),
              build.triton_vector(1, m16, ms16, block_d),
              build.triton_vector(itemsize, True, d % 16 == 0, block_d))
    vec = min(vec, max(block_r * block_d // (32 * nw), 1))
    row_threads = min(32 * nw, max(1, block_d // vec))
    lanes = min(row_threads, 32)
    warps = min(max(row_threads // lanes, 1), nw)
    threads = max(lanes * warps, MIN_THREADS)
    groups = -(-rows // (threads // (lanes * warps)))
    return MaskedPlan(vec, lanes, warps, block_d // (lanes * warps), threads,
                      min(groups, sms * BLOCKS_PER_SM))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``, to which the masked kernel's grid
    is sized."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``softmax`` library."""
    vp, ci, cl, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
    lib.repro_softmax_masked.argtypes = [vp, vp, vp, ci, cl, ci, cl, cl, cf,
                                         ci, ci, ci, ci, ci, vp]
    lib.repro_softmax_masked.restype = ci
    lib.repro_cuda_error_string.argtypes = [ci]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build.library("softmax"))))
    return _LIB


def _check(name, x, mask=None):
    if x.dim() != 2 or x.dtype not in _FLOAT:
        raise ValueError(f"{name}: x {tuple(x.shape)} {x.dtype}; need (rows, d) "
                         f"f32 or bf16")
    if x.stride(1) != 1:
        raise ValueError(f"{name}: x strides {x.stride()}: rows must be "
                         f"contiguous")
    if mask is not None:
        if mask.shape != x.shape or mask.dtype != torch.bool \
                or mask.device != x.device:
            raise ValueError(f"{name}: mask {tuple(mask.shape)} {mask.dtype} "
                             f"on {mask.device}; need x's shape, bool, on "
                             f"{x.device}")
        if mask.stride(1) != 1:
            raise ValueError(f"{name}: mask strides {mask.stride()}: rows "
                             f"must be contiguous")


def _split(x, mask, scale: float):
    """The split layout's two kernels on x (and the mask): rows wider than
    the one-pass block."""
    global _PART_JIT, _SPLIT_JIT
    rows, d = x.shape
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    # the bool mask is read as bytes
    m = mask.view(torch.uint8) if mask is not None else x
    block, n = split_plan(d)
    if _PART_JIT is None:
        _PART_JIT = build.triton_jit(_softmax_partials_kernel)
    if _SPLIT_JIT is None:
        _SPLIT_JIT = build.triton_jit(_softmax_split_kernel)
    part = torch.empty((rows, n, 2), dtype=torch.float32, device=x.device)
    grid = (rows, n)
    _PART_JIT[grid](x, m, part, d, n, x.stride(0), m.stride(0),
                    float(scale), HAS_MASK=mask is not None,
                    BLOCK_D=block, num_warps=4)
    _SPLIT_JIT[grid](x, m, part, out, d, n, x.stride(0), m.stride(0),
                     float(scale), HAS_MASK=mask is not None,
                     BLOCK_D=block, BLOCK_C=build.next_pow2(n),
                     num_warps=4)
    return out


def _launch(x, scale: float):
    global _JIT
    _check("softmax", x)
    rows, d = x.shape
    if split_plan(d) is not None:
        out = _split(x, None, scale)
    else:
        out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
        block_r, block_d, warps = _layout(rows, d)
        if _JIT is None:
            _JIT = build.triton_jit(_softmax_kernel)
        _JIT[(-(-rows // block_r),)](
            x, out, rows, d, x.stride(0), float(scale), BLOCK_R=block_r,
            BLOCK_D=block_d, num_warps=warps)
    launches[build.signature(x, scale)] += 1
    return out


def _cuda(x, mask, scale: float):
    """One launch of the CUDA masked kernel on x and its bool mask (rows of
    at most ``MAX_ONE_PASS`` columns)."""
    rows, d = x.shape
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    m = mask.view(torch.uint8)
    plan = masked_plan(max(rows, 1), d, x.dtype, x.data_ptr(), x.stride(0),
                       m.data_ptr(), m.stride(0), sm_count(x.device.index))
    err = _lib().repro_softmax_masked(
        x.data_ptr(), m.data_ptr(), out.data_ptr(), _FLOAT[x.dtype], rows, d,
        x.stride(0), m.stride(0), float(scale), plan.vec, plan.lanes,
        plan.warps, plan.threads, plan.blocks,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        msg = _lib().repro_cuda_error_string(err).decode()
        if err < 0:
            raise ValueError(f"softmax_masked: {msg} (x {x.dtype} "
                             f"{tuple(x.shape)} strides {x.stride()}, {plan})")
        raise RuntimeError(f"softmax_masked kernel launch failed: {msg} "
                           f"({err})")
    return out


def _launch_masked(x, mask, scale: float):
    _check("softmax_masked", x, mask)
    if split_plan(x.shape[1]) is None:
        out = _cuda(x, mask, scale)
    else:
        out = _split(x, mask, scale)
    masked_launches[build.signature(x, mask, scale)] += 1
    return out


def _launch_cuda(x, mask, scale: float):
    """One launch of the CUDA masked kernel (the one the op launches on
    rows of at most ``MAX_ONE_PASS`` columns), with the op's checks and no
    launch counted."""
    _check("softmax_masked", x, mask)
    if split_plan(x.shape[1]) is not None:
        raise ValueError(f"softmax_masked: rows of {x.shape[1]} columns take "
                         f"the split layout, not the one-pass kernel")
    return _cuda(x, mask, scale)


@torch.library.custom_op("repro_torch::softmax", mutates_args=(),
                         device_types="cpu")
def softmax_op(x: torch.Tensor, scale: float) -> torch.Tensor:
    return softmax_plain(x, scale)


softmax_op.register_kernel("cuda")(_launch)


@softmax_op.register_fake
def _(x, scale):
    return x.new_empty(x.shape)


@torch.library.custom_op("repro_torch::softmax_masked", mutates_args=(),
                         device_types="cpu")
def softmax_masked_op(x: torch.Tensor, mask: torch.Tensor,
                      scale: float) -> torch.Tensor:
    return softmax_masked_plain(x, mask, scale)


softmax_masked_op.register_kernel("cuda")(_launch_masked)


@softmax_masked_op.register_fake
def _(x, mask, scale):
    return x.new_empty(x.shape)


def softmax(x, scale: float = 1.0, mask=None):
    """``softmax(x * scale)`` over the last axis; ``mask`` (bool,
    broadcastable to x) keeps the lanes where it is True."""
    d = x.shape[-1]
    if mask is None:
        return softmax_op(x.reshape(-1, d), float(scale)).reshape(x.shape)
    m = mask.expand(x.shape).reshape(-1, d)
    return softmax_masked_op(x.reshape(-1, d), m,
                             float(scale)).reshape(x.shape)
