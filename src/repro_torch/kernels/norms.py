"""RMSNorm, the residual add + RMSNorm and LayerNorm: the ports of the
reference's ``_rmsnorm_kernel`` (``src/repro/kernels/norms.py:32``),
``_rmsnorm_residual_kernel`` (``:58``) and ``_layernorm_kernel`` (``:92``).

RMSNorm and LayerNorm are CUDA C++ for ``sm_90a`` (``repro_torch/csrc/
norms.cu``, built by :mod:`.build` at first use and bound with ``ctypes``);
its source note gives the bound and the design.  They compute what the
Triton kernels they replaced computed (deleted since; ``PERF.md`` keeps
their times), bit for bit: each row summed over the same lanes, each
lane's elements in the same order, the same butterfly across lanes and
warps, and the same rounded operations.  :func:`block_plan` gives an
operand the layout Triton gave it (which depends on Triton's
divisibility-by-16 view of the pointers and strides) and the block the
CUDA kernel runs it in.  What each Triton kernel did: a program held
``BLOCK_R`` whole rows (``BLOCK_D`` = d rounded up to a power of two,
masked), computed ``mean(x^2)`` in f32 with one row reduction, then
``x * rsqrt(mean + eps) * gamma`` in f32 and one cast out; LayerNorm took
the mean, then the variance as the mean of ``(x - mu)^2`` over the masked
row (two passes over registers, not ``E[x^2] - mu^2``), both divided with
``div_rn``, then ``(x - mu) * rsqrt(var + eps) * gamma + beta``.

The residual add + RMSNorm is a Triton kernel, bound by bytes: it reads
x and res and writes the norm and the new residual, 16.8 MB a launch at
qwen3-1.7b's (1024, 2048) bf16, 5.0 us at 3.35 TB/s.  Design: whole-row
programs as above; ``s = x + res`` in f32, stored once as the new
residual, and ``mean(s^2)`` taken from the f32 s (not from the rounded
residual), as the reference does; then ``s * rsqrt(mean + eps) * gamma``
and one cast out.

They are the custom ops ``repro_torch::rmsnorm``,
``repro_torch::rmsnorm_residual`` (two outputs) and
``repro_torch::layernorm`` over ``(rows, d)``: the CPU implementation is
the plain version, the CUDA implementation launches the kernel.
:func:`rmsnorm`, :func:`rmsnorm_residual` and :func:`layernorm` reshape to
``(rows, d)`` outside the op, as the reference wrappers do.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import NamedTuple

import torch

from . import build
from . import ref as _ref

__all__ = ["Plan", "bind", "block_plan", "rmsnorm", "rmsnorm_plain",
           "launches", "rmsnorm_residual", "rmsnorm_residual_plain",
           "residual_launches", "layernorm", "layernorm_plain",
           "layernorm_launches"]

_FLOAT = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132            # the H100 SXM's SMs
MIN_THREADS = 128    # a block's threads at least: narrow rows side by side

# kernel launches since the last reset, by build.signature of the arguments
launches: Counter = Counter()               # _rmsnorm_kernel
residual_launches: Counter = Counter()      # _rmsnorm_residual_kernel
layernorm_launches: Counter = Counter()     # _layernorm_kernel
_RES_JIT = None
_LIB: ctypes.CDLL | None = None
tl = None  # bound by build.triton_jit at the residual kernel's first launch


def _rmsnorm_residual_kernel(x_ptr, r_ptr, g_ptr, o_ptr, s_ptr, rows, d,
                             stride_x, stride_r, eps,
                             BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
    r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)[:, None]
    c = tl.arange(0, BLOCK_D)[None, :]
    mask = (r < rows) & (c < d)
    r64 = r.to(tl.int64)
    s = (tl.load(x_ptr + r64 * stride_x + c, mask=mask, other=0.0).to(tl.float32)
         + tl.load(r_ptr + r64 * stride_r + c, mask=mask, other=0.0).to(tl.float32))
    tl.store(s_ptr + r64 * d + c, s.to(s_ptr.dtype.element_ty), mask=mask)
    var = tl.div_rn(tl.sum(s * s, axis=1)[:, None], 1.0 * d)
    g = tl.load(g_ptr + c, mask=c < d, other=0.0).to(tl.float32)
    y = s * tl.rsqrt(var + eps) * g
    tl.store(o_ptr + r64 * d + c, y.to(o_ptr.dtype.element_ty), mask=mask)


def rmsnorm_plain(x, gamma, eps: float):
    """The plain version: the reference's ``ref`` oracle."""
    return _ref.rmsnorm(x, gamma, eps)


def rmsnorm_residual_plain(x, res, gamma, eps: float):
    """The plain version: the reference's ``ref`` oracle."""
    return _ref.rmsnorm_residual(x, res, gamma, eps)


def layernorm_plain(x, gamma, beta, eps: float):
    """The plain version: the reference's ``ref`` oracle."""
    return _ref.layernorm(x, gamma, beta, eps)


def _check(name, x, *vectors):
    """Raise on what the kernels do not take: x (rows, d) with contiguous
    rows; contiguous (d,) vectors on x's device; f32 or bf16."""
    if x.dim() != 2 or any(tuple(v.shape) != (x.shape[1],) for v in vectors):
        raise ValueError(f"{name}: x {tuple(x.shape)}, vectors "
                         f"{[tuple(v.shape) for v in vectors]}; need (rows, d) "
                         f"and (d,)")
    if any(t.dtype not in _FLOAT for t in (x, *vectors)):
        raise TypeError(f"{name}: dtypes {[t.dtype for t in (x, *vectors)]}")
    if any(v.device != x.device for v in vectors):
        raise ValueError(f"{name}: vectors on "
                         f"{[str(v.device) for v in vectors]}, x on {x.device}")
    if x.stride(1) != 1 or not all(v.is_contiguous() for v in vectors):
        raise ValueError(f"{name}: x strides {x.stride()}: rows must be "
                         f"contiguous")


def _blocks(rows: int, d: int) -> tuple[int, int, int]:
    """(BLOCK_R, BLOCK_D, num_warps) of a Triton program: whole rows, about
    a thousand elements a program or one row."""
    block_d = build.next_pow2(d)
    block_r = min(max(1, 1024 // block_d), build.next_pow2(rows))
    return block_r, block_d, 4 if block_r * block_d <= 2048 else 8


class Plan(NamedTuple):
    """An operand's layout as the Triton kernel took it (``vec`` consecutive
    columns a lane, a row over ``lanes`` lanes of ``warps`` warps, so
    ``elems`` = BLOCK_D / (lanes * warps) elements a lane), and the CUDA
    kernel's block: ``threads``, one row each lanes * warps of them, and
    whether LayerNorm's gamma and beta load ``early``, with x (RMSNorm's
    gamma always does)."""
    vec: int
    lanes: int
    warps: int
    elems: int
    threads: int
    early: bool


def block_plan(rows: int, d: int, dtype: torch.dtype, ptr: int, stride: int,
               vectors_aligned: bool = True) -> Plan:
    """The plan of an operand x (rows, d) of ``dtype`` at address ``ptr``
    with rows ``stride`` elements apart (gamma and beta 16-byte aligned
    unless ``vectors_aligned`` is False).  Triton's coalescing gives a
    load the widest vector of the pointers of its shape that depend on it:
    x's, the output's (16-byte aligned, row stride d) and, in a program of
    one row, gamma's and beta's; at most the program's elements over its
    threads.  Its blocked layout then spreads a row over the threads that
    fill ``BLOCK_D / vec`` columns: the lanes of a warp first, then warps.
    The CUDA block runs at least ``MIN_THREADS`` threads, rows side by
    side; LayerNorm's gamma and beta load early where the grid has at most
    one block an SM (a decode step: latency), late otherwise (throughput:
    fewer registers through the reductions)."""
    return _plan(rows, d, dtype.itemsize, ptr % 16 == 0, stride % 16 == 0,
                 vectors_aligned)


@functools.lru_cache(maxsize=1024)
def _plan(rows: int, d: int, itemsize: int, ptr16: bool, stride16: bool,
          vectors16: bool) -> Plan:
    if rows < 1 or d < 1:
        raise ValueError(f"norms: {rows} rows of {d}: nothing to normalise")
    block_r, block_d, nw = _blocks(rows, d)
    vec = max(build.triton_vector(itemsize, ptr16, stride16, block_d),
              build.triton_vector(itemsize, True, d % 16 == 0, block_d))
    if block_r == 1:
        vec = max(vec, build.triton_vector(itemsize, vectors16, True, block_d))
    vec = min(vec, max(block_r * block_d // (32 * nw), 1))
    row_threads = min(32 * nw, max(1, block_d // vec))
    lanes = min(row_threads, 32)
    warps = min(max(row_threads // lanes, 1), nw)
    elems = block_d // (lanes * warps)
    threads = max(lanes * warps, MIN_THREADS)
    blocks = -(-rows // (threads // (lanes * warps)))
    return Plan(vec, lanes, warps, elems, threads, blocks <= SMS)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``norms`` library."""
    vp, ci, cl, cf = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_float)
    plan = [ci, ci, ci, ci, ci, vp]  # vec lanes warps threads early stream
    lib.repro_rmsnorm.argtypes = [vp, vp, vp, ci, cl, ci, cl, cf, *plan]
    lib.repro_rmsnorm.restype = ci
    lib.repro_layernorm.argtypes = [vp, vp, vp, vp, ci, cl, ci, cl, cf, *plan]
    lib.repro_layernorm.restype = ci
    lib.repro_cuda_error_string.argtypes = [ci]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build.library("norms"))))
    return _LIB


def _cuda(name, x, vectors, eps: float):
    """One launch of the CUDA kernel ``name`` (``rmsnorm`` or
    ``layernorm``) on x and its (d,) ``vectors``."""
    rows, d = x.shape
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    plan = block_plan(rows, d, x.dtype, x.data_ptr(), x.stride(0),
                      all(v.data_ptr() % 16 == 0 for v in vectors))
    fn = getattr(_lib(), f"repro_{name}")
    err = fn(x.data_ptr(), *(v.data_ptr() for v in vectors), out.data_ptr(),
             _FLOAT[x.dtype], rows, d, x.stride(0), float(eps), plan.vec,
             plan.lanes, plan.warps, plan.threads, int(plan.early),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        msg = _lib().repro_cuda_error_string(err).decode()
        if err < 0:
            raise ValueError(f"{name}: {msg} (x {x.dtype} {tuple(x.shape)} "
                             f"strides {x.stride()}, {plan})")
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    return out


def _launch(x, gamma, eps: float):
    _check("rmsnorm", x, gamma)
    out = _cuda("rmsnorm", x, (gamma,), eps)
    launches[build.signature(x, gamma, eps)] += 1
    return out


def _launch_residual(x, res, gamma, eps: float):
    global _RES_JIT
    _check("rmsnorm_residual", x, gamma)
    _check("rmsnorm_residual", res, gamma)
    if res.shape != x.shape or res.device != x.device:
        raise ValueError(f"rmsnorm_residual: res {tuple(res.shape)} on "
                         f"{res.device}, x {tuple(x.shape)} on {x.device}")
    rows, d = x.shape
    normed = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    new_res = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    block_r, block_d, warps = _blocks(rows, d)
    if _RES_JIT is None:
        _RES_JIT = build.triton_jit(_rmsnorm_residual_kernel)
    grid = (-(-rows // block_r),)
    _RES_JIT[grid](x, res, gamma, normed, new_res, rows, d, x.stride(0),
                   res.stride(0), float(eps),
                   BLOCK_R=block_r, BLOCK_D=block_d, num_warps=warps)
    residual_launches[build.signature(x, res, gamma, eps)] += 1
    return normed, new_res


def _launch_layernorm(x, gamma, beta, eps: float):
    _check("layernorm", x, gamma, beta)
    out = _cuda("layernorm", x, (gamma, beta), eps)
    layernorm_launches[build.signature(x, gamma, beta, eps)] += 1
    return out


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=(),
                         device_types="cpu")
def rmsnorm_op(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    return rmsnorm_plain(x, gamma, eps)


rmsnorm_op.register_kernel("cuda")(_launch)


@rmsnorm_op.register_fake
def _(x, gamma, eps):
    return x.new_empty(x.shape)


def rmsnorm(x, gamma, eps: float = 1e-6):
    """x (..., d), gamma (d,) -> x's shape and dtype."""
    d = x.shape[-1]
    return rmsnorm_op(x.reshape(-1, d), gamma, float(eps)).reshape(x.shape)


@torch.library.custom_op("repro_torch::rmsnorm_residual", mutates_args=(),
                         device_types="cpu")
def rmsnorm_residual_op(x: torch.Tensor, res: torch.Tensor, gamma: torch.Tensor,
                        eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    return rmsnorm_residual_plain(x, res, gamma, eps)


rmsnorm_residual_op.register_kernel("cuda")(_launch_residual)


@rmsnorm_residual_op.register_fake
def _(x, res, gamma, eps):
    return x.new_empty(x.shape), x.new_empty(x.shape)


def rmsnorm_residual(x, res, gamma, eps: float = 1e-6):
    """x, res (..., d), gamma (d,) -> (the norm of x + res, x + res), each
    in x's shape and dtype."""
    d = x.shape[-1]
    normed, new_res = rmsnorm_residual_op(x.reshape(-1, d), res.reshape(-1, d),
                                          gamma, float(eps))
    return normed.reshape(x.shape), new_res.reshape(x.shape)


@torch.library.custom_op("repro_torch::layernorm", mutates_args=(),
                         device_types="cpu")
def layernorm_op(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 eps: float) -> torch.Tensor:
    return layernorm_plain(x, gamma, beta, eps)


layernorm_op.register_kernel("cuda")(_launch_layernorm)


@layernorm_op.register_fake
def _(x, gamma, beta, eps):
    return x.new_empty(x.shape)


def layernorm(x, gamma, beta, eps: float = 1e-5):
    """x (..., d), gamma and beta (d,) -> x's shape and dtype."""
    d = x.shape[-1]
    return layernorm_op(x.reshape(-1, d), gamma, beta,
                        float(eps)).reshape(x.shape)
