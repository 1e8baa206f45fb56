"""RMSNorm, the residual add + RMSNorm and LayerNorm: the ports of the
reference's ``_rmsnorm_kernel`` (``src/repro/kernels/norms.py:32``),
``_rmsnorm_residual_kernel`` (``:58``) and ``_layernorm_kernel`` (``:92``),
Triton kernels.

Bound on this card: bytes.  The kernel reads x once and writes y once (plus
the (d,) gamma); a row's statistics never leave registers.  Design: a
program holds ``BLOCK_R`` whole rows (``BLOCK_D`` = d rounded up to a power
of two, masked), computes ``mean(x^2)`` in f32 with one row reduction, then
``x * rsqrt(mean + eps) * gamma`` in f32 and one cast out.  Narrow rows
(the qk-norm's d = 128) take several rows a program, so a program holds
about a thousand elements either way.

The residual add + RMSNorm is bound by bytes: it reads x and res and
writes the norm and the new residual, 16.8 MB a launch at qwen3-1.7b's
(1024, 2048) bf16, 5.0 us at 3.35 TB/s.  Design: the same whole-row
programs; ``s = x + res`` in f32, stored once as the new residual, and
``mean(s^2)`` taken from the f32 s (not from the rounded residual), as the
reference does; then ``s * rsqrt(mean + eps) * gamma`` and one cast out.

LayerNorm is bound by bytes too: 25.2 MB a launch at nemotron-4-15b's
prefill, (1024, 6144) bf16, 7.5 us at 3.35 TB/s; a decode launch at
(4, 6144) is bound by launch latency.  Design: the same whole-row programs
(d = 6144 gives ``BLOCK_D`` 8192, one row a program); the mean, then the
variance as the mean of ``(x - mu)^2`` over the masked row (two passes over
registers, not ``E[x^2] - mu^2``), both divided with ``div_rn``; then
``(x - mu) * rsqrt(var + eps) * gamma + beta`` in f32 and one cast out.

They are the custom ops ``repro_torch::rmsnorm``,
``repro_torch::rmsnorm_residual`` (two outputs) and
``repro_torch::layernorm`` over ``(rows, d)``: the CPU implementation is
the plain version, the CUDA implementation launches the kernel.
:func:`rmsnorm`, :func:`rmsnorm_residual` and :func:`layernorm` reshape to
``(rows, d)`` outside the op, as the reference wrappers do.
"""

from __future__ import annotations

from collections import Counter

import torch

from . import build
from . import ref as _ref

__all__ = ["rmsnorm", "rmsnorm_plain", "launches", "rmsnorm_residual",
           "rmsnorm_residual_plain", "residual_launches", "layernorm",
           "layernorm_plain", "layernorm_launches"]

_FLOAT = (torch.float32, torch.bfloat16)

# kernel launches since the last reset, by build.signature of the arguments
launches: Counter = Counter()               # _rmsnorm_kernel
residual_launches: Counter = Counter()      # _rmsnorm_residual_kernel
layernorm_launches: Counter = Counter()     # _layernorm_kernel
_JIT = _RES_JIT = _LN_JIT = None
tl = None             # triton.language, bound by build.triton_jit at launch


def _rmsnorm_kernel(x_ptr, g_ptr, o_ptr, rows, d, stride_x, eps,
                    BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
    r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)[:, None]
    c = tl.arange(0, BLOCK_D)[None, :]
    mask = (r < rows) & (c < d)
    r64 = r.to(tl.int64)
    x = tl.load(x_ptr + r64 * stride_x + c, mask=mask, other=0.0).to(tl.float32)
    var = tl.div_rn(tl.sum(x * x, axis=1)[:, None], 1.0 * d)
    g = tl.load(g_ptr + c, mask=c < d, other=0.0).to(tl.float32)
    y = x * tl.rsqrt(var + eps) * g
    tl.store(o_ptr + r64 * d + c, y.to(o_ptr.dtype.element_ty), mask=mask)


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


def _layernorm_kernel(x_ptr, g_ptr, b_ptr, o_ptr, rows, d, stride_x, eps,
                      BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
    r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)[:, None]
    c = tl.arange(0, BLOCK_D)[None, :]
    mask = (r < rows) & (c < d)
    r64 = r.to(tl.int64)
    x = tl.load(x_ptr + r64 * stride_x + c, mask=mask, other=0.0).to(tl.float32)
    mu = tl.div_rn(tl.sum(x, axis=1)[:, None], 1.0 * d)
    xc = tl.where(mask, x - mu, 0.0)
    var = tl.div_rn(tl.sum(xc * xc, axis=1)[:, None], 1.0 * d)
    g = tl.load(g_ptr + c, mask=c < d, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + c, mask=c < d, other=0.0).to(tl.float32)
    y = xc * tl.rsqrt(var + eps) * g + b
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
    """(BLOCK_R, BLOCK_D, num_warps): whole rows, about a thousand elements
    a program or one row."""
    block_d = build.next_pow2(d)
    block_r = min(max(1, 1024 // block_d), build.next_pow2(rows))
    return block_r, block_d, 4 if block_r * block_d <= 2048 else 8


def _launch(x, gamma, eps: float):
    global _JIT
    _check("rmsnorm", x, gamma)
    rows, d = x.shape
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    block_r, block_d, warps = _blocks(rows, d)
    if _JIT is None:
        _JIT = build.triton_jit(_rmsnorm_kernel)
    grid = (-(-rows // block_r),)
    _JIT[grid](x, gamma, out, rows, d, x.stride(0), float(eps),
               BLOCK_R=block_r, BLOCK_D=block_d, num_warps=warps)
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
    global _LN_JIT
    _check("layernorm", x, gamma, beta)
    rows, d = x.shape
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    block_r, block_d, warps = _blocks(rows, d)
    if _LN_JIT is None:
        _LN_JIT = build.triton_jit(_layernorm_kernel)
    grid = (-(-rows // block_r),)
    _LN_JIT[grid](x, gamma, beta, out, rows, d, x.stride(0), float(eps),
                  BLOCK_R=block_r, BLOCK_D=block_d, num_warps=warps)
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
