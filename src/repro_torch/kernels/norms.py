"""RMSNorm: the port of the reference's ``_rmsnorm_kernel``
(``src/repro/kernels/norms.py:32``), a Triton kernel.

Bound on this card: bytes.  The kernel reads x once and writes y once (plus
the (d,) gamma); a row's statistics never leave registers.  Design: a
program holds ``BLOCK_R`` whole rows (``BLOCK_D`` = d rounded up to a power
of two, masked), computes ``mean(x^2)`` in f32 with one row reduction, then
``x * rsqrt(mean + eps) * gamma`` in f32 and one cast out.  Narrow rows
(the qk-norm's d = 128) take several rows a program, so a program holds
about a thousand elements either way.

It is the custom op ``repro_torch::rmsnorm`` over ``(rows, d)``: the CPU
implementation is the plain version, the CUDA implementation launches the
kernel.  :func:`rmsnorm` reshapes to ``(rows, d)`` outside the op, as the
reference wrapper does.
"""

from __future__ import annotations

from collections import Counter

import torch

from . import build
from . import ref as _ref

__all__ = ["rmsnorm", "rmsnorm_plain", "launches"]

_FLOAT = (torch.float32, torch.bfloat16)

# kernel launches since the last reset, by build.signature of the arguments
launches: Counter = Counter()
_JIT = None
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


def rmsnorm_plain(x, gamma, eps: float):
    """The plain version: the reference's ``ref`` oracle."""
    return _ref.rmsnorm(x, gamma, eps)


def _launch(x, gamma, eps: float):
    global _JIT
    if x.dim() != 2 or tuple(gamma.shape) != (x.shape[1],):
        raise ValueError(f"rmsnorm: x {tuple(x.shape)}, gamma "
                         f"{tuple(gamma.shape)}; need (rows, d) and (d,)")
    if x.dtype not in _FLOAT or gamma.dtype not in _FLOAT:
        raise TypeError(f"rmsnorm: dtypes {x.dtype}, {gamma.dtype}")
    if gamma.device != x.device:
        raise ValueError(f"rmsnorm: gamma on {gamma.device}, x on {x.device}")
    if x.stride(1) != 1 or not gamma.is_contiguous():
        raise ValueError(f"rmsnorm: x strides {x.stride()}: rows must be "
                         f"contiguous")
    rows, d = x.shape
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    block_d = build.next_pow2(d)
    block_r = min(max(1, 1024 // block_d), build.next_pow2(rows))
    if _JIT is None:
        _JIT = build.triton_jit(_rmsnorm_kernel)
    grid = (-(-rows // block_r),)
    _JIT[grid](x, gamma, out, rows, d, x.stride(0), float(eps),
               BLOCK_R=block_r, BLOCK_D=block_d,
               num_warps=4 if block_r * block_d <= 2048 else 8)
    launches[build.signature(x, gamma, eps)] += 1
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
