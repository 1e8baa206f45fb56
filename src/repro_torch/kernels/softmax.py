"""Scaled softmax, plain and masked: the ports of the reference's
``_softmax_kernel`` and ``_softmax_masked_kernel``
(``src/repro/kernels/softmax.py:18``, ``:25``), one Triton kernel with a
``HAS_MASK`` switch.

What it computes: ``softmax(x * scale)`` over the last axis with f32
statistics; the masked variant first sets masked lanes to ``-inf``,
replaces a non-finite row max by 0 and divides by ``max(sum, 1e-30)``, so a
fully masked row is 0.  The plain variant keeps the reference's NaN on a
row that is all ``-inf``.

Bound on this card: bytes.  A launch reads x (and the bool mask) once and
writes the output once: 21.0 MB for the masked (4, 16, 256, 256) bf16
scores of qwen3-1.7b's long prompts, 6.3 us at 3.35 TB/s.  Design:

* rows that fit one register block (``next_pow2(d) <= MAX_ONE_PASS``):
  whole-row programs, ``BLOCK_R`` rows a program (about a thousand
  elements), one pass: ``x * scale`` in f32, the row max, ``exp(x - max)``,
  the sum and the division, one cast out; lanes past the row are ``-inf``
  and never enter the max;
* wider rows (a vocabulary row, 151936 columns): one row a program, two
  sweeps over ``WIDE_BLOCK`` columns at a time, both in column order: an
  online max and sum (the sum rescaled by ``exp(m_old - m_new)`` when the
  max rises), then the write.  The row is read twice; no atomics, so the
  result does not depend on scheduling.

They are the custom ops ``repro_torch::softmax(x, scale)`` and
``repro_torch::softmax_masked(x, mask, scale)`` over ``(rows, d)``: the CPU
implementation is the plain version, the CUDA implementation launches the
kernel.  :func:`softmax` broadcasts the mask to x's shape and reshapes both
to ``(rows, d)`` outside the op, as the reference wrapper does.
"""

from __future__ import annotations

from collections import Counter

import torch

from . import build
from . import ref as _ref

__all__ = ["softmax", "softmax_plain", "softmax_masked_plain", "launches",
           "masked_launches"]

_FLOAT = (torch.float32, torch.bfloat16)
MAX_ONE_PASS = 8192   # the widest row block of the one-pass layout
WIDE_BLOCK = 4096     # columns a sweep step of a wider row

# kernel launches since the last reset, by build.signature of the arguments
launches: Counter = Counter()               # _softmax_kernel
masked_launches: Counter = Counter()        # _softmax_masked_kernel
_JIT = None
tl = None             # triton.language, bound by build.triton_jit at launch


def _softmax_kernel(x_ptr, m_ptr, o_ptr, rows, d, stride_x, stride_m, scale,
                    HAS_MASK: tl.constexpr, ONE_PASS: tl.constexpr,
                    BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
    if ONE_PASS:
        r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)[:, None]
        c = tl.arange(0, BLOCK_D)[None, :]
        inb = (r < rows) & (c < d)
        r64 = r.to(tl.int64)
        x = tl.load(x_ptr + r64 * stride_x + c, mask=inb,
                    other=0.0).to(tl.float32) * scale
        valid = inb
        if HAS_MASK:
            keep = tl.load(m_ptr + r64 * stride_m + c, mask=inb, other=0)
            valid = valid & (keep != 0)
        x = tl.where(valid, x, float("-inf"))
        mx = tl.max(x, axis=1)[:, None]
        if HAS_MASK:
            mx = tl.where(tl.abs(mx) < float("inf"), mx, 0.0)
        e = tl.exp(x - mx)
        s = tl.sum(e, axis=1)[:, None]
        if HAS_MASK:
            s = tl.maximum(s, 1e-30, propagate_nan=tl.PropagateNan.ALL)
        tl.store(o_ptr + r64 * d + c, tl.div_rn(e, s).to(o_ptr.dtype.element_ty),
                 mask=inb)
    else:
        row = tl.program_id(0).to(tl.int64)
        x_row = x_ptr + row * stride_x
        m_row = m_ptr + row * stride_m
        o_row = o_ptr + row * d
        zero = tl.zeros([BLOCK_D], tl.float32)
        # f32 scalars, typed as the loop carries them
        m = tl.max(zero, axis=0) - float("inf")
        l = tl.sum(zero, axis=0)
        for c0 in range(0, d, BLOCK_D):
            c = c0 + tl.arange(0, BLOCK_D)
            valid = c < d
            x = tl.load(x_row + c, mask=valid, other=0.0).to(tl.float32) * scale
            if HAS_MASK:
                valid = valid & (tl.load(m_row + c, mask=c < d, other=0) != 0)
            x = tl.where(valid, x, float("-inf"))
            m_new = tl.maximum(m, tl.max(x, axis=0))
            # the shift a row of -inf so far (or a masked row's non-finite
            # max) takes: its lanes then add exp(-inf) = 0, not NaN
            if HAS_MASK:
                ms = tl.where(tl.abs(m_new) < float("inf"), m_new, 0.0)
            else:
                ms = tl.where(m_new == float("-inf"), 0.0, m_new)
            l = l * tl.exp(m - ms) + tl.sum(tl.exp(x - ms), axis=0)
            m = m_new
        if HAS_MASK:
            m = tl.where(tl.abs(m) < float("inf"), m, 0.0)
            l = tl.maximum(l, 1e-30, propagate_nan=tl.PropagateNan.ALL)
        for c0 in range(0, d, BLOCK_D):
            c = c0 + tl.arange(0, BLOCK_D)
            valid = c < d
            x = tl.load(x_row + c, mask=valid, other=0.0).to(tl.float32) * scale
            if HAS_MASK:
                valid = valid & (tl.load(m_row + c, mask=c < d, other=0) != 0)
            x = tl.where(valid, x, float("-inf"))
            y = tl.div_rn(tl.exp(x - m), l)
            tl.store(o_row + c, y.to(o_ptr.dtype.element_ty), mask=c < d)


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


def _layout(rows: int, d: int) -> tuple[bool, int, int, int]:
    """(ONE_PASS, BLOCK_R, BLOCK_D, num_warps): whole rows, about a
    thousand elements a program, up to ``MAX_ONE_PASS`` columns; else one
    row a program in ``WIDE_BLOCK`` column steps."""
    block_d = build.next_pow2(d)
    if block_d > MAX_ONE_PASS:
        return False, 1, WIDE_BLOCK, 8
    block_r = min(max(1, 1024 // block_d), build.next_pow2(rows))
    return True, block_r, block_d, 4 if block_r * block_d <= 2048 else 8


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


def _run(x, mask, scale: float):
    global _JIT
    rows, d = x.shape
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    one_pass, block_r, block_d, warps = _layout(rows, d)
    if _JIT is None:
        _JIT = build.triton_jit(_softmax_kernel)
    # the bool mask is read as bytes
    m = mask.view(torch.uint8) if mask is not None else x
    _JIT[(-(-rows // block_r),)](
        x, m, out, rows, d, x.stride(0), m.stride(0), float(scale),
        HAS_MASK=mask is not None, ONE_PASS=one_pass, BLOCK_R=block_r,
        BLOCK_D=block_d, num_warps=warps)
    return out


def _launch(x, scale: float):
    _check("softmax", x)
    out = _run(x, None, scale)
    launches[build.signature(x, scale)] += 1
    return out


def _launch_masked(x, mask, scale: float):
    _check("softmax_masked", x, mask)
    out = _run(x, mask, scale)
    masked_launches[build.signature(x, mask, scale)] += 1
    return out


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
