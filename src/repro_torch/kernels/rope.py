"""Rotary position embedding: the port of the reference's ``_rope_kernel``
(``src/repro/kernels/rope.py:19``), a Triton kernel.

Bound on this card: bytes.  The kernel reads x once and writes it once; the
angle tables are recomputed in registers from each row's position (compute
is free beside the traffic), so no cos/sin table is materialized.  Design:
one program per token row of ``(B*L, H*Dh)``; it computes
``freq = theta^(-i/half)`` and ``cos``/``sin`` of ``pos * freq`` once for
the row, as a ``(1, half)`` tile (the power and the trig functions in f64,
rounded to f32 once: ``half`` values a row, nothing beside the row's
traffic), and rotates the two halves of every head
(``[x1*c - x2*s, x2*c + x1*s]``, not interleaved pairs) as an
``(H, half)`` tile.  Positions are cast to f32 in the kernel, as the
reference does.

It is the custom op ``repro_torch::rope(x, positions, theta, head_dim)``
over ``x (B*L, H*Dh)``, ``positions (B*L,)``: the CPU implementation is the
plain version, the CUDA implementation launches the kernel.  :func:`rope`
makes the 2-D views outside the op, as the reference wrapper does.
"""

from __future__ import annotations

from collections import Counter

import torch

from . import build
from . import ref as _ref

__all__ = ["rope", "rope_plain", "launches"]

_FLOAT = (torch.float32, torch.bfloat16)

# kernel launches since the last reset, by build.signature of the arguments
launches: Counter = Counter()
_JIT = None
tl = libdevice = None  # bound by build.triton_jit at the first launch


def _rope_kernel(x_ptr, pos_ptr, o_ptr, stride_x, stride_pos, theta, H,
                 HALF: tl.constexpr, BLOCK_H: tl.constexpr,
                 BLOCK_HALF: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    h = tl.arange(0, BLOCK_H)[:, None]
    i = tl.arange(0, BLOCK_HALF)[None, :]
    mask = (h < H) & (i < HALF)
    pos = tl.load(pos_ptr + row * stride_pos).to(tl.float32)
    # the f32 steps of the reference, each rounded once: e = i / half,
    # p = theta^e, freq = 1 / p, ang = pos * freq, then cos and sin.  The
    # power and the trig functions go through f64 so that their f32 values
    # are correctly rounded: an ulp off in freq is pos ulps off in the
    # angle, and Triton's default f32 division is approximate, hence div_rn.
    e = tl.div_rn(i.to(tl.float32), 1.0 * HALF)
    p = libdevice.pow(theta.to(tl.float64), e.to(tl.float64)).to(tl.float32)
    ang = pos * tl.div_rn(1.0, p)
    c = libdevice.cos(ang.to(tl.float64)).to(tl.float32)
    s = libdevice.sin(ang.to(tl.float64)).to(tl.float32)
    src = x_ptr + row * stride_x + h * (2 * HALF) + i
    x1 = tl.load(src, mask=mask, other=0.0).to(tl.float32)
    x2 = tl.load(src + HALF, mask=mask, other=0.0).to(tl.float32)
    dst = o_ptr + row * (H * 2 * HALF) + h * (2 * HALF) + i
    dt = o_ptr.dtype.element_ty
    tl.store(dst, (x1 * c - x2 * s).to(dt), mask=mask)
    tl.store(dst + HALF, (x2 * c + x1 * s).to(dt), mask=mask)


def rope_plain(x, positions, theta: float, head_dim: int):
    """The plain version: the reference's ``ref`` oracle on the
    ``(rows, H, Dh)`` view."""
    rows, width = x.shape
    xr = x.reshape(rows, width // head_dim, head_dim)
    return _ref.rope(xr, positions, theta).reshape(rows, width)


def _launch(x, positions, theta: float, head_dim: int):
    global _JIT
    if x.dim() != 2 or head_dim % 2 or x.shape[1] % head_dim \
            or tuple(positions.shape) != (x.shape[0],):
        raise ValueError(f"rope: x {tuple(x.shape)}, positions "
                         f"{tuple(positions.shape)}, head_dim {head_dim}")
    if x.dtype not in _FLOAT or positions.dtype.is_floating_point:
        raise TypeError(f"rope: x {x.dtype}, positions {positions.dtype}")
    if positions.device != x.device:
        raise ValueError(f"rope: positions on {positions.device}, x on {x.device}")
    if x.stride(1) != 1:
        raise ValueError(f"rope: x strides {x.stride()}: rows must be contiguous")
    rows, width = x.shape
    H, half = width // head_dim, head_dim // 2
    out = torch.empty((rows, width), dtype=x.dtype, device=x.device)
    if _JIT is None:
        _JIT = build.triton_jit(_rope_kernel)
    _JIT[(rows,)](x, positions, out, x.stride(0), positions.stride(0),
                  float(theta), H,
                  HALF=half, BLOCK_H=build.next_pow2(H),
                  BLOCK_HALF=build.next_pow2(half), num_warps=4)
    launches[build.signature(x, positions, theta, head_dim)] += 1
    return out


@torch.library.custom_op("repro_torch::rope", mutates_args=(), device_types="cpu")
def rope_op(x: torch.Tensor, positions: torch.Tensor, theta: float,
            head_dim: int) -> torch.Tensor:
    return rope_plain(x, positions, theta, head_dim)


rope_op.register_kernel("cuda")(_launch)


@rope_op.register_fake
def _(x, positions, theta, head_dim):
    return x.new_empty(x.shape)


def rope(x, positions, theta: float = 10000.0):
    """x: (B, L, H, Dh); positions: (B, L).  Returns rotated x."""
    B, L, H, Dh = x.shape
    out = rope_op(x.reshape(B * L, H * Dh), positions.reshape(B * L),
                  float(theta), Dh)
    return out.reshape(B, L, H, Dh)
