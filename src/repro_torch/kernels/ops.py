"""Model-facing kernel API.

The reference dispatches these between its Pallas kernels and plain
oracles with ``kernel_mode``; its serving path runs the ``ref`` mode, and
the port has only that mode so far: each wrapper is the plain oracle of
:mod:`.ref`.  The fused kernels of the serving path are the generated
stitched kernels the compiler emits around these ops.
"""

from __future__ import annotations

from . import ref as _ref

__all__ = ["rmsnorm", "swiglu", "rope", "attention"]


def rmsnorm(x, gamma, eps: float = 1e-6):
    return _ref.rmsnorm(x, gamma, eps)


def swiglu(gate, up):
    return _ref.swiglu(gate, up)


def rope(x, positions, theta: float = 10000.0):
    return _ref.rope(x, positions, theta)


def attention(q, k, v, *, causal: bool = True, scale: float | None = None,
              window: int | None = None, positions_q=None):
    return _ref.attention(q, k, v, causal=causal, scale=scale, window=window,
                          positions_q=positions_q)
