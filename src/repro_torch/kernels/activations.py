"""MLP activations: SwiGLU and GeGLU, the port of the reference's
``_glu_kernel`` (``src/repro/kernels/activations.py:17``), and squared
ReLU, the port of its ``_sqrelu_kernel`` (``:54``); Triton kernels.

Bound on this card: bytes.  One elementwise pass reads gate and up once
and writes the product once, where the unfused chain makes four or five
round trips.  Design: a 2-D grid of (row, block of ``BLOCK`` columns) over
the (rows, F) operands (rows may be strided, columns contiguous); each
program computes ``act(gate) * up`` in f32 and casts once.  ``ACT`` is a
compile-time switch: 0 is SiLU (``g * sigmoid(g)``), 1 is the tanh form of
GELU, which is what ``jax.nn.gelu`` computes by default and
``F.gelu(approximate="tanh")`` in the plain version.

Squared ReLU is bound by bytes too: 100.7 MB a launch at nemotron-4-15b's
prefill, (1024, 24576) bf16, 30.0 us at 3.35 TB/s.  Design: one flat
elementwise pass over the contiguous operand, ``BLOCK`` elements a
program: ``r = max(x, 0)`` in f32 (NaN stays NaN, as in ``jnp.maximum``),
``r * r``, one cast out.

They are the custom ops ``repro_torch::glu(gate, up, act)`` and
``repro_torch::squared_relu(x)``: the CPU implementation is the plain
version, the CUDA implementation launches the kernel.  :func:`swiglu`,
:func:`geglu` and :func:`squared_relu` reshape to ``(rows, F)`` outside
the op, as the reference wrappers do.
"""

from __future__ import annotations

from collections import Counter

import torch

from . import build
from . import ref as _ref

__all__ = ["swiglu", "geglu", "glu_plain", "launches", "squared_relu",
           "squared_relu_plain", "sqrelu_launches"]

_ACTS = {"silu": 0, "gelu": 1}
_FLOAT = (torch.float32, torch.bfloat16)
BLOCK = 1024

# kernel launches since the last reset, by build.signature of the arguments
launches: Counter = Counter()               # _glu_kernel
sqrelu_launches: Counter = Counter()        # _sqrelu_kernel
_JIT = _SQ_JIT = None
tl = libdevice = None  # bound by build.triton_jit at the first launch


def _glu_kernel(g_ptr, u_ptr, o_ptr, F, stride_g, stride_u,
                ACT: tl.constexpr, BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    col = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
    mask = col < F
    g = tl.load(g_ptr + row * stride_g + col, mask=mask, other=0.0).to(tl.float32)
    u = tl.load(u_ptr + row * stride_u + col, mask=mask, other=0.0).to(tl.float32)
    if ACT == 0:
        a = g * tl.sigmoid(g)
    else:
        a = 0.5 * g * (1.0 + libdevice.tanh(
            0.7978845608028654 * (g + 0.044715 * g * g * g)))
    tl.store(o_ptr + row * F + col, (a * u).to(o_ptr.dtype.element_ty), mask=mask)


def _sqrelu_kernel(x_ptr, o_ptr, n, BLOCK: tl.constexpr):
    off = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = off < n
    x = tl.load(x_ptr + off, mask=mask, other=0.0).to(tl.float32)
    r = tl.maximum(x, 0.0, propagate_nan=tl.PropagateNan.ALL)
    tl.store(o_ptr + off, (r * r).to(o_ptr.dtype.element_ty), mask=mask)


def glu_plain(gate, up, act: str):
    """The plain version: the reference's ``ref`` oracles."""
    if act == "silu":
        return _ref.swiglu(gate, up)
    return _ref.geglu(gate, up)


def _launch(gate, up, act: str):
    global _JIT
    if act not in _ACTS:
        raise ValueError(f"glu: act {act!r}, expected one of {sorted(_ACTS)}")
    if gate.dim() != 2 or gate.shape != up.shape or gate.dtype != up.dtype \
            or gate.dtype not in _FLOAT:
        raise ValueError(f"glu: gate {tuple(gate.shape)} {gate.dtype}, up "
                         f"{tuple(up.shape)} {up.dtype}; need equal (rows, F)")
    if up.device != gate.device:
        raise ValueError(f"glu: up on {up.device}, gate on {gate.device}")
    if gate.stride(1) != 1 or up.stride(1) != 1:
        raise ValueError(f"glu: strides {gate.stride()}, {up.stride()}: rows "
                         f"must be contiguous")
    rows, F = gate.shape
    out = torch.empty((rows, F), dtype=gate.dtype, device=gate.device)
    if _JIT is None:
        _JIT = build.triton_jit(_glu_kernel)
    _JIT[(rows, -(-F // BLOCK))](gate, up, out, F, gate.stride(0), up.stride(0),
                                ACT=_ACTS[act], BLOCK=BLOCK, num_warps=4)
    launches[build.signature(gate, up, act)] += 1
    return out


def squared_relu_plain(x):
    """The plain version: the reference's ``ref`` oracle."""
    return _ref.squared_relu(x)


def _launch_sqrelu(x):
    global _SQ_JIT
    if x.dtype not in _FLOAT:
        raise TypeError(f"squared_relu: dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"squared_relu: x strides {x.stride()}: must be "
                         f"contiguous")
    out = torch.empty_like(x)
    n = x.numel()
    if _SQ_JIT is None:
        _SQ_JIT = build.triton_jit(_sqrelu_kernel)
    _SQ_JIT[(max(1, -(-n // BLOCK)),)](x, out, n, BLOCK=BLOCK, num_warps=4)
    sqrelu_launches[build.signature(x)] += 1
    return out


@torch.library.custom_op("repro_torch::glu", mutates_args=(), device_types="cpu")
def glu_op(gate: torch.Tensor, up: torch.Tensor, act: str) -> torch.Tensor:
    return glu_plain(gate, up, act)


glu_op.register_kernel("cuda")(_launch)


@glu_op.register_fake
def _(gate, up, act):
    return gate.new_empty(gate.shape)


def _glu(gate, up, act: str):
    F = gate.shape[-1]
    out = glu_op(gate.reshape(-1, F), up.reshape(-1, F), act)
    return out.reshape(gate.shape)


def swiglu(gate, up):
    return _glu(gate, up, "silu")


def geglu(gate, up):
    return _glu(gate, up, "gelu")


@torch.library.custom_op("repro_torch::squared_relu", mutates_args=(),
                         device_types="cpu")
def squared_relu_op(x: torch.Tensor) -> torch.Tensor:
    return squared_relu_plain(x)


squared_relu_op.register_kernel("cuda")(_launch_sqrelu)


@squared_relu_op.register_fake
def _(x):
    return x.new_empty(x.shape)


def squared_relu(x):
    F = x.shape[-1]
    return squared_relu_op(x.reshape(-1, F)).reshape(x.shape)
