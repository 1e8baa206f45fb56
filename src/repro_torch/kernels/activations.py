"""MLP activations: SwiGLU and GeGLU, the port of the reference's
``_glu_kernel`` (``src/repro/kernels/activations.py:17``), and squared
ReLU, the port of its ``_sqrelu_kernel`` (``:54``).

SwiGLU and GeGLU are CUDA C++ for ``sm_90a`` (``repro_torch/csrc/
activations.cu``, built by :mod:`.build` at first use and bound with
``ctypes``); its source note gives the bound, the design and the rounded
operations.  It computes what the Triton ``_glu_kernel`` it replaced
computed (since retired; ``PERF.md`` keeps its times), bit for bit:
``act(gate) * up`` in f32 with the same rounded operations (SiLU as
``1 / (1 + 2^(-g log2 e))`` with Triton's approximate ``ex2`` and
``div.full``; GeGLU's tanh, the tanh GELU that ``jax.nn.gelu`` computes by
default and ``F.gelu(approximate="tanh")`` in the plain version, as
Triton's libdevice ``tanhf``) and one cast out; a block of 128 threads
takes 1024 columns of a row (or several rows narrower than that) in
16-byte loads.

Squared ReLU is a Triton kernel, bound by bytes: 100.7 MB a launch at
nemotron-4-15b's prefill, (1024, 24576) bf16, 30.0 us at 3.35 TB/s.
Design: one flat elementwise pass over the contiguous operand, ``BLOCK``
elements a program: ``r = max(x, 0)`` in f32 (NaN stays NaN, as in
``jnp.maximum``), ``r * r``, one cast out.

They are the custom ops ``repro_torch::glu(gate, up, act)`` and
``repro_torch::squared_relu(x)``: the CPU implementation is the plain
version, the CUDA implementation launches the kernel.  :func:`swiglu`,
:func:`geglu` and :func:`squared_relu` reshape to ``(rows, F)`` outside
the op, as the reference wrappers do.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from . import build
from . import ref as _ref

__all__ = ["bind", "swiglu", "geglu", "glu_plain", "launches",
           "squared_relu", "squared_relu_plain", "sqrelu_launches"]

_ACTS = {"silu": 0, "gelu": 1}
_FLOAT = {torch.float32: 0, torch.bfloat16: 1}
BLOCK = 1024          # squared ReLU's elements a program

# kernel launches since the last reset, by build.signature of the arguments
launches: Counter = Counter()               # _glu_kernel
sqrelu_launches: Counter = Counter()        # _sqrelu_kernel
_SQ_JIT = None
_LIB: ctypes.CDLL | None = None
tl = None  # bound by build.triton_jit at the first launch


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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``activations`` library."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_glu.argtypes = [vp, vp, vp, ci, ci, cl, cl, cl, cl, vp]
    lib.repro_glu.restype = ci
    lib.repro_cuda_error_string.argtypes = [ci]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build.library("activations"))))
    return _LIB


def _launch(gate, up, act: str):
    """One launch of the CUDA kernel on (rows, F) gate and up, after the
    checks, counted."""
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
    err = _lib().repro_glu(
        gate.data_ptr(), up.data_ptr(), out.data_ptr(), _FLOAT[gate.dtype],
        _ACTS[act], rows, F, gate.stride(0), up.stride(0),
        torch.cuda.current_stream(gate.device).cuda_stream)
    if err:
        msg = _lib().repro_cuda_error_string(err).decode()
        if err < 0:
            raise ValueError(f"glu: {msg} (gate {gate.dtype} "
                             f"{tuple(gate.shape)} strides {gate.stride()}, "
                             f"up strides {up.stride()})")
        raise RuntimeError(f"glu kernel launch failed: {msg} ({err})")
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
