"""Mamba-1 selective scan: the port of the reference's ``_mamba_kernel``
(``src/repro/kernels/mamba_scan.py``), sequential over the time axis with
an f32 state of ``(channels, d_state)``.

The kernel is CUDA C++ for ``sm_90a`` (``repro_torch/csrc/mamba_scan.cu``,
built by :mod:`.build` at first use and bound with ``ctypes``); its source
note gives the bound and the design.  The kernel spreads a channel's
states over 4 lanes of a warp and adds a step's states in increasing n, as
one thread a channel did; :func:`mamba_scan_lanes_plain` spells that
arithmetic and order of sums in PyTorch.  It is the custom op
``repro_torch::mamba_scan``: the CPU implementation is the plain version
below, the CUDA implementation launches the kernel, so ``make_fx`` sees
one node, which the tracer tags ``_mamba_kernel``.  The planner's registry
does not know that name, so the node cuts the graph and the planner
stitches the pointwise halo around it, as in the reference (its docstring:
the paper's "large-granularity dedicated implementation").  As in the
reference wrapper, no op surrounds the kernel: the node's operands are x,
delta, A, B, C and D as the model passes them.

B and C may be strided views (columns of the model's ``dbc`` projection):
the kernel reads them through their strides.  x and delta need a unit
channel stride, and get one here when they lack it.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from . import build

__all__ = ["bind", "mamba_scan", "mamba_scan_plain", "mamba_scan_lanes_plain",
           "launches"]

# dtype codes of the C interface; any other dtype passes a code the C
# entry point refuses
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_UNSUPPORTED = 99

# kernel launches since the last reset, by build.signature of the arguments
launches: Counter = Counter()
_LIB: ctypes.CDLL | None = None


def mamba_scan_plain(x, delta, A, B, C, D):
    """The plain version, the kernel's recurrence on tensors, every value in
    f32: ``h = exp(dt * A) * h + (dt * x) * B_t``, ``y_t = sum_n h * C_t +
    D * x_t``, rounded once to x's dtype.  x, delta (Bb, L, Dm); A (Dm, N);
    B, C (Bb, L, N); D (Dm,)."""
    xf, df = x.to(torch.float32), delta.to(torch.float32)
    Af, Bf, Cf = A.to(torch.float32), B.to(torch.float32), C.to(torch.float32)
    Df = D.to(torch.float32)
    Bb, L, Dm = x.shape
    h = xf.new_zeros((Bb, Dm, A.shape[1]))
    y = torch.empty_like(xf)
    for t in range(L):
        d_t = df[:, t]
        h = torch.exp(d_t[..., None] * Af) * h \
            + (d_t * xf[:, t])[..., None] * Bf[:, t, None, :]
        y[:, t] = (h * Cf[:, t, None, :]).sum(-1) + Df * xf[:, t]
    return y.to(x.dtype)


def mamba_scan_lanes_plain(x, delta, A, B, C, D):
    """The lanes kernel's arithmetic on tensors, every value in f32: the
    recurrence as in :func:`mamba_scan_plain`, and ``sum_n h[n] * C[n]``
    added one state at a time in increasing n, the order of one thread's
    loop, which the lanes kernel keeps by handing the sum from lane to
    lane."""
    xf, df = x.to(torch.float32), delta.to(torch.float32)
    Af = A.to(torch.float32)
    Bf, Cf = B.to(torch.float32), C.to(torch.float32)
    Df = D.to(torch.float32)
    Bb, L, Dm = x.shape
    h = xf.new_zeros((Bb, Dm, A.shape[1]))
    y = torch.empty_like(xf)
    for t in range(L):
        d_t = df[:, t]
        h = torch.exp(d_t[..., None] * Af) * h \
            + (d_t * xf[:, t])[..., None] * Bf[:, t, None, :]
        hc = h * Cf[:, t, None, :]
        acc = xf.new_zeros((Bb, Dm))
        for n in range(A.shape[1]):
            acc = acc + hc[..., n]
        y[:, t] = acc + Df * xf[:, t]
    return y.to(x.dtype)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``mamba_scan`` library."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_mamba_scan.argtypes = [vp] * 7 + [ci] * 6 + [cl] * 10 + [vp]
    lib.repro_mamba_scan.restype = ci
    lib.repro_cuda_error_string.argtypes = [ci]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build.library("mamba_scan"))))
    return _LIB


def _launch(x, delta, A, B, C, D):
    if x.dim() != 3 or tuple(delta.shape) != tuple(x.shape):
        raise ValueError(f"mamba_scan: x {tuple(x.shape)}, delta "
                         f"{tuple(delta.shape)}; need both (Bb, L, Dm)")
    Bb, L, Dm = x.shape
    N = A.shape[-1] if A.dim() == 2 else -1
    if (tuple(A.shape) != (Dm, N) or tuple(B.shape) != (Bb, L, N)
            or tuple(C.shape) != (Bb, L, N) or tuple(D.shape) != (Dm,)):
        raise ValueError(f"mamba_scan: A {tuple(A.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}, D {tuple(D.shape)}; need (Dm, N), "
                         f"(Bb, L, N), (Bb, L, N), (Dm,) for x {tuple(x.shape)}")
    if any(t.dtype != torch.float32 for t in (A, B, C, D)):
        raise TypeError(f"mamba_scan: A, B, C, D must be float32, got "
                        f"{[str(t.dtype) for t in (A, B, C, D)]}")
    if any(t.device != x.device for t in (delta, A, B, C, D)):
        raise ValueError("mamba_scan: all operands must be on x's device")
    x = x if x.stride(2) == 1 else x.contiguous()
    delta = delta if delta.stride(2) == 1 else delta.contiguous()
    A, D = A.contiguous(), D.contiguous()
    y = torch.empty((Bb, L, Dm), dtype=x.dtype, device=x.device)
    err = _lib().repro_mamba_scan(
        x.data_ptr(), delta.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), y.data_ptr(),
        _DTYPES.get(x.dtype, _UNSUPPORTED), _DTYPES.get(delta.dtype, _UNSUPPORTED),
        Bb, L, Dm, N, x.stride(0), x.stride(1), delta.stride(0),
        delta.stride(1), *B.stride(), *C.stride(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        msg = _lib().repro_cuda_error_string(err).decode()
        if err < 0:
            raise ValueError(f"mamba_scan: {msg} (x {x.dtype} {tuple(x.shape)}, "
                             f"delta {delta.dtype}, N={N})")
        raise RuntimeError(f"mamba_scan kernel launch failed: {msg} ({err})")
    launches[build.signature(x, delta, A, B, C, D)] += 1
    return y


@torch.library.custom_op("repro_torch::mamba_scan", mutates_args=(),
                         device_types="cpu")
def mamba_scan_op(x: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor,
                  D: torch.Tensor) -> torch.Tensor:
    return mamba_scan_plain(x, delta, A, B, C, D)


mamba_scan_op.register_kernel("cuda")(_launch)


@mamba_scan_op.register_fake
def _(x, delta, A, B, C, D):
    return x.new_empty(x.shape)


def mamba_scan(x, delta, A, B, C, D):
    """x, delta (Bb, L, Dm); A (Dm, N); B, C (Bb, L, N); D (Dm,) -> y
    (Bb, L, Dm) in x's dtype: the kernel on CUDA tensors, the plain version
    on CPU ones."""
    return mamba_scan_op(x, delta, A, B, C, D)
