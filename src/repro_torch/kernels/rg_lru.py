"""RG-LRU recurrence: the port of the reference's ``_rglru_kernel``
(``src/repro/kernels/rg_lru.py``), RecurrentGemma's gated diagonal linear
recurrence with an f32 state of ``(batch, channels)``.

The kernel is CUDA C++ for ``sm_90a`` (``repro_torch/csrc/rg_lru.cu``,
built by :mod:`.build` at first use and bound with ``ctypes``); its source
note gives the bound and the design.  The library holds two kernels: the
"tiles" kernel, which the op launches (a block's warps compute the gates of
a tile of channels and steps, two of them walk its chain), and the
"thread" kernel it replaced (one thread walks all of L for a channel),
kept as a yardstick that ``chip_smoke.py`` times on the same operands
through :func:`_launch_variant`.  Both compute each element with the same
rounded operations in the same order, so they give the same bits.  It is
the custom op ``repro_torch::rg_lru``: the CPU implementation is the plain
version below, the CUDA implementation launches the kernel, so ``make_fx``
sees one node, which the tracer tags ``_rglru_kernel``.  The planner's
registry does not know that name (nor does the reference's), so the node
cuts the graph: the gate chain is stitched inside the kernel, the paper's
large-granularity dedicated kernel.  As in the reference wrapper, no op
surrounds the kernel: the node's operands are x, the two gates and Lambda
as the model passes them.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from . import build
from .ref import softplus

__all__ = ["bind", "rg_lru", "rg_lru_plain", "launches", "newton_mismatches"]

# dtype codes of the C interface; any other dtype passes a code the C
# entry point refuses
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_UNSUPPORTED = 99

# kernel launches since the last reset, by build.signature of the arguments
launches: Counter = Counter()
_LIB: ctypes.CDLL | None = None


def rg_lru_plain(x, input_gate, rec_gate, Lambda, c: float = 8.0):
    """The plain version, the kernel's loop on tensors, every value in f32:
    ``a = exp((-c * softplus(Lambda)) * sigmoid(rec_gate_t))``, ``h = a * h
    + sqrt(max(1 - a * a, 1e-12)) * (sigmoid(input_gate_t) * x_t)``, each
    h_t rounded once to x's dtype.  x and the gates (B, L, D); Lambda
    (D,)."""
    xf, igf = x.to(torch.float32), input_gate.to(torch.float32)
    rgf = rec_gate.to(torch.float32)
    neg_c_lam = -c * softplus(Lambda.to(torch.float32))
    h = xf.new_zeros((x.shape[0], x.shape[2]))
    y = torch.empty_like(xf)
    for t in range(x.shape[1]):
        a = torch.exp(neg_c_lam * torch.sigmoid(rgf[:, t]))
        mult = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
        h = a * h + mult * (torch.sigmoid(igf[:, t]) * xf[:, t])
        y[:, t] = h
    return y.to(x.dtype)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``rg_lru`` library."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.repro_rg_lru, lib.repro_rg_lru_thread):
        fn.argtypes = [vp] * 5 + [ci] * 6 + [ctypes.c_float] + [cl] * 9 + [vp]
        fn.restype = ci
    lib.repro_rg_lru_newton_mismatches.argtypes = [vp, vp]
    lib.repro_rg_lru_newton_mismatches.restype = ci
    lib.repro_cuda_error_string.argtypes = [ci]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build.library("rg_lru"))))
    return _LIB


def _launch(x, input_gate, rec_gate, Lambda, c: float = 8.0):
    y = _launch_variant("tiles", x, input_gate, rec_gate, Lambda, c)
    launches[build.signature(x, input_gate, rec_gate, Lambda, c)] += 1
    return y


def _launch_variant(variant: str, x, input_gate, rec_gate, Lambda,
                    c: float = 8.0):
    """One launch of the tiles kernel (``variant="tiles"``, the one the op
    launches) or the thread kernel it replaced (``"thread"``), with the
    op's checks and no launch counted."""
    entry = {"tiles": "repro_rg_lru",
             "thread": "repro_rg_lru_thread"}.get(variant)
    if entry is None:
        raise ValueError(f"rg_lru: unknown variant {variant!r}")
    if x.dim() != 3 or tuple(input_gate.shape) != tuple(x.shape) \
            or tuple(rec_gate.shape) != tuple(x.shape):
        raise ValueError(f"rg_lru: x {tuple(x.shape)}, input_gate "
                         f"{tuple(input_gate.shape)}, rec_gate "
                         f"{tuple(rec_gate.shape)}; need all three (B, L, D)")
    B, L, D = x.shape
    if tuple(Lambda.shape) != (D,) or Lambda.dtype != torch.float32:
        raise ValueError(f"rg_lru: Lambda {Lambda.dtype} "
                         f"{tuple(Lambda.shape)}; need float32 ({D},)")
    if any(t.device != x.device for t in (input_gate, rec_gate, Lambda)):
        raise ValueError("rg_lru: all operands must be on x's device")
    Lambda = Lambda.contiguous()
    y = torch.empty((B, L, D), dtype=x.dtype, device=x.device)
    code = lambda t: _DTYPES.get(t.dtype, _UNSUPPORTED)  # noqa: E731
    err = getattr(_lib(), entry)(
        x.data_ptr(), input_gate.data_ptr(), rec_gate.data_ptr(),
        Lambda.data_ptr(), y.data_ptr(), code(x), code(input_gate),
        code(rec_gate), B, L, D, float(c), *x.stride(), *input_gate.stride(),
        *rec_gate.stride(), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        msg = _lib().repro_cuda_error_string(err).decode()
        if err < 0:
            raise ValueError(f"rg_lru: {msg} (x {x.dtype} {tuple(x.shape)} "
                             f"strides {x.stride()}, gates {input_gate.dtype}, "
                             f"{rec_gate.dtype})")
        raise RuntimeError(f"rg_lru {variant} kernel launch failed: {msg} "
                           f"({err})")
    return y


def newton_mismatches(device) -> tuple[int, int]:
    """The floats where the tiles kernel's branch-free reciprocal (on
    [1, 2^126)) and square root (on [1e-12, 1]) differ from the IEEE
    division and ``sqrtf`` they stand for, counted on ``device`` over every
    float of those domains: (0, 0) when the tiles kernel's gates are the
    thread kernel's bit for bit."""
    out = torch.zeros(2, dtype=torch.int64, device=device)
    err = _lib().repro_rg_lru_newton_mismatches(
        out.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream)
    if err:
        raise RuntimeError(f"rg_lru newton check launch failed: "
                           f"{_lib().repro_cuda_error_string(err).decode()}")
    return tuple(int(v) for v in out.tolist())


@torch.library.custom_op("repro_torch::rg_lru", mutates_args=(),
                         device_types="cpu")
def rg_lru_op(x: torch.Tensor, input_gate: torch.Tensor,
              rec_gate: torch.Tensor, Lambda: torch.Tensor,
              c: float = 8.0) -> torch.Tensor:
    return rg_lru_plain(x, input_gate, rec_gate, Lambda, c)


rg_lru_op.register_kernel("cuda")(_launch)


@rg_lru_op.register_fake
def _(x, input_gate, rec_gate, Lambda, c=8.0):
    return x.new_empty(x.shape)


def rg_lru(x, input_gate, rec_gate, Lambda, c: float = 8.0):
    """x, input_gate, rec_gate (B, L, D); Lambda (D,) f32 -> every h_t
    (B, L, D) in x's dtype: the kernel on CUDA tensors, the plain version on
    CPU ones."""
    return rg_lru_op(x, input_gate, rec_gate, Lambda, float(c))
