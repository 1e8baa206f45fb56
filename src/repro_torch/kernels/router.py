"""MoE top-k router: the port of the reference's ``_router_kernel``
(``src/repro/kernels/router.py``): softmax over the experts, the k largest
probabilities in order and renormalisation in one pass over the router
logits.

The kernel is CUDA C++ for ``sm_90a`` (``repro_torch/csrc/router.cu``,
built by :mod:`.build` at first use and bound with ``ctypes``); its source
note gives the bound and the design: each column's slot is the count of
the row's columns that beat it, so no step waits on a previous pick.  It is
the custom op ``repro_torch::topk_router`` with two outputs, weights
``(T, k)`` in the logits' dtype and ids ``(T, k)`` int32: the CPU
implementation is the plain version below, the CUDA implementation
launches the kernel, so ``make_fx`` sees one node with two projections,
which the tracer tags ``_router_kernel`` for the planner's registry.  As in
the reference wrapper, no op surrounds the kernel: the node's one operand
is the logits.  It gives the bits of the kernel of k argmax rounds it
replaced (since retired; ``PERF.md`` keeps its times).

Equal probabilities rank by the lower expert index, in the kernel's counts
and in the plain version's ``argmax`` rounds (``torch.argmax`` returns the
first maximal index); the order of the k ids matters, since the dispatch's
stable sort and its capacity drops follow it.  The kernel takes the
renormalising sum in slot order.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from . import build

__all__ = ["bind", "topk_router", "topk_router_plain", "launches"]

MAX_EXPERTS = 64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset, by build.signature of the arguments
launches: Counter = Counter()
_LIB: ctypes.CDLL | None = None


def topk_router_plain(logits, k: int, renormalize: bool = True):
    """The plain version, the TPU kernel's arithmetic on tensors: f32
    softmax, then k rounds of max / first argmax / mask to -1.
    logits (T, E) -> (weights (T, k) in the logits' dtype, ids (T, k)
    int32)."""
    x = logits.to(torch.float32)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    cols = torch.arange(x.shape[-1], device=x.device)[None, :]
    ws, ids = [], []
    for _ in range(k):
        ws.append(probs.amax(dim=-1))
        idx = probs.argmax(dim=-1)
        ids.append(idx.to(torch.int32))
        probs = torch.where(cols == idx[:, None], -1.0, probs)
    w = torch.stack(ws, dim=-1)
    if renormalize:
        w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return w.to(logits.dtype), torch.stack(ids, dim=-1)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``router`` library."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_topk_router.argtypes = [vp] * 3 + [ci] * 4 + [cl] * 2 + [ci, vp]
    lib.repro_topk_router.restype = ci
    lib.repro_cuda_error_string.argtypes = [ci]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build.library("router"))))
    return _LIB


def _launch(logits, k: int, renormalize: bool = True):
    """One launch of the kernel, after the checks, counted."""
    if logits.dim() != 2:
        raise ValueError(f"topk_router: logits {tuple(logits.shape)}, need "
                         f"(T, E)")
    T, E = logits.shape
    if logits.dtype not in _DTYPES:
        raise TypeError(f"topk_router: logits {logits.dtype}; the kernel "
                        f"takes float32 or bfloat16")
    if not 1 <= E <= MAX_EXPERTS or not 1 <= k <= E:
        raise ValueError(f"topk_router: E={E}, k={k}: the kernel takes "
                         f"1 <= k <= E <= {MAX_EXPERTS}")
    if T and logits.stride(1) != 1:
        raise ValueError(f"topk_router: logits strides {logits.stride()}: the "
                         f"last dimension must be contiguous")
    dev = logits.device
    w = torch.empty((T, k), dtype=logits.dtype, device=dev)
    ids = torch.empty((T, k), dtype=torch.int32, device=dev)
    err = _lib().repro_topk_router(
        logits.data_ptr(), w.data_ptr(), ids.data_ptr(), _DTYPES[logits.dtype],
        T, E, k, logits.stride(0), logits.stride(1), int(bool(renormalize)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = _lib().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"topk_router kernel launch failed: {msg} ({err})")
    launches[build.signature(logits, k, renormalize)] += 1
    return w, ids


@torch.library.custom_op("repro_torch::topk_router", mutates_args=(),
                         device_types="cpu")
def topk_router_op(logits: torch.Tensor, k: int,
                   renormalize: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    return topk_router_plain(logits, k, renormalize)


topk_router_op.register_kernel("cuda")(_launch)


@topk_router_op.register_fake
def _(logits, k, renormalize=True):
    T = logits.shape[0]
    return (logits.new_empty((T, k)),
            logits.new_empty((T, k), dtype=torch.int32))


def topk_router(logits, k: int, renormalize: bool = True):
    """logits (T, E) -> (weights (T, k) in the logits' dtype, ids (T, k)
    int32): the kernel on a CUDA tensor, the plain version on a CPU one."""
    return topk_router_op(logits, int(k), bool(renormalize))
