"""Model-facing kernel API: wrappers that dispatch between the hand-written
kernels and the plain oracles.

``kernel_mode`` decides the backend, as in the reference
(``repro/kernels/ops.py``):

* ``"kernels"`` — the hand-written kernels, the counterpart of the
  reference's ``"pallas"`` mode: RMSNorm, the residual add + RMSNorm,
  LayerNorm, RoPE, SwiGLU/GeGLU, squared ReLU, the scaled (and masked)
  softmax and the cross-entropy in Triton, decode attention, flash
  attention, the MoE router, the Mamba-1 selective scan and the RG-LRU
  recurrence in CUDA C++.  Each is a ``torch.library`` custom op, so the
  tracer sees one node (with a projection per output) and tags it with the
  reference kernel's name; the planner's registry prices the tags it knows
  and cuts the graph at the others (squared ReLU, the softmaxes, the
  cross-entropy and the two recurrences), as the reference's does.  On the
  CPU the op runs its plain version.
* ``"ref"`` — the plain-PyTorch oracles of :mod:`.ref`; the default.

The switch is a context variable, read when the model function runs: at
trace time in ``stitch()``'s ``offline`` mode, on every call in ``jit``
mode.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Literal

import torch

from . import activations as _act
from . import cross_entropy as _xent
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import mamba_scan as _mamba
from . import norms as _norms
from . import ref as _ref
from . import rg_lru as _rglru
from . import rope as _rope
from . import router as _router
from . import softmax as _softmax

__all__ = ["KernelMode", "get_mode", "kernel_mode", "rmsnorm",
           "rmsnorm_residual", "layernorm", "softmax", "swiglu", "geglu",
           "squared_relu", "rope", "cross_entropy", "attention",
           "decode_attention", "topk_router", "mamba_scan", "rg_lru",
           "KERNEL_TAGS",
           "launch_counts", "launch_counts_by_signature",
           "launch_counts_by_variant", "reset_launch_counts"]

KernelMode = Literal["kernels", "ref"]
_mode: contextvars.ContextVar[str] = contextvars.ContextVar("kernel_mode",
                                                            default="ref")

# each kernel's launch counter (by build.signature of the arguments), by the
# name its launches are counted under
_KERNELS = {"rmsnorm": _norms.launches, "layernorm": _norms.layernorm_launches,
            "glu": _act.launches, "squared_relu": _act.sqrelu_launches,
            "rope": _rope.launches, "decode_attention": _decode.launches,
            "flash_attention": _flash.launches, "router": _router.launches,
            "mamba_scan": _mamba.launches, "rg_lru": _rglru.launches,
            "rmsnorm_residual": _norms.residual_launches,
            "softmax": _softmax.launches,
            "softmax_masked": _softmax.masked_launches,
            "cross_entropy": _xent.launches}
# the kernels with more than one variant: launches by variant
_VARIANTS = {"flash_attention": _flash.variant_launches,
             "decode_attention": _decode.variant_launches}

# each custom op -> the reference kernel body it ports, the name the
# planner's registry (kernels/registry.py) knows it by; ``_sqrelu_kernel``,
# ``_softmax_kernel``, ``_softmax_masked_kernel``, ``_xent_kernel``,
# ``_mamba_kernel`` and ``_rglru_kernel`` are not in the registry (nor in
# the reference's), so their nodes cut the graph
KERNEL_TAGS = {
    torch.ops.repro_torch.rmsnorm.default: "_rmsnorm_kernel",
    torch.ops.repro_torch.layernorm.default: "_layernorm_kernel",
    torch.ops.repro_torch.glu.default: "_glu_kernel",
    torch.ops.repro_torch.squared_relu.default: "_sqrelu_kernel",
    torch.ops.repro_torch.rope.default: "_rope_kernel",
    torch.ops.repro_torch.decode_attention.default: "_decode_attn_kernel",
    torch.ops.repro_torch.flash_attention.default: "_flash_kernel",
    torch.ops.repro_torch.topk_router.default: "_router_kernel",
    torch.ops.repro_torch.mamba_scan.default: "_mamba_kernel",
    torch.ops.repro_torch.rg_lru.default: "_rglru_kernel",
    torch.ops.repro_torch.rmsnorm_residual.default: "_rmsnorm_residual_kernel",
    torch.ops.repro_torch.softmax.default: "_softmax_kernel",
    torch.ops.repro_torch.softmax_masked.default: "_softmax_masked_kernel",
    torch.ops.repro_torch.cross_entropy.default: "_xent_kernel",
}


def get_mode() -> str:
    return _mode.get()


@contextlib.contextmanager
def kernel_mode(mode: KernelMode):
    if mode not in ("kernels", "ref"):
        raise ValueError(f"kernel mode must be 'kernels' or 'ref', got {mode!r}")
    tok = _mode.set(mode)
    try:
        yield
    finally:
        _mode.reset(tok)


def _use_kernels() -> bool:
    return _mode.get() == "kernels"


def launch_counts() -> dict[str, int]:
    """Launches of each hand-written kernel since the last reset."""
    return {name: sum(c.values()) for name, c in _KERNELS.items()}


def launch_counts_by_signature() -> dict[str, dict[tuple, int]]:
    """The same, per kernel by :func:`.build.signature` of its arguments:
    each tensor's shape and dtype, the other arguments as they are."""
    return {name: dict(c) for name, c in _KERNELS.items()}


def launch_counts_by_variant() -> dict[str, dict[str, int]]:
    """Launches of flash attention by variant (``"sm90"``: wgmma + TMA,
    ``"simt"``: CUDA cores) and of decode attention (``"split"``, its one
    kernel)."""
    return {name: dict(c) for name, c in _VARIANTS.items()}


def reset_launch_counts() -> None:
    for c in (*_KERNELS.values(), *_VARIANTS.values()):
        c.clear()


# -- wrappers -----------------------------------------------------------------

def rmsnorm(x, gamma, eps: float = 1e-6):
    if _use_kernels():
        return _norms.rmsnorm(x, gamma, eps)
    return _ref.rmsnorm(x, gamma, eps)


def rmsnorm_residual(x, res, gamma, eps: float = 1e-6):
    """(RMSNorm of x + res, x + res), each in x's dtype."""
    if _use_kernels():
        return _norms.rmsnorm_residual(x, res, gamma, eps)
    return _ref.rmsnorm_residual(x, res, gamma, eps)


def layernorm(x, gamma, beta, eps: float = 1e-5):
    if _use_kernels():
        return _norms.layernorm(x, gamma, beta, eps)
    return _ref.layernorm(x, gamma, beta, eps)


def softmax(x, scale: float = 1.0, mask=None):
    """``softmax(x * scale)`` over the last axis; a bool ``mask``
    (broadcastable to x) keeps the lanes where it is True.  A fully masked
    row is 0 in kernel mode and NaN in ref mode, as in the reference."""
    if _use_kernels():
        return _softmax.softmax(x, scale, mask)
    return _ref.softmax(x, scale, mask)


def swiglu(gate, up):
    if _use_kernels():
        return _act.swiglu(gate, up)
    return _ref.swiglu(gate, up)


def geglu(gate, up):
    if _use_kernels():
        return _act.geglu(gate, up)
    return _ref.geglu(gate, up)


def squared_relu(x):
    if _use_kernels():
        return _act.squared_relu(x)
    return _ref.squared_relu(x)


def rope(x, positions, theta: float = 10000.0):
    if _use_kernels():
        return _rope.rope(x, positions, theta)
    return _ref.rope(x, positions, theta)


def cross_entropy(logits, labels):
    """logits (B, V), labels (B,) int -> the mean NLL (f32 scalar)."""
    if _use_kernels():
        return _xent.cross_entropy(logits, labels)
    return _ref.cross_entropy(logits, labels)


def attention(q, k, v, *, causal: bool = True, scale: float | None = None,
              window: int | None = None, q_offset: int = 0):
    if _use_kernels():
        return _flash.flash_attention(q, k, v, causal=causal, scale=scale,
                                      window=window, q_offset=q_offset)
    pos_q = None
    if q_offset:
        pos_q = (q_offset + torch.arange(q.shape[1], device=q.device))[None, :]
    return _ref.attention(q, k, v, causal=causal, scale=scale, window=window,
                          positions_q=pos_q)


def decode_attention(q, k, v, positions, *, scale: float | None = None,
                     window: int | None = None):
    """Single-token decode attention against a dense KV view; kernel-only
    (callers gate on :func:`get_mode`: the ref path is the einsum chain in
    :func:`repro_torch.models.layers.apply_attention`)."""
    return _decode.decode_attention(q, k, v, positions, scale=scale,
                                    window=window)


def topk_router(logits, k: int, renormalize: bool = True):
    """logits (T, E) -> (weights (T, k), ids (T, k) int32)."""
    if _use_kernels():
        return _router.topk_router(logits, k, renormalize)
    return _ref.topk_router(logits, k, renormalize)


def mamba_scan(x, delta, A, B, C, D, return_state: bool = False):
    """x, delta (Bb, L, Dm); A (Dm, N); B, C (Bb, L, N); D (Dm,) -> y
    [, final state (Bb, Dm, N) f32].  The kernel takes no state out, so a
    call that asks for it runs the oracle, as in the reference."""
    if _use_kernels() and not return_state:
        return _mamba.mamba_scan(x, delta, A, B, C, D)
    return _ref.mamba_scan(x, delta, A, B, C, D, return_state=return_state)


def rg_lru(x, input_gate, rec_gate, Lambda, c: float = 8.0,
           return_state: bool = False):
    """x, input_gate, rec_gate (B, L, D); Lambda (D,) -> every h_t (B, L, D)
    [, the last h (B, D) f32].  The kernel takes no state out, so a call
    that asks for it runs the oracle, as in the reference."""
    if _use_kernels() and not return_state:
        return _rglru.rg_lru(x, input_gate, rec_gate, Lambda, c)
    return _ref.rg_lru(x, input_gate, rec_gate, Lambda, c,
                       return_state=return_state)
