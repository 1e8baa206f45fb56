"""Model-facing kernel API: wrappers that dispatch between the hand-written
kernels and the plain oracles.

``kernel_mode`` decides the backend, as in the reference
(``repro/kernels/ops.py``):

* ``"kernels"`` — the hand-written kernels, the counterpart of the
  reference's ``"pallas"`` mode: RMSNorm, RoPE and SwiGLU/GeGLU in Triton,
  decode attention, flash attention and the MoE router in CUDA C++.  Each
  is a ``torch.library`` custom op, so the tracer sees one node (with a
  projection per output) and tags it for the planner's registry; on the
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
from . import decode_attention as _decode
from . import flash_attention as _flash
from . import norms as _norms
from . import ref as _ref
from . import rope as _rope
from . import router as _router

__all__ = ["KernelMode", "get_mode", "kernel_mode", "rmsnorm", "swiglu",
           "geglu", "rope", "attention", "decode_attention", "topk_router",
           "KERNEL_TAGS",
           "launch_counts", "launch_counts_by_signature", "reset_launch_counts"]

KernelMode = Literal["kernels", "ref"]
_mode: contextvars.ContextVar[str] = contextvars.ContextVar("kernel_mode",
                                                            default="ref")

# kernel modules by the name their launches are counted under
_KERNELS = {"rmsnorm": _norms, "glu": _act, "rope": _rope,
            "decode_attention": _decode, "flash_attention": _flash,
            "router": _router}

# each custom op -> the reference kernel body it ports, the name the
# planner's registry (kernels/registry.py) knows it by
KERNEL_TAGS = {
    torch.ops.repro_torch.rmsnorm.default: "_rmsnorm_kernel",
    torch.ops.repro_torch.glu.default: "_glu_kernel",
    torch.ops.repro_torch.rope.default: "_rope_kernel",
    torch.ops.repro_torch.decode_attention.default: "_decode_attn_kernel",
    torch.ops.repro_torch.flash_attention.default: "_flash_kernel",
    torch.ops.repro_torch.topk_router.default: "_router_kernel",
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
    return {name: sum(mod.launches.values()) for name, mod in _KERNELS.items()}


def launch_counts_by_signature() -> dict[str, dict[tuple, int]]:
    """The same, per kernel by :func:`.build.signature` of its arguments:
    each tensor's shape and dtype, the other arguments as they are."""
    return {name: dict(mod.launches) for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches.clear()


# -- wrappers -----------------------------------------------------------------

def rmsnorm(x, gamma, eps: float = 1e-6):
    if _use_kernels():
        return _norms.rmsnorm(x, gamma, eps)
    return _ref.rmsnorm(x, gamma, eps)


def swiglu(gate, up):
    if _use_kernels():
        return _act.swiglu(gate, up)
    return _ref.swiglu(gate, up)


def geglu(gate, up):
    if _use_kernels():
        return _act.geglu(gate, up)
    return _ref.geglu(gate, up)


def rope(x, positions, theta: float = 10000.0):
    if _use_kernels():
        return _rope.rope(x, positions, theta)
    return _ref.rope(x, positions, theta)


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
