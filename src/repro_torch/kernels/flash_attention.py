"""Causal / local-window GQA flash attention: the port of the reference's
``_flash_kernel`` (``src/repro/kernels/flash_attention.py``).

Two CUDA C++ kernels for ``sm_90a`` (built by :mod:`.build` at first use and
bound with ``ctypes``; each source note gives the bound and the design):

* ``"sm90"`` (``repro_torch/csrc/flash_attention_sm90.cu``): ``wgmma`` fed
  by TMA, for bf16 at head widths 64, 128 and 256 with 16-byte-aligned
  tensors and strides;
* ``"simt"`` (``repro_torch/csrc/flash_attention.cu``): f32 FMAs on the CUDA
  cores, for f32 (``wgmma`` would compute it in TF32) and every other bf16
  shape.

:func:`_variant` picks one from the arguments alone; a call it sends to the
Hopper kernel that the kernel refuses raises, and nothing falls back.  It is
the custom op
``repro_torch::flash_attention``: the CPU implementation is the plain
version below, the CUDA implementation launches the kernel, so ``make_fx``
sees the whole attention as one node, which the tracer tags
``_flash_kernel`` for the planner's registry.

:func:`flash_attention` mirrors the reference wrapper op for op around the
kernel (the three transposes to ``(B, H, L, Dh)`` and the transpose back),
so the traced graph hands the node the reference's operands in the
reference's order: ``(q^T, k^T, v^T)``.  The transposes stay views: the
kernel takes strides and copies nothing.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import Optional

import torch

from . import build

__all__ = ["bind", "flash_attention", "flash_attention_plain", "launches",
           "variant_launches"]

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535       # the kernel's grid: (q tiles, Hq, B)
SM90_HEAD_DIMS = (64, 128, 256)

# kernel launches since the last reset, by build.signature of the arguments,
# and by variant ("sm90", "simt")
launches: Counter = Counter()
variant_launches: Counter = Counter()
_LIB: ctypes.CDLL | None = None
_LIB_SM90: ctypes.CDLL | None = None


def _variant(dtype, dh: int, ptrs, strides) -> str:
    """The kernel a call runs: ``"sm90"`` for bf16 at head width 64, 128 or
    256 with every base pointer 16-byte aligned and every stride (in
    elements) a positive multiple of 8; ``"simt"`` for the rest, f32
    included."""
    if dtype != torch.bfloat16 or dh not in SM90_HEAD_DIMS:
        return "simt"
    if any(p % 16 for p in ptrs) or any(s <= 0 or s % 8 for s in strides):
        return "simt"
    return "sm90"


def flash_attention_plain(qt, kt, vt, scale: float, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0):
    """The plain version.  qt (B, Hq, Lq, Dh), kt/vt (B, Hkv, Lkv, Dh) ->
    (B, Hq, Lq, Dh) in qt's dtype.  Masked scores are -1e30, as in the
    reference kernel, so a row without a valid key (a window, and
    ``q_offset + i >= Lkv - 1 + window``) is the mean of V over all keys."""
    B, Hq, Lq, Dh = qt.shape
    _, Hkv, Lkv, _ = kt.shape
    group = Hq // Hkv
    qg = qt.to(torch.float32).reshape(B, Hkv, group, Lq, Dh)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kt.to(torch.float32)) * scale
    qpos = q_offset + torch.arange(Lq, device=qt.device)[:, None]
    kpos = torch.arange(Lkv, device=qt.device)[None, :]
    mask = torch.ones((Lq, Lkv), dtype=torch.bool, device=qt.device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, vt.to(torch.float32)) / l
    return out.reshape(B, Hq, Lq, Dh).to(qt.dtype).contiguous()


# each variant's C function; the two share one signature
_ENTRY = {"simt": "repro_flash_attention", "sm90": "repro_flash_attention_sm90"}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``flash_attention`` or
    ``flash_attention_sm90`` library."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in _ENTRY.values():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = ([vp] * 4 + [ci] * 7 + [cl] * 9
                           + [ctypes.c_float, ci, ci, ci, vp])
            fn.restype = ci
    lib.repro_cuda_error_string.argtypes = [ci]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build.library("flash_attention"))))
    return _LIB


def _lib_sm90() -> ctypes.CDLL:
    global _LIB_SM90
    if _LIB_SM90 is None:
        _LIB_SM90 = bind(ctypes.CDLL(str(
            build.library("flash_attention_sm90"))))
    return _LIB_SM90


def _launch(qt, kt, vt, scale: float, causal: bool = True,
            window: Optional[int] = None, q_offset: int = 0):
    return _launch_variant(None, qt, kt, vt, scale, causal, window, q_offset)


def _launch_variant(variant: Optional[str], qt, kt, vt, scale: float,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0):
    """Launch the kernel ``variant`` names, or :func:`_variant`'s choice
    when it is None (the card check and the card tests name "simt" to time
    and test the CUDA-core kernel on bf16)."""
    if qt.dim() != 4 or kt.dim() != 4 or tuple(vt.shape) != tuple(kt.shape):
        raise ValueError(f"flash_attention: shapes q {tuple(qt.shape)}, "
                         f"k {tuple(kt.shape)}, v {tuple(vt.shape)}")
    B, Hq, Lq, Dh = qt.shape
    _, Hkv, Lkv, _ = kt.shape
    if kt.shape[0] != B or kt.shape[3] != Dh or min(B, Hq, Lq, Hkv, Lkv) < 1:
        raise ValueError(f"flash_attention: shapes q {tuple(qt.shape)}, "
                         f"k {tuple(kt.shape)}, v {tuple(vt.shape)}")
    if qt.dtype not in _DTYPES or kt.dtype != qt.dtype or vt.dtype != qt.dtype:
        raise TypeError(f"flash_attention: dtypes {qt.dtype}, {kt.dtype}, "
                        f"{vt.dtype}; the kernel takes float32 or bfloat16")
    if Hq % Hkv or not 1 <= Dh <= MAX_HEAD_DIM or max(B, Hq) > _GRID_LIMIT:
        raise ValueError(f"flash_attention: B={B}, Hq={Hq}, Hkv={Hkv}, Dh={Dh}:"
                         f" the kernel takes Hq a multiple of Hkv (any group),"
                         f" Dh <= {MAX_HEAD_DIM}, B and Hq <= {_GRID_LIMIT}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window}, need >= 1")
    if not 0 <= q_offset <= 2 ** 31 - 1 - Lq:
        raise ValueError(f"flash_attention: q_offset {q_offset}, need >= 0 "
                         f"with q_offset + Lq in int32")
    dev = qt.device
    for name, t in (("q", qt), ("k", kt), ("v", vt)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {dev}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} strides {t.stride()}: "
                             f"the last dimension must be contiguous")
    ptrs = [t.data_ptr() for t in (qt, kt, vt)]
    strides = [s for t in (qt, kt, vt) for s in t.stride()[:3]]
    variant = variant or _variant(qt.dtype, Dh, ptrs, strides)
    if variant not in _ENTRY:
        raise ValueError(f"flash_attention: no variant {variant!r}")
    lib = _lib_sm90() if variant == "sm90" else _lib()
    out = torch.empty((B, Hq, Lq, Dh), dtype=qt.dtype, device=dev)
    err = getattr(lib, _ENTRY[variant])(
        *ptrs, out.data_ptr(), _DTYPES[qt.dtype], B, Hq, Hkv, Lq, Lkv, Dh,
        *strides, float(scale), int(bool(causal)),
        int(window) if window is not None else 0, int(q_offset),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention {variant} kernel launch failed: "
                           f"{msg} ({err})")
    launches[build.signature(qt, kt, vt, scale, causal, window, q_offset)] += 1
    variant_launches[variant] += 1
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cpu")
def flash_attention_op(qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
                       scale: float, causal: bool = True,
                       window: Optional[int] = None,
                       q_offset: int = 0) -> torch.Tensor:
    return flash_attention_plain(qt, kt, vt, scale, causal, window, q_offset)


flash_attention_op.register_kernel("cuda")(_launch)


@flash_attention_op.register_fake
def _(qt, kt, vt, scale, causal=True, window=None, q_offset=0):
    return qt.new_empty(qt.shape)


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    window: int | None = None, q_offset: int = 0,
                    block_q: int = 128, block_k: int = 128):
    """q: (B, Lq, Hq, Dh); k, v: (B, Lkv, Hkv, Dh) -> (B, Lq, Hq, Dh).

    ``q_offset``: absolute position of q[0] (for chunked prefill).
    ``block_q`` / ``block_k`` are the reference's TPU tile sizes, taken so
    that callers of either package pass the same arguments; the result
    does not depend on them, and the kernels keep their own tiles."""
    del block_q, block_k
    Dh = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    qt = q.transpose(1, 2)            # (B, Hq, Lq, Dh)
    kt = k.transpose(1, 2)            # (B, Hkv, Lkv, Dh)
    vt = v.transpose(1, 2)
    out = flash_attention_op(qt, kt, vt, float(scale), bool(causal), window,
                             int(q_offset))
    return out.transpose(1, 2)
