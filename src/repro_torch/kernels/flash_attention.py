"""Causal / local-window GQA flash attention: the port of the reference's
``_flash_kernel`` (``src/repro/kernels/flash_attention.py``).

The kernel is CUDA C++ for ``sm_90a`` (``repro_torch/csrc/flash_attention.cu``,
built by :mod:`.build` at first use and bound with ``ctypes``); its source
note gives the bound and the design.  It is the custom op
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

__all__ = ["bind", "flash_attention", "flash_attention_plain", "launches"]

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535       # the kernel's grid: (q tiles, Hq, B)

# kernel launches since the last reset, by build.signature of the arguments
launches: Counter = Counter()
_LIB: ctypes.CDLL | None = None


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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``flash_attention`` library."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_flash_attention.argtypes = (
        [vp] * 4 + [ci] * 7 + [cl] * 9 + [ctypes.c_float, ci, ci, ci, vp])
    lib.repro_flash_attention.restype = ci
    lib.repro_cuda_error_string.argtypes = [ci]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build.library("flash_attention"))))
    return _LIB


def _launch(qt, kt, vt, scale: float, causal: bool = True,
            window: Optional[int] = None, q_offset: int = 0):
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
    out = torch.empty((B, Hq, Lq, Dh), dtype=qt.dtype, device=dev)
    err = _lib().repro_flash_attention(
        qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), out.data_ptr(),
        _DTYPES[qt.dtype], B, Hq, Hkv, Lq, Lkv, Dh,
        qt.stride(0), qt.stride(1), qt.stride(2),
        kt.stride(0), kt.stride(1), kt.stride(2),
        vt.stride(0), vt.stride(1), vt.stride(2),
        float(scale), int(bool(causal)),
        int(window) if window is not None else 0, int(q_offset),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = _lib().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} ({err})")
    launches[build.signature(qt, kt, vt, scale, causal, window, q_offset)] += 1
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
    does not depend on them, and the kernel keeps its own tiles (64 q rows
    by 64 keys, 32 q rows above head width 128)."""
    del block_q, block_k
    Dh = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    qt = q.transpose(1, 2)            # (B, Hq, Lq, Dh)
    kt = k.transpose(1, 2)            # (B, Hkv, Lkv, Dh)
    vt = v.transpose(1, 2)
    out = flash_attention_op(qt, kt, vt, float(scale), bool(causal), window,
                             int(q_offset))
    return out.transpose(1, 2)
