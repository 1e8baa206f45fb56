"""Single-token decode attention against a dense KV view: the port of the
reference's ``_decode_attn_kernel`` (``src/repro/kernels/decode_attention.py``).

The kernel is CUDA C++ for ``sm_90a`` (``repro_torch/csrc/decode_attention.cu``,
built by :mod:`.build` at first use and bound with ``ctypes``); its source
note gives the bound and the design.  It is the custom op
``repro_torch::decode_attention``: the CPU implementation is the plain
version below, the CUDA implementation launches the kernel, so ``make_fx``
sees the whole masked-softmax chain as one node, which the tracer tags
``_decode_attn_kernel`` for the planner's registry.

:func:`decode_attention` mirrors the reference wrapper op for op around the
kernel (positions cast and reshaped to ``(B, 1)``, the three transposes to
``(B, H, S, Dh)`` and the transpose back), so the traced graph hands the
node the reference's operands in the reference's order:
``(positions, q^T, k^T, v^T)``.  The transposes stay views: the kernel
takes strides and copies nothing.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import Optional

import torch

from . import build

__all__ = ["bind", "decode_attention", "decode_attention_plain", "launches"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset, by build.signature of the arguments
launches: Counter = Counter()
_LIB: ctypes.CDLL | None = None


def decode_attention_plain(pos, qt, kt, vt, scale: float,
                           window: Optional[int] = None):
    """The plain version.  pos (B, 1) int, qt (B, Hq, 1, Dh), kt/vt
    (B, Hkv, Smax, Dh) -> (B, Hq, 1, Dh) in qt's dtype."""
    B, Hq, _, Dh = qt.shape
    _, Hkv, Smax, _ = kt.shape
    group = Hq // Hkv
    qg = qt.to(torch.float32).reshape(B, Hkv, group, Dh)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, kt.to(torch.float32)) * scale
    kpos = torch.arange(Smax, device=qt.device)[None, :]
    qpos = pos.reshape(B, 1).to(kpos.dtype)
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (qpos - kpos < window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgk,bhkd->bhgd", p, vt.to(torch.float32)) / l
    return out.reshape(B, Hq, 1, Dh).to(qt.dtype).contiguous()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``decode_attention`` library."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_decode_attention.argtypes = (
        [vp] * 5 + [ci] * 6 + [cl] * 9 + [ctypes.c_float, ci, vp])
    lib.repro_decode_attention.restype = ci
    lib.repro_cuda_error_string.argtypes = [ci]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        _LIB = bind(ctypes.CDLL(str(build.library("decode_attention"))))
    return _LIB


def _launch(pos, qt, kt, vt, scale: float, window: Optional[int] = None):
    B, Hq, one, Dh = qt.shape
    _, Hkv, Smax, _ = kt.shape
    if one != 1 or tuple(vt.shape) != tuple(kt.shape) or kt.shape[0] != B \
            or kt.shape[3] != Dh or tuple(pos.shape) != (B, 1):
        raise ValueError(f"decode_attention: shapes q {tuple(qt.shape)}, "
                         f"k {tuple(kt.shape)}, v {tuple(vt.shape)}, "
                         f"positions {tuple(pos.shape)}")
    if qt.dtype not in _DTYPES or kt.dtype != qt.dtype or vt.dtype != qt.dtype:
        raise TypeError(f"decode_attention: dtypes {qt.dtype}, {kt.dtype}, "
                        f"{vt.dtype}; the kernel takes float32 or bfloat16")
    if pos.dtype != torch.int32:
        raise TypeError(f"decode_attention: positions {pos.dtype}, need int32")
    if Hq % Hkv or Hq // Hkv > 8 or Dh > 256:
        raise ValueError(f"decode_attention: Hq={Hq}, Hkv={Hkv}, Dh={Dh}: the "
                         f"kernel takes a GQA group of at most 8, Dh <= 256")
    dev = qt.device
    if pos.device != dev:
        raise ValueError(f"decode_attention: positions on {pos.device}, q on {dev}")
    for name, t in (("q", qt), ("k", kt), ("v", vt)):
        if t.device != dev:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {dev}")
        if t.stride(-1) != 1:
            raise ValueError(f"decode_attention: {name} strides {t.stride()}: "
                             f"the last dimension must be contiguous")
    out = torch.empty((B, Hq, 1, Dh), dtype=qt.dtype, device=dev)
    err = _lib().repro_decode_attention(
        qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), pos.data_ptr(),
        out.data_ptr(), _DTYPES[qt.dtype], B, Hq, Hkv, Smax, Dh,
        qt.stride(0), qt.stride(1), kt.stride(0), kt.stride(1), kt.stride(2),
        vt.stride(0), vt.stride(1), vt.stride(2), pos.stride(0),
        float(scale), int(window) if window is not None else 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = _lib().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"decode_attention kernel launch failed: {msg} ({err})")
    launches[build.signature(pos, qt, kt, vt, scale, window)] += 1
    return out


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=(),
                         device_types="cpu")
def decode_attention_op(pos: torch.Tensor, qt: torch.Tensor, kt: torch.Tensor,
                        vt: torch.Tensor, scale: float,
                        window: Optional[int] = None) -> torch.Tensor:
    return decode_attention_plain(pos, qt, kt, vt, scale, window)


decode_attention_op.register_kernel("cuda")(_launch)


@decode_attention_op.register_fake
def _(pos, qt, kt, vt, scale, window=None):
    B, Hq, _, Dh = qt.shape
    return qt.new_empty((B, Hq, 1, Dh))


def decode_attention(q, k, v, positions, *, scale: float | None = None,
                     window: int | None = None):
    """q: (B, 1, Hq, Dh); k, v: (B, Smax, Hkv, Dh); positions: (B,) absolute
    position of each row's new token -> (B, 1, Hq, Dh).  Cache rows past
    ``positions[b]`` are masked."""
    B, Lq, Hq, Dh = q.shape
    if Lq != 1:
        raise ValueError(f"decode_attention is single-token (Lq={Lq})")
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    pos = positions.to(torch.int32).reshape(B, 1)
    qt = q.transpose(1, 2)            # (B, Hq, 1, Dh)
    kt = k.transpose(1, 2)            # (B, Hkv, Smax, Dh)
    vt = v.transpose(1, 2)
    out = decode_attention_op(pos, qt, kt, vt, float(scale), window)
    return out.transpose(1, 2)
