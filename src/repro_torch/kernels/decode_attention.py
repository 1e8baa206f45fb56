"""Single-token decode attention against a dense KV view: the port of the
reference's ``_decode_attn_kernel`` (``src/repro/kernels/decode_attention.py``).

The kernel is CUDA C++ for ``sm_90a`` (``repro_torch/csrc/decode_attention.cu``,
built by :mod:`.build` at first use and bound with ``ctypes``); its source
note gives the bound and the design.  It splits the cache's keys into
chunks fixed by ``Smax`` (:func:`chunk_plan`; the positions are never read
on the host), writes each chunk's partial (m, l, acc) to f32 scratch and
folds them in chunk order in a second kernel;
:func:`decode_attention_split_plain` is that algorithm in PyTorch.  It is
the custom op
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

__all__ = ["bind", "chunk_plan", "decode_attention", "decode_attention_plain",
           "decode_attention_split_plain", "launches", "variant_launches"]

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 32                # keys a chunk of the split kernel (kChunk)

# kernel launches since the last reset, by build.signature of the arguments,
# and by variant (the one kernel, "split", as ops.launch_counts_by_variant
# reports each attention kernel's)
launches: Counter = Counter()
variant_launches: Counter = Counter()
_LIB: ctypes.CDLL | None = None


def chunk_plan(smax: int) -> tuple[int, int]:
    """(keys a chunk, chunks) of the split kernel for a cache of ``smax``
    keys: from the static shape alone."""
    if smax < 1:
        raise ValueError(f"decode_attention: Smax {smax}, need >= 1")
    return CHUNK, -(-smax // CHUNK)


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


def decode_attention_split_plain(pos, qt, kt, vt, scale: float,
                                 window: Optional[int] = None):
    """The split kernel's algorithm in PyTorch, same arguments and result
    as :func:`decode_attention_plain`: per chunk of :func:`chunk_plan`, the
    valid keys' max m_c, l_c = sum exp(s - m_c) and acc_c = sum exp(s - m_c)
    v, or the sentinel (-inf, 0, 0) for a chunk without a valid key; then
    the chunks folded in order, each weighted by exp(m_c - M) and a
    sentinel by 0.  A row without a valid key scores every key at -1e30."""
    B, Hq, _, Dh = qt.shape
    _, Hkv, Smax, _ = kt.shape
    chunk, n = chunk_plan(Smax)
    qg = qt.to(torch.float32).reshape(B, Hkv, Hq // Hkv, Dh)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, kt.to(torch.float32)) * scale
    kpos = torch.arange(Smax, device=qt.device)[None, :]
    qpos = pos.reshape(B, 1).to(kpos.dtype)
    valid = kpos <= qpos
    if window is not None:
        valid = valid & (qpos - kpos < window)
    none = ~valid.any(-1, keepdim=True)
    valid = valid | none
    s = torch.where(none[:, None, None, :], NEG_INF, s)
    vf = vt.to(torch.float32)
    ms, ls, accs = [], [], []
    for c in range(n):
        keys = slice(c * chunk, min(Smax, (c + 1) * chunk))
        ok = valid[:, None, None, keys]
        sc = torch.where(ok, s[..., keys], -torch.inf)
        m = sc.amax(-1, keepdim=True)
        empty = ~ok.any(-1, keepdim=True)
        p = torch.where(ok, torch.exp(sc - torch.where(empty, 0.0, m)), 0.0)
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("bhgk,bhkd->bhgd", p, vf[:, :, keys]))
    M = torch.stack(ms).amax(0)
    lsum = torch.zeros_like(ls[0])
    acc = torch.zeros_like(accs[0])
    for m, l, a in zip(ms, ls, accs):
        w = torch.where(m == -torch.inf, 0.0, torch.exp(m - M))
        lsum = lsum + l * w
        acc = acc + a * w
    out = acc / lsum.clamp_min(1e-30)
    return out.reshape(B, Hq, 1, Dh).to(qt.dtype).contiguous()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a built ``decode_attention`` library."""
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_decode_attention.argtypes = (
        [vp] * 6 + [ci] * 6 + [cl] * 9 + [ctypes.c_float, ci, vp])
    lib.repro_decode_attention.restype = ci
    lib.repro_decode_attention_chunk.argtypes = []
    lib.repro_decode_attention_chunk.restype = ci
    if lib.repro_decode_attention_chunk() != CHUNK:
        raise build.BuildError(
            f"decode_attention: the library's chunk is "
            f"{lib.repro_decode_attention_chunk()} keys, the wrapper's {CHUNK}")
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
    if Hq % Hkv or Dh > 256:
        raise ValueError(f"decode_attention: Hq={Hq}, Hkv={Hkv}, Dh={Dh}: the "
                         f"kernel takes Hq a multiple of Hkv, Dh <= 256")
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
    ptrs = [qt.data_ptr(), kt.data_ptr(), vt.data_ptr(), pos.data_ptr(),
            out.data_ptr()]
    rest = [_DTYPES[qt.dtype], B, Hq, Hkv, Smax, Dh,
            qt.stride(0), qt.stride(1), kt.stride(0), kt.stride(1),
            kt.stride(2), vt.stride(0), vt.stride(1), vt.stride(2),
            pos.stride(0), float(scale),
            int(window) if window is not None else 0,
            torch.cuda.current_stream(dev).cuda_stream]
    lib = _lib()
    _, n = chunk_plan(Smax)
    partials = torch.empty(B * Hq * n * (Dh + 2), dtype=torch.float32,
                           device=dev)
    err = lib.repro_decode_attention(*ptrs, partials.data_ptr(), *rest)
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"decode_attention kernel launch failed: {msg} "
                           f"({err})")
    launches[build.signature(pos, qt, kt, vt, scale, window)] += 1
    variant_launches["split"] += 1
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
