"""Plain-PyTorch oracles of the reference's kernel API (``ref`` mode).

Each function computes what ``repro/kernels/ref.py`` computes, in the same
layouts: activations are ``(B, S, H, Dh)``, statistics in f32, results cast
back to the input dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["rmsnorm", "swiglu", "geglu", "rope", "attention"]


def rmsnorm(x, gamma, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gamma.to(torch.float32)).to(x.dtype)


def swiglu(gate, up):
    return (F.silu(gate.to(torch.float32)) * up.to(torch.float32)).to(gate.dtype)


def geglu(gate, up):
    """GELU in its tanh form, which is ``jax.nn.gelu``'s default."""
    return (F.gelu(gate.to(torch.float32), approximate="tanh")
            * up.to(torch.float32)).to(gate.dtype)


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding on halves. x: (..., L, H, Dh) or (..., L, Dh);
    positions (..., L)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.to(torch.float32)[..., None] * freq       # (..., L, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == positions.dim() + 2:                         # (..., L, H, Dh)
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention(q, k, v, *, causal: bool = True, scale: float | None = None,
              positions_q=None, positions_kv=None, window: int | None = None):
    """GQA attention oracle.  q: (B, Lq, Hq, Dh), k/v: (B, Lkv, Hkv, Dh);
    masked logits are -inf."""
    B, Lq, Hq, Dh = q.shape
    _, Lkv, Hkv, _ = k.shape
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    kr = torch.repeat_interleave(k, group, dim=2)
    vr = torch.repeat_interleave(v, group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          kr.to(torch.float32)) * scale
    dev = q.device
    pq = positions_q if positions_q is not None else \
        torch.arange(Lq, device=dev)[None]
    pk = positions_kv if positions_kv is not None else \
        torch.arange(Lkv, device=dev)[None]
    mask = torch.ones((B, 1, Lq, Lkv), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (pq[:, None, :, None] >= pk[:, None, None, :])
    if window is not None:
        mask = mask & (pq[:, None, :, None] - pk[:, None, None, :] < window)
    logits = torch.where(mask, logits, -math.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vr.to(torch.float32))
    return out.to(q.dtype)
