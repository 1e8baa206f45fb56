"""Dense-family layer library: GQA attention (RoPE / qk-norm / dense KV
cache), the SwiGLU / GeGLU MLP, RMSNorm, and their initializers.

All functions are pure; parameters are nested dicts of tensors in the
reference's layout (weights ``(in, out)`` for ``x @ w``, activations
``(B, S, H, Dh)``).  Params live in ``cfg.param_dtype`` (f32) and are cast
to ``cfg.dtype`` at use; reductions run in f32.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref
from .config import ModelConfig

Params = dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float, cfg: ModelConfig,
            device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(torch_dtype(cfg.param_dtype))


def init_norm(cfg: ModelConfig, device, d: int | None = None) -> Params:
    return {"g": torch.ones((d or cfg.d_model,),
                           dtype=torch_dtype(cfg.param_dtype), device=device)}


def init_attention(gen, cfg: ModelConfig, device) -> Params:
    D, dh, Hq, Hkv = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads
    sc = 1.0 / math.sqrt(D)
    p = {
        "wq": _normal(gen, (D, Hq * dh), sc, cfg, device),
        "wk": _normal(gen, (D, Hkv * dh), sc, cfg, device),
        "wv": _normal(gen, (D, Hkv * dh), sc, cfg, device),
        "wo": _normal(gen, (Hq * dh, D), 1.0 / math.sqrt(Hq * dh), cfg, device),
    }
    if cfg.qk_norm:
        p["q_norm_g"] = init_norm(cfg, device, dh)["g"]
        p["k_norm_g"] = init_norm(cfg, device, dh)["g"]
    return p


def init_mlp(gen, cfg: ModelConfig, device) -> Params:
    D, F = cfg.d_model, cfg.d_ff
    sc_in, sc_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(F)
    return {
        "w_gate": _normal(gen, (D, F), sc_in, cfg, device),
        "w_up": _normal(gen, (D, F), sc_in, cfg, device),
        "w_down": _normal(gen, (F, D), sc_out, cfg, device),
    }


# ---------------------------------------------------------------------------
# norms / MLPs
# ---------------------------------------------------------------------------

def apply_norm(p: Params, x, cfg: ModelConfig):
    return ops.rmsnorm(x, p["g"].to(torch_dtype(cfg.dtype)))


def apply_mlp(p: Params, x, cfg: ModelConfig):
    dt = torch_dtype(cfg.dtype)
    gate = x @ p["w_gate"].to(dt)
    up = x @ p["w_up"].to(dt)
    h = ops.swiglu(gate, up) if cfg.act == "swiglu" else ops.geglu(gate, up)
    return h @ p["w_down"].to(dt)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def apply_attention(p: Params, x, cfg: ModelConfig, positions,
                    cache: Params | None = None, window: int | None = None,
                    return_kv: bool = False):
    """x: (B, S, D).  With ``cache`` (decode), S is the new-token count and
    attention runs against cache+new; returns (out, new_cache).  With
    ``return_kv`` (prefill) the post-RoPE k/v are returned instead.
    ``window``: local-attention window (keys within ``window`` positions)."""
    dt = torch_dtype(cfg.dtype)
    B, S, D = x.shape
    Hq, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh

    q = (x @ p["wq"].to(dt)).reshape(B, S, Hq, dh)
    k = (x @ p["wk"].to(dt)).reshape(B, S, Hkv, dh)
    v = (x @ p["wv"].to(dt)).reshape(B, S, Hkv, dh)
    if cfg.qk_norm:
        q = ops.rmsnorm(q, p["q_norm_g"].to(dt))
        k = ops.rmsnorm(k, p["k_norm_g"].to(dt))
    q = ops.rope(q, positions, cfg.rope_theta)
    k = ops.rope(k, positions, cfg.rope_theta)

    scale = 1.0 / math.sqrt(dh)
    new_cache = {"k": k, "v": v} if return_kv else None
    if cache is not None:
        # dense static-shape serving: cache (B, Smax, Hkv, dh).  A scalar
        # ``length`` is the lock-step batch; a (B,) vector is the ragged
        # batch, each slot writing its new KV at its own offset.  The
        # functional write returns a fresh cache tensor (a full copy).
        length = cache["length"]
        base = length[:, None] if length.dim() else length
        pos = base + torch.arange(S, dtype=torch.int32, device=x.device)
        pos = pos.expand(B, S).long()
        rows = torch.arange(B, device=x.device)[:, None].expand(B, S)
        ck = cache["k"].index_put((rows, pos), k.to(cache["k"].dtype))
        cv = cache["v"].index_put((rows, pos), v.to(cache["v"].dtype))
        new_cache = {"k": ck, "v": cv, "length": length + S}
        if S == 1 and ops.get_mode() == "kernels":
            # the decode-attention kernel: the whole masked-softmax chain is
            # one registered CUSTOM node (the position mask covers length
            # validity, as in the einsum chain below)
            out = ops.decode_attention(q, ck, cv, positions[:, 0], scale=scale,
                                       window=window)
            out = out.reshape(B, S, Hq * dh) @ p["wo"].to(dt)
            return out, new_cache
        Smax = ck.shape[1]
        group = Hq // Hkv
        # grouped-GQA contraction at native Hkv width, f32 accumulation
        qg = q.reshape(B, S, Hkv, group, dh)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                              ck.to(torch.float32)) * scale
        kpos = torch.arange(Smax, device=x.device)[None, None, None, None, :]
        qpos = positions[:, None, None, :, None]
        mask = kpos <= qpos
        if window is not None:
            mask = mask & (qpos - kpos < window)
        logits = torch.where(mask, logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd",
                           probs.to(dt).to(torch.float32),
                           cv.to(torch.float32))
        out = out.reshape(B, S, Hq, dh).to(dt)
    elif ops.get_mode() == "kernels" and S % 128 == 0:
        # the flash-attention kernel, as the reference's pallas mode
        out = ops.attention(q, k, v, causal=True, scale=scale, window=window)
    else:
        out = _ref.attention(q, k, v, causal=True, scale=scale, window=window,
                             positions_q=positions)
    out = out.reshape(B, S, Hq * dh) @ p["wo"].to(dt)
    return out, new_cache
