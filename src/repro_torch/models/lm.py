"""Decoder-only transformer LM, dense family.

The layer loop is a Python loop over a list of per-layer parameter dicts,
so tracing unrolls it exactly like the reference with ``scan_layers=False``.

* ``prefill``     — full-sequence causal forward that fills a KV cache;
* ``decode_step`` — single-token step against a static-shape KV cache.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import (Params, apply_attention, apply_mlp, apply_norm,
                     init_attention, init_mlp, init_norm, torch_dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(gen, cfg: ModelConfig, device) -> Params:
    return {
        "norm1": init_norm(cfg, device),
        "attn": init_attention(gen, cfg, device),
        "norm2": init_norm(cfg, device),
        "mlp": init_mlp(gen, cfg, device),
    }


def init_params(cfg: ModelConfig, seed: int, device) -> Params:
    """Random weights from ``seed`` (a ``torch.Generator`` on ``device``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    pdt = torch_dtype(cfg.param_dtype)
    p = {
        "embed": (torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                              device=device) * 0.02).to(pdt),
        "layers": [init_layer(gen, cfg, device) for _ in range(cfg.n_layers)],
        "final_norm": init_norm(cfg, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = (torch.randn((cfg.d_model, cfg.vocab), generator=gen,
                                    device=device)
                        / math.sqrt(cfg.d_model)).to(pdt)
    return p


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed_tokens(params: Params, tokens, cfg: ModelConfig):
    return F.embedding(tokens, params["embed"]).to(torch_dtype(cfg.dtype))


def _head_matrix(params: Params, cfg: ModelConfig):
    dt = torch_dtype(cfg.dtype)
    if cfg.tie_embeddings:
        return params["embed"].t().to(dt)
    return params["lm_head"].to(dt)


def _layer(h, lp: Params, cfg: ModelConfig, positions, cache=None,
           return_kv=False):
    a_in = apply_norm(lp["norm1"], h, cfg)
    attn_out, kv = apply_attention(lp["attn"], a_in, cfg, positions,
                                   cache=cache, return_kv=return_kv)
    h = h + attn_out
    m_in = apply_norm(lp["norm2"], h, cfg)
    return h + apply_mlp(lp["mlp"], m_in, cfg), kv


def prefill(params: Params, tokens, cfg: ModelConfig, true_len=None):
    """Full-sequence causal forward that also fills a KV cache.
    Returns (last-position logits, cache).

    ``true_len`` (B,) enables bucketed ragged prefill: ``tokens`` may be
    right-padded to a shape bucket, logits are gathered at each row's true
    last position, and ``cache["length"]`` comes back as that vector."""
    B, S = tokens.shape
    dt = torch_dtype(cfg.dtype)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    h = embed_tokens(params, tokens, cfg)
    ks, vs = [], []
    for lp in params["layers"]:
        h, kv = _layer(h, lp, cfg, positions, return_kv=True)
        ks.append(kv["k"].to(dt))
        vs.append(kv["v"].to(dt))
    h = apply_norm(params["final_norm"], h, cfg)
    if true_len is None:
        last = h[:, -1]
        length = torch.tensor(S, dtype=torch.int32, device=tokens.device)
    else:
        length = true_len.to(torch.int32)
        rows = torch.arange(B, device=tokens.device)
        last = h[rows, (length - 1).long()]
    logits = (last @ _head_matrix(params, cfg)).to(torch.float32)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs), "length": length}
    return logits, cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Params:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.dh)
    dt = torch_dtype(cfg.dtype)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def decode_step(params: Params, cache: Params, tokens, cfg: ModelConfig):
    """tokens: (B, S_new) — S_new=1 for pure decode.  Returns
    (logits_last, new_cache).  ``cache["length"]`` is a scalar (lock-step
    batch) or a (B,) vector (ragged batch)."""
    B, S = tokens.shape
    length = cache["length"]
    base = length[:, None] if length.dim() else length
    positions = base + torch.arange(S, dtype=torch.int32,
                                    device=tokens.device).expand(B, S)
    h = embed_tokens(params, tokens, cfg)
    nks, nvs = [], []
    for i, lp in enumerate(params["layers"]):
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i],
                       "length": length}
        h, new_cache = _layer(h, lp, cfg, positions, cache=layer_cache)
        nks.append(new_cache["k"])
        nvs.append(new_cache["v"])
    h = apply_norm(params["final_norm"], h, cfg)
    logits = (h[:, -1] @ _head_matrix(params, cfg)).to(torch.float32)
    new_cache = {"k": torch.stack(nks), "v": torch.stack(nvs),
                 "length": length + S}
    return logits, new_cache
