"""Decoder-only transformer LM, dense and MoE families: RMSNorm and a gated
MLP (qwen3, granite-moe), or LayerNorm and the two-matrix squared-ReLU MLP
(nemotron-4-15b), as ``cfg.norm`` and ``cfg.act`` say.

The layer loop is a Python loop over a list of per-layer parameter dicts,
so tracing unrolls it exactly like the reference with ``scan_layers=False``.

* ``prefill``     — full-sequence causal forward that fills a KV cache;
* ``decode_step`` — single-token step against a static-shape KV cache;
* ``lm_loss``     — the chunked cross-entropy of a final hidden state (the
  ssm family's ``train_forward`` scores through it);
* ``block_forward`` — one dense layer on its own (the reference's
  ``Model.block_fn`` of the dense family).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import (Params, apply_attention, apply_mlp, apply_moe,
                     apply_norm, init_attention, init_mlp, init_moe, init_norm,
                     torch_dtype)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(gen, cfg: ModelConfig, device) -> Params:
    return {
        "norm1": init_norm(cfg, device),
        "attn": init_attention(gen, cfg, device),
        "norm2": init_norm(cfg, device),
        "mlp": (init_moe(gen, cfg, device) if cfg.family == "moe"
                else init_mlp(gen, cfg, device)),
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


def lm_loss(params: Params, h, labels, cfg: ModelConfig, n_chunks: int = 16):
    """Mean cross-entropy of ``h`` (B, S, D) against ``labels`` (B, S),
    chunked: the (tokens, vocab) logits exist one chunk of tokens at a time
    (16 chunks: 64 tokens a chunk at 1024 tokens), each in f32 with its own
    max, exp, sum and log and the gold logit by ``gather``; the chunks are
    unrolled as the reference's ``scan_or_unroll`` is with
    ``scan_layers=False``.  ``cfg.loss_groups > 1`` chunks within each of G
    token groups, as the reference does.  Forward only."""
    B, S, D = h.shape
    W = _head_matrix(params, cfg)
    T = B * S
    G = cfg.loss_groups
    while T % G:
        G //= 2
    G = max(G, 1)
    Tg = T // G
    while Tg % n_chunks:
        n_chunks -= 1
    Tc = Tg // n_chunks
    hg = h.reshape(G, Tg, D)
    yg = labels.reshape(G, Tg)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for j in range(n_chunks):
        hcb = hg[:, j * Tc:(j + 1) * Tc]
        ycb = yg[:, j * Tc:(j + 1) * Tc]
        logits = torch.einsum("gtd,dv->gtv", hcb, W).to(torch.float32)
        m = torch.amax(logits, dim=-1)
        lse = torch.log(torch.sum(torch.exp(logits - m[..., None]), dim=-1)) + m
        gold = torch.gather(logits, -1, ycb[..., None].long())[..., 0]
        total = total + torch.sum(lse - gold)
    return total / T


def _layer(h, lp: Params, cfg: ModelConfig, positions, cache=None,
           return_kv=False):
    a_in = apply_norm(lp["norm1"], h, cfg)
    attn_out, kv = apply_attention(lp["attn"], a_in, cfg, positions,
                                   cache=cache, return_kv=return_kv)
    h = h + attn_out
    m_in = apply_norm(lp["norm2"], h, cfg)
    if cfg.family == "moe":
        # token rows through the MoE; serving drops its aux metrics
        B, S, D = m_in.shape
        y2d, _ = apply_moe(lp["mlp"], m_in.reshape(B * S, D), cfg)
        return h + y2d.reshape(B, S, D), kv
    return h + apply_mlp(lp["mlp"], m_in, cfg), kv


def block_forward(lp: Params, x, cfg: ModelConfig):
    """One dense layer on its own, the reference's ``block_forward`` (its
    dense ``Model.block_fn``): x (B, S, D) -> (B, S, D), positions 0 .. S-1
    in every row.  The MoE block (the reference's dense expert form) is not
    ported."""
    if cfg.family != "dense":
        raise NotImplementedError(f"block_forward of the {cfg.family!r} "
                                  f"family is not ported (dense only)")
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    return _layer(x, lp, cfg, positions)[0]


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
