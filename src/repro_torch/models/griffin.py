"""RecurrentGemma-style hybrid LM (griffin): repeating (RG-LRU, RG-LRU,
local-attention) blocks with GeGLU MLPs.

The layers come in *super-blocks* of the 3-layer pattern; a config whose
depth is not a multiple of the pattern gets the remainder as trailing
recurrent blocks (recurrentgemma-9b: 38 = 12 x 3 + 2).
``params["supers"]`` is a list of ``n_super`` dicts ``{"l0", "l1", "l2"}``
and ``params["rest"]`` a list of recurrent layers, so tracing unrolls the
layers like the reference with ``scan_layers=False``.

* ``train_forward`` — the model's loss over a batch of token sequences
  (forward only: a scoring pass);
* ``_rec_block``    — one recurrent block, the ``Model.block_fn`` entry.

Serving (``prefill`` with the LRU state, the ring KV cache, the recurrent
and windowed decode steps) is not ported yet.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from .config import HybridConfig, ModelConfig
from .layers import (Params, _normal, apply_attention, apply_mlp, apply_norm,
                     init_attention, init_mlp, init_norm, torch_dtype)
from .lm import embed_tokens, lm_loss


def _h(cfg: ModelConfig) -> HybridConfig:
    return cfg.hybrid or HybridConfig()


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_rec_layer(gen, cfg: ModelConfig, device) -> Params:
    D, Dr = cfg.d_model, _h(cfg).d_rnn or cfg.d_model
    sc = 1.0 / math.sqrt(D)
    return {
        "norm1": init_norm(cfg, device),
        "x_proj": _normal(gen, (D, Dr), sc, cfg, device),
        "in_gate": _normal(gen, (D, Dr), sc, cfg, device),
        "rec_gate": _normal(gen, (D, Dr), sc, cfg, device),
        "Lambda": torch.full((Dr,), 0.5, dtype=torch_dtype(cfg.param_dtype),
                             device=device),
        "out_proj": _normal(gen, (Dr, D), 1.0 / math.sqrt(Dr), cfg, device),
        "norm2": init_norm(cfg, device),
        "mlp": init_mlp(gen, cfg, device),
    }


def init_attn_layer(gen, cfg: ModelConfig, device) -> Params:
    return {
        "norm1": init_norm(cfg, device),
        "attn": init_attention(gen, cfg, device),
        "norm2": init_norm(cfg, device),
        "mlp": init_mlp(gen, cfg, device),
    }


def _layout(cfg: ModelConfig):
    pat = _h(cfg).pattern
    n_super = cfg.n_layers // len(pat)
    n_rest = cfg.n_layers - n_super * len(pat)
    return pat, n_super, n_rest


def init_params(cfg: ModelConfig, seed: int, device) -> Params:
    """Random weights from ``seed`` (a ``torch.Generator`` on ``device``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    pat, n_super, n_rest = _layout(cfg)

    def init_super():
        return {f"l{i}": (init_rec_layer(gen, cfg, device) if kind == "rec"
                          else init_attn_layer(gen, cfg, device))
                for i, kind in enumerate(pat)}

    return {
        "embed": _normal(gen, (cfg.vocab, cfg.d_model), 0.02, cfg, device),
        "supers": [init_super() for _ in range(n_super)],
        "rest": [init_rec_layer(gen, cfg, device) for _ in range(n_rest)],
        "final_norm": init_norm(cfg, device),
        "lm_head": _normal(gen, (cfg.d_model, cfg.vocab),
                           1.0 / math.sqrt(cfg.d_model), cfg, device),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _rec_block(lp: Params, x, cfg: ModelConfig):
    dt = torch_dtype(cfg.dtype)
    xn = apply_norm(lp["norm1"], x, cfg)
    y = ops.rg_lru(
        xn @ lp["x_proj"].to(dt),
        xn @ lp["in_gate"].to(dt),
        xn @ lp["rec_gate"].to(dt),
        lp["Lambda"].to(torch.float32),
        _h(cfg).c,
    )
    x = x + y @ lp["out_proj"].to(dt)
    return x + apply_mlp(lp["mlp"], apply_norm(lp["norm2"], x, cfg), cfg)


def _attn_block(lp: Params, x, cfg: ModelConfig, positions):
    """Local attention over the last ``window`` positions: the flash kernel
    in kernel mode at ``S % 128 == 0``, as the reference's pallas mode."""
    a, _ = apply_attention(lp["attn"], apply_norm(lp["norm1"], x, cfg), cfg,
                           positions, window=_h(cfg).window)
    x = x + a
    return x + apply_mlp(lp["mlp"], apply_norm(lp["norm2"], x, cfg), cfg)


def backbone(params: Params, h, cfg: ModelConfig, positions):
    pat = _h(cfg).pattern
    for sp in params["supers"]:
        for i, kind in enumerate(pat):
            lp = sp[f"l{i}"]
            h = (_rec_block(lp, h, cfg) if kind == "rec"
                 else _attn_block(lp, h, cfg, positions))
    for lp in params["rest"]:
        h = _rec_block(lp, h, cfg)
    return apply_norm(params["final_norm"], h, cfg)


def train_forward(params: Params, batch: dict, cfg: ModelConfig):
    """(loss, aux) of a batch ``{"tokens", "labels"}`` (B, S): the chunked
    cross-entropy of :func:`repro_torch.models.lm.lm_loss`; aux is empty."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    h = embed_tokens(params, tokens, cfg)
    h = backbone(params, h, cfg, positions)
    return lm_loss(params, h, batch["labels"], cfg), {}
