"""Mamba-1 LM (the falcon-mamba-7b family): attention-free, one selective
scan a layer.

Per block: in_proj -> causal depthwise conv -> SiLU -> selective scan
(:func:`repro_torch.kernels.ops.mamba_scan`) -> output gate -> out_proj.
The layers are a Python list, so tracing unrolls them like the reference
with ``scan_layers=False``.

* ``train_forward`` — the model's loss over a batch of token sequences
  (forward only: a scoring pass);
* ``_block``        — one block, the ``Model.block_fn`` entry.

Serving (``prefill`` with the scan's state, ``init_cache``, the recurrent
``decode_step``) is not ported yet.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ref import softplus as _softplus
from .config import ModelConfig, SSMConfig
from .layers import Params, _normal, apply_norm, init_norm, torch_dtype
from .lm import embed_tokens, lm_loss


def _dims(cfg: ModelConfig):
    s = cfg.ssm or SSMConfig()
    dm = s.expand * cfg.d_model
    dtr = s.dt_rank or math.ceil(cfg.d_model / 16)
    return s, dm, dtr


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(gen, cfg: ModelConfig, device) -> Params:
    s, dm, dtr = _dims(cfg)
    D, N = cfg.d_model, s.d_state
    pdt = torch_dtype(cfg.param_dtype)
    A = torch.arange(1, N + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(dm, 1)
    return {
        "norm": init_norm(cfg, device),
        "in_proj": _normal(gen, (D, 2 * dm), 1.0 / math.sqrt(D), cfg, device),
        "conv_w": _normal(gen, (s.d_conv, dm), 1.0 / math.sqrt(s.d_conv),
                          cfg, device),
        "conv_b": torch.zeros((dm,), dtype=pdt, device=device),
        "x_proj": _normal(gen, (dm, dtr + 2 * N), 1.0 / math.sqrt(dm), cfg,
                          device),
        "dt_proj": _normal(gen, (dtr, dm), 1.0 / math.sqrt(dtr), cfg, device),
        "dt_bias": torch.zeros((dm,), dtype=pdt, device=device),
        "A_log": torch.log(A).to(pdt),
        "D": torch.ones((dm,), dtype=pdt, device=device),
        "out_proj": _normal(gen, (dm, D), 1.0 / math.sqrt(dm), cfg, device),
    }


def init_params(cfg: ModelConfig, seed: int, device) -> Params:
    """Random weights from ``seed`` (a ``torch.Generator`` on ``device``)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return {
        "embed": _normal(gen, (cfg.vocab, cfg.d_model), 0.02, cfg, device),
        "layers": [init_layer(gen, cfg, device) for _ in range(cfg.n_layers)],
        "final_norm": init_norm(cfg, device),
        "lm_head": _normal(gen, (cfg.d_model, cfg.vocab),
                           1.0 / math.sqrt(cfg.d_model), cfg, device),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _silu(x):
    """``jax.nn.silu``'s spelling: ``x * logistic(x)``."""
    return x * torch.sigmoid(x)


def _causal_conv(x, w, b):
    """Depthwise causal conv.  x: (B, S, Dm); w: (K, Dm).  ``w[0]`` weighs
    the current token and ``w[K-1]`` the oldest: K-1 zeros padded on the
    left, then ``pad[:, i:i+S] * w[K-1-i]`` added in x's dtype, one rounding
    an add, from ``zeros + b``; the zeros are a scalar broadcast by the
    first add (the same values as the reference's ``zeros_like(x) + b``,
    without a full-size ``full_like`` node that would cut the chain).
    (``F.conv1d`` correlates the other way and runs in TF32 on the card.)"""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    acc = torch.zeros((), dtype=x.dtype, device=x.device) + b.to(x.dtype)
    for i in range(K):
        acc = acc + pad[:, i:i + S, :] * w[K - 1 - i].to(x.dtype)
    return acc


def _block(lp: Params, x, cfg: ModelConfig):
    s, dm, dtr = _dims(cfg)
    dt = torch_dtype(cfg.dtype)
    N = s.d_state
    xz = x @ lp["in_proj"].to(dt)
    xin, z = xz[..., :dm], xz[..., dm:]
    xc = _silu(_causal_conv(xin, lp["conv_w"], lp["conv_b"]))
    dbc = xc @ lp["x_proj"].to(dt)
    dt_lowrank = dbc[..., :dtr]
    B_ssm = dbc[..., dtr:dtr + N].to(torch.float32)
    C_ssm = dbc[..., dtr + N:].to(torch.float32)
    delta = _softplus(dt_lowrank @ lp["dt_proj"].to(dt) + lp["dt_bias"].to(dt))
    A = -torch.exp(lp["A_log"].to(torch.float32))
    y = ops.mamba_scan(xc, delta, A, B_ssm, C_ssm, lp["D"].to(torch.float32))
    y = y * _silu(z)
    return y @ lp["out_proj"].to(dt)


def backbone(params: Params, h, cfg: ModelConfig):
    for lp in params["layers"]:
        h = h + _block(lp, apply_norm(lp["norm"], h, cfg), cfg)
    return apply_norm(params["final_norm"], h, cfg)


def train_forward(params: Params, batch: dict, cfg: ModelConfig):
    """(loss, aux) of a batch ``{"tokens", "labels"}`` (B, S): the chunked
    cross-entropy of :func:`repro_torch.models.lm.lm_loss`; aux is empty."""
    h = embed_tokens(params, batch["tokens"], cfg)
    h = backbone(params, h, cfg)
    return lm_loss(params, h, batch["labels"], cfg), {}
