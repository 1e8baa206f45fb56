"""Unified model interface: build a ported architecture from its config and
get its init / prefill / decode callables.  Dense and MoE families."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from . import lm
from .config import ModelConfig

Params = dict[str, Any]


@dataclass
class Model:
    cfg: ModelConfig
    init: Callable[..., Params]                    # (seed, device) -> params
    prefill: Callable[..., tuple]                  # (params, tokens, true_len=)
    decode_step: Callable[..., tuple]              # (params, cache, tokens)
    init_cache: Callable[..., Params]              # (batch, max_len, device)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense and moe only)")
    return Model(
        cfg=cfg,
        init=lambda seed, device: lm.init_params(cfg, seed, device),
        prefill=lambda p, tokens, true_len=None, **kw: lm.prefill(
            p, tokens, cfg, true_len=true_len),
        decode_step=lambda p, cache, tokens, **kw: lm.decode_step(
            p, cache, tokens, cfg),
        init_cache=lambda b, s, device: lm.init_cache(cfg, b, s, device),
    )
