"""Unified model interface: build a ported architecture from its config and
get its callables.  Dense (qwen3, nemotron-4-15b) and MoE (granite-moe)
families serve (init / prefill / decode);
the ssm family (falcon-mamba) and the hybrid family (recurrentgemma) score
(``train_forward``, ``block_fn``) and do not serve yet."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from . import griffin, lm, mamba
from .config import ModelConfig

Params = dict[str, Any]


@dataclass
class Model:
    cfg: ModelConfig
    init: Callable[..., Params]                    # (seed, device) -> params
    prefill: Callable[..., tuple] | None           # (params, tokens, true_len=)
    decode_step: Callable[..., tuple] | None       # (params, cache, tokens)
    init_cache: Callable[..., Params] | None       # (batch, max_len, device)
    # (params, {"tokens", "labels"}) -> (loss, aux): the forward of a
    # training step, here a scoring pass (forward only); None for the
    # families whose training is not ported yet
    train_forward: Callable[..., tuple] | None = None
    # single-block forward (layer_params, x) -> x': a block stitched on its
    # own, the reference's function-level entry point
    block_fn: Callable[..., Any] | None = None

    def layer_params(self, params: Params, index: int = 0) -> Params:
        """One layer's params, the ``block_fn`` operand for layer
        ``index``.  The hybrid family keeps no ``layers`` list: its
        ``block_fn`` operand is ``params["supers"][i]["l0"]``."""
        if "layers" not in params:
            raise ValueError(f"{self.cfg.family!r} params carry no stacked "
                             f"'layers' tree")
        return params["layers"][index]


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "ssm":
        return Model(
            cfg=cfg,
            init=lambda seed, device: mamba.init_params(cfg, seed, device),
            prefill=None, decode_step=None, init_cache=None,
            train_forward=lambda p, batch: mamba.train_forward(p, batch, cfg),
            block_fn=lambda lp, x: mamba._block(lp, x, cfg),
        )
    if cfg.family == "hybrid":
        return Model(
            cfg=cfg,
            init=lambda seed, device: griffin.init_params(cfg, seed, device),
            prefill=None, decode_step=None, init_cache=None,
            train_forward=lambda p, batch: griffin.train_forward(p, batch, cfg),
            block_fn=lambda lp, x: griffin._rec_block(lp, x, cfg),
        )
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense, moe, ssm and "
            f"hybrid only)")
    return Model(
        cfg=cfg,
        init=lambda seed, device: lm.init_params(cfg, seed, device),
        prefill=lambda p, tokens, true_len=None, **kw: lm.prefill(
            p, tokens, cfg, true_len=true_len),
        decode_step=lambda p, cache, tokens, **kw: lm.decode_step(
            p, cache, tokens, cfg),
        init_cache=lambda b, s, device: lm.init_cache(cfg, b, s, device),
    )
