"""Carry the reference's parameters across.

The reference stacks per-layer parameters along a leading layer axis
(``params["layers"]`` is one tree of ``(L, ...)`` arrays); the port keeps a
list of per-layer dicts.  Both store weights ``(in, out)``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .config import ModelConfig
from .layers import torch_dtype

__all__ = ["params_from_jax", "params_to_numpy"]


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: dict, cfg: ModelConfig, device="cpu") -> dict:
    """Reference params (a tree of numpy arrays, stacked ``layers``) ->
    the port's params on ``device``, in ``cfg.param_dtype``."""
    pdt = torch_dtype(cfg.param_dtype)

    def tensor(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), dtype=pdt,
                            device=device)

    out: dict[str, Any] = {k: _map(v, tensor) for k, v in tree.items()
                           if k != "layers"}
    out["layers"] = [
        _map(tree["layers"], lambda a, _i=i: tensor(np.asarray(a)[_i]))
        for i in range(cfg.n_layers)]
    return out


def params_to_numpy(params: dict) -> dict:
    """Inverse of :func:`params_from_jax`: the reference layout, as numpy
    float32 arrays."""
    def arr(t):
        return t.detach().to("cpu", torch.float32).numpy()

    out = {k: _map(v, arr) for k, v in params.items() if k != "layers"}
    layers = [_map(lp, arr) for lp in params["layers"]]

    def stack_trees(trees):
        if isinstance(trees[0], dict):
            return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    out["layers"] = stack_trees(layers)
    return out
