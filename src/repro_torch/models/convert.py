"""Carry the reference's parameters across.

The reference stacks per-layer parameters along a leading layer axis
(``params["layers"]`` is one tree of ``(L, ...)`` arrays; the hybrid
family's ``params["supers"]`` one tree of ``(n_super, ...)`` arrays beside
a ``rest`` list of layer trees); the port keeps lists of per-layer dicts.
Both store weights ``(in, out)``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

from .config import ModelConfig
from .layers import torch_dtype

__all__ = ["params_from_jax", "params_to_numpy"]

# the keys whose tree the reference stacks along a leading axis
_STACKED = ("layers", "supers")


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """Reference params (a tree of numpy arrays, stacked ``layers`` or
    ``supers``) -> the port's params on ``device`` (the card unless the
    caller asks for the CPU), in ``cfg.param_dtype``.  Every leaf is
    carried as it is: a LayerNorm's ``b`` and the two-matrix MLP too."""
    pdt = torch_dtype(cfg.param_dtype)
    device = resolve_device(device)

    def tensor(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), dtype=pdt,
                            device=device)

    out = {}
    for k, v in tree.items():
        if k in _STACKED:
            n = np.asarray(_leaves(v)[0]).shape[0]
            out[k] = [_map(v, lambda a, _i=i: tensor(np.asarray(a)[_i]))
                      for i in range(n)]
        else:
            out[k] = _map(v, tensor)
    return out


def params_to_numpy(params: dict) -> dict:
    """Inverse of :func:`params_from_jax`: the reference layout, as numpy
    float32 arrays."""
    def arr(t):
        return t.detach().to("cpu", torch.float32).numpy()

    def stack_trees(trees):
        if isinstance(trees[0], dict):
            return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    return {k: (stack_trees([_map(lp, arr) for lp in v]) if k in _STACKED
                else _map(v, arr))
            for k, v in params.items()}
