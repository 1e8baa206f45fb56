"""The port's tracer against the reference's, and a reduced qwen3 layer's
plan in both planners.

``torch.mean`` traces as the jaxpr of ``jnp.mean``: a REDUCTION ``sum``, a
BROADCAST back to the kept rank when dims are kept, and a ``div`` by the
count as a scalar literal.  The reduced qwen3-1.7b layer (the reference's
``block_forward`` in ref mode, traced by the reference) plans the same in
the port's planner as in the reference's: the same ops, the same chosen
member sets, packs and kernel counts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.core import StitchCompiler as RefCompiler
from repro.core import V100 as REF_V100
from repro.core.trace import trace_to_graph as ref_trace
from repro.kernels import ops as ref_ops
from repro.models import lm as ref_lm
from repro_torch.core import StitchCompiler, V100
from repro_torch.core.trace import trace_to_graph
from repro_torch.kernels import ref

from test_torch_planner import _groups, to_port


def _nodes(g):
    """Each non-parameter node in topological order: kind, op, shape,
    dtype, the operands' positions, and a constant's value."""
    order = [n for n in g.topo_order() if g[n].kind.name != "PARAMETER"]
    at = {n: i for i, n in enumerate(order)}
    out = []
    for name in order:
        n = g[name]
        value = n.attrs.get("value")
        out.append((n.kind.name, n.attrs.get("op"), tuple(n.shape),
                    str(n.dtype),
                    tuple(at.get(o, "arg") for o in n.operands),
                    tuple(n.attrs.get("axes", ())),
                    tuple(n.attrs.get("bcast_dims", ())),
                    None if value is None else float(np.asarray(value))))
    return out


@pytest.mark.parametrize("dims,keep", [((-1,), True), ((-1,), False),
                                       ((1, 2), True), (None, False)])
def test_mean_traces_as_the_reference(dims, keep):
    x = np.random.default_rng(0).standard_normal((2, 3, 8)).astype(np.float32)
    rg, _ = ref_trace(lambda a: jnp.mean(a, axis=dims, keepdims=keep),
                      jnp.asarray(x))
    if dims is None:
        g, _ = trace_to_graph(lambda a: torch.mean(a), torch.as_tensor(x))
    else:
        g, _ = trace_to_graph(lambda a: torch.mean(a, dim=dims, keepdim=keep),
                              torch.as_tensor(x))
    assert _nodes(g) == _nodes(rg)


def test_rmsnorm_oracle_mean_is_sum_broadcast_division():
    """The ref-mode RMSNorm's statistics: no REDUCTION ``mean`` is left, and
    the sum's broadcast and the division by the width are there, as in the
    reference's trace of its RMSNorm."""
    x = np.random.default_rng(1).standard_normal((2, 4, 64)).astype(np.float32)
    gamma = np.ones(64, np.float32)
    g, _ = trace_to_graph(lambda a, w: ref.rmsnorm(a, w, 1e-6),
                          torch.as_tensor(x), torch.as_tensor(gamma))
    reds = [n for n in g.nodes.values() if n.kind.name == "REDUCTION"]
    assert [(n.attrs["op"], n.shape) for n in reds] == [("sum", (2, 4))]
    (bc,) = g.users(reds[0].name)
    assert g[bc].kind.name == "BROADCAST" and g[bc].shape == (2, 4, 1)
    (div,) = g.users(bc)
    lit = g[g[div].operands[1]]
    assert g[div].attrs["op"] == "div" and float(lit.attrs["value"]) == 64.0


def _layer_graph():
    """The reference's ref-mode trace of one reduced qwen3-1.7b layer
    (``block_forward``) at B=2, S=16."""
    cfg = ref_get_reduced("qwen3_1_7b")
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda a: a[0], params["layers"]) \
        if isinstance(params["layers"], dict) else params["layers"][0]
    x = np.random.default_rng(2).standard_normal((2, 16, cfg.d_model))
    with ref_ops.kernel_mode("ref"):
        rg, _ = ref_trace(lambda p, h: ref_lm.block_forward(p, h, cfg), lp,
                          jnp.asarray(x, cfg.dtype), name="qwen3_layer")
    return rg


@pytest.mark.parametrize("mode", ["stitch", "xla"])
def test_reduced_qwen3_layer_plans_as_the_reference(mode):
    rg = _layer_graph()
    want = RefCompiler(REF_V100, mode=mode, use_pallas=False).compile(rg)
    got = StitchCompiler(V100, mode=mode).compile(to_port(rg))
    assert got.stats.n_ops == want.stats.n_ops
    assert got.stats.n_kernels == want.stats.n_kernels
    assert _groups(got) == _groups(want)
    assert got.stats.packs == want.stats.packs
    assert got.stats.pattern_classes == want.stats.pattern_classes
