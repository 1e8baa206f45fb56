"""The port's tracer against the reference's, and a reduced qwen3 layer's
plan in both planners.

``torch.mean`` traces as the jaxpr of ``jnp.mean``: a REDUCTION ``sum``, a
BROADCAST back to the kept rank when dims are kept, and a ``div`` by the
count as a scalar literal.  Each jnp idiom the port's layers use (a 3-D
matmul, a two-operand einsum, implicit size-1 broadcasts and rank
promotion, softmax, keepdims reductions, ``where`` with a literal, iota,
indexing with None, repeat, take_along_axis, square, ``c / x``) traces
node for node as its jnp counterpart.  The port's own ref-mode trace of the
reduced qwen3-1.7b layer (its ``block_forward``) is node for node the
reference's trace of its ``block_forward`` and plans as it does in both
modes: the same ops, kernels, chosen member sets, packs and pattern
classes.  The reference's graph, converted, plans the same in both
planners too.
"""

from __future__ import annotations

import functools

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
from repro_torch.configs import get_reduced
from repro_torch.core import StitchCompiler, V100
from repro_torch.core.trace import trace_to_graph
from repro_torch.kernels import ref
from repro_torch.models import lm

from test_torch_planner import _groups, to_port


def _nodes(g):
    """Each non-parameter node in topological order: kind, op, shape,
    dtype, the operands' positions, its axes, broadcast dims, dot
    dimension numbers and permutation, and a constant's value."""
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
                    _dims(n.attrs.get("contract")), _dims(n.attrs.get("batch")),
                    tuple(n.attrs.get("perm", ())),
                    None if value is None
                    else tuple(np.asarray(value, np.float64).ravel())))
    return out


def _dims(pair):
    return None if pair is None else tuple(tuple(d) for d in pair)


def _order(g):
    """node -> its position in ``_nodes``."""
    order = [n for n in g.topo_order() if g[n].kind.name != "PARAMETER"]
    return {n: i for i, n in enumerate(order)}


def _plan(compiled, g):
    """The chosen groups as sorted positions (``_nodes`` order), packed or
    not: two graphs equal node for node compare by position."""
    at = _order(g)
    return sorted((sorted(at[m] for m in grp.members), grp.pack is not None)
                  for grp in compiled.groups)


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


def _rng_arrays(*shapes, dtype=np.float32):
    rng = np.random.default_rng(3)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


# (jnp function, torch function, input shapes): each traces node for node
# as the other
IDIOMS = {
    "matmul_3d": (lambda x, w: x @ w, lambda x, w: x @ w,
                  [(2, 16, 64), (64, 32)]),
    "einsum_qk": (lambda q, k: jnp.einsum("bqhd,bkhd->bhqk", q, k),
                  lambda q, k: torch.einsum("bqhd,bkhd->bhqk", q, k),
                  [(2, 16, 4, 8), (2, 12, 4, 8)]),
    "einsum_pv": (lambda p, v: jnp.einsum("bhqk,bkhd->bqhd", p, v),
                  lambda p, v: torch.einsum("bhqk,bkhd->bqhd", p, v),
                  [(2, 4, 16, 12), (2, 12, 4, 8)]),
    "einsum_gqa": (lambda q, k: jnp.einsum("bqhgd,bkhd->bhgqk", q, k),
                   lambda q, k: torch.einsum("bqhgd,bkhd->bhgqk", q, k),
                   [(2, 3, 2, 2, 8), (2, 10, 2, 8)]),
    "einsum_lm_head": (lambda h, w: jnp.einsum("gtd,dv->gtv", h, w),
                       lambda h, w: torch.einsum("gtd,dv->gtv", h, w),
                       [(2, 5, 16), (16, 40)]),
    "size1_broadcast": (lambda x, r: x * r, lambda x, r: x * r,
                        [(2, 16, 64), (2, 16, 1)]),
    "size1_both_sides": (lambda a, b: a - b, lambda a, b: a - b,
                         [(2, 1, 16, 1), (1, 1, 1, 16)]),
    "rank_promotion": (lambda x, g: x * g, lambda x, g: x * g,
                       [(2, 16, 64), (64,)]),
    "softmax": (lambda x: jax.nn.softmax(x, axis=-1),
                lambda x: torch.softmax(x, dim=-1), [(2, 4, 16, 16)]),
    "log_softmax": (lambda x: jax.nn.log_softmax(x, axis=-1),
                    lambda x: torch.log_softmax(x, dim=-1), [(3, 40)]),
    "max_keepdims": (lambda x: jnp.max(x, axis=-1, keepdims=True),
                     lambda x: torch.amax(x, dim=-1, keepdim=True), [(16, 50)]),
    "where_literal": (lambda x: jnp.where(x > 0, x, -jnp.inf),
                      lambda x: torch.where(x > 0, x, -float("inf")),
                      [(2, 8, 8)]),
    "iota": (lambda x: x * jnp.arange(8, dtype=jnp.float32),
             lambda x: x * torch.arange(8, dtype=torch.float32), [(3, 8)]),
    "index_none": (lambda p: p[:, None, :, None],
                   lambda p: p[:, None, :, None], [(2, 16)]),
    "repeat": (lambda k: jnp.repeat(k, 3, axis=2),
               lambda k: torch.repeat_interleave(k, 3, dim=2),
               [(2, 5, 2, 8)]),
    "square": (lambda x: jnp.square(x), lambda x: torch.square(x), [(4, 8)]),
    "reciprocal": (lambda x: 1.0 / x, lambda x: 1.0 / x, [(4, 8)]),
}


@pytest.mark.parametrize("idiom", list(IDIOMS))
def test_idiom_traces_as_jnp(idiom):
    jfn, tfn, shapes = IDIOMS[idiom]
    arrays = _rng_arrays(*shapes)
    rg, _ = ref_trace(jfn, *(jnp.asarray(a) for a in arrays))
    g, _ = trace_to_graph(tfn, *(torch.as_tensor(a) for a in arrays))
    assert _nodes(g) == _nodes(rg)


def test_take_along_axis_traces_as_jnp():
    """The gold logit's gather: the (B, 1) index, its wrap, the index
    reshaped to (B, 1, 1) and one gather node, as ``jnp.take_along_axis``
    traces (the gathers' CUSTOM prims differ: ``gather`` and
    ``aten.gather.default``)."""
    x, = _rng_arrays((16, 50))
    lab = np.random.default_rng(4).integers(0, 50, 16).astype(np.int32)

    def jfn(a, l):
        return jnp.take_along_axis(a, l[:, None], axis=-1)

    def tfn(a, l):
        idx = l[:, None]
        idx = torch.where(idx < 0, idx + a.shape[-1], idx)
        return torch.gather(a, 1, idx)
    rg, _ = ref_trace(jfn, jnp.asarray(x), jnp.asarray(lab))
    g, _ = trace_to_graph(tfn, torch.as_tensor(x), torch.as_tensor(lab))
    assert _nodes(g) == _nodes(rg)
    (gather,) = [n for n in g.nodes.values() if n.kind.name == "CUSTOM"]
    got = gather.attrs["eval_fn"](torch.as_tensor(x),
                                  torch.as_tensor(lab).reshape(16, 1, 1))
    np.testing.assert_array_equal(got.numpy(),
                                  np.take_along_axis(x, lab[:, None], -1))


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


@functools.lru_cache(maxsize=None)
def _layer_graph(B=2, S=16):
    """The reference's ref-mode trace of one reduced qwen3-1.7b layer
    (``block_forward``) at (B, S)."""
    cfg = ref_get_reduced("qwen3_1_7b")
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda a: a[0], params["layers"]) \
        if isinstance(params["layers"], dict) else params["layers"][0]
    x = np.random.default_rng(2).standard_normal((B, S, cfg.d_model))
    with ref_ops.kernel_mode("ref"):
        rg, _ = ref_trace(lambda p, h: ref_lm.block_forward(p, h, cfg), lp,
                          jnp.asarray(x, cfg.dtype), name="qwen3_layer")
    return rg


def _sorted_keys(tree):
    """A params dict with its keys in jax's flattening order (sorted), so
    both traces number their parameters alike."""
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    return tree


@functools.lru_cache(maxsize=None)
def _port_layer_graph(B=2, S=16):
    """The port's own ref-mode trace of its reduced qwen3-1.7b layer
    (``lm.block_forward``) at (B, S)."""
    cfg = get_reduced("qwen3_1_7b")
    lp = _sorted_keys(lm.init_params(cfg, 0, "cpu")["layers"][0])
    x = np.random.default_rng(2).standard_normal((B, S, cfg.d_model))
    g, _ = trace_to_graph(lambda p, h: lm.block_forward(p, h, cfg), lp,
                          torch.as_tensor(x).to(getattr(torch, cfg.dtype)),
                          name="qwen3_layer")
    return g


def test_reduced_qwen3_layer_traces_node_for_node():
    g, rg = _port_layer_graph(), _layer_graph()
    assert len(g.compute_nodes()) == len(rg.compute_nodes()) == 163
    assert _nodes(g) == _nodes(rg)


@pytest.mark.parametrize("mode", ["stitch", "xla"])
def test_reduced_qwen3_layer_plans_as_the_reference(mode):
    """The port's own trace planned by the port against the reference's
    trace planned by the reference: 163 ops, 8 kernels in stitch mode, the
    same groups (by position), packs and pattern classes."""
    rg, g = _layer_graph(), _port_layer_graph()
    want = RefCompiler(REF_V100, mode=mode, use_pallas=False).compile(rg)
    got = StitchCompiler(V100, mode=mode).compile(g)
    assert got.stats.n_ops == want.stats.n_ops == 163
    assert got.stats.n_kernels == want.stats.n_kernels
    if mode == "stitch":
        assert got.stats.n_kernels == 8
    assert _plan(got, g) == _plan(want, rg)
    assert got.stats.packs == want.stats.packs
    assert got.stats.pattern_classes == want.stats.pattern_classes


def test_reduced_qwen3_layer_plans_as_the_reference_at_a_prefill_bucket():
    """At B=4, S=64 (a prefill bucket) the same layer traces node for node
    as the reference's, and both planners cut it into 106 kernels, not 8:
    the same groups and packs."""
    rg, g = _layer_graph(4, 64), _port_layer_graph(4, 64)
    assert _nodes(g) == _nodes(rg)
    want = RefCompiler(REF_V100, use_pallas=False).compile(rg)
    got = StitchCompiler(V100).compile(g)
    assert got.stats.n_ops == want.stats.n_ops == 163
    assert got.stats.n_kernels == want.stats.n_kernels == 106
    assert _plan(got, g) == _plan(want, rg)
    assert got.stats.packs == want.stats.packs


@pytest.mark.parametrize("mode", ["stitch", "xla"])
def test_reference_qwen3_layer_graph_plans_alike(mode):
    """The reference's graph, converted node for node, in both planners."""
    rg = _layer_graph()
    want = RefCompiler(REF_V100, mode=mode, use_pallas=False).compile(rg)
    got = StitchCompiler(V100, mode=mode).compile(to_port(rg))
    assert got.stats.n_ops == want.stats.n_ops
    assert got.stats.n_kernels == want.stats.n_kernels
    assert _groups(got) == _groups(want)
    assert got.stats.packs == want.stats.packs
    assert got.stats.pattern_classes == want.stats.pattern_classes
