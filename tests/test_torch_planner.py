"""The port's planner (``repro_torch.core``) against the reference's.

The planner holds no framework code, so on the same graph it must choose
exactly what the reference chooses: the same member sets, the same packs,
and the same kernel counts in every mode.  Graphs: the conftest softmax and
mlp_norm graphs and six paper workloads, built by the reference and copied
node for node into the port's IR.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from benchmarks import workloads
from conftest import make_mlp_norm_graph, make_softmax_graph
from repro.core import StitchCompiler as RefCompiler
from repro.core import V100 as REF_V100
from repro_torch.core import Graph, OpKind, OpNode, StitchCompiler, V100
from repro_torch.core.trace import trace_to_graph

WORKLOADS = ["logistic", "nmt", "multi-interests", "word2vec", "perceptron",
             "var-encoder"]
GRAPHS = ["softmax", "mlp_norm"] + WORKLOADS
MODES = ("off", "xla", "stitch")


@functools.lru_cache(maxsize=None)
def ref_graph(name: str):
    if name == "softmax":
        return make_softmax_graph()[0]
    if name == "mlp_norm":
        return make_mlp_norm_graph()
    return workloads.WORKLOADS[name]()


def to_port(rg) -> Graph:
    """Copy a reference graph into the port's IR, node for node (executable
    closures are dropped: planning never runs them)."""
    g = Graph(rg.name)
    for name in rg.topo_order():
        n = rg[name]
        attrs = {k: v for k, v in n.attrs.items() if k != "eval_fn"}
        g.add(OpNode(n.name, OpKind(n.kind.value), tuple(n.shape),
                     str(n.dtype), tuple(n.operands), attrs))
    g.mark_output(*rg.outputs)
    return g


@functools.lru_cache(maxsize=None)
def plans(name: str, mode: str):
    rg = ref_graph(name)
    ref = RefCompiler(REF_V100, mode=mode, use_pallas=False).compile(rg)
    port = StitchCompiler(V100, mode=mode).compile(to_port(rg))
    return ref, port


def _groups(compiled):
    return sorted((sorted(grp.members), grp.pack is not None)
                  for grp in compiled.groups)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", GRAPHS)
def test_plan_equals_reference(name, mode):
    ref, port = plans(name, mode)
    assert port.stats.n_ops == ref.stats.n_ops
    assert port.stats.n_kernels == ref.stats.n_kernels
    assert _groups(port) == _groups(ref)
    assert port.stats.packs == ref.stats.packs
    assert port.stats.packed_subgraphs == ref.stats.packed_subgraphs
    assert port.stats.pattern_classes == ref.stats.pattern_classes


@pytest.mark.parametrize("name", GRAPHS)
def test_packs_equal_reference(name):
    ref, port = plans(name, "stitch")

    def packs(c):
        return sorted(sorted(sorted(s) for s in grp.pack)
                      for grp in c.groups if grp.pack)

    assert packs(port) == packs(ref)


def test_baseline_kernel_counts():
    """nmt off/xla/stitch = 29/18/5 as recorded in benchmarks/baseline.json."""
    counts = [plans("nmt", m)[1].stats.n_kernels for m in MODES]
    assert counts == [29, 18, 5]


def test_h100_preset():
    from repro_torch.core import H100
    assert H100.hbm_bw == 3.35e12
    assert H100.peak_flops == 989e12
    assert H100.onchip_budget == 227 * 1024
    assert H100.reg_budget == 256 * 1024


def test_frontend_spells_broadcasts_explicitly():
    """ATen broadcasting is spelled as jnp's: a lower-rank operand gets an
    explicit rank-promoting BROADCAST (size-1 dims in front, right-aligned
    ``bcast_dims``), size-1 dims then broadcast implicitly, scalars become
    shape-() constants, mean is a REDUCTION sum, its broadcast back to the
    kept rank and a division by a count literal."""
    def fn(x, g):
        return (x - x.mean(-1, keepdim=True)) * g * 0.5

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((4, 3, 8)).astype(np.float32))
    gm = torch.as_tensor(rng.standard_normal((8,)).astype(np.float32))
    g, names = trace_to_graph(fn, x, gm)
    kinds = [g[n].kind for n in g.topo_order()]
    assert OpKind.REDUCTION in kinds
    bc = [g[n] for n in g.nodes if g[n].kind is OpKind.BROADCAST]
    got = sorted((tuple(b.shape), tuple(b.attrs["bcast_dims"])) for b in bc)
    assert got == [((1, 1, 8), (2,)), ((4, 3, 1), (0, 1))]
    lits = [g[n] for n in g.nodes if g[n].kind is OpKind.CONSTANT]
    assert sorted(float(c.attrs["value"]) for c in lits) == [0.5, 8.0]
    assert [tuple(c.shape) for c in lits] == [(), ()]
    for node in g.nodes.values():
        if node.kind is OpKind.ELEMENTWISE:
            for o in node.operands:
                shp = g[o].shape
                assert shp == () or (len(shp) == len(node.shape) and all(
                    a in (1, b) for a, b in zip(shp, node.shape)))
