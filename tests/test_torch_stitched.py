"""The port's stitched emitter (``repro_torch.kernels.stitched``) against the
reference's (``repro.kernels.stitched``).

* ``analyze_pattern`` makes the reference's row and role decisions on every
  chosen pattern of the planner-parity graphs.
* The plain stitched version equals the reference's stitched Pallas kernel
  (interpret mode) on seeded inputs, rtol/atol 2e-4.
* The Triton source renders for every emittable pattern and compiles as
  Python without importing triton.
* Horizontal packs render one program range per subgraph.
* Patterns too wide for one block fold their (B, S) rows into B*S rows;
  the folded pattern's plain version equals the reference's graph function.
* Operands with size-1 dims broadcast implicitly, as jnp traces them: the
  emitter spells each as an explicit BROADCAST member and renders it; the
  plain version equals the reference's graph function; any other shape
  mismatch is refused.

The card-only checks of the same kernels are in ``test_torch_gpu.py``.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import FusionPattern as RefPattern
from repro.core import GraphBuilder as RefBuilder
from repro.core import build_reference_fn as ref_graph_fn
from repro.kernels.stitched import StitchInfeasible as RefInfeasible
from repro.kernels.stitched import analyze_pattern as ref_analyze
from repro.kernels.stitched import build_stitched_callable as ref_build
from repro_torch.core import FusionPattern, GraphBuilder, PackPattern
from repro_torch.kernels.stitched import (MAX_BLOCK_ELEMS, StitchInfeasible,
                                          analyze_pattern,
                                          build_stitched_callable,
                                          check_emittable, emission_plan,
                                          explicit_broadcasts, fold_rows)
from test_torch_gpu import (chain_graph, implicit_broadcast_graph,
                            pack_pattern, prefill_norm_graph)
from test_torch_planner import GRAPHS, plans, ref_graph, to_port

TOL = dict(rtol=2e-4, atol=2e-4)
# graphs whose reference plan chose patterns this emitter stage can emit
# (the others' patterns all hold GEMMs or slices)
EMITTABLE = ("softmax", "word2vec", "var-encoder")


@functools.lru_cache(maxsize=None)
def pattern_pairs(name: str):
    """(reference pattern, port pattern) for every pattern the reference
    plan chose on graph ``name``."""
    ref, _ = plans(name, "stitch")
    rg = ref_graph(name)
    pg = to_port(rg)
    return [(RefPattern(rg, p.members), FusionPattern(pg, p.members))
            for p in ref.stats.ilp.chosen]


def _emittable(p) -> bool:
    try:
        check_emittable(p, analyze_pattern(p))
        return True
    except StitchInfeasible:
        return False


def _sample(node, rng) -> np.ndarray:
    shape = tuple(node.shape)
    dt = str(node.dtype)
    if dt == "bool":
        return rng.random(shape) > 0.5
    if dt.startswith("int") or dt.startswith("uint"):
        return rng.integers(0, 4, shape).astype(dt)
    return rng.uniform(0.5, 1.5, shape).astype(dt)


@pytest.mark.parametrize("name", GRAPHS)
def test_analysis_matches_reference(name):
    pairs = pattern_pairs(name)
    assert pairs
    for rp, pp in pairs:
        try:
            ra = ref_analyze(rp)
        except RefInfeasible as e:
            with pytest.raises(StitchInfeasible) as pe:
                analyze_pattern(pp)
            assert str(pe.value) == str(e)
            continue
        pa = analyze_pattern(pp)
        assert pa.rows == ra.rows
        assert pa.roles == ra.roles
        assert pa.feasible_blocks == ra.feasible_blocks
        assert pa.single_block == ra.single_block
        assert {k: (c, float(v)) for k, (c, v) in pa.acc_init.items()} == \
            {k: (c, float(v)) for k, (c, v) in ra.acc_init.items()}


@pytest.mark.parametrize("name", GRAPHS)
def test_plain_version_matches_reference_kernel(name):
    """Every emittable chosen pattern: the port's plain stitched version
    equals the reference's stitched kernel (Pallas, interpret mode)."""
    rng = np.random.default_rng(0)
    checked = 0
    for rp, pp in pattern_pairs(name):
        if not _emittable(pp):
            continue
        k = build_stitched_callable(pp)
        inputs = [_sample(pp.graph[i], rng) for i in pp.external_inputs]
        got = k.plain(*[torch.as_tensor(x) for x in inputs])
        want = ref_build(rp)(*[jnp.asarray(x) for x in inputs])
        for gv, wv in zip(got, want):
            np.testing.assert_allclose(gv.numpy(), np.asarray(wv),
                                       equal_nan=True, **TOL)
        checked += 1
    assert (checked > 0) == (name in EMITTABLE)


@pytest.mark.parametrize("name", GRAPHS)
def test_triton_source_compiles(name):
    n = 0
    for _, pp in pattern_pairs(name):
        if not _emittable(pp):
            continue
        src = build_stitched_callable(pp).source
        assert "@triton.jit" in src and "tl.store" in src
        compile(src, f"<stitched:{name}>", "exec")
        n += 1
    assert (n > 0) == (name in EMITTABLE)


def test_unsupported_members_name_their_stage():
    """GEMM members are rejected statically with the ROADMAP stage."""
    (_, pp), = [x for x in pattern_pairs("mlp_norm")]
    with pytest.raises(StitchInfeasible, match="stage 2"):
        check_emittable(pp, analyze_pattern(pp))


def test_masked_chain_renders():
    g = chain_graph(12, 100, "bfloat16")
    p = FusionPattern(g, frozenset(n.name for n in g.compute_nodes()))
    src = build_stitched_callable(p).source
    assert "< 100" in src and "float('-inf')" in src
    compile(src, "<chain>", "exec")


def test_pack_subgraphs_take_program_ranges():
    p = pack_pattern()
    k = build_stitched_callable(p, row_block=8)
    assert k.emitted.grid == 3 * 8
    src = k.source
    for s in range(3):
        assert f"if prog // 8 == {s}:" in src
    compile(src, "<pack>", "exec")
    rng = np.random.default_rng(0)
    ins = [torch.as_tensor(rng.standard_normal((64, 100)).astype(np.float32))
           for _ in p.external_inputs]
    env = dict(zip(p.external_inputs, ins))
    g = p.graph
    for name, y in zip(p.external_outputs, k(*ins)):
        x = env[g[g[name].operands[0]].operands[0]]
        torch.testing.assert_close(y, torch.exp(x.bfloat16().float()).bfloat16())


def _whole(g):
    return FusionPattern(g, frozenset(n.name for n in g.compute_nodes()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_rows_fold_to_tokens(dtype):
    """The reference's analysis gives rows of S*D elements (too wide for a
    block); the emitter folds (B, S) into B*S rows of D, and the plain
    version equals the reference's graph function on the same inputs."""
    B, S, D = 2, 32, 1024
    g = prefill_norm_graph(GraphBuilder, B, S, D, dtype)
    p = _whole(g)
    with pytest.raises(StitchInfeasible):
        check_emittable(p, analyze_pattern(p))
    k = build_stitched_callable(p)
    assert k.analysis.rows == B * S
    assert k.emitted.block_r * D <= MAX_BLOCK_ELEMS
    assert f"rows[:, None] * {D}" in k.source
    compile(k.source, "<folded>", "exec")

    rg = prefill_norm_graph(RefBuilder, B, S, D, dtype)
    rng = np.random.default_rng(0)
    feeds = {}
    for name in p.external_inputs:
        node = g[name]
        x = rng.standard_normal(node.shape).astype(np.float32)
        feeds[name] = x if node.shape else np.float32(1e-6)
    jfeeds = {n: jnp.asarray(v, dtype=str(g[n].dtype)) for n, v in feeds.items()}
    tfeeds = [torch.as_tensor(np.array(jfeeds[n], np.float32))
              .to(getattr(torch, str(g[n].dtype))) for n in p.external_inputs]
    want = ref_graph_fn(rg)(jfeeds)
    got = k(*tfeeds)
    tol = TOL if dtype == "float32" else dict(rtol=1.6e-2, atol=1.6e-2)
    for name, val in zip(p.external_outputs, got):
        np.testing.assert_allclose(val.float().numpy(),
                                   np.asarray(want[name], np.float32), **tol)


def test_fold_refuses_row_varying_invariants():
    """A (S, D) table broadcast over the batch varies along the folded rows
    (a rotary table): the fold refuses it rather than read it as one row."""
    b = GraphBuilder("rope_like")
    x = b.param("x", (4, 64, 128))
    tab = b.param("table", (64, 128))
    y = b.ew("mul", x, b.bcast(tab, (4, 64, 128), (1, 2)))
    g = b.build(outputs=[b.reduce("sum", y, axes=(2,))])
    with pytest.raises(StitchInfeasible, match="crosses the folded rows"):
        fold_rows(_whole(g))


def test_fold_refuses_moved_rows():
    b = GraphBuilder("attn_like")
    x = b.param("x", (4, 64, 8, 16))
    t = b.transpose(x, (0, 2, 1, 3))
    g = b.build(outputs=[b.ew("exp", t)])
    with pytest.raises(StitchInfeasible):
        fold_rows(_whole(g))


def test_pack_folds_per_subgraph():
    """A pack of per-layer activations over (B, S, F) folds to B*S rows;
    each subgraph keeps its own range of programs."""
    b = GraphBuilder("pack_fold")
    groups = []
    for i in range(2):
        x = b.param(f"x{i}", (4, 64, 6144), "bfloat16")
        c = b.ew("convert", x, dtype="float32")
        groups.append(frozenset((c, b.ew("exp", c))))
    g = b.build(outputs=[max(grp, key=lambda n: n.startswith("exp"))
                         for grp in groups])
    p = PackPattern(g, frozenset().union(*groups), "pack",
                    member_groups=tuple(groups))
    k = build_stitched_callable(p)
    assert k.analysis.rows == 256
    blocks = 256 // k.emitted.block_r
    assert k.emitted.grid == 2 * blocks
    assert f"if prog // {blocks} == 1:" in k.source
    compile(k.source, "<pack_fold>", "exec")


@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", dict(rtol=1.6e-2,
                                                         atol=1.6e-2))])
def test_implicit_broadcast_matches_reference(dtype, tol):
    """The (rows, 1) statistics and the (1, cols) gamma broadcast
    implicitly: the emitter spells each as an explicit BROADCAST member,
    renders the kernel, and its plain version equals the reference's graph
    function on the same inputs."""
    g = implicit_broadcast_graph(GraphBuilder, 12, 100, dtype)
    p = _whole(g)
    ep = explicit_broadcasts(p)
    added = sorted(n for n in ep.members if n not in p.members)
    assert len(added) == 3
    assert all(ep.graph[n].kind.name == "BROADCAST" for n in added)
    emit_p, ana = emission_plan(p)
    assert ana.rows == 12
    k = build_stitched_callable(p)
    assert "@triton.jit" in k.source
    compile(k.source, "<implicit>", "exec")

    rg = implicit_broadcast_graph(RefBuilder, 12, 100, dtype)
    rng = np.random.default_rng(5)
    feeds = {n: rng.standard_normal(g[n].shape).astype(np.float32)
             for n in p.external_inputs}
    jfeeds = {n: jnp.asarray(v, dtype=str(g[n].dtype)) for n, v in feeds.items()}
    want = ref_graph_fn(rg)(jfeeds)
    got = k(*[torch.as_tensor(np.array(jfeeds[n], np.float32))
              .to(getattr(torch, str(g[n].dtype))) for n in p.external_inputs])
    for name, val in zip(p.external_outputs, got):
        np.testing.assert_allclose(val.float().numpy(),
                                   np.asarray(want[name], np.float32), **tol)


@pytest.mark.parametrize("other", [(12, 3), (100,)],
                         ids=["unequal_dim", "lower_rank"])
def test_other_shape_mismatch_is_refused(other):
    """Only a same-rank operand whose dims are 1 or the member's broadcasts
    implicitly; any other operand shape is refused."""
    b = GraphBuilder("mismatch")
    x = b.param("x", (12, 100))
    y = b.param("y", other)
    g = b.build(outputs=[b.ew("exp", b.ew("mul", x, y, shape=(12, 100)))])
    p = _whole(g)
    assert explicit_broadcasts(p).members == p.members
    with pytest.raises(StitchInfeasible, match="does not broadcast"):
        emission_plan(p)
