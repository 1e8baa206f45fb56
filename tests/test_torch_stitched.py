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
* Layout-only patterns (reshapes, transposes of size-1 axes, broadcasts
  that only add size-1 dims, converts to the same dtype) are served as
  views: no kernel, the plain version's values exactly, the input's
  storage; an input whose strides admit no view is copied and counted; a
  graph output that would view a graph input, or share its bytes with
  another output, launches a kernel instead.
* Patterns that compute element by element render in the flat layout
  (16-byte accesses, programs across the card).

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
from repro_torch.kernels import stitched
from repro_torch.kernels.stitched import (MAX_BLOCK_ELEMS, StitchedKernel,
                                          StitchedView, StitchInfeasible,
                                          alias_refusal, analyze_pattern,
                                          build_stitched_callable,
                                          cause_stage, check_emittable,
                                          emission_plan, explicit_broadcasts,
                                          fold_rows, layout_only,
                                          refusal_causes)
from test_torch_gpu import (MOVEMENT_CASES, chain_graph,
                            implicit_broadcast_graph, kv_cut_pattern,
                            movement_graph, movement_inputs, pack_pattern,
                            prefill_norm_graph)
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


# (member on x of shape (4, 1, 2048), layout-only?): each pattern is the one
# member, fed by a graph input and read by an exp outside the pattern
LAYOUT_CASES = {
    "reshape": (lambda b, x: b.reshape(x, (4, 2048)), True),
    "reshape_heads": (lambda b, x: b.reshape(x, (64, 128)), True),
    "transpose_size1_axis": (lambda b, x: b.transpose(x, (1, 0, 2)), True),
    "broadcast_adds_size1": (
        lambda b, x: b.bcast(x, (4, 1, 1, 2048), (0, 1, 3)), True),
    "convert_same_dtype": (
        lambda b, x: b.ew("convert", x, dtype="float32"), True),
    "transpose_real_axis": (lambda b, x: b.transpose(x, (2, 1, 0)), False),
    "broadcast_expands": (
        lambda b, x: b.bcast(x, (4, 3, 2048), (0, 1, 2)), False),
    "convert_changes_dtype": (
        lambda b, x: b.ew("convert", x, dtype="bfloat16"), False),
    "add": (lambda b, x: b.ew("add", x, x), False),
}


def _layout_pattern(case):
    b = GraphBuilder(f"layout_{case}")
    x = b.param("x", (4, 1, 2048))
    y = LAYOUT_CASES[case][0](b, x)
    g = b.build(outputs=[b.ew("exp", y)])
    return FusionPattern(g, frozenset({y}))


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_layout_only_classification(case):
    """Which members make a pattern layout-only, and what the emitter
    builds for it: a view for those, a kernel (or a refusal) for the
    rest."""
    p = _layout_pattern(case)
    want = LAYOUT_CASES[case][1]
    assert layout_only(p) == want
    try:
        k = build_stitched_callable(p)
    except StitchInfeasible:
        assert not want
        return
    assert isinstance(k, StitchedView) == want
    assert isinstance(k, StitchedKernel) != want


@pytest.mark.parametrize("case", [c for c, (_, v) in LAYOUT_CASES.items() if v])
def test_view_equals_plain_and_shares_storage(case):
    """A view pattern's call launches nothing and builds no source: each
    output is the plain version's values exactly, on the input's storage;
    the call is counted apart from the launches."""
    p = _layout_pattern(case)
    k = build_stitched_callable(p)
    x = torch.randn(4, 1, 2048, generator=torch.Generator().manual_seed(0))
    stitched.reset_launch_counts()
    out, = k(x)
    want, = k.plain(x)
    assert torch.equal(out, want) and out.shape == want.shape
    assert out.dtype == want.dtype and out.is_contiguous()
    assert out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
    assert stitched.view_counts()[k.digest] == 1
    assert stitched.view_copy_counts()[k.digest] == 0
    assert not any(stitched.launch_counts().values())
    assert not hasattr(k, "source")


def test_view_of_a_strided_input_copies_and_counts():
    """An input whose strides admit no contiguous view (a permuted tensor)
    is copied by ``reshape``, the copy counted; a contiguous input at an
    offset is viewed, nothing counted."""
    k = build_stitched_callable(_layout_pattern("reshape"))
    gen = torch.Generator().manual_seed(1)
    stitched.reset_launch_counts()
    x = torch.randn(2048, 1, 4, generator=gen).permute(2, 1, 0)
    out, = k(x)
    assert torch.equal(out, k.plain(x)[0]) and out.is_contiguous()
    assert out.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
    assert stitched.view_copy_counts()[k.digest] == 1
    big = torch.randn(8, 1, 2048, generator=gen)
    out, = k(big[4:])
    assert torch.equal(out, big[4:].reshape(4, 2048))
    assert out.data_ptr() == big[4:].data_ptr()
    assert stitched.view_counts()[k.digest] == 2
    assert stitched.view_copy_counts()[k.digest] == 1


def test_views_never_alias_what_callers_hold():
    """A graph output that would view a graph input (the engine writes its
    cache and inputs in place), or share its bytes with another graph
    output, is refused the view route and launches a kernel; a graph
    output viewing an intermediate is served as a view."""
    b = GraphBuilder("alias_input")
    x = b.param("x", (4, 1, 2048))
    y = b.reshape(x, (4, 2048))
    g = b.build(outputs=[y])
    p = FusionPattern(g, frozenset({y}))
    assert layout_only(p) and "graph input" in alias_refusal(g, y)
    assert isinstance(build_stitched_callable(p), StitchedKernel)

    b = GraphBuilder("alias_shared")
    x = b.param("x", (4, 1, 2048))
    t = b.ew("exp", x)
    y = b.reshape(t, (4, 2048))
    g = b.build(outputs=[t, y])
    p = FusionPattern(g, frozenset({y}))
    assert "another output" in alias_refusal(g, y)
    assert isinstance(build_stitched_callable(p), StitchedKernel)

    b = GraphBuilder("alias_intermediate")
    x = b.param("x", (4, 1, 2048))
    y = b.reshape(b.ew("exp", x), (4, 2048))
    g = b.build(outputs=[y])
    p = FusionPattern(g, frozenset({y}))
    assert alias_refusal(g, y) is None
    assert isinstance(build_stitched_callable(p), StitchedView)


def _add_reshape_pattern(dtype="bfloat16", d=2048):
    """A decode step's residual add and its view, (4, 1, d)."""
    b = GraphBuilder("add_reshape")
    x = b.param("x", (4, 1, d), dtype)
    r = b.param("r", (4, 1, d), dtype)
    h = b.ew("add", x, r)
    y = b.reshape(h, (4, d))
    g = b.build(outputs=[h, b.ew("exp", y)])
    return FusionPattern(g, frozenset({h, y}))


@pytest.mark.parametrize("dtype,d,block,grid", [
    ("bfloat16", 2048, 256, 32), ("bfloat16", 6144, 256, 96),
    ("float32", 2048, 128, 64), ("int64", 2048, 64, 128)])
def test_flat_layout_spreads_elementwise_patterns(dtype, d, block, grid):
    """An element-by-element pattern renders flat: each program 16 bytes a
    thread (of its widest value) of one warp over consecutive elements, the
    decode step's 4 rows over many programs; the add is one expression of
    the two loaded values."""
    p = _add_reshape_pattern(dtype, d)
    k = build_stitched_callable(p)
    em = k.emitted
    assert (em.layout, em.block, em.grid, em.num_warps) == ("flat", block,
                                                            grid, 1)
    assert f"offs = tl.program_id(0) * {block} + tl.arange(0, {block})" \
        in k.source and "mask" not in k.source
    compile(k.source, "<flat>", "exec")
    add = [ln.strip() for ln in k.source.splitlines()
           if ln.strip().startswith("v3 = ")]
    assert len(add) == 1 and "v1" in add[0] and "v2" in add[0]


def test_reductions_and_packs_keep_the_rows_layout():
    """A pattern with a row reduction, a horizontal pack, and a pattern
    whose rows layout already spreads over more programs than the flat one
    would (8192 one-element rows of int32: 1024 programs of 8 rows, flat
    64) keep the rows layout; a ragged flat pattern masks its tail."""
    g = chain_graph(12, 100, "bfloat16")
    p = FusionPattern(g, frozenset(n.name for n in g.compute_nodes()))
    assert build_stitched_callable(p).emitted.layout == "rows"
    assert build_stitched_callable(pack_pattern(),
                                   row_block=8).emitted.layout == "rows"
    b = GraphBuilder("index_add")
    x = b.param("x", (8192,), "int32")
    y = b.ew("add", x, x)
    g = b.build(outputs=[b.ew("mul", y, y)])
    k = build_stitched_callable(FusionPattern(g, frozenset({y})))
    assert (k.emitted.layout, k.emitted.grid) == ("rows", 1024)
    k = build_stitched_callable(_add_reshape_pattern("float32", 100))
    assert k.emitted.layout == "flat" and "mask=offs < 400" in k.source


# what each member class renders to: a text of its source, and its scratch
# workspaces and sweeps over a wide row
MOVEMENT_RENDER = {
    "slice_row_input": ("+ 10", 0, 0),
    "slice_computed": ("tl.debug_barrier()", 1, 0),
    "slice_invariant": ("(in0 + 96)", 0, 0),
    "transpose_moves": ("tl.permute(", 0, 0),
    "reshape_leading": ("tl.reshape(", 0, 0),
    "reshape_inner": ("tl.debug_barrier()", 1, 0),
    "gather_invariant": ("tl.where(", 1, 0),
    "wide_row": ("for c0 in range(0, 151936, 16384):", 0, 3),
    "wide_invariant": ("for c0 in range(pid * 4, 5, 4):", 0, 1),
    "kv_cut": ("(in0 + 4096)", 0, 0),
    "gather_moves": ("tl.where(", 0, 0),
}


@pytest.mark.parametrize("case", list(MOVEMENT_CASES))
def test_data_movement_members_match_reference(case):
    """Each data-movement member class the emitter renders (a trailing-dim
    slice of a ROW input and of an in-kernel value, a slice of an
    invariant, a transpose moving two trailing axes, a non-power-of-two
    reshape at the leading and at an inner axis, gathers from an invariant
    table at ROW indices, a 151936-element row whose max and sum feed an
    elementwise member, wide invariant tiles in two chunk groups, the
    stacked KV cache's cut, data movement only):
    the static check admits it (each of these members was refused before
    as ROADMAP Queue 2 stage 1), its plain version equals the reference's
    stitched Pallas kernel in interpret mode on the same numpy inputs
    within 2e-4, and its source compiles as Python."""
    g = movement_graph(case)
    p = _whole(g)
    assert refusal_causes(p) == []
    check_emittable(*emission_plan(p))
    k = build_stitched_callable(p)
    assert isinstance(k, StitchedKernel)
    text, scratch, sweeps = MOVEMENT_RENDER[case]
    assert text in k.source
    assert (len(k.emitted.scratch), k.emitted.sweeps) == (scratch, sweeps)
    compile(k.source, f"<{case}>", "exec")
    rg = movement_graph(case, RefBuilder)
    rp = RefPattern(rg, frozenset(n.name for n in rg.compute_nodes()))
    ins = movement_inputs(g, p.external_inputs)
    got = k.plain(*[torch.as_tensor(x) for x in ins])
    want = ref_build(rp, interpret=True)(*[jnp.asarray(x) for x in ins])
    assert len(got) == len(want)
    for gv, wv in zip(got, want):
        np.testing.assert_allclose(gv.float().numpy(),
                                   np.asarray(wv, np.float32), **TOL)


def _decode_plan(arch):
    """The reduced ``arch``'s ref-mode decode step (float32) traced."""
    from dataclasses import replace

    from repro_torch.configs import get_reduced
    from repro_torch.core.trace import trace_to_graph
    from repro_torch.models import build_model
    cfg = replace(get_reduced(arch), dtype="float32")
    model = build_model(cfg)
    params = model.init(0, "cpu")
    cache = model.init_cache(4, 32, "cpu")
    cache["length"] = torch.as_tensor([5, 4, 3, 5], dtype=torch.int32)
    tok = torch.zeros((4, 1), dtype=torch.long)
    g, _ = trace_to_graph(lambda p, c, t: model.decode_step(p, c, t),
                          params, cache, tok, name="decode")
    return g


# torch groups of each reduced ref-mode decode plan while the emitter
# refused every data-movement member (counted by refusal_causes)
TORCH_GROUPS_BEFORE = {"qwen3-1.7b": 6, "granite-moe-1b-a400m": 14}


@pytest.mark.parametrize("arch", list(TORCH_GROUPS_BEFORE))
def test_decode_plans_lose_their_data_movement_refusals(arch, monkeypatch):
    """On the reduced decode plans every torch group's causes, all of them,
    name stages 2, 3 and 5 or the reference's own analysis, never stage 1;
    torch groups fall from the count they had while stage 1 was refused;
    and the member sets are those of the same plan with the emitter
    refusing every pattern."""
    from repro_torch.core import StitchCompiler
    g = _decode_plan(arch)
    plan = StitchCompiler(plan_budget=5.0).compile(g)
    torch_groups = [grp for grp in plan.groups if grp.kind == "torch"]
    for grp in torch_groups:
        causes = refusal_causes(FusionPattern(g, grp.members))
        assert causes and not any(cause_stage(c) == 1 for c in causes)
    assert 0 < plan.stats.triton_groups
    assert len(torch_groups) < TORCH_GROUPS_BEFORE[arch]

    def refuse(p):
        raise StitchInfeasible("refused")

    monkeypatch.setattr(stitched, "emission_plan", refuse)
    none = StitchCompiler(plan_budget=5.0).compile(g)
    assert none.stats.triton_groups == 0
    assert sorted(sorted(grp.members) for grp in plan.groups) == \
        sorted(sorted(grp.members) for grp in none.groups)
    assert plan.stats.ilp.method == none.stats.ilp.method


def test_input_runs_are_views_unless_graph_outputs():
    """An output that is a run of an input's elements (a reshape, a slice
    of one run) and that the caller does not hold past the call is a view
    of the input at its offset; a pattern whose outputs are all such views
    builds and launches no kernel.  As a graph output
    (``MOVEMENT_CASES["kv_cut"]``) it is copied."""
    k = build_stitched_callable(kv_cut_pattern())
    assert isinstance(k, StitchedView) and not hasattr(k, "source")
    assert k.runs == [("kv", 0), ("kv", 4096)]
    kv = torch.randn(2, 4, 16, 2, 32, generator=torch.Generator().manual_seed(0))
    stitched.reset_launch_counts()
    for o, r in zip(k(kv), k.plain(kv)):
        assert torch.equal(o, r) and o.is_contiguous()
        assert o.untyped_storage().data_ptr() == kv.untyped_storage().data_ptr()
    assert stitched.view_counts()[k.digest] == 1
    assert not any(stitched.launch_counts().values())
    g = movement_graph("kv_cut")
    k = build_stitched_callable(_whole(g))
    assert not k.emitted.view_outs and k.source.count("tl.store") == 2
