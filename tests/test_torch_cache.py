"""The port's plan cache (``repro_torch.cache``) against the reference's.

Each case of ``tests/test_cache.py`` runs here on the same graphs, built by
one builder function in both packages (or traced from the same function in
each), and asserts what the reference's test asserts, in the port's idiom,
plus that the port hits or misses wherever the reference does.  Replayed
plans are held to the reference's replay: the same member sets, packs and
group classes (single op or fused).  The two emitters accept different
patterns (the port's Triton emitter refuses GEMM members), so a fused
group's kind (``triton`` / ``torch``) is held to the port's own fresh plan,
as is every replayed plan: same groups, kinds, packs and kernel sources.
Outputs: the reference's rtol/atol 2e-4 against ``build_reference_fn``, and
bit for bit between a replayed and a fresh plan of the port.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import CompilationService as RefService
from repro.cache import StitchCache as RefCache
from repro.cache import compute_signature as ref_signature
from repro.core import GraphBuilder as RefBuilder
from repro.core import StitchCompiler as RefCompiler
from repro.core import V100 as REF_V100
from repro.core.trace import trace_to_graph as ref_trace
from repro_torch.cache import (BucketPolicy, CompilationService,
                               EvictionPolicy, GroupRecord, MemoryStore,
                               PlanRecord, StitchCache, compute_signature)
from repro_torch.core import (V100, GraphBuilder, OpKind, OpNode,
                              StitchCompiler, build_reference_fn)
from repro_torch.core.trace import trace_to_graph

TOL = dict(rtol=2e-4, atol=2e-4)
ROOT = Path(__file__).resolve().parents[1]


def softmax(B, pname="x", rows=64, cols=256):
    b = B("softmax")
    x = b.param(pname, (rows, cols))
    m = b.reduce("max", x, axes=(1,))
    e = b.ew("exp", b.ew("sub", x, b.bcast(m, (rows, cols), (0,))))
    s = b.reduce("sum", e, axes=(1,))
    y = b.ew("div", e, b.bcast(s, (rows, cols), (0,)))
    return b.build(outputs=[y]), x


def mlp_norm(B, rows=128, d=256):
    """The conftest's ``make_mlp_norm_graph``, for either builder."""
    b = B("mlp_norm")
    x = b.param("x", (rows, d))
    w = b.param("w", (d, d))
    g = b.param("gamma", (d,))
    h = b.dot(x, w, name="dot_0")
    mu = b.reduce("mean", h, axes=(1,), keepdims=True)
    dlt = b.ew("sub", h, b.bcast(mu, (rows, d), (0, 1)))
    v = b.reduce("mean", b.ew("square", dlt), axes=(1,), keepdims=True)
    r = b.ew("rsqrt", b.ew("add", v, b.const("eps", ())))
    y = b.ew("mul", b.ew("mul", dlt, b.bcast(r, (rows, d), (0, 1))),
             b.bcast(g, (rows, d), (1,)))
    return b.build(outputs=[b.ew("relu", y)])


def both(build, *args, **kwargs):
    """(reference graph, port graph) of one builder function."""
    out = []
    for B in (RefBuilder, GraphBuilder):
        g = build(B, *args, **kwargs)
        out.append(g[0] if isinstance(g, tuple) else g)
    return tuple(out)


def statuses(cache_cls, compiler_cls, hw, graphs, **kw):
    cache = cache_cls()
    comp = compiler_cls(hw, mode="stitch", cache=cache, **kw)
    return [comp.compile(g).stats.cache_status for g in graphs], cache


def _groups(compiled, ref: bool = False):
    """(member set, pack, class) per group; the class of a fused group is
    "fused" for the reference, the kind for the port."""
    out = []
    for grp in compiled.groups:
        pack = (sorted(sorted(s) for s in grp.pack) if grp.pack else None)
        cls = grp.kind if grp.kind == "op" else ("fused" if ref else grp.kind)
        out.append((sorted(grp.members), pack, cls))
    return sorted(out, key=repr)


def assert_same_plan(port_replay, port_fresh, ref_replay):
    """The port's replay equals its fresh plan (kinds, packs, sources) and
    the reference's replay (member sets, packs, single op or fused)."""
    assert _groups(port_replay) == _groups(port_fresh)
    as_ref = [(m, p, "op" if c == "op" else "fused")
              for m, p, c in _groups(port_replay)]
    assert sorted(as_ref, key=repr) == _groups(ref_replay, ref=True)
    assert port_replay.stats.n_kernels == ref_replay.stats.n_kernels
    assert port_replay.stats.packs == ref_replay.stats.packs

    def sources(c):
        return sorted(getattr(grp.tuned.callable, "source", "view")
                      for grp in c.groups if grp.kind == "triton")

    assert sources(port_replay) == sources(port_fresh)


def rand_inputs(g, seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for name, node in g.nodes.items():
        if node.kind is OpKind.PARAMETER:
            out[name] = rng.standard_normal(node.shape).astype(np.float32)
        elif node.kind is OpKind.CONSTANT and "value" not in node.attrs:
            out[name] = np.float32(1e-5)
    return out


def run_port(compiled, inputs):
    outs = compiled({k: torch.as_tensor(v) for k, v in inputs.items()})
    return {k: v.numpy() for k, v in outs.items()}


# -------------------------------------------------- signatures ---------------

def test_signature_invariant_under_renaming():
    for sig, B in ((ref_signature, RefBuilder), (compute_signature, GraphBuilder)):
        s1 = sig(softmax(B, "x")[0])
        s2 = sig(softmax(B, "completely_different_input_name")[0])
        assert s1.graph_key == s2.graph_key
        assert s1.shape_key == s2.shape_key


def _perm(B, swap):
    b = B("perm")
    x = b.param("x", (32, 64))
    y = b.param("y", (32, 64))
    if swap:
        bb = b.ew("tanh", y)
        aa = b.ew("exp", x)
    else:
        aa = b.ew("exp", x)
        bb = b.ew("tanh", y)
    return b.build(outputs=[b.ew("add", aa, bb)])


def test_signature_invariant_under_insertion_order():
    """Two independent chains inserted in opposite orders (trace-order
    permutation) give the same canonical signature, in both packages."""
    for sig, B in ((ref_signature, RefBuilder), (compute_signature, GraphBuilder)):
        s1, s2 = sig(_perm(B, False)), sig(_perm(B, True))
        assert s1.graph_key == s2.graph_key
        assert s1.shape_key == s2.shape_key


def test_signature_invariant_under_trace_order():
    def f1(x, y):
        a = torch.exp(x)
        b = torch.tanh(y)
        return a + b

    def f2(x, y):
        b = torch.tanh(y)
        a = torch.exp(x)
        return a + b

    def r1(x, y):
        a = jnp.exp(x)
        b = jnp.tanh(y)
        return a + b

    def r2(x, y):
        b = jnp.tanh(y)
        a = jnp.exp(x)
        return a + b

    x = np.zeros((8, 16), np.float32)
    t = torch.as_tensor(x)
    g1, _ = trace_to_graph(f1, t, t)
    g2, _ = trace_to_graph(f2, t, t)
    assert compute_signature(g1).graph_key == compute_signature(g2).graph_key
    rg1, _ = ref_trace(r1, x, x)
    rg2, _ = ref_trace(r2, x, x)
    assert ref_signature(rg1).graph_key == ref_signature(rg2).graph_key


def _binary(B, op, dtype="float32"):
    b = B("g")
    x = b.param("x", (16, 32), dtype)
    y = b.param("y", (16, 32), dtype)
    return b.build(outputs=[b.ew(op, x, y)])


def _sub_order(B, swap):
    b = B("g")
    x = b.param("x", (16, 32))
    e = b.ew("exp", x)
    return b.build(outputs=[b.ew("sub", e, x) if swap else b.ew("sub", x, e)])


def test_signature_distinguishes_structure():
    for sig, B in ((ref_signature, RefBuilder), (compute_signature, GraphBuilder)):
        base = sig(_binary(B, "add")).graph_key
        assert sig(_binary(B, "sub")).graph_key != base
        assert sig(_binary(B, "add", "bfloat16")).graph_key != base
        # operand order matters (sub is not commutative)
        assert (sig(_sub_order(B, False)).graph_key
                != sig(_sub_order(B, True)).graph_key)


def test_signature_shapes_factored_out():
    for sig, B in ((ref_signature, RefBuilder), (compute_signature, GraphBuilder)):
        s1, s2 = sig(softmax(B, rows=100)[0]), sig(softmax(B, rows=120)[0])
        assert s1.graph_key == s2.graph_key      # same program
        assert s1.shape_key != s2.shape_key      # different concrete shapes


_SUBPROCESS_SIG = r"""
import sys, torch
from repro_torch.cache import compute_signature
from repro_torch.core import GraphBuilder
from repro_torch.core.trace import trace_to_graph

seed = int(sys.argv[1])
torch.manual_seed(seed)
b = GraphBuilder("consts")
x = b.param("x", (4, 8))
c = b.const("table", (8,))
b.graph[c].attrs["value"] = torch.randn(8)           # values differ by seed
s = b.const("scale", ())
b.graph[s].attrs["value"] = torch.tensor(0.5)
k = b.custom("custom", (4, 8), "float32", (x, c), prim="opaque",
             device="cuda:0", cast=torch.bfloat16, where=torch.device("cpu"),
             eval_fn=lambda a, t: a * t)
y = b.ew("mul", k, b.bcast(s, (4, 8), ()))
g1 = b.build(outputs=[y])
g2, _ = trace_to_graph(lambda a: a * 0.5 + torch.arange(8.0), torch.zeros(4, 8))
print(compute_signature(g1).graph_key, compute_signature(g2).graph_key)
"""


def test_signature_stable_across_processes():
    """A tensor constant (its values and device left out, a scalar's value
    kept), a ``cuda``-named device string, a dtype and a device in attrs
    give the same signature in two fresh processes with different string
    hash salts."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SUBPROCESS_SIG, str(seed)],
        env=dict(os.environ, PYTHONHASHSEED=str(seed),
                 PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for seed in (1, 2)]
    keys = []
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        assert proc.returncode == 0, err
        keys.append(out.split())
    assert keys[0] == keys[1] and len(keys[0]) == 2


def test_kernel_mode_and_ref_mode_never_share_a_key():
    """One function traced in each kernel mode: the kernel-mode graph's
    hand-written kernel nodes make its signature differ, so a plan of one
    mode never replays for the other."""
    from repro_torch.kernels import ops

    def fn(x, gamma, w):
        return ops.rmsnorm(x @ w, gamma) * 2.0

    rng = np.random.default_rng(0)
    args = [torch.as_tensor(rng.standard_normal(s).astype(np.float32))
            for s in ((16, 64), (64,), (64, 64))]
    g_ref, _ = trace_to_graph(fn, *args)
    with ops.kernel_mode("kernels"):
        g_km, _ = trace_to_graph(fn, *args)
    assert any(n.attrs.get("kernel") for n in g_km.nodes.values())
    cache = StitchCache()
    keys = [cache.key_for(compute_signature(g), "stitch", "H100")
            for g in (g_ref, g_km)]
    assert keys[0] != keys[1]
    comp = StitchCompiler(mode="stitch", cache=cache)
    assert comp.compile(g_km).stats.cache_status == "miss"
    assert comp.compile(g_ref).stats.cache_status == "miss"
    assert comp.compile(trace_to_graph(fn, *args)[0]).stats.cache_status == "hit"


# -------------------------------------------------- bucketing ----------------

def test_bucket_policy_pow2():
    p = BucketPolicy()
    assert p.bucket_shape((100, 256)) == (128, 256)
    assert p.bucket_shape((120, 256)) == (128, 256)
    assert p.bucket_shape((3, 100)) == (3, 128)   # small dims stay exact
    assert p.bucket_shape(()) == ()
    assert BucketPolicy(mode="exact").bucket_shape((100,)) == (100,)


def test_bucketed_shapes_share_cache_entry():
    (r100, p100), (r120, p120) = both(softmax, rows=100), both(softmax, rows=120)
    ref_st, rcache = statuses(RefCache, RefCompiler, REF_V100, [r100, r120],
                              use_pallas=False)
    cache = StitchCache()
    comp = StitchCompiler(V100, mode="stitch", cache=cache)
    fresh = comp.compile(p100)
    replayed = comp.compile(p120)                 # same bucket (128): replay
    assert [fresh.stats.cache_status, replayed.stats.cache_status] == ref_st \
        == ["miss", "hit"]
    # hit and miss landed in the SAME bucket, in both packages
    for rep in (cache.report(), rcache.report()):
        assert rep["total_hits"] == 1 and rep["total_misses"] == 1
        (_, counts), = rep["per_bucket"].items()
        assert counts == {"hits": 1, "misses": 1}
    ref_replay = RefCompiler(REF_V100, mode="stitch", cache=rcache,
                             use_pallas=False).compile(r120)
    assert_same_plan(replayed,
                     StitchCompiler(V100, mode="stitch").compile(p120),
                     ref_replay)
    inp = rand_inputs(p120)
    out = run_port(replayed, inp)
    want = build_reference_fn(p120)({k: torch.as_tensor(v) for k, v in inp.items()})
    for k in want:
        np.testing.assert_allclose(out[k], want[k].numpy(), **TOL)


def test_plans_keyed_by_hardware():
    from repro.core.cost import TPU_V5E as REF_TPU
    from repro_torch.core import H100
    rg, pg = both(softmax)
    rg2, pg2 = both(softmax, "renamed")
    rcache, cache = RefCache(), StitchCache()
    RefCompiler(REF_V100, mode="stitch", cache=rcache, use_pallas=False).compile(rg)
    StitchCompiler(V100, mode="stitch", cache=cache).compile(pg)
    ref = RefCompiler(REF_TPU, mode="stitch", cache=rcache,
                      use_pallas=False).compile(rg2)
    other = StitchCompiler(H100, mode="stitch", cache=cache).compile(pg2)
    assert other.stats.cache_status == ref.stats.cache_status == "miss"


def test_placement_key_single_device_only():
    """The single-device placement spells as the reference's does (``""``,
    so records of either placement path share keys); a mesh is refused
    until mesh placement is ported, never silently keyed as one device."""
    from repro.cache import placement_key as ref_placement_key
    from repro_torch.cache import placement_key
    assert placement_key() == ref_placement_key() == ""
    for kw in ({"mesh": object()}, {"specs": ("x",)}):
        with pytest.raises(NotImplementedError, match="mesh placement"):
            placement_key(**kw)


def test_plans_keyed_by_gen_config():
    """A plan solved under one GenConfig must not replay under another."""
    from repro.core.fusiongen import GenConfig as RefGenConfig
    from repro_torch.core import GenConfig
    seq = []
    for Cache, Comp, hw, GC, B, kw in (
            (RefCache, RefCompiler, REF_V100, RefGenConfig, RefBuilder,
             {"use_pallas": False}),
            (StitchCache, StitchCompiler, V100, GenConfig, GraphBuilder, {})):
        cache = Cache()
        Comp(hw, mode="stitch", cache=cache, **kw).compile(softmax(B)[0])
        other = Comp(hw, mode="stitch", cache=cache,
                     gen_cfg=GC(large_gemm_flops=1.0), **kw).compile(
                         softmax(B, "renamed")[0])
        same = Comp(hw, mode="stitch", cache=cache, **kw).compile(
            softmax(B, "renamed_again")[0])
        seq.append((other.stats.cache_status, same.stats.cache_status))
    assert seq[0] == seq[1] == ("miss", "hit")


def test_graph_mutation_invalidates_live_memo():
    cache = StitchCache()
    comp = StitchCompiler(mode="stitch", cache=cache)
    g, x = softmax(GraphBuilder)
    comp.compile(g)
    g.add(OpNode("late", OpKind.ELEMENTWISE, (64, 256), "float32",
                 (g.outputs[0],), {"op": "neg"}))
    g.mark_output("late")
    cg = comp.compile(g)                         # must NOT replay stale plan
    rg, _ = softmax(RefBuilder)
    rcache = RefCache()
    rcomp = RefCompiler(mode="stitch", cache=rcache, use_pallas=False)
    rcomp.compile(rg)
    from repro.core import OpKind as RefKind, OpNode as RefNode
    rg.add(RefNode("late", RefKind.ELEMENTWISE, (64, 256), "float32",
                   (rg.outputs[0],), {"op": "neg"}))
    rg.mark_output("late")
    assert cg.stats.cache_status == rcomp.compile(rg).stats.cache_status == "miss"
    inp = rand_inputs(g)
    want = build_reference_fn(g)({k: torch.as_tensor(v) for k, v in inp.items()})
    np.testing.assert_allclose(run_port(cg, inp)["late"], want["late"].numpy(),
                               **TOL)


def test_distant_shapes_miss():
    (r64, p64), (r100, p100) = both(softmax, rows=64), both(softmax, rows=100)
    ref_st, _ = statuses(RefCache, RefCompiler, REF_V100, [r64, r100],
                         use_pallas=False)
    st, cache = statuses(StitchCache, StitchCompiler, V100, [p64, p100])
    assert st == ref_st == ["miss", "miss"]      # bucket 128 != 64
    assert cache.report()["total_misses"] == 2


# -------------------------------------------------- store / eviction ---------

def _dummy_record(i):
    return PlanRecord(
        graph_key=f"g{i}", bucket_key="b", shape_key="s", mode="stitch",
        hw="H100", n_nodes=1, groups=(GroupRecord((0,), "op"),))


def test_memory_lru_eviction():
    ms = MemoryStore(capacity=2)
    for i in range(3):
        ms.put(_dummy_record(i))
    assert len(ms) == 2 and ms.evictions == 1
    assert ms.get(("g0", "b", "stitch", "H100", "", "")) is None   # evicted
    assert ms.get(("g2", "b", "stitch", "H100", "", "")) is not None
    assert EvictionPolicy().memory_entries == 128


def test_disk_roundtrip_replay_matches_fresh_compile(tmp_path):
    d = str(tmp_path / "plans")
    rd = str(tmp_path / "ref_plans")
    cold = StitchCompiler(mode="stitch", cache=StitchCache(directory=d)).compile(
        mlp_norm(GraphBuilder))
    # new process simulation: fresh cache over the same directory, fresh
    # graph object (isomorphic rebuild)
    g2 = mlp_norm(GraphBuilder)
    warm_cache = StitchCache(directory=d)
    warm = StitchCompiler(mode="stitch", cache=warm_cache).compile(g2)
    assert cold.stats.cache_status == "miss"
    assert warm.stats.cache_status == "hit"
    assert warm.stats.n_kernels == cold.stats.n_kernels
    assert warm.stats.triton_groups == cold.stats.triton_groups
    assert warm_cache.report()["disk_entries"] == 1
    RefCompiler(mode="stitch", cache=RefCache(directory=rd),
                use_pallas=False).compile(mlp_norm(RefBuilder))
    ref_warm = RefCompiler(mode="stitch", cache=RefCache(directory=rd),
                           use_pallas=False).compile(mlp_norm(RefBuilder))
    assert ref_warm.stats.cache_status == "hit"
    assert_same_plan(warm, cold, ref_warm)
    inp = rand_inputs(g2)
    want = build_reference_fn(g2)({k: torch.as_tensor(v) for k, v in inp.items()})
    out_cold, out_warm = run_port(cold, inp), run_port(warm, inp)
    for k in want:
        np.testing.assert_allclose(out_warm[k], want[k].numpy(), **TOL)
        np.testing.assert_array_equal(out_warm[k], out_cold[k])


# -------------------------------------------------- replay skips pipeline ----

def _forbid_pipeline(monkeypatch, calls=None):
    """Patch pattern generation, the ILP and the tuner to fail (or, with a
    ``calls`` list, to count)."""
    from repro_torch.core import compiler as port_compiler
    from repro_torch.core.tuner import TemplateTuner

    def guard(name, fn):
        def wrapped(*a, **k):
            if calls is None:
                raise AssertionError(f"{name} ran on a cache hit")
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(port_compiler, "generate_patterns",
                        guard("generate_patterns", port_compiler.generate_patterns))
    monkeypatch.setattr(port_compiler, "solve_fusion_plan",
                        guard("solve_fusion_plan", port_compiler.solve_fusion_plan))
    monkeypatch.setattr(TemplateTuner, "tune", guard("tune", TemplateTuner.tune))


def test_cache_hit_skips_pattern_gen_ilp_and_tuning(monkeypatch):
    cache = StitchCache()
    comp = StitchCompiler(mode="stitch", cache=cache)
    g, _ = softmax(GraphBuilder)
    first = comp.compile(g)
    assert first.stats.cache_status == "miss"
    _forbid_pipeline(monkeypatch)
    # same graph object (live memo) ...
    second = comp.compile(g)
    assert second.stats.cache_status == "hit"
    assert second.stats.n_kernels == first.stats.n_kernels
    # ... and an isomorphic rebuild (record replay)
    third = comp.compile(softmax(GraphBuilder, "renamed")[0])
    assert third.stats.cache_status == "hit"
    assert third.stats.n_kernels == first.stats.n_kernels


def test_execution_based_tuning_measures_and_raises_kernel_faults(monkeypatch):
    """With sample inputs, every Triton group carries its measured seconds
    a call (on the CPU the plain version is timed).  A candidate the
    emitter refuses at the measure stage is skipped with a diagnostic; a
    kernel that fails to run raises to the caller, never leaving its group
    to plain PyTorch."""
    from repro_torch.kernels.stitched import StitchedKernel, StitchInfeasible

    def fn(x):
        h = torch.exp(x - torch.amax(x, -1, keepdim=True))
        return h / torch.sum(h, -1, keepdim=True)

    x = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (16, 64)).astype(np.float32))
    g, names = trace_to_graph(fn, x)
    samples = dict(zip(names, (x,)))
    cg = StitchCompiler(execution_based_eval=True).compile(
        g, sample_inputs=samples)
    triton = [grp for grp in cg.groups if grp.kind == "triton"]
    assert triton
    assert all(0 < grp.tuned.measured_time < 1.0 for grp in triton)
    assert [d for d in cg.stats.diagnostics if d["stage"] == "measure"] == []
    (y,) = cg(samples).values()
    np.testing.assert_allclose(y.numpy(), fn(x).numpy(), **TOL)

    def refuse(self, *a, **k):
        raise StitchInfeasible("refused at launch")

    monkeypatch.setattr(StitchedKernel, "__call__", refuse)
    cg = StitchCompiler(execution_based_eval=True).compile(
        g, sample_inputs=samples)
    assert cg.stats.triton_groups == 0
    assert any(d["stage"] == "measure" and "refused" in d["reason"]
               for d in cg.stats.diagnostics)

    def fail(self, *a, **k):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(StitchedKernel, "__call__", fail)
    with pytest.raises(RuntimeError, match="failed to launch"):
        StitchCompiler(execution_based_eval=True).compile(
            g, sample_inputs=samples)


def test_warm_compile_runs_no_planner_stage(monkeypatch):
    """The reference's "warm compile at least 10x faster", as structure:
    a hit calls neither pattern generation, nor the ILP, nor the tuner, and
    records no stage seconds; the cold compile calls each.  The ratio of
    seconds is measured on the card by ``chip_smoke.py``."""
    calls: list[str] = []
    _forbid_pipeline(monkeypatch, calls)
    cache = StitchCache()
    comp = StitchCompiler(mode="stitch", cache=cache)
    cold = comp.compile(mlp_norm(GraphBuilder))
    assert {"generate_patterns", "solve_fusion_plan", "tune"} <= set(calls)
    assert set(cold.stats.stage_seconds) == {"pattern_gen", "ilp", "verify",
                                             "tune"}
    calls.clear()
    warm = comp.compile(mlp_norm(GraphBuilder))   # record replay
    again = comp.compile(warm.graph)              # live memo
    assert calls == []
    for cg in (warm, again):
        assert cg.stats.cache_status == "hit" and cg.stats.stage_seconds == {}
        assert cg.stats.n_kernels == cold.stats.n_kernels


# -------------------------------------------------- service ------------------

def test_service_miss_then_upgrade():
    svc = CompilationService(StitchCache())
    g, _ = softmax(GraphBuilder)
    fb, status = svc.compile_or_fallback(g, device="cpu")
    rsvc = RefService(RefCache(), fallback_mode="xla", use_pallas=False)
    rfb, rstatus = rsvc.compile_or_fallback(softmax(RefBuilder)[0])
    assert status == rstatus == "miss"
    assert fb.stats.mode == rfb.stats.mode == "xla"   # served at once, unstitched
    svc.wait(timeout=120)
    rsvc.wait(timeout=120)
    assert svc.pending() == 0 and svc.last_error is None
    g2, _ = softmax(GraphBuilder, "renamed")          # background compile landed
    up, status = svc.compile_or_fallback(g2)
    rup, rstatus = rsvc.compile_or_fallback(softmax(RefBuilder, "renamed")[0])
    assert status == rstatus == "hit"
    assert up.stats.mode == "stitch" and up.stats.cache_status == "hit"
    assert_same_plan(up, StitchCompiler(mode="stitch").compile(g2), rup)
    inp = rand_inputs(g2)
    want = build_reference_fn(g2)({k: torch.as_tensor(v) for k, v in inp.items()})
    for k, v in run_port(up, inp).items():
        np.testing.assert_allclose(v, want[k].numpy(), **TOL)


@functools.lru_cache(maxsize=None)
def qwen3():
    """Reduced qwen3-1.7b in f32 with the same weights in both packages."""
    from repro.configs import get_reduced as ref_reduced
    from repro.models import build_model as ref_build
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_jax

    rcfg = replace(ref_reduced("qwen3_1_7b"), dtype="float32",
                   scan_layers=False)
    cfg = replace(get_reduced("qwen3_1_7b"), dtype="float32",
                  scan_layers=False)
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                             device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8))
    return rmodel, rparams, model, params, prompts


def test_engine_miss_then_upgrade_identical_tokens():
    """The port's engine over a service: the first serve (fallback plans,
    upgraded mid-stream as the compiles land) and the second (stitched,
    status hit) give the reference engine's tokens with its service, and
    the port's offline engine's."""
    from repro.serve import Engine as RefEngine
    from repro.serve import ServeConfig as RefServeConfig
    from repro_torch.serve import Engine, ServeConfig

    rmodel, rparams, model, params, prompts = qwen3()
    lens = np.array([8, 6], np.int32)
    rsvc = RefService(RefCache(), use_pallas=False)
    reng = RefEngine(rmodel, rparams, RefServeConfig(
        batch=2, max_len=48, max_new_tokens=3, stitch_execute=True,
        paged=False), stitch_service=rsvc)
    ref_first = reng.generate(prompts.astype(np.int32), prompt_lens=lens)
    rsvc.wait(timeout=300)
    ref_second = reng.generate(prompts.astype(np.int32), prompt_lens=lens)

    svc = CompilationService(StitchCache())
    scfg = ServeConfig(batch=2, max_len=48, max_new_tokens=3,
                       stitch_execute=True)
    eng = Engine(model, params, scfg, device="cpu", stitch_service=svc)
    first = eng.generate(prompts, prompt_lens=lens)
    assert eng.stitch_status in ("miss", "pending", "hit")
    svc.wait(timeout=300)
    second = eng.generate(prompts, prompt_lens=lens)
    assert eng.stitch_status == "hit"
    rep = eng.stitch_report()
    assert rep["plan"]["mode"] == "stitch"
    assert rep["plan"]["n_kernels"] < rep["plan"]["n_ops"]
    assert rep["service_error"] is None and rep["errors"] == {}
    assert rep["calls"]["fallback"] == 0
    offline = Engine(model, params, scfg, device="cpu").generate(
        prompts, prompt_lens=lens)
    for got in (first, second, ref_first, ref_second):
        np.testing.assert_array_equal(got, offline)


def test_offline_plans_replay_in_stitch_mode(tmp_path):
    """An offline engine whose compiler has a disk cache writes both plans
    under the keys a service looks up (the prefill's under its
    specialization); a stitch-mode engine over a fresh cache on that
    directory then hits both at their first call, never serves the
    fallback plan, and gives the offline engine's tokens."""
    from repro_torch.kernels import ops
    from repro_torch.serve import Engine, ServeConfig

    _, _, model, params, prompts = qwen3()
    lens = np.array([8, 5], np.int32)
    scfg = ServeConfig(batch=2, max_len=32, max_new_tokens=3,
                       stitch_execute=True)
    with ops.kernel_mode("kernels"):
        offline = Engine(model, params, scfg, device="cpu",
                         compiler=StitchCompiler(
                             cache=StitchCache(str(tmp_path))))
        want = offline.generate(prompts, prompt_lens=lens)
        svc = CompilationService(StitchCache(str(tmp_path)))
        eng = Engine(model, params, scfg, device="cpu", stitch_service=svc)
        got = eng.generate(prompts, prompt_lens=lens)
    assert len(list(tmp_path.glob("plan_*.json"))) == 2
    assert svc.cache.report()["total_hits"] == 2
    rep = eng.report()
    for k in ("prefill", "decode"):
        assert rep[k]["status"] == "hit"
        assert set(rep[k]["plan_calls"]) == {"stitch"}
    np.testing.assert_array_equal(got, want)
