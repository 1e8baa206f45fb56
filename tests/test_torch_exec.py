"""The port's execution layer (``repro_torch.exec.stitch``) against the
reference's ``repro.exec.stitch``.

Each case of ``tests/test_exec.py`` that needs no mesh and no donation runs
on one function written in both frameworks, with the same numpy inputs:
both packages must route each call alike (stitched, fallback, eager; miss,
hit, failed) and agree on the outputs within rtol/atol 2e-4 (the
reference's tolerance across frameworks); within the port, a stitched call
equals the eager function within 1e-6 (the reference's own ``ck``).
"""

from __future__ import annotations

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.cache import CompilationService as RefService
from repro.exec import stitch as ref_stitch
from repro_torch.cache import CompilationService
from repro_torch.exec import StitchedFunction, stitch

CROSS = dict(rtol=2e-4, atol=2e-4)
SAME = dict(rtol=1e-6, atol=1e-6)


def ck(a, b, tol=SAME):
    la = pytree.tree_flatten(a)[0] if not isinstance(a, list) else a
    lb = jax.tree_util.tree_leaves(b) if not isinstance(b, list) else b
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(np.asarray(x, np.float32),
                                   np.asarray(y, np.float32), **tol)


def leaves(tree):
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in pytree.tree_flatten(tree)[0]]


def pair(*shapes, seed=0):
    """The same inputs as numpy, torch and jax arrays."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return arrs, [torch.as_tensor(a) for a in arrs], [jnp.asarray(a) for a in arrs]


@pytest.fixture
def svcs():
    # max_background=0: upgrades land only when the test compiles them —
    # deterministic miss-then-upgrade points
    svc = CompilationService()
    svc.max_background = 0
    return svc, RefService(max_background=0)


def test_stitch_pytree_and_kwargs_roundtrip(svcs):
    """Nested dict/tuple inputs AND outputs round-trip through stitch(),
    with kwargs flowing as traced inputs; a kwargs structure change is
    drift, served eagerly."""
    def fn(tree, pair_, bias=None):
        x, y = pair_
        h = tree["a"]["w"] * torch.tanh(x) + y
        if bias is not None:
            h = h + bias["b"]
        return {"out": (h, h * 2.0), "norm": torch.sqrt(torch.sum(h * h, -1))}

    def rfn(tree, pair_, bias=None):
        x, y = pair_
        h = tree["a"]["w"] * jnp.tanh(x) + y
        if bias is not None:
            h = h + bias["b"]
        return {"out": (h, h * 2.0), "norm": jnp.sqrt(jnp.sum(h * h, -1))}

    _, (w, x, y, b), (rw, rx, ry, rb) = pair((8, 16), (8, 16), (16,), (16,))
    svc, rsvc = svcs
    sf = stitch(fn, mode="stitch", service=svc, device="cpu")
    rsf = ref_stitch(rfn, service=rsvc)
    out = sf({"a": {"w": w}}, (x, y), bias={"b": b})
    rout = rsf({"a": {"w": rw}}, (rx, ry), bias={"b": rb})
    assert (pytree.tree_structure(out).num_leaves
            == jax.tree_util.tree_structure(rout).num_leaves == 3)
    assert sorted(out) == sorted(rout) and len(out["out"]) == 2
    ck(leaves(out), leaves(fn({"a": {"w": w}}, (x, y), bias={"b": b})))

    def by_key(o):       # torch keeps a dict's insertion order, jax sorts
        return [o["norm"], o["out"][0], o["out"][1]]

    ck(by_key(out), by_key(rout), CROSS)
    assert (sf.stitched_calls, sf.fallback_calls) == (rsf.stitched_calls,
                                                      rsf.fallback_calls) == (1, 0)
    assert sf.status in ("miss", "pending") and rsf.status in ("miss", "pending")
    out2 = sf({"a": {"w": w}}, (x, y))
    rsf({"a": {"w": rw}}, (rx, ry))
    ck(leaves(out2), leaves(fn({"a": {"w": w}}, (x, y))))
    assert sf.fallback_calls == rsf.fallback_calls == 1


def test_stitch_static_argnums_retrace_on_change(svcs):
    def fn(x, n):
        return {"p": x ** n, "s": torch.sum(x) * n}

    def rfn(x, n):
        return {"p": x ** n, "s": jnp.sum(x) * n}

    _, (x,), (rx,) = pair((4, 8), seed=1)
    svc, rsvc = svcs
    sf = stitch(fn, mode="stitch", service=svc, device="cpu",
                static_argnums=(1,))
    rsf = ref_stitch(rfn, service=rsvc, static_argnums=(1,))
    for n in (2, 3, 2):                                   # the last: cached
        out = sf(x, n)
        ck(leaves(out), leaves(fn(x, n)))
        ck(leaves(out), jax.tree_util.tree_leaves(rsf(rx, n)), CROSS)
    assert sf.report()["specializations"] == rsf.report()["specializations"] == 2
    assert (sf.stitched_calls, sf.fallback_calls) == (rsf.stitched_calls,
                                                      rsf.fallback_calls) == (3, 0)


def test_stitch_shape_drift_falls_back(svcs):
    def fn(d):
        return {"y": torch.tanh(d["x"]) * d["g"]}

    def rfn(d):
        return {"y": jnp.tanh(d["x"]) * d["g"]}

    _, (x, g), (rx, rg) = pair((8, 16), (16,), seed=2)
    svc, rsvc = svcs
    sf = stitch(fn, mode="stitch", service=svc, device="cpu")
    rsf = ref_stitch(rfn, service=rsvc)
    sf({"x": x, "g": g})
    rsf({"x": rx, "g": rg})
    assert sf.fallback_calls == rsf.fallback_calls == 0
    drifted = {"x": x[:, :8], "g": g[:8]}
    out = sf(drifted)                                 # eager, this call
    ck(leaves(out), leaves(fn(drifted)))
    ck(leaves(out), jax.tree_util.tree_leaves(
        rsf({"x": rx[:, :8], "g": rg[:8]})), CROSS)
    assert sf.fallback_calls == rsf.fallback_calls == 1
    sf({"x": x, "g": g})                              # original shape: stitched
    rsf({"x": rx, "g": rg})
    assert ((sf.fallback_calls, sf.stitched_calls)
            == (rsf.fallback_calls, rsf.stitched_calls) == (1, 2))


def test_stitch_upgrade_hits_and_matches(svcs):
    def fn(d):
        h = torch.exp(d["x"] - torch.amax(d["x"], -1, keepdim=True))
        return h / torch.sum(h, -1, keepdim=True)

    def rfn(d):
        h = jnp.exp(d["x"] - jnp.max(d["x"], -1, keepdims=True))
        return h / jnp.sum(h, -1, keepdims=True)

    _, (x,), (rx,) = pair((16, 64), seed=3)
    svc, rsvc = svcs
    sf = stitch(fn, mode="stitch", service=svc, device="cpu")
    rsf = ref_stitch(rfn, service=rsvc)
    first, rfirst = sf({"x": x}), rsf({"x": rx})
    assert sf.status in ("miss", "pending") and rsf.status in ("miss", "pending")
    assert sf.compiled.stats.mode == rsf.compiled.stats.mode == "xla"
    svc.compiler("stitch").compile(sf.graph, bypass_cache_lookup=True)
    rsvc.compiler("stitch").compile(rsf.graph, bypass_cache_lookup=True)
    second, rsecond = sf({"x": x}), rsf({"x": rx})
    assert sf.status == rsf.status == "hit"
    assert sf.compiled.stats.mode == "stitch"
    assert sf.report()["plan_calls"] == {"xla": 1, "stitch": 1}
    for got, want in ((first, rfirst), (second, rsecond)):
        ck([got], [fn({"x": x})])
        ck([got], [want], CROSS)
    plan = sf.plan_stats()
    assert plan["n_kernels"] < plan["n_ops"]
    assert plan["n_kernels"] == rsf.plan_stats()["n_kernels"]


def test_warmup_eligible_and_poll_upgrade(svcs):
    """``warmup`` traces and fetches the fallback without running, as the
    reference's does; ``eligible`` is true only at a traced signature;
    ``poll_upgrade`` re-kicks a compile the worker cap deferred and lands
    the plan with no call in between.  ``jit`` mode warms nothing."""
    def fn(x):
        return torch.tanh(x) * torch.exp(x) + 1.0

    def rfn(x):
        return jnp.tanh(x) * jnp.exp(x) + 1.0

    _, (x, y), (rx, ry) = pair((8, 32), (4, 32), seed=5)
    svc, rsvc = svcs
    sf = stitch(fn, mode="stitch", service=svc, device="cpu")
    rsf = ref_stitch(rfn, service=rsvc)
    assert not sf.eligible(x) and not rsf.eligible(rx)
    assert sf.warmup(x) == rsf.warmup(rx) == "pending"   # worker cap 0
    assert (sf.stitched_calls, sf.fallback_calls) == (0, 0)
    assert sf.eligible(x) and rsf.eligible(rx)
    assert not sf.eligible(y) and not rsf.eligible(ry)   # other shape
    for s, f in ((svc, sf), (rsvc, rsf)):
        s.max_background = 2
        f.poll_upgrade()                                  # re-kicks
        f.wait(120)
        f.poll_upgrade()                                  # lands
    assert sf.status == rsf.status == "hit"
    assert sf.compiled.stats.mode == "stitch"
    assert sf.report()["service_error"] is None
    ck([sf(x)], [fn(x)])
    ck([sf(x)], [rsf(rx)], CROSS)
    assert sf.report()["plan_calls"] == {"stitch": 2}
    assert stitch(fn, mode="jit", device="cpu").warmup(x) is None
    assert ref_stitch(rfn, mode="jit").warmup(rx) is None


def test_stitch_shadow_mode_serves_eager_but_reports(svcs):
    def fn(x):
        return torch.tanh(x) * 2.0

    def rfn(x):
        return jnp.tanh(x) * 2.0

    svc, rsvc = svcs
    sf = stitch(fn, mode="shadow", service=svc, device="cpu")
    rsf = ref_stitch(rfn, mode="shadow", service=rsvc)
    x = torch.ones(4, 4)
    ck([sf(x)], [rsf(jnp.ones((4, 4), jnp.float32))], CROSS)
    assert (sf.jit_calls, sf.stitched_calls) == (rsf.jit_calls,
                                                 rsf.stitched_calls) == (1, 0)
    assert sf.report()["plan"]["mode"] == rsf.report()["plan"]["mode"] == "xla"


def test_stitch_and_shadow_create_a_service():
    for mode in ("stitch", "shadow"):
        sf = stitch(torch.tanh, mode=mode, device="cpu")
        assert isinstance(sf.service, CompilationService)
    sf = stitch(torch.tanh, device="cpu")        # the default: stitch mode
    assert sf.mode == "stitch" and isinstance(sf.service, CompilationService)
    assert stitch(torch.tanh, mode="offline", device="cpu").service is None
    with pytest.raises(ValueError, match="service="):
        stitch(torch.tanh, mode="stitch", device="cpu",
               compiler=CompilationService().compiler("stitch"))


@pytest.mark.parametrize("call", ["no_mode", "service", "offline_service"])
def test_stitch_takes_the_references_calls(call):
    """The reference's ``tests/test_exec.py`` calls, unchanged but for
    ``device="cpu"``: ``stitch(fn)``, ``stitch(fn, service=svc)`` and
    ``stitch(fn, mode="offline", service=svc)`` run on both packages with
    equal results, and equal statuses and stitched and jit call counts
    after ``wait()``."""
    def fn(d):
        h = torch.exp(d["x"] - torch.amax(d["x"], -1, keepdim=True))
        return h / torch.sum(h, -1, keepdim=True)

    def rfn(d):
        h = jnp.exp(d["x"] - jnp.max(d["x"], -1, keepdims=True))
        return h / jnp.sum(h, -1, keepdims=True)

    _, (x,), (rx,) = pair((16, 64), seed=7)
    kwargs = {"no_mode": {}, "service": {}, "offline_service": {
        "mode": "offline"}}[call]
    if call == "no_mode":
        sf, rsf = stitch(fn, device="cpu"), ref_stitch(rfn)
    else:
        sf = stitch(fn, service=CompilationService(), device="cpu", **kwargs)
        rsf = ref_stitch(rfn, service=RefService(), **kwargs)
    assert sf.mode == rsf.mode
    outs = [(sf({"x": x}), rsf({"x": rx}))]
    # a background compile may land before the first call's poll
    first = ({"compiled"} if call == "offline_service"
             else {"miss", "pending", "hit"})
    assert {sf.status, rsf.status} <= first
    sf.wait(120)
    rsf.wait(120)
    outs.append((sf({"x": x}), rsf({"x": rx})))
    assert sf.status == rsf.status == ("compiled" if call == "offline_service"
                                       else "hit")
    assert sf.compiled.stats.mode == rsf.compiled.stats.mode == "stitch"
    for got, want in outs:
        ck([got], [fn({"x": x})])
        ck([got], [want], CROSS)
    assert (sf.stitched_calls, sf.jit_calls, sf.fallback_calls) == (
        rsf.stitched_calls, rsf.jit_calls, rsf.fallback_calls) == (2, 0, 0)
    assert sf.report()["service_error"] is rsf.report()["service_error"] is None


def test_background_failure_warns_once_and_reports(monkeypatch):
    def fn(x):
        return torch.tanh(x) * torch.exp(x)

    def rfn(x):
        return jnp.tanh(x) * jnp.exp(x)

    def boom(*a, **k):
        raise RuntimeError("ILP exploded")

    results = []
    for mk, f, x, target in (
            (CompilationService, fn, torch.ones(8, 32),
             "repro_torch.core.compiler.solve_fusion_plan"),
            (RefService, rfn, jnp.ones((8, 32), jnp.float32),
             "repro.core.compiler.solve_fusion_plan")):
        svc = mk()
        svc.max_background = 0                      # no thread yet
        sf = (stitch(f, mode="stitch", service=svc, device="cpu")
              if mk is CompilationService else ref_stitch(f, service=svc))
        sf(x)                                       # trace + fallback plan
        assert sf.status in ("miss", "pending")
        with monkeypatch.context() as m:
            # only stitch-mode compiles solve the ILP; the xla fallback is
            # unaffected
            m.setattr(target, boom)
            svc.max_background = 2
            sf(x)                                   # poll re-kicks the compile
            svc.wait(60.0)
        with pytest.warns(RuntimeWarning, match="ILP exploded"):
            sf(x)                                   # failure surfaced, once
        assert sf.status == "failed"
        rep = sf.report()
        assert "ILP exploded" in rep["error"]
        assert "ILP exploded" in rep["service_error"]
        assert any("ILP exploded" in v for v in rep["errors"].values())
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            out = sf(x)                             # no second warning; and
        results.append(np.asarray(out))             # the fallback serves
        assert not svc.ensure_compiling(sf.graph)   # the doomed compile is
    np.testing.assert_allclose(results[0], results[1], **CROSS)   # not re-kicked
    np.testing.assert_allclose(results[0], (torch.tanh(torch.ones(8, 32))
                                            * torch.exp(torch.ones(8, 32))).numpy(),
                               **SAME)


# ---------------------------------------------------------------------------
# anytime ILP: wall-clock budget -> greedy fallback plan
# ---------------------------------------------------------------------------

def _mlp_graph(B, rows=64, d=128):
    b = B("mlp_norm")
    x = b.param("x", (rows, d))
    w = b.param("w", (d, d))
    gm = b.param("gamma", (d,))
    h = b.dot(x, w, name="dot_0")
    mu = b.reduce("mean", h, axes=(1,), keepdims=True)
    dlt = b.ew("sub", h, b.bcast(mu, (rows, d), (0, 1)))
    v = b.reduce("mean", b.ew("square", dlt), axes=(1,), keepdims=True)
    eps = b.const("eps", ())
    b.graph[eps].attrs["value"] = np.float32(1e-6)
    r = b.ew("rsqrt", b.ew("add", v, eps))
    y = b.ew("mul", b.ew("mul", dlt, b.bcast(r, (rows, d), (0, 1))),
             b.ew("relu", b.bcast(gm, (rows, d), (1,))))
    return b.build(outputs=[y])


def test_anytime_ilp_greedy_fallback_is_valid():
    from repro.core import CostModel as RefCost
    from repro.core import GenConfig as RefGen
    from repro.core import GraphBuilder as RefBuilder
    from repro.core import generate_patterns as ref_patterns
    from repro.core.ilp import solve_fusion_plan as ref_solve
    from repro_torch.core import (CostModel, GenConfig, GraphBuilder,
                                  generate_patterns)
    from repro_torch.core.ilp import solve_fusion_plan

    chosen = []
    for B, gen, Gen, Cost, solve in (
            (RefBuilder, ref_patterns, RefGen, RefCost, ref_solve),
            (GraphBuilder, generate_patterns, GenConfig, CostModel,
             solve_fusion_plan)):
        g = _mlp_graph(B)
        patterns = gen(g, Gen())
        scores = [Cost().score(p).score for p in patterns]
        exact = solve(g, patterns, scores)
        assert exact.method == "ilp" and not exact.budget_expired
        budgeted = solve(g, patterns, scores, budget_seconds=0.0)
        assert budgeted.method == "greedy" and budgeted.budget_expired
        # valid plan: pairwise disjoint members, every member a graph node
        seen = set()
        for p in budgeted.chosen:
            assert not (p.members & seen) and p.members <= set(g.nodes)
            seen |= p.members
        assert budgeted.objective > 0
        chosen.append(sorted(sorted(p.members) for p in budgeted.chosen))
    assert chosen[0] == chosen[1]


def test_plan_budget_compiles_correct_executable():
    from repro.core import GraphBuilder as RefBuilder
    from repro.core import StitchCompiler as RefCompiler
    from repro.core import build_reference_fn as ref_fn
    from repro_torch.core import GraphBuilder, StitchCompiler, build_reference_fn

    rng = np.random.default_rng(0)
    inputs = {"x": rng.standard_normal((64, 128)).astype(np.float32),
              "w": (rng.standard_normal((128, 128)) * 0.05).astype(np.float32),
              "gamma": rng.standard_normal(128).astype(np.float32)}
    g = _mlp_graph(GraphBuilder)
    compiled = StitchCompiler(mode="stitch", plan_budget=0.0).compile(g)
    ref = RefCompiler(mode="stitch", plan_budget=0.0,
                      use_pallas=False).compile(_mlp_graph(RefBuilder))
    assert compiled.stats.ilp.method == ref.stats.ilp.method == "greedy"
    assert compiled.stats.n_kernels == ref.stats.n_kernels
    assert compiled.stats.n_kernels < compiled.stats.n_ops
    tin = {k: torch.as_tensor(v) for k, v in inputs.items()}
    out = compiled(tin)
    want = build_reference_fn(g)(tin)
    rwant = ref_fn(_mlp_graph(RefBuilder))(inputs)
    for k in want:
        np.testing.assert_allclose(out[k].numpy(), want[k].numpy(), **SAME)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(rwant[k]), **CROSS)


def test_stitched_function_rejects_bad_mode():
    with pytest.raises(ValueError, match="mode"):
        StitchedFunction(lambda x: x, mode="nope", device="cpu")
