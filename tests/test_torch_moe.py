"""The port's MoE family (granite-moe-1b-a400m) against the reference.

* The router kernel's plain version against the reference's Pallas
  ``_router_kernel`` (interpret mode) and both packages' router oracles:
  ids exactly equal, weights within f32 2e-4 / bf16 1.6e-2; ties rank by
  the lower expert index.
* The kernel-mode trace holds one ``_router_kernel`` node per layer with
  two tagged projections at the reference's shapes and dtypes, and a
  builder-made graph with a router node plans exactly as the reference's.
* ``apply_moe`` against the reference at the config's capacity and at one
  small enough to drop tokens (counts and drops equal).
* Reduced granite served at an 8 and a 128 bucket: the port's ref mode
  against the reference's ref mode, its kernel mode against the reference's
  pallas mode; tokens equal, logits within rtol/atol 2e-4.
* The MoE params round trip, and the launcher serves the reduced config.
"""

from __future__ import annotations

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_reduced
from repro.core import StitchCompiler as RefCompiler
from repro.core import V100 as REF_V100
from repro.core import GraphBuilder as RefBuilder
from repro.core.trace import trace_to_graph as ref_trace
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.kernels import registry as ref_registry
from repro.kernels import router as ref_router
from repro.models import build_model as ref_build
from repro.models import layers as ref_layers
from repro.models.config import MoEConfig as RefMoEConfig
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import OpKind, StitchCompiler, V100
from repro_torch.core.trace import trace_to_graph
from repro_torch.kernels import ops, ref, registry, router
from repro_torch.models import build_model, layers
from repro_torch.models.config import MoEConfig
from repro_torch.models.convert import params_from_jax, params_to_numpy

from test_torch_kernel_mode import NEW_TOKENS, _serve_both, ref_kernel_name
from test_torch_planner import _groups, to_port

ARCH = "granite-moe-1b-a400m"
TOL = dict(rtol=2e-4, atol=2e-4)
DTYPES = [("float32", 2e-4), ("bfloat16", 1.6e-2)]


@functools.lru_cache(maxsize=None)
def setup():
    rcfg = replace(ref_reduced(ARCH), dtype="float32", scan_layers=False)
    cfg = replace(get_reduced(ARCH), dtype="float32", scan_layers=False)
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, rparams)
    model = build_model(cfg)
    params = params_from_jax(tree, cfg, device="cpu")
    return rmodel, rparams, tree, model, params


# -- the router ------------------------------------------------------------------

ROUTER_CASES = [(16, 4, 2), (64, 32, 8), (50, 60, 4)]


def _logits(T, E, seed, bf16_rounded=False):
    x = (2.0 * np.random.default_rng(seed).standard_normal((T, E))
         ).astype(np.float32)
    if bf16_rounded:
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x


def _check_router(x: np.ndarray, k: int, renorm: bool, dtype: str, tol: float):
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    w, i = router.topk_router(tx, k, renorm)
    assert w.shape == i.shape == (x.shape[0], k)
    assert w.dtype == tx.dtype and i.dtype == torch.int32
    # the reference's Pallas kernel (interpret mode) and its oracle
    for rw, ri in (ref_router.topk_router(jx, k, renorm),
                   ref_oracles.topk_router(jx, k, renorm)):
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_allclose(w.float().numpy(),
                                   np.asarray(rw, np.float32), rtol=tol, atol=tol)
    # the port's oracle
    ow, oi = ref.topk_router(tx, k, renorm)
    torch.testing.assert_close(oi, i, rtol=0, atol=0)
    torch.testing.assert_close(ow.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("T,E,k", ROUTER_CASES)
def test_router_plain_matches_reference_kernel(T, E, k, renorm, dtype, tol):
    _check_router(_logits(T, E, T + E), k, renorm, dtype, tol)


@pytest.mark.parametrize("renorm", [True, False])
def test_router_ties_on_bf16_rounded_logits(renorm):
    """bf16-rounded logits, as the served router's are in bf16 compute:
    exact ties among the top k+1 are common, and all three versions rank
    them by the lower expert index."""
    x = _logits(512, 32, 3, bf16_rounded=True)
    top = -np.sort(-x, axis=1)[:, :9]
    assert (np.diff(top, axis=1) == 0).any(axis=1).sum() > 10
    _check_router(x, 8, renorm, "float32", 2e-4)


def test_router_oracle_and_plain_take_the_lowest_index_among_ties():
    x = torch.tensor([[0.5, 0.9, 0.9, 0.1, 0.9], [1.0, 1.0, 1.0, 1.0, 1.0]]).log()
    for fn in (ref.topk_router, router.topk_router_plain):
        w, i = fn(x, 3)
        assert i.tolist() == [[1, 2, 4], [0, 1, 2]]
        torch.testing.assert_close(w, torch.full((2, 3), 1 / 3))


# -- config, params --------------------------------------------------------------

def test_granite_config_equals_the_reference():
    from repro.configs import get_config as ref_config
    for port_cfg, ref_cfg in ((get_config(ARCH), ref_config(ARCH)),
                              (get_reduced(ARCH), ref_reduced(ARCH))):
        assert vars(port_cfg.moe) == vars(ref_cfg.moe)
        assert {k: v for k, v in vars(port_cfg).items() if k != "moe"} == \
            {k: v for k, v in vars(ref_cfg).items() if k != "moe"}
    assert [f.name for f in MoEConfig.__dataclass_fields__.values()] == \
        [f.name for f in RefMoEConfig.__dataclass_fields__.values()]


def test_moe_params_round_trip():
    _, _, tree, model, params = setup()
    mlp = params["layers"][0]["mlp"]
    m = model.cfg.moe
    assert set(mlp) == {"router", "w_gate", "w_up", "w_down"}
    assert tuple(mlp["w_gate"].shape) == (m.n_experts, model.cfg.d_model,
                                          m.d_expert)
    back = params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


# -- apply_moe -------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [1.25, 0.3],
                         ids=["config_capacity", "drops"])
def test_apply_moe_matches_reference(capacity_factor):
    rmodel, rparams, _, model, params = setup()
    rcfg = replace(rmodel.cfg, moe=replace(rmodel.cfg.moe,
                                           capacity_factor=capacity_factor))
    cfg = replace(model.cfg, moe=replace(model.cfg.moe,
                                         capacity_factor=capacity_factor))
    rp = jax.tree.map(lambda a: a[1], rparams["layers"])["mlp"]
    p = params["layers"][1]["mlp"]
    x = np.random.default_rng(5).standard_normal((48, cfg.d_model)
                                                 ).astype(np.float32)
    ry, raux = ref_layers.apply_moe(rp, jnp.asarray(x), rcfg)
    y, aux = layers.apply_moe(p, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    for key in ("moe_aux", "moe_drop_frac"):
        np.testing.assert_allclose(float(aux[key]), float(raux[key]), **TOL)
    # counts and drops of the dispatch, on the same routing
    m = cfg.moe
    T, k = x.shape[0], m.top_k
    C = max(8, -(-int(np.ceil(m.capacity_factor * T * k / m.n_experts)) // 8) * 8)
    logits = np.asarray(jnp.asarray(x) @ rp["router"], np.float32)
    rw, ri = ref_oracles.topk_router(jnp.asarray(logits), k)
    _, rcounts, rdrop = ref_layers._moe_group_dispatch(
        jnp.asarray(x), rw, ri, rp, rcfg, C)
    _, counts, drop = layers._moe_group_dispatch(
        torch.as_tensor(x), torch.as_tensor(np.asarray(rw)),
        torch.as_tensor(np.asarray(ri)), p, cfg, C)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(rcounts))
    assert int(drop) == int(rdrop)
    assert (int(drop) > 0) == (capacity_factor < 1)


# -- the trace and the plan -------------------------------------------------------

@functools.lru_cache(maxsize=None)
def traced_steps():
    """(reference graph in pallas mode, port graph in kernel mode) of the
    reduced decode step."""
    rmodel, rparams, _, model, params = setup()
    rcache = rmodel.init_cache(2, 16)
    rcache["length"] = jnp.asarray([5, 3], jnp.int32)
    with ref_ops.kernel_mode("pallas"):
        rg, _ = ref_trace(lambda p, c, t: rmodel.decode_step(p, c, t),
                          rparams, rcache, jnp.zeros((2, 1), jnp.int32),
                          name="decode")
    cache = model.init_cache(2, 16, "cpu")
    cache["length"] = torch.tensor([5, 3], dtype=torch.int32)
    with ops.kernel_mode("kernels"):
        g, _ = trace_to_graph(lambda p, c, t: model.decode_step(p, c, t),
                              params, cache, torch.zeros((2, 1), dtype=torch.long),
                              name="decode")
    return rg, g


def _router_nodes(graph, is_router):
    """(base, its projections in order) of each router node."""
    out = []
    for n in graph.nodes.values():
        if is_router(n):
            projs = sorted((graph[u] for u in graph.users(n.name)),
                           key=lambda p: p.attrs["project"])
            out.append((n, projs))
    return out


def test_router_node_and_its_projections_are_tagged():
    rg, g = traced_steps()
    L = setup()[3].cfg.n_layers
    ref_nodes = _router_nodes(rg, lambda n: "project" not in n.attrs
                              and ref_kernel_name(n) == "_router_kernel")
    port_nodes = _router_nodes(g, lambda n: n.attrs.get("kernel") == "_router_kernel"
                               and "project" not in n.attrs)
    assert len(port_nodes) == len(ref_nodes) == L
    spell = lambda graph, n: (tuple(n.shape), str(n.dtype))
    for (rbase, rprojs), (base, projs) in zip(ref_nodes, port_nodes):
        assert base.attrs.get("multi") and rbase.attrs.get("multi")
        assert [spell(g, p) for p in projs] == [spell(rg, p) for p in rprojs]
        assert [spell(g, g[o]) for o in base.operands] == \
            [spell(rg, rg[o]) for o in rbase.operands]
        # fault fixed: each projection carries the base's tag, so the
        # registry admits it as it does the reference's
        assert [p.attrs.get("kernel") for p in projs] == ["_router_kernel"] * 2
        assert all(registry.lookup(p).name == "_router_kernel" for p in projs)
        assert registry.lookup(base).flops(base, g) == \
            ref_registry._REGISTRY["_router_kernel"].flops(rbase, rg)


def _router_layer_graph(builder):
    """A reduced MoE layer's router spelled with registered kernel nodes:
    norm -> router GEMM -> router (a shapeless base, weights and ids
    projections) -> the weights scale an expert MLP's output, the ids feed
    an unregistered gather."""
    T, D, E, k, F = 8, 64, 8, 2, 32
    b = builder("router_layer")
    x, g = b.param("x", (T, D)), b.param("g", (D,))
    wr, wg, wu, wd = (b.param("wr", (D, E)), b.param("wg", (D, F)),
                      b.param("wu", (D, F)), b.param("wd", (F, D)))
    table = b.param("table", (E, D))
    tag = "_router_kernel"
    n1 = b.custom("_rmsnorm_kernel", (T, D), "float32", (x, g),
                  kernel="_rmsnorm_kernel")
    base = b.custom(tag, (), "float32", (b.dot(n1, wr),), kernel=tag, multi=True)
    w = b.custom(f"{tag}.o0", (T, k), "float32", (base,), kernel=tag, project=0)
    ids = b.custom(f"{tag}.o1", (T, k), "int32", (base,), kernel=tag, project=1)
    act = b.custom("_glu_kernel", (T, F), "float32",
                   (b.dot(n1, wg), b.dot(n1, wu)), kernel="_glu_kernel")
    scale = b.reduce("sum", w, axes=(1,))
    y = b.ew("mul", b.dot(act, wd), b.bcast(scale, (T, D), (0,)))
    emb = b.gather(table, ids)
    out = b.ew("add", b.ew("add", x, y), b.reduce("sum", emb, axes=(1,)))
    return b.build(outputs=[out])


def test_router_plan_equals_reference():
    rg = _router_layer_graph(RefBuilder)
    ref_plan = RefCompiler(REF_V100, mode="stitch", use_pallas=False).compile(rg)
    port = StitchCompiler(V100, mode="stitch").compile(to_port(rg))
    assert port.stats.n_ops == ref_plan.stats.n_ops
    assert port.stats.n_kernels == ref_plan.stats.n_kernels
    assert _groups(port) == _groups(ref_plan)
    g = port.graph
    assert any(len(grp.members) > 1 and any(
        g[m].attrs.get("kernel") == "_router_kernel" for m in grp.members)
        for grp in port.groups)


# -- serving ----------------------------------------------------------------------

LENS = np.array([5, 3])
LONG_LENS = np.array([100, 70])


@functools.lru_cache(maxsize=None)
def served(bucket: int, modes: tuple):
    rmodel, rparams, _, model, params = setup()
    lens = LENS if bucket == 8 else LONG_LENS
    prompts = np.random.default_rng(bucket).integers(
        0, model.cfg.vocab, (2, int(lens.max())))
    ref_run, port_run, eng = _serve_both(
        prompts, lens, bucket, bucket + 8,
        models=(rmodel, rparams, model, params), modes=modes)
    return ref_run, port_run, eng


@pytest.mark.parametrize("modes", [("ref", "ref"), ("pallas", "kernels")],
                         ids=["ref_mode", "kernel_mode"])
@pytest.mark.parametrize("bucket", [8, 128])
def test_served_granite_matches_reference(bucket, modes):
    ref_run, port_run, eng = served(bucket, modes)
    np.testing.assert_array_equal(port_run[0], ref_run[0])
    np.testing.assert_allclose(port_run[1], ref_run[1], **TOL)
    assert len(port_run[2]) == len(ref_run[2]) == NEW_TOKENS - 1
    for p, r in zip(port_run[2], ref_run[2]):
        np.testing.assert_allclose(p, r, **TOL)
    rep = eng.report()
    assert rep["decode"]["calls"]["stitched"] == NEW_TOKENS - 1
    assert rep["prefill"]["calls"]["fallback"] == 0
    for ex in (eng._prefill_exec, eng._exec):
        # the dropped aux metrics leave no node: no mean over token rows
        assert not [n for n in ex.graph.nodes.values()
                    if n.kind is OpKind.REDUCTION and n.attrs["op"] == "mean"
                    and n.attrs["axes"] == (0,)]
        tags = [n.attrs.get("kernel") for n in ex.graph.nodes.values()]
        n_router = tags.count("_router_kernel")
        # a base and two projections a layer in kernel mode, none in ref mode
        assert n_router == (3 * setup()[3].cfg.n_layers if modes[1] == "kernels" else 0)


def test_serve_launcher_granite_cpu(capsys):
    from repro_torch.launch import serve as launcher
    launcher.main(["--arch", ARCH, "--reduced", "--stitch", "--dense",
                   "--mode", "static", "--device", "cpu", "--slots", "2",
                   "--prompt-len", "6", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=granite-moe-smoke" in out and "tokens/s" in out


def test_unported_moe_options_are_refused():
    """The grouped dispatch and shared experts (qwen2-moe) are not ported."""
    _, _, _, model, params = setup()
    cfg = replace(model.cfg, moe=replace(model.cfg.moe, n_groups=2))
    with pytest.raises(NotImplementedError, match="n_groups"):
        layers.apply_moe(params["layers"][0]["mlp"], torch.zeros(8, 64), cfg)
    cfg = replace(model.cfg, moe=replace(model.cfg.moe, n_shared=1,
                                         d_shared=64))
    with pytest.raises(NotImplementedError, match="shared experts"):
        build_model(cfg).init(0, "cpu")
