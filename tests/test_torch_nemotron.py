"""The port's LayerNorm / squared-ReLU dense family (nemotron-4-15b,
reduced: 2 layers, d_model 96, 6/2 heads, d_ff 192, vocab 256) against the
reference.

* The config and ``param_count`` equal the reference's.
* The plain LayerNorm and squared ReLU (what the Triton kernels compute)
  against the reference's Pallas ``_layernorm_kernel`` and
  ``_sqrelu_kernel`` in interpret mode, at d = 96 and 6144, with random
  gamma and beta and inputs holding negatives and exact zeros: LayerNorm
  within rtol/atol 2e-4 in f32 (the reference's own tolerance) and one bf16
  step (1.6e-2) in bf16, squared ReLU bitwise in both.  The ref-mode
  squared ReLU traces to the reference's nodes, node for node.
* The params round trip (a LayerNorm's ``b``, the two-matrix MLP).
* The traced decode step and prefill hold ``_layernorm_kernel`` on 2L+1
  nodes and ``_sqrelu_kernel`` on L nodes, at the reference's operand
  shapes, as many as the reference's pallas-mode trace.
* The reference's traced decode-step graph, ref mode and pallas mode (its
  Pallas nodes tagged from their debug info), plans identically in both
  packages; the unregistered squared-ReLU node is a group of its own there
  and in the port's own kernel-mode plan.
* Served at an 8 and a 128 bucket: the port's ref mode against the
  reference's ref mode, its kernel mode against the reference's pallas
  mode, tokens equal and logits within rtol/atol 2e-4; once more with
  bf16 parameters.  Every norm's g and b are seeded away from 1 and 0, so a
  path that dropped either would disagree.
* The launcher serves the reduced config; a ``norm`` or ``act`` the port
  does not know is refused; ``params_from_jax`` defaults to the card.
"""

from __future__ import annotations

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_reduced as ref_reduced
from repro.core import StitchCompiler as RefCompiler
from repro.core import V100 as REF_V100
from repro.core.trace import trace_to_graph as ref_trace
from repro.kernels import activations as ref_act
from repro.kernels import norms as ref_norms
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracles
from repro.models import build_model as ref_build
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import OpKind, StitchCompiler, V100
from repro_torch.core.trace import trace_to_graph
from repro_torch.kernels import activations, norms, ops, ref
from repro_torch.models import build_model, layers
from repro_torch.models.convert import params_from_jax, params_to_numpy

from test_torch_kernel_mode import NEW_TOKENS, _serve_both, ref_kernel_name
from test_torch_planner import _groups, to_port

ARCH = "nemotron-4-15b"
TOL = dict(rtol=2e-4, atol=2e-4)
DTYPES = [("float32", 2e-4), ("bfloat16", 1.6e-2)]


def _seed_norms(tree, seed: int = 1):
    """Every norm's g to ``1 + 0.1 N(0, 1)`` and b to ``0.1 N(0, 1)``, in
    place (random init makes them 1 and 0)."""
    rng = np.random.default_rng(seed)
    for v in tree.values():
        if not isinstance(v, dict):
            continue
        if set(v) == {"g", "b"}:
            v["g"] = (1 + 0.1 * rng.standard_normal(v["g"].shape)).astype(np.float32)
            v["b"] = (0.1 * rng.standard_normal(v["b"].shape)).astype(np.float32)
        else:
            _seed_norms(v, seed + 1)
    return tree


@functools.lru_cache(maxsize=None)
def setup(param_dtype: str = "float32"):
    """(reference model, its params, the numpy tree, port model, its
    params): the same seeded weights, in ``param_dtype``."""
    rcfg = replace(ref_reduced(ARCH), dtype="float32", scan_layers=False,
                   remat="none", param_dtype=param_dtype)
    cfg = replace(get_reduced(ARCH), dtype="float32", scan_layers=False,
                  remat="none", param_dtype=param_dtype)
    rmodel = ref_build(rcfg)
    tree = _seed_norms(jax.tree.map(
        lambda a: np.asarray(a, np.float32), rmodel.init(jax.random.PRNGKey(0))))
    rparams = jax.tree.map(lambda a: jnp.asarray(a, param_dtype), tree)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), rparams)
    model = build_model(cfg)
    params = params_from_jax(tree, cfg, device="cpu")
    return rmodel, rparams, tree, model, params


# -- config --------------------------------------------------------------------

def test_nemotron_config_and_param_count_equal_the_reference():
    for port_cfg, rcfg in ((get_config(ARCH), ref_config(ARCH)),
                           (get_reduced(ARCH), ref_reduced(ARCH))):
        assert vars(port_cfg) == vars(rcfg)
        assert port_cfg.param_count() == rcfg.param_count()
    assert (get_config(ARCH).norm, get_config(ARCH).act) == ("ln", "sqrelu")
    # the port's init makes the reference's leaves, shape for shape
    rmodel, rparams, _, model, _ = setup()
    ours = model.init(0, "cpu")
    assert jax.tree.map(lambda a: tuple(a.shape), params_to_numpy(ours)) == \
        jax.tree.map(lambda a: tuple(a.shape), rparams)


# -- the two kernels' plain versions ---------------------------------------------------

def _pair(a: np.ndarray, dtype: str):
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.as_tensor(a).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("shape", [(3, 5, 96), (4, 6144)], ids=["d96", "d6144"])
def test_layernorm_plain_matches_reference_kernel(shape, dtype, tol):
    rng = np.random.default_rng(shape[-1])
    d = shape[-1]
    x = (2.0 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    x.reshape(-1)[::7] = 0.0
    g = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    (jx, tx), (jg, tg), (jb, tb) = (_pair(a, dtype) for a in (x, g, b))
    want = np.asarray(ref_norms.layernorm(jx, jg, jb, 1e-5, block_rows=4),
                      np.float32)
    np.testing.assert_allclose(want, np.asarray(
        ref_oracles.layernorm(jx, jg, jb, 1e-5), np.float32), rtol=tol, atol=tol)
    for out in (norms.layernorm_plain(tx, tg, tb, 1e-5),
                norms.layernorm(tx, tg, tb), ref.layernorm(tx, tg, tb)):
        assert out.shape == tx.shape and out.dtype == tx.dtype
        np.testing.assert_allclose(out.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 5, 96), (4, 6144)], ids=["d96", "d6144"])
def test_squared_relu_plain_matches_reference_kernel_bitwise(shape, dtype):
    rng = np.random.default_rng(shape[-1] + 1)
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    x.reshape(-1)[::5] = 0.0
    nonzero = x != 0
    assert 0.4 < (x[nonzero] < 0).mean() < 0.6 and not nonzero.all()
    jx, tx = _pair(x, dtype)
    want = np.asarray(ref_act.squared_relu(jx, block_rows=4).astype(jnp.float32))
    np.testing.assert_array_equal(np.asarray(
        ref_oracles.squared_relu(jx).astype(jnp.float32)), want)
    for out in (activations.squared_relu_plain(tx),
                activations.squared_relu(tx), ref.squared_relu(tx)):
        assert out.shape == tx.shape and out.dtype == tx.dtype
        np.testing.assert_array_equal(out.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_squared_relu_traces_to_the_reference_nodes(dtype):
    """``max`` against a scalar literal, then ``mul``, between the converts:
    the reference's nodes, node for node."""
    x = np.random.default_rng(0).standard_normal((4, 96)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    rg, _ = ref_trace(ref_oracles.squared_relu, jx)
    g, _ = trace_to_graph(ref.squared_relu, tx)

    def spelled(graph):
        out = []
        for name in graph.topo_order():
            n = graph[name]
            val = n.attrs.get("value")
            out.append((n.name, n.kind.value, tuple(n.shape), str(n.dtype),
                        tuple(n.operands), n.attrs.get("op"),
                        None if val is None else float(np.asarray(val))))
        return out

    assert spelled(g) == spelled(rg)


# -- params ---------------------------------------------------------------------------

def test_nemotron_params_round_trip():
    _, _, tree, model, params = setup()
    lp = params["layers"][0]
    assert set(lp["mlp"]) == {"w_up", "w_down"}
    assert set(lp["norm1"]) == set(lp["norm2"]) == set(params["final_norm"]) \
        == {"g", "b"}
    back = params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)


def test_params_from_jax_defaults_to_the_card(monkeypatch):
    _, _, tree, model, _ = setup()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(tree, model.cfg)


# -- traces and plans -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def traced(what: str, modes: tuple):
    """(reference graph, port graph) of the reduced decode step at ragged
    lengths or the prefill at 128 tokens, in ``modes``."""
    rmodel, rparams, _, model, params = setup()
    if what == "decode":
        rcache = rmodel.init_cache(2, 16)
        rcache["length"] = jnp.asarray([5, 3], jnp.int32)
        rargs = (rparams, rcache, jnp.zeros((2, 1), jnp.int32))
        cache = model.init_cache(2, 16, "cpu")
        cache["length"] = torch.tensor([5, 3], dtype=torch.int32)
        args = (params, cache, torch.zeros((2, 1), dtype=torch.long))
        rfn, fn = rmodel.decode_step, model.decode_step
    else:
        toks = np.zeros((2, 128), np.int32)
        rargs, args = (rparams, jnp.asarray(toks)), (params, torch.as_tensor(toks).long())
        rfn, fn = rmodel.prefill, model.prefill
    with ref_ops.kernel_mode(modes[0]):
        rg, _ = ref_trace(lambda *a: rfn(*a), *rargs, name=what)
    with ops.kernel_mode(modes[1]):
        g, _ = trace_to_graph(lambda *a: fn(*a), *args, name=what)
    return rg, g


def _kernel_nodes(graph, name_of):
    out = {}
    for n in graph.nodes.values():
        name = name_of(n)
        if name is not None and "project" not in n.attrs:
            out.setdefault(name, []).append(n)
    return out


@pytest.mark.parametrize("what", ["decode", "prefill"])
def test_traced_kernel_nodes_match_the_reference(what):
    rg, g = traced(what, ("pallas", "kernels"))
    L = setup()[3].cfg.n_layers
    ref_nodes = _kernel_nodes(rg, ref_kernel_name)
    port = _kernel_nodes(g, lambda n: n.attrs.get("kernel")
                         if n.kind is OpKind.CUSTOM else None)
    attn = "_decode_attn_kernel" if what == "decode" else "_flash_kernel"
    assert {k: len(v) for k, v in port.items()} == {
        "_layernorm_kernel": 2 * L + 1, "_sqrelu_kernel": L,
        "_rope_kernel": 2 * L, attn: L}
    assert {k: len(v) for k, v in ref_nodes.items()} == \
        {k: len(v) for k, v in port.items()}

    def spell(graph, n):
        return (tuple(n.shape), str(n.dtype),
                [(tuple(graph[o].shape), str(graph[o].dtype)) for o in n.operands])

    for tag in ("_layernorm_kernel", "_sqrelu_kernel"):
        assert sorted(spell(g, n) for n in port[tag]) == \
            sorted(spell(rg, n) for n in ref_nodes[tag])


def _tagged_port_copy(rg):
    """The reference graph with each Pallas node tagged with its kernel
    body (the reference tracer leaves them untagged under jax 0.9), and its
    copy in the port's IR."""
    for n in rg.nodes.values():
        name = ref_kernel_name(n)
        if name is not None:
            n.attrs["kernel"] = name
    return to_port(rg)


def _alone(compiled, name) -> bool:
    (grp,) = [grp for grp in compiled.groups if name in grp.members]
    return list(grp.members) == [name]


@pytest.mark.parametrize("modes", [("ref", "ref"), ("pallas", "kernels")],
                         ids=["ref_mode", "kernel_mode"])
def test_layer_plan_equals_reference(modes):
    rg, g = traced("decode", modes)
    pg = _tagged_port_copy(rg)
    ref_plan = RefCompiler(REF_V100, mode="stitch", use_pallas=False).compile(rg)
    port = StitchCompiler(V100, mode="stitch").compile(pg)
    assert port.stats.n_ops == ref_plan.stats.n_ops
    assert port.stats.n_kernels == ref_plan.stats.n_kernels
    assert _groups(port) == _groups(ref_plan)
    assert port.stats.pattern_classes == ref_plan.stats.pattern_classes
    if modes[1] == "ref":
        return
    # registered kernels fuse with neighbours; the squared-ReLU node cuts
    sq = [n for n, node in pg.nodes.items()
          if node.attrs.get("kernel") == "_sqrelu_kernel"]
    assert len(sq) == setup()[3].cfg.n_layers
    assert all(_alone(port, n) and _alone(ref_plan, n) for n in sq)
    assert any(len(grp.members) > 1 and any(
        pg[m].attrs.get("kernel") == "_layernorm_kernel" for m in grp.members)
        for grp in port.groups)
    own = StitchCompiler(V100, mode="stitch").compile(g)
    own_sq = [n for n, node in g.nodes.items()
              if node.attrs.get("kernel") == "_sqrelu_kernel"]
    assert len(own_sq) == len(sq) and all(_alone(own, n) for n in own_sq)


# -- serving --------------------------------------------------------------------------

LENS = np.array([5, 3])
LONG_LENS = np.array([100, 70])


@functools.lru_cache(maxsize=None)
def served(bucket: int, modes: tuple, param_dtype: str = "float32"):
    rmodel, rparams, _, model, params = setup(param_dtype)
    lens = LENS if bucket == 8 else LONG_LENS
    prompts = np.random.default_rng(bucket).integers(
        0, model.cfg.vocab, (2, int(lens.max())))
    return _serve_both(prompts, lens, bucket, bucket + 8,
                       models=(rmodel, rparams, model, params), modes=modes)


@pytest.mark.parametrize("bucket,modes,param_dtype", [
    (8, ("ref", "ref"), "float32"), (8, ("pallas", "kernels"), "float32"),
    (128, ("ref", "ref"), "float32"), (128, ("pallas", "kernels"), "float32"),
    (8, ("pallas", "kernels"), "bfloat16"),
], ids=["8-ref_mode", "8-kernel_mode", "128-ref_mode", "128-kernel_mode",
        "8-kernel_mode-bf16_params"])
def test_served_nemotron_matches_reference(bucket, modes, param_dtype):
    ref_run, port_run, eng = served(bucket, modes, param_dtype)
    np.testing.assert_array_equal(port_run[0], ref_run[0])
    np.testing.assert_allclose(port_run[1], ref_run[1], **TOL)
    assert len(port_run[2]) == len(ref_run[2]) == NEW_TOKENS - 1
    for p, r in zip(port_run[2], ref_run[2]):
        np.testing.assert_allclose(p, r, **TOL)
    rep = eng.report()
    assert rep["decode"]["calls"]["stitched"] == NEW_TOKENS - 1
    assert rep["prefill"]["calls"]["fallback"] == 0
    L = setup()[3].cfg.n_layers
    for ex in (eng._prefill_exec, eng._exec):
        tags = [n.attrs.get("kernel") for n in ex.graph.nodes.values()]
        kern = modes[1] == "kernels"
        assert tags.count("_layernorm_kernel") == (2 * L + 1 if kern else 0)
        assert tags.count("_sqrelu_kernel") == (L if kern else 0)


def test_serve_launcher_nemotron_cpu(capsys):
    from repro_torch.launch import serve as launcher
    launcher.main(["--arch", ARCH, "--reduced", "--stitch", "--dense",
                   "--mode", "static", "--device", "cpu", "--slots", "2",
                   "--prompt-len", "6", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=nemotron-smoke" in out and "tokens/s" in out


@pytest.mark.parametrize("field,value", [("act", "gelu"), ("norm", "layer")])
def test_unknown_norm_or_act_is_refused(field, value):
    _, _, _, model, params = setup()
    cfg = replace(model.cfg, **{field: value})
    with pytest.raises(ValueError, match=f"{field}='{value}' is not ported"):
        build_model(cfg).init(0, "cpu")
    x = torch.zeros(2, 3, cfg.d_model)
    lp = params["layers"][0]
    with pytest.raises(ValueError, match=f"'{value}'"):
        if field == "act":
            layers.apply_mlp(lp["mlp"], x, cfg)
        else:
            layers.apply_norm(lp["norm1"], x, cfg)
