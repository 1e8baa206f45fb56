"""The port's kernel mode against the reference's ``pallas`` mode.

Reduced qwen3-1.7b (2 layers, d_model 64) in float32 with unrolled layers,
the same weights in both packages (``params_from_jax``):

* the traced decode step holds one CUSTOM node per kernel call, as many per
  kernel as the reference's pallas-mode trace, and the planner's registry
  prices the matching nodes alike;
* a hand-built graph with registered kernels gives exactly the reference's
  plan;
* the port's stitched ``Engine`` in kernel mode serves the reference
  engine's greedy tokens (pallas mode, jit), with prefill and step logits
  within rtol/atol 2e-4 (the reference's own tolerance), and its own
  ref-mode tokens, at an 8 bucket and at a 128 bucket, where both prefills
  run their flash-attention kernel;
* the traced prefill's flash node has the reference node's operands and
  registry price;
* its decode plan fuses the registered kernels with their neighbours.

Under jax 0.9.0 the reference's tracer leaves its Pallas CUSTOM nodes
untagged (``pallas_call`` has no ``name_and_src_info`` param), so the
tests read each node's kernel name from the jaxpr's debug info instead.
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
from repro.kernels import registry as ref_registry
from repro.models import build_model as ref_build
from repro.serve import Engine as RefEngine
from repro.serve import ServeConfig as RefServeConfig
from repro_torch.configs import get_reduced
from repro_torch.core import OpKind, StitchCompiler, V100
from repro_torch.core.trace import trace_to_graph
from repro_torch.kernels import ops, registry, stitched
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Engine, ServeConfig

from test_torch_planner import _groups, to_port

TOL = dict(rtol=2e-4, atol=2e-4)
LENS = np.array([5, 3])
NEW_TOKENS = 4
KERNELS = ("_rmsnorm_kernel", "_rope_kernel", "_glu_kernel",
           "_decode_attn_kernel")


@functools.lru_cache(maxsize=None)
def setup():
    rcfg = replace(ref_reduced("qwen3_1_7b"), dtype="float32",
                   scan_layers=False)
    cfg = replace(get_reduced("qwen3_1_7b"), dtype="float32",
                  scan_layers=False)
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, rparams), cfg,
                             device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 5))
    return rmodel, rparams, model, params, prompts


def ref_kernel_name(node) -> str | None:
    """The Pallas kernel body of a reference CUSTOM node, from the kernel
    jaxpr's debug info (``"_rmsnorm_kernel at .../norms.py:32"``)."""
    if node.kind.value != "custom" or node.attrs.get("prim") != "pallas_call":
        return None
    params = node.attrs["eval_fn"].__kwdefaults__["_params"]
    return params["jaxpr"].debug_info.func_src_info.split(" ")[0]


@functools.lru_cache(maxsize=None)
def traced_steps():
    """(reference graph in pallas mode, port graph in kernel mode) of the
    reduced decode step at ragged lengths."""
    rmodel, rparams, model, params, _ = setup()
    rcache = rmodel.init_cache(2, 16)
    rcache["length"] = jnp.asarray(LENS, jnp.int32)
    with ref_ops.kernel_mode("pallas"):
        rg, _ = ref_trace(lambda p, c, t: rmodel.decode_step(p, c, t),
                          rparams, rcache, jnp.zeros((2, 1), jnp.int32),
                          name="decode")
    cache = model.init_cache(2, 16, "cpu")
    cache["length"] = torch.as_tensor(LENS, dtype=torch.int32)
    with ops.kernel_mode("kernels"):
        g, _ = trace_to_graph(lambda p, c, t: model.decode_step(p, c, t),
                              params, cache, torch.zeros((2, 1), dtype=torch.long),
                              name="decode")
    return rg, g


def test_traced_decode_step_has_the_reference_kernel_nodes():
    rg, g = traced_steps()
    n_layers = setup()[2].cfg.n_layers

    def priced(graph, name_of, desc_of):
        out = {}
        for n in graph.nodes.values():
            name = name_of(n)
            if name is None:
                continue
            desc = desc_of(name, n)
            out.setdefault(name, []).append(
                (desc.flops(n, graph), desc.scratch_bytes(n, graph)))
        return {k: sorted(v) for k, v in out.items()}

    ref = priced(rg, ref_kernel_name,
                 lambda name, n: ref_registry._REGISTRY[name])
    port = priced(g, lambda n: n.attrs.get("kernel")
                  if n.kind is OpKind.CUSTOM else None,
                  lambda name, n: registry.lookup(n))
    assert set(port) == set(KERNELS)
    assert {k: len(v) for k, v in port.items()} == {
        "_rmsnorm_kernel": 4 * n_layers + 1, "_rope_kernel": 2 * n_layers,
        "_glu_kernel": n_layers, "_decode_attn_kernel": n_layers}
    assert port == ref


def test_decode_attention_node_operands_match_the_reference():
    """The registry reads operands by position: (positions, q^T, k^T, v^T)
    at the reference's shapes and dtypes."""
    rg, g = traced_steps()
    (rnode, *_), (pnode, *_) = (
        [n for n in graph.nodes.values() if name_of(n) == "_decode_attn_kernel"]
        for graph, name_of in ((rg, ref_kernel_name),
                               (g, lambda n: n.attrs.get("kernel"))))
    assert [(tuple(g[o].shape), str(g[o].dtype)) for o in pnode.operands] == \
        [(tuple(rg[o].shape), str(rg[o].dtype)) for o in rnode.operands]
    assert tuple(pnode.shape) == tuple(rnode.shape)
    kinds = [g[o].kind for o in pnode.operands[1:]]
    assert kinds == [OpKind.TRANSPOSE] * 3


def _layer_graph(builder):
    """One reduced decode layer spelled with registered kernel nodes:
    norm -> q/k/v GEMMs -> rope -> decode attention -> o GEMM -> residual
    -> norm -> gate/up GEMMs -> GLU -> down GEMM -> residual."""
    B, D, H, KV, Dh, S, F = 4, 64, 4, 2, 16, 32, 128
    b = builder("kernel_layer")
    x = b.param("x", (B, D))
    g1, g2 = b.param("g1", (D,)), b.param("g2", (D,))
    pos = b.param("pos", (B,), "int32")
    kc, vc = b.param("kc", (B, KV, S, Dh)), b.param("vc", (B, KV, S, Dh))
    wq, wk, wo = (b.param("wq", (D, H * Dh)), b.param("wk", (D, KV * Dh)),
                  b.param("wo", (H * Dh, D)))
    wg, wu, wd = b.param("wg", (D, F)), b.param("wu", (D, F)), b.param("wd", (F, D))

    def kern(tag, shape, *operands):
        return b.custom(tag, shape, "float32", operands, kernel=tag)

    n1 = kern("_rmsnorm_kernel", (B, D), x, g1)
    q = kern("_rope_kernel", (B, H * Dh), b.dot(n1, wq), pos)
    k = kern("_rope_kernel", (B, KV * Dh), b.dot(n1, wk), pos)
    qt = b.transpose(b.reshape(q, (B, 1, H, Dh)), (0, 2, 1, 3))
    kn = b.ew("add", kc, b.bcast(b.reshape(k, (B, KV, 1, Dh)),
                                 (B, KV, S, Dh), (0, 1, 2, 3)))
    att = kern("_decode_attn_kernel", (B, H, 1, Dh), b.reshape(pos, (B, 1)),
               qt, kn, vc)
    o = b.dot(b.reshape(b.transpose(att, (0, 2, 1, 3)), (B, H * Dh)), wo)
    h = b.ew("add", x, o)
    n2 = kern("_rmsnorm_kernel", (B, D), h, g2)
    act = kern("_glu_kernel", (B, F), b.dot(n2, wg), b.dot(n2, wu))
    out = b.ew("add", h, b.dot(act, wd))
    return b.build(outputs=[out, kn])


def test_registered_kernel_plan_equals_reference():
    rg = _layer_graph(RefBuilder)
    ref = RefCompiler(REF_V100, mode="stitch", use_pallas=False).compile(rg)
    port = StitchCompiler(V100, mode="stitch").compile(to_port(rg))
    assert port.stats.n_ops == ref.stats.n_ops
    assert port.stats.n_kernels == ref.stats.n_kernels
    assert _groups(port) == _groups(ref)
    assert port.stats.pattern_classes == ref.stats.pattern_classes
    g = port.graph
    assert any(len(grp.members) > 1
               and any(g[m].attrs.get("kernel") for m in grp.members)
               for grp in port.groups)


def _serve_both(prompts, lens, bucket, max_len, models=None,
                modes=("pallas", "kernels")):
    """(reference pallas-mode run, port kernel-mode run, port kernel-mode
    engine) of the same prompts: tokens, prefill logits, step logits.
    ``models`` (reference model and params, port model and params) default
    to the reduced qwen3 of :func:`setup`; ``modes`` are the reference's and
    the port's kernel modes."""
    rmodel, rparams, model, params = models or setup()[:4]
    steps = NEW_TOKENS - 1
    B = len(lens)
    padded = np.zeros((B, bucket), np.int32)
    padded[:, :prompts.shape[1]] = prompts
    with ref_ops.kernel_mode(modes[0]):
        reng = RefEngine(rmodel, rparams, RefServeConfig(
            batch=B, max_len=max_len, max_new_tokens=NEW_TOKENS, paged=False))
        rlogits0, _ = jax.jit(lambda p, t, l: rmodel.prefill(p, t, true_len=l))(
            rparams, jnp.asarray(padded), jnp.asarray(lens))
        px = reng.prefill(prompts, prompt_lens=lens)
        assert px.bucket == bucket
        for row in range(B):
            reng.insert(px, slot=row, row=row)
        cache = reng.kv.decode_cache()
        tok = jnp.asarray(px.first_tokens.astype(np.int32)[:, None])
        rtoks, rsteps = [px.first_tokens], []
        for _ in range(steps):
            logits, cache = reng._decode_dispatch(cache, tok, {})
            rsteps.append(np.asarray(logits))
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
            rtoks.append(np.asarray(tok)[:, 0])
    ref = (np.stack(rtoks, 1), np.asarray(rlogits0), rsteps)

    scfg = ServeConfig(batch=B, max_len=max_len, max_new_tokens=NEW_TOKENS,
                       stitch_execute=True)
    with ops.kernel_mode(modes[1]):
        eng = Engine(model, params, scfg, device="cpu")
        logits0, _ = eng._prefill_exec(
            params, torch.as_tensor(padded).long(),
            torch.as_tensor(lens, dtype=torch.int32))
        pxp = eng.prefill(prompts, prompt_lens=lens)
        assert pxp.bucket == bucket
        for row in range(B):
            eng.insert(pxp, slot=row, row=row)
        toks, step_logits = eng.generate_step(steps=steps, return_logits=True)
    port = (np.concatenate([pxp.first_tokens[:, None], toks], 1),
            logits0.numpy(), [x.numpy() for x in step_logits])
    return ref, port, eng


@functools.lru_cache(maxsize=None)
def served():
    """(reference pallas-mode run, port kernel-mode run, port kernel-mode
    engine, port ref-mode stitched engine, its tokens) at the 8 bucket."""
    _, _, model, params, prompts = setup()
    ref, port, eng = _serve_both(prompts, LENS, 8, 32)
    ref_eng = Engine(model, params, ServeConfig(
        batch=2, max_len=32, max_new_tokens=NEW_TOKENS, stitch_execute=True),
        device="cpu")
    ref_toks = ref_eng.generate(prompts, prompt_lens=LENS)
    return ref, port, eng, ref_eng, ref_toks


# prompts of 100 and 70 tokens: bucket 128, where both packages' kernel
# modes run their flash-attention kernel in the prefill
LONG_LENS = np.array([100, 70])


@functools.lru_cache(maxsize=None)
def served_long():
    cfg = setup()[2].cfg
    prompts = np.random.default_rng(1).integers(0, cfg.vocab, (2, 100))
    return _serve_both(prompts, LONG_LENS, 128, 136)


def test_kernel_mode_tokens_equal_reference_pallas_mode():
    ref, port, _, _, ref_mode_toks = served()
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_array_equal(port[0], ref_mode_toks)


def test_kernel_mode_logits_match_reference_pallas_mode():
    ref, port, eng, _, _ = served()
    np.testing.assert_allclose(port[1], ref[1], **TOL)
    assert len(port[2]) == len(ref[2]) == NEW_TOKENS - 1
    for p, r in zip(port[2], ref[2]):
        np.testing.assert_allclose(p, r, **TOL)
    rep = eng.report()
    assert rep["decode"]["calls"] == {"stitched": NEW_TOKENS - 1,
                                      "fallback": 0, "jit": 0}
    assert rep["prefill"]["calls"]["fallback"] == 0


def test_kernel_mode_decode_plan_fuses_registered_kernels():
    _, _, eng, ref_eng, _ = served()
    kern, plain = eng.report()["decode"]["plan"], ref_eng.report()["decode"]["plan"]
    assert kern["n_kernels"] < plain["n_kernels"]
    assert kern["n_ops"] < plain["n_ops"]
    g = eng._exec.graph
    fused = [grp for grp in eng._exec.compiled.groups
             if len(grp.members) > 1
             and any(g[m].attrs.get("kernel") in KERNELS for m in grp.members)]
    assert fused
    # the emitter leaves custom members to the eager executor: such a group
    # runs as a torch group whose kernel node launches the hand-written kernel
    assert {grp.kind for grp in fused} == {"torch"}


def test_stitched_engine_serves_layout_patterns_as_views():
    """The ref-mode engine's layout-only pattern (a pack of size-1
    broadcasts in its prefill plan) runs as views, with no kernel (still a
    ``triton`` group of the plan, whose counts are the reference's), no
    graph output viewing a graph input; the engine that ran it served, over
    several decode steps, the tokens of the kernel-mode engine and of the
    reference."""
    ref, port, _, ref_eng, ref_toks = served()
    views = [grp for ex in (ref_eng._prefill_exec, ref_eng._exec)
             for grp in ex.compiled.groups if grp.kind == "triton"
             and isinstance(grp.tuned.callable, stitched.StitchedView)]
    assert views
    for grp in views:
        p = grp.tuned.pattern
        assert all(stitched.alias_refusal(p.graph, o) is None
                   for o in p.external_outputs)
    np.testing.assert_array_equal(ref_toks, port[0])
    np.testing.assert_array_equal(ref_toks, ref[0])


def test_kernel_mode_prefill_at_a_128_bucket_matches_reference_pallas_mode():
    ref, port, eng = served_long()
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_allclose(port[1], ref[1], **TOL)
    assert len(port[2]) == len(ref[2]) == NEW_TOKENS - 1
    for p, r in zip(port[2], ref[2]):
        np.testing.assert_allclose(p, r, **TOL)
    rep = eng.report()
    assert rep["prefill"]["calls"]["fallback"] == 0
    g = eng._prefill_exec.graph
    flash = [n for n in g.nodes.values()
             if n.attrs.get("kernel") == "_flash_kernel"]
    assert len(flash) == setup()[2].cfg.n_layers


@functools.lru_cache(maxsize=None)
def traced_prefills():
    """(reference graph in pallas mode, port graph in kernel mode) of the
    reduced prefill at 128 tokens.  The reference traces without remat,
    which would hide each layer in one CUSTOM node (the values are the
    same)."""
    rmodel, rparams, model, params, _ = setup()
    rmodel = ref_build(replace(rmodel.cfg, remat="none"))
    toks = np.zeros((2, 128), np.int32)
    with ref_ops.kernel_mode("pallas"):
        rg, _ = ref_trace(lambda p, t: rmodel.prefill(p, t), rparams,
                          jnp.asarray(toks), name="prefill")
    with ops.kernel_mode("kernels"):
        g, _ = trace_to_graph(lambda p, t: model.prefill(p, t), params,
                              torch.as_tensor(toks).long(), name="prefill")
    return rg, g


def test_flash_node_operands_and_price_match_the_reference():
    """The flash node takes the reference's operands, (q^T, k^T, v^T) in
    (B, H, L, Dh), and the copied registry prices it alike.  Its formulas
    read those operands as (B, L, H, Dh), so the modeled FLOPs take Hkv
    where Lkv belongs: a reference caveat the port keeps."""
    rg, g = traced_prefills()
    rnodes = [n for n in rg.nodes.values() if ref_kernel_name(n) == "_flash_kernel"]
    pnodes = [n for n in g.nodes.values() if n.attrs.get("kernel") == "_flash_kernel"]
    assert len(pnodes) == len(rnodes) == setup()[2].cfg.n_layers
    rdesc = ref_registry._REGISTRY["_flash_kernel"]
    for rn, pn in zip(rnodes, pnodes):
        assert [(tuple(g[o].shape), str(g[o].dtype)) for o in pn.operands] == \
            [(tuple(rg[o].shape), str(rg[o].dtype)) for o in rn.operands]
        assert tuple(pn.shape) == tuple(rn.shape)
        assert [g[o].kind for o in pn.operands] == [OpKind.TRANSPOSE] * 3
        desc = registry.lookup(pn)
        assert desc.name == "_flash_kernel"
        assert desc.flops(pn, g) == rdesc.flops(rn, rg)
        assert desc.scratch_bytes(pn, g) == rdesc.scratch_bytes(rn, rg)
        (B, Hq, L, Dh), hkv = g[pn.operands[0]].shape, g[pn.operands[1]].shape[1]
        assert desc.flops(pn, g) == 4.0 * B * L * Hq * hkv * Dh
