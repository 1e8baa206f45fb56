"""The port's serving path (``repro_torch.serve``) against the reference's.

Reduced qwen3-1.7b (2 layers, d_model 64) in float32, the same weights in
both packages (``params_from_jax``): the port's ``Engine`` serving through
stitched ``offline`` mode on the CPU must give the reference engine's greedy
tokens, with prefill and per-step logits within rtol/atol 2e-4.
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
from repro.models import build_model as ref_build
from repro.serve import Engine as RefEngine
from repro.serve import ServeConfig as RefServeConfig
from repro_torch.configs import get_reduced
from repro_torch.core import OpKind
from repro_torch.core.trace import trace_to_graph
from repro_torch.exec import stitch
from repro_torch.kernels import stitched
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.serve import Engine, ServeConfig

TOL = dict(rtol=2e-4, atol=2e-4)
PROMPT_LENS = np.array([5, 4, 3])
NEW_TOKENS = 6


@functools.lru_cache(maxsize=None)
def setup():
    rcfg = replace(ref_reduced("qwen3_1_7b"), dtype="float32",
                   scan_layers=False)
    cfg = replace(get_reduced("qwen3_1_7b"), dtype="float32",
                  scan_layers=False)
    rmodel = ref_build(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, rparams)
    model = build_model(cfg)
    params = params_from_jax(tree, cfg, device="cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 5))
    return rmodel, rparams, tree, model, params, prompts


@functools.lru_cache(maxsize=None)
def served():
    """(reference run, port run): tokens, prefill logits, step logits."""
    rmodel, rparams, _, model, params, prompts = setup()
    steps = NEW_TOKENS - 1

    reng = RefEngine(rmodel, rparams, RefServeConfig(
        batch=3, max_len=32, max_new_tokens=NEW_TOKENS, paged=False))
    pb = 8
    padded = np.zeros((3, pb), np.int32)
    padded[:, :5] = prompts
    rlogits0, _ = jax.jit(lambda p, t, l: rmodel.prefill(p, t, true_len=l))(
        rparams, jnp.asarray(padded), jnp.asarray(PROMPT_LENS))
    px = reng.prefill(prompts, prompt_lens=PROMPT_LENS)
    for row in range(3):
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

    eng = Engine(model, params, ServeConfig(
        batch=3, max_len=32, max_new_tokens=NEW_TOKENS, stitch_execute=True),
        device="cpu")
    logits0, _ = eng._prefill_exec(params, torch.as_tensor(padded).long(),
                                   torch.as_tensor(PROMPT_LENS, dtype=torch.int32))
    pxp = eng.prefill(prompts, prompt_lens=PROMPT_LENS)
    for row in range(3):
        eng.insert(pxp, slot=row, row=row)
    toks, steps_logits = eng.generate_step(steps=steps, return_logits=True)
    port = (np.concatenate([pxp.first_tokens[:, None], toks], 1),
            logits0.numpy(), [x.numpy() for x in steps_logits])
    return ref, port, eng


def test_tokens_equal_reference():
    ref, port, _ = served()
    np.testing.assert_array_equal(port[0], ref[0])


def test_prefill_logits_match_reference():
    ref, port, _ = served()
    np.testing.assert_allclose(port[1], ref[1], **TOL)


def test_step_logits_match_reference():
    ref, port, _ = served()
    assert len(port[2]) == len(ref[2]) == NEW_TOKENS - 1
    for p, r in zip(port[2], ref[2]):
        np.testing.assert_allclose(p, r, **TOL)


def test_stitched_decode_served_every_step():
    _, _, eng = served()
    rep = eng.report()["decode"]
    assert rep["calls"]["stitched"] == NEW_TOKENS - 1
    assert rep["calls"]["fallback"] == 0
    assert eng.report()["prefill"]["calls"]["fallback"] == 0


def test_reduced_decode_plan_has_triton_groups():
    _, _, eng = served()
    plan = eng.report()["decode"]["plan"]
    assert plan["triton_groups"] > 0
    assert plan["n_kernels"] < plan["n_ops"]
    compiled = eng._exec.compiled
    kernels = 0
    for grp in compiled.groups:
        if grp.kind == "triton":
            k = grp.tuned.callable
            # a pattern whose outputs are all views of its inputs has no
            # kernel to compile
            if isinstance(k, stitched.StitchedView):
                continue
            compile(k.source, "<stitched>", "exec")
            kernels += 1
    assert kernels > 0


def test_generate_matches_staged_tokens():
    ref, _, _ = served()
    _, _, _, model, params, prompts = setup()
    eng = Engine(model, params, ServeConfig(
        batch=3, max_len=32, max_new_tokens=NEW_TOKENS), device="cpu")
    np.testing.assert_array_equal(
        eng.generate(prompts, prompt_lens=PROMPT_LENS), ref[0])


def test_params_from_jax_round_trips():
    _, _, tree, model, params, _ = setup()
    back = params_to_numpy(params)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    assert len(params["layers"]) == model.cfg.n_layers


def test_frontend_traces_reduced_decode_step():
    _, _, _, model, params, _ = setup()
    cache = model.init_cache(3, 32, "cpu")
    cache["length"] = torch.as_tensor(PROMPT_LENS, dtype=torch.int32)
    tok = torch.zeros((3, 1), dtype=torch.long)
    g, names = trace_to_graph(lambda p, c, t: model.decode_step(p, c, t),
                              params, cache, tok, name="decode")
    g.validate()
    prims = {n.attrs.get("prim") for n in g.nodes.values()
             if n.kind is OpKind.CUSTOM}
    assert any("index_put" in str(p) for p in prims)
    assert any("embedding" in str(p) for p in prims)
    kinds = {n.kind for n in g.nodes.values()}
    assert {OpKind.GEMM, OpKind.BROADCAST, OpKind.REDUCTION} <= kinds
    assert len(g.outputs) == 4           # logits, k, v, length
    assert len(names) == len(torch.utils._pytree.tree_flatten(
        (params, cache, tok))[0])


def test_stitch_falls_back_on_drift():
    def fn(x, y):
        return {"s": torch.softmax(x, -1) * y}

    sf = stitch(fn, mode="offline", device="cpu", name="fn")
    x, y = torch.randn(4, 8), torch.randn(4, 8)
    torch.testing.assert_close(sf(x, y)["s"], fn(x, y)["s"])
    sf(torch.randn(2, 8), torch.randn(2, 8))
    rep = sf.report()
    assert rep["calls"] == {"stitched": 1, "fallback": 1, "jit": 0}
    assert rep["plan"]["triton_groups"] >= 1


def test_entry_points_need_a_card_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, _, model, params, _ = setup()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(model, params, ServeConfig(batch=1, max_len=8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stitch(lambda x: x)


def test_serve_launcher_static_cpu(capsys):
    from repro_torch.launch import serve as launcher
    launcher.main(["--arch", "qwen3-1.7b", "--reduced", "--stitch", "--dense",
                   "--mode", "static", "--device", "cpu", "--slots", "2",
                   "--prompt-len", "6", "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert "tokens/s" in out and "triton_groups" in out


@pytest.mark.parametrize("window", [None, 300])
def test_chunked_causal_attention_matches_reference(window):
    """Past 512 tokens the ref-mode prefill attends in 512-row q chunks, as
    the reference's unrolled branch does (``use_scan=False``)."""
    from repro.models.layers import _chunked_causal_attention as ref_chunked
    from repro_torch.models.layers import _chunked_causal_attention
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 1024, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 1024, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 1024, 2, 16)).astype(np.float32)
    want = ref_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25,
                       window, use_scan=False)
    got = _chunked_causal_attention(torch.as_tensor(q), torch.as_tensor(k),
                                    torch.as_tensor(v), 0.25, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _traced_prefill(model, params, S):
    g, _ = trace_to_graph(lambda p, t: model.prefill(p, t), params,
                          torch.zeros((1, S), dtype=torch.long), name="prefill")
    return g


def test_ref_mode_prefill_past_512_tokens_is_chunked():
    """At 1024 tokens no traced tensor is larger than one 512-row chunk of
    the logits, (B, Hq, 512, S): the grouped einsum's batched GEMM holds it
    as (B*Hkv, group*512, S).  The logits equal the reference's.  At 512
    tokens the prefill still takes the one-shot oracle, whose logits are
    (B, Hq, S, S)."""
    rmodel, rparams, _, model, params, _ = setup()
    Hq = model.cfg.n_heads
    g = _traced_prefill(model, params, 1024)
    assert max(n.size for n in g.nodes.values()) == Hq * 512 * 1024
    g = _traced_prefill(model, params, 512)
    assert any(tuple(n.shape) == (1, Hq, 512, 512) for n in g.nodes.values())
    toks = np.random.default_rng(12).integers(0, model.cfg.vocab, (1, 1024))
    want, _ = jax.jit(rmodel.prefill)(rparams, jnp.asarray(toks))
    got, _ = model.prefill(params, torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
