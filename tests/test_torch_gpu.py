"""Card-only checks of the port (``gpu`` marker): generated Triton
stitched kernels against their plain versions, and the stitched engine
against the eager one.  They skip without a CUDA device.  This file
imports no JAX, so it runs on a machine with only PyTorch and Triton:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.core import FusionPattern, GraphBuilder, PackPattern
from repro_torch.kernels.stitched import build_stitched_callable


def chain_graph(rows: int, cols: int, dtype: str):
    """x -> f32 -> softmax-like chain with a gamma broadcast, rows and cols
    not powers of two (masked lanes)."""
    b = GraphBuilder("chain")
    x = b.param("x", (rows, cols), dtype)
    gam = b.param("gamma", (cols,), "float32")
    xf = b.ew("convert", x, dtype="float32") if dtype != "float32" else x
    m = b.reduce("max", xf, axes=(1,))
    e = b.ew("exp", b.ew("sub", xf, b.bcast(m, (rows, cols), (0,))))
    s = b.reduce("sum", e, axes=(1,))
    y = b.ew("div", e, b.bcast(s, (rows, cols), (0,)))
    z = b.ew("mul", y, b.bcast(gam, (rows, cols), (1,)))
    out = b.ew("convert", z, dtype=dtype) if dtype != "float32" else z
    return b.build(outputs=[out])


def implicit_broadcast_graph(builder=GraphBuilder, rows: int = 12,
                             cols: int = 100, dtype: str = "float32"):
    """A softmax scaled by a per-column gamma, spelled as jnp traces it:
    the row max and sum broadcast to (rows, 1) and gamma held as (1, cols),
    each combined with the (rows, cols) values by an implicit size-1
    broadcast."""
    b = builder("implicit")
    x = b.param("x", (rows, cols), dtype)
    gam = b.param("gamma", (1, cols), "float32")
    full = (rows, cols)
    xf = b.ew("convert", x, dtype="float32") if dtype != "float32" else x
    m = b.bcast(b.reduce("max", xf, axes=(1,)), (rows, 1), (0,))
    e = b.ew("exp", b.ew("sub", xf, m, shape=full))
    s = b.bcast(b.reduce("sum", e, axes=(1,)), (rows, 1), (0,))
    z = b.ew("mul", b.ew("div", e, s, shape=full), gam, shape=full)
    out = b.ew("convert", z, dtype=dtype) if dtype != "float32" else z
    return b.build(outputs=[out])


def pack_pattern():
    """Three independent convert -> exp chains as one horizontal pack."""
    b = GraphBuilder("pack")
    xs = [b.param(f"w{i}", (64, 100)) for i in range(3)]
    chains = []
    for x in xs:
        c = b.ew("convert", x, dtype="bfloat16")
        chains.append((c, b.ew("exp", c)))
    g = b.build(outputs=[e for _, e in chains])
    groups = tuple(frozenset(ch) for ch in chains)
    return PackPattern(g, frozenset().union(*groups), "pack",
                       member_groups=groups)


def prefill_norm_graph(builder=GraphBuilder, B=4, S=64, D=2048,
                       dtype="bfloat16"):
    """A prefill's residual add + RMSNorm: the o-projection's (B*S, D)
    output reshaped to (B, S, D), added to the residual, normalized, and
    reshaped back to (B*S, D) for the next GEMM.  Rows of S*D elements are
    too wide for one block until (B, S) folds into B*S rows."""
    b = builder("prefill_norm")
    dot = b.param("dot", (B * S, D), dtype)
    res = b.param("res", (B, S, D), dtype)
    gam = b.param("gamma", (D,), "float32")
    eps = b.const("eps", (), "float32")
    h = b.ew("add", res, b.reshape(dot, (B, S, D)))
    hf = b.ew("convert", h, dtype="float32")
    var = b.reduce("mean", b.ew("mul", hf, hf), axes=(2,), keepdims=True)
    r = b.ew("rsqrt", b.ew("add", var, b.bcast(eps, (B, S, 1), ())))
    y = b.ew("mul", b.ew("mul", hf, b.bcast(r, (B, S, D), (0, 1, 2))),
             b.bcast(gam, (B, S, D), (2,)))
    out = b.reshape(b.ew("convert", y, dtype=dtype), (B * S, D))
    return b.build(outputs=[h, out])


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: Triton kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 1.6e-2)])
def test_generated_kernel_on_card(dtype, tol):
    _need_card()
    g = chain_graph(12, 100, dtype)
    p = FusionPattern(g, frozenset(n.name for n in g.compute_nodes()))
    k = build_stitched_callable(p, row_block=8)
    gen = torch.Generator().manual_seed(0)
    args = [torch.randn(tuple(g[i].shape), generator=gen)
            .to(getattr(torch, str(g[i].dtype))).cuda()
            for i in p.external_inputs]
    before = k.launches
    out = k(*args)
    ref = k.plain(*args)
    assert k.launches == before + 1
    for o, r in zip(out, ref):
        torch.testing.assert_close(o.float(), r.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 1.6e-2)])
def test_implicit_broadcast_kernel_on_card(dtype, tol):
    """Operands with size-1 dims, broadcast implicitly, in a generated
    kernel against its plain version."""
    _need_card()
    g = implicit_broadcast_graph(dtype=dtype)
    p = FusionPattern(g, frozenset(n.name for n in g.compute_nodes()))
    k = build_stitched_callable(p)
    gen = torch.Generator().manual_seed(1)
    args = [torch.randn(tuple(g[i].shape), generator=gen)
            .to(getattr(torch, str(g[i].dtype))).cuda()
            for i in p.external_inputs]
    before = k.launches
    out = k(*args)
    assert k.launches == before + 1
    for o, r in zip(out, k.plain(*args)):
        torch.testing.assert_close(o.float(), r.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_pack_kernel_on_card():
    _need_card()
    k = build_stitched_callable(pack_pattern(), row_block=8)
    ins = [torch.randn(64, 100, device="cuda") for _ in range(3)]
    for o, r in zip(k(*ins), k.plain(*ins)):
        torch.testing.assert_close(o.float(), r.float(), rtol=1.6e-2,
                                   atol=1.6e-2)


@pytest.mark.gpu
def test_folded_kernel_on_card():
    """A prefill norm with rows folded to one per token, on the card."""
    _need_card()
    g = prefill_norm_graph()
    p = FusionPattern(g, frozenset(n.name for n in g.compute_nodes()))
    k = build_stitched_callable(p)
    assert k.analysis.rows == 4 * 64
    gen = torch.Generator().manual_seed(0)
    args = [torch.randn(tuple(g[i].shape), generator=gen)
            .to(getattr(torch, str(g[i].dtype))).cuda()
            if g[i].shape else torch.tensor(1e-6, device="cuda")
            for i in p.external_inputs]
    for o, r in zip(k(*args), k.plain(*args)):
        torch.testing.assert_close(o.float(), r.float(), rtol=1.6e-2,
                                   atol=1.6e-2)


@pytest.mark.gpu
def test_stitched_engine_on_card_matches_eager():
    """Reduced qwen3 in float32 on the card: stitched tokens == eager."""
    _need_card()
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig
    cfg = replace(get_reduced("qwen3_1_7b"), dtype="float32")
    model = build_model(cfg)
    params = model.init(0, "cuda")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 5))
    lens = np.array([5, 4, 3])
    out = []
    for stitch_execute in (True, False):
        eng = Engine(model, params, ServeConfig(
            batch=3, max_len=32, max_new_tokens=6,
            stitch_execute=stitch_execute), device="cuda")
        out.append(eng.generate(prompts, prompt_lens=lens))
    np.testing.assert_array_equal(out[0], out[1])


# -- the hand-written kernels (kernel mode) -----------------------------------

# qwen3-1.7b main-path shapes, batch 4: decode rows, qk-norm rows (16 q and
# 8 kv heads of 128), prefill token rows (4 x 64)
NORM_SHAPES = [(4, 2048), (64, 128), (32, 128), (256, 2048), (4096, 128)]
GLU_SHAPES = [(4, 6144), (256, 6144)]
ROPE_SHAPES = [(4, 16), (4, 8), (256, 16)]          # (rows, heads), Dh 128
KERNEL_TOL = [("float32", 2e-5), ("bfloat16", 1.6e-2)]


def _rand(shape, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(getattr(torch, dtype)).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
def test_rmsnorm_kernel_on_card(dtype, tol):
    _need_card()
    from repro_torch.kernels import norms
    for rows, d in NORM_SHAPES:
        x, g = _rand((rows, d), dtype), _rand((d,), dtype, 1)
        before = sum(norms.launches.values())
        out = norms.rmsnorm_op(x, g, 1e-6)
        assert sum(norms.launches.values()) == before + 1
        torch.testing.assert_close(out.float(),
                                   norms.rmsnorm_plain(x, g, 1e-6).float(),
                                   rtol=tol, atol=tol)


# the CUDA norms (csrc/norms.cu): NORM_SHAPES and nemotron's decode and
# prefill rows and qwen3's bucket-256 qk-norm rows
NORM_CUDA_SHAPES = NORM_SHAPES + [(4, 6144), (1024, 6144), (16384, 128)]


def _norm(kernel, x, g, b):
    from repro_torch.kernels import norms
    if kernel == "rmsnorm":
        return norms.rmsnorm_op(x, g, 1e-6)
    return norms.layernorm_op(x, g, b, 1e-5)


def _norm_operand(rows, d, dtype, seed):
    x = 2.0 * _rand((rows, d), dtype, seed) + 0.5
    g = 1.0 + 0.1 * _rand((d,), dtype, seed + 1)
    return x, g, 0.1 * _rand((d,), dtype, seed + 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
@pytest.mark.parametrize("kernel", ["rmsnorm", "layernorm"])
def test_norm_cuda_against_plain_on_card(kernel, dtype, tol):
    """At NORM_CUDA_SHAPES and at operands laid out otherwise: rows wider
    than the row and x off 16-byte alignment (d = 2048 keeps the output's
    vector, d = 200 takes x's), and gamma off alignment."""
    _need_card()
    from repro_torch.kernels import norms
    plain = {"rmsnorm": lambda x, g, b: norms.rmsnorm_plain(x, g, 1e-6),
             "layernorm": lambda x, g, b: norms.layernorm_plain(x, g, b, 1e-5)}
    cases = [_norm_operand(rows, d, dtype, 10 * i)
             for i, (rows, d) in enumerate(NORM_CUDA_SHAPES)]
    for rows, d in ((4, 2048), (37, 200), (1, 200)):
        x, g, b = _norm_operand(rows, d + 9, dtype, rows)
        cases.append((x[:, 1:d + 1], g[:d], b[:d]))
        cases.append((x[:, :d], g[1:d + 1], b[:d]))
    for x, g, b in cases:
        out = _norm(kernel, x, g, b)
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), plain[kernel](x, g, b).float(),
                                   rtol=tol, atol=tol)


# the GLU operands of examples/torch_router_glu_breakdown.py beside
# GLU_SHAPES: recurrentgemma's scoring call, granite's experts at decode and
# prefill (rows narrower than a block, side by side), and ragged widths
GLU_CUDA_SHAPES = GLU_SHAPES + [(1024, 12288), (256, 512), (10240, 512),
                                (7, 333), (37, 40)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_glu_kernel_on_card(act, dtype, tol):
    """At GLU_CUDA_SHAPES and at row-strided operands: a column slice of a
    wider tensor (16-byte loads) and misaligned slices (one element a
    chunk)."""
    _need_card()
    from repro_torch.kernels import activations
    cases = [(_rand(s, dtype, 2 * i), _rand(s, dtype, 2 * i + 1))
             for i, s in enumerate(GLU_CUDA_SHAPES)]
    # row-strided operands (a column slice of a wider tensor) are taken as
    # they are; a transposed one is refused
    wide_g, wide_u = _rand((4, 2 * 6144), dtype), _rand((4, 2 * 6144), dtype, 1)
    cases += [(wide_g[:, :6144], wide_u[:, 6144:]),
              (wide_g[:, 1:6145], wide_u[:, 3:6147])]
    for gate, up in cases:
        out = activations.glu_op(gate, up, act)
        torch.testing.assert_close(
            out.float(), activations.glu_plain(gate, up, act).float(),
            rtol=tol, atol=tol, msg=lambda m: f"{tuple(gate.shape)} "
            f"{gate.stride()}: {m}")
    gate, up = cases[0]
    with pytest.raises(ValueError, match="contiguous"):
        activations.glu_op(gate.t(), up.t(), act)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
def test_rope_kernel_on_card(dtype, tol):
    _need_card()
    from repro_torch.kernels import rope
    for rows, heads in ROPE_SHAPES:
        x = _rand((rows, heads * 128), dtype)
        pos = torch.randint(0, 128, (rows,), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(2)).cuda()
        out = rope.rope_op(x, pos, 1e6, 128)
        torch.testing.assert_close(
            out.float(), rope.rope_plain(x, pos, 1e6, 128).float(),
            rtol=tol, atol=tol)


# (rows, heads, head_dim, row stride past the row): ROPE_SHAPES, nemotron's
# 48 q heads, head widths 64 and 256, one head (recurrentgemma's k), head_dim
# 8 (16 bytes of f32, 8 of bf16: bf16 takes the scalar path), and rows
# wider than the row, by 8 elements (16-byte loads) and by 3 (scalar)
ROPE_CASES = [(r, h, 128, 0) for r, h in ROPE_SHAPES] + [
    (4, 48, 128, 0), (1024, 48, 128, 0), (64, 16, 64, 0), (1024, 16, 256, 0),
    (1024, 1, 256, 0), (37, 1, 128, 0), (6, 4, 8, 0), (64, 16, 128, 8),
    (33, 3, 64, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
def test_rope_cuda_against_plain_on_card(dtype, tol):
    """The CUDA kernel against its plain version (the kernel's spec, every
    step rounded where the kernel rounds it) at positions up to 4096, int32
    and int64; the uncounted launch equals the op's, which counts one."""
    _need_card()
    from repro_torch.kernels import rope
    gen = torch.Generator().manual_seed(5)
    for i, (rows, heads, hd, pad) in enumerate(ROPE_CASES):
        x = _rand((rows, heads * hd + pad), dtype, 70 + i)[:, :heads * hd]
        pos = torch.randint(0, 4097, (rows,), generator=gen)
        pos[0] = 4096
        pos = (pos if i % 2 else pos.to(torch.int32)).cuda()
        before = dict(rope.launches)
        new = rope._launch_kernel(x, pos, 1e4, hd)
        torch.cuda.synchronize()
        assert dict(rope.launches) == before
        want = rope.rope_plain(x, pos, 1e4, hd).float()
        torch.testing.assert_close(new.float(), want, rtol=tol, atol=tol)
        out = rope.rope_op(x, pos, 1e4, hd)
        assert sum(rope.launches.values()) == sum(before.values()) + 1
        assert torch.equal(out, new) and out.is_contiguous()


@pytest.mark.gpu
def test_rope_kernel_refusals_on_card():
    """What the kernel does not take raises, in the wrapper or in the C entry
    point; no call falls back to another kernel."""
    _need_card()
    from repro_torch.kernels import rope
    x = _rand((8, 4 * 128), "bfloat16")
    pos = torch.arange(8, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rope.rope_op(x.half(), pos, 1e4, 128)
    with pytest.raises(TypeError, match="int32 or int64"):
        rope.rope_op(x, pos.float(), 1e4, 128)
    with pytest.raises(ValueError, match="head_dim"):
        rope.rope_op(x, pos, 1e4, 127)
    with pytest.raises(ValueError, match="nothing to rotate"):
        rope.rope_op(x[:0], pos[:0], 1e4, 128)
    with pytest.raises(ValueError, match="rows must be contiguous"):
        rope.rope_op(x.t().contiguous().t(), pos, 1e4, 128)
    with pytest.raises(ValueError, match="need a whole number"):
        rope.rope_op(_rand((2, 8192), "float32"), pos[:2], 1e4, 8192)
    # the C entry point refuses a plan that pads a head or leaves one out,
    # and 16-byte loads on a misaligned row
    lib, out = rope._lib(), torch.empty_like(x)
    freq = rope._freq(x.device, 1e4, 64)
    stream = torch.cuda.current_stream().cuda_stream

    def call(xp, R, Hc, vec):
        return lib.repro_rope(xp, pos.data_ptr(), freq.data_ptr(),
                              out.data_ptr(), 1, 0, 8, 4, 64, 512, 1, R, Hc,
                              vec, stream)
    assert call(x.data_ptr(), 2, 3, 8) == -4
    assert call(x.data_ptr(), 2, 4, 3) == -4
    assert call(x.data_ptr() + 2, 2, 4, 8) == -5
    assert b"aligned" in lib.repro_cuda_error_string(-5)
    assert call(x.data_ptr(), 2, 4, 8) == 0
    torch.cuda.synchronize()
    assert torch.equal(out, rope._launch_kernel(x, pos, 1e4, 128))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
@pytest.mark.parametrize("window", [None, 32])
def test_decode_attention_kernel_on_card(window, dtype, tol):
    """q (4, 16, 1, 128) against transposed views of a (4, 128, 8, 128)
    cache; positions at 0, in the middle, at Smax-1 and one more."""
    _need_card()
    from repro_torch.kernels import decode_attention as da
    q = _rand((4, 1, 16, 128), dtype)
    k, v = _rand((4, 128, 8, 128), dtype, 1), _rand((4, 128, 8, 128), dtype, 2)
    pos = torch.tensor([[0], [64], [127], [50]], dtype=torch.int32).cuda()
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    before = sum(da.launches.values())
    out = da.decode_attention_op(pos, qt, kt, vt, 128 ** -0.5, window)
    torch.cuda.synchronize()
    assert sum(da.launches.values()) == before + 1
    torch.testing.assert_close(
        out.float(), da.decode_attention_plain(pos, qt, kt, vt, 128 ** -0.5,
                                               window).float(),
        rtol=tol, atol=tol)


# (B, Hq, Hkv, Lq, Lkv, Dh, causal, window, q_offset): the prefill's shape
# at bucket 256; a chunk after 256 cached tokens with a window; MHA at Dh 64
# off the tile grid; rows without a valid key (qpos >= Lkv - 1 + window);
# recurrentgemma's head width 256 on one kv head (a group of 16) at its
# scoring shape, and off the 32-row tile with a window below L
FLASH_CASES = [(4, 16, 8, 256, 256, 128, True, None, 0),
               (2, 8, 4, 128, 384, 128, True, 64, 256),
               (2, 4, 4, 200, 200, 64, False, 48, 0),
               (1, 4, 2, 128, 128, 128, True, 16, 100),
               (4, 16, 1, 256, 256, 256, True, None, 0),
               (1, 16, 1, 300, 300, 256, True, 64, 0)]


def _flash_args(i, case, dtype):
    """The case's q, k, v as views strided from (B, L, H, Dh) activations."""
    B, Hq, Hkv, Lq, Lkv, Dh, causal, window, q_offset = case
    q = _rand((B, Lq, Hq, Dh), dtype, 3 * i)
    k, v = (_rand((B, Lkv, Hkv, Dh), dtype, 3 * i + j) for j in (1, 2))
    return (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            Dh ** -0.5, causal, window, q_offset)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
def test_flash_attention_kernel_on_card(dtype, tol):
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    for i, case in enumerate(FLASH_CASES):
        args = _flash_args(i, case, dtype)
        before = sum(fa.launches.values())
        out = fa.flash_attention_op(*args)
        torch.cuda.synchronize()
        assert sum(fa.launches.values()) == before + 1
        torch.testing.assert_close(out.float(),
                                   fa.flash_attention_plain(*args).float(),
                                   rtol=tol, atol=tol)
    # the same shape with a strided last dimension is refused
    qt, kt, vt = args[:3]
    bad = qt.contiguous().transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_op(bad, kt, vt, 0.1)


# bf16 cases for both flash variants at every head width the Hopper kernel
# takes: Lq 200 against Lkv 384 with a q_offset (a chunk after 184 cached
# tokens), rows without a valid key, a window across kv tiles, GQA groups
# of 6 and 16, and causal=False
FLASH_VARIANT_CASES = [(2, 12, 2, 200, 384, 64, True, None, 184),
                       (1, 4, 2, 128, 128, 64, True, 16, 100),
                       (2, 48, 8, 256, 256, 128, True, None, 0),
                       (2, 8, 4, 200, 384, 128, True, 100, 184),
                       (1, 4, 2, 128, 128, 128, True, 16, 100),
                       (2, 4, 4, 200, 200, 128, False, None, 0),
                       (2, 16, 1, 256, 256, 256, True, None, 0),
                       (1, 16, 1, 300, 300, 256, True, 64, 0),
                       (1, 8, 2, 200, 384, 256, True, None, 184)]


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["sm90", "simt"])
def test_flash_attention_variants_on_card(variant):
    """Each flash variant against the plain version in bf16 at 1.6e-2; the
    dispatch sends every case to the Hopper kernel, and a shape it refuses
    raises."""
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    for i, case in enumerate(FLASH_VARIANT_CASES):
        args = _flash_args(i, case, "bfloat16")
        ptrs = [t.data_ptr() for t in args[:3]]
        strides = [st for t in args[:3] for st in t.stride()[:3]]
        assert fa._variant(torch.bfloat16, case[5], ptrs, strides) == "sm90"
        before = fa.variant_launches[variant]
        out = fa._launch_variant(variant, *args)
        torch.cuda.synchronize()
        assert fa.variant_launches[variant] == before + 1
        torch.testing.assert_close(out.float(),
                                   fa.flash_attention_plain(*args).float(),
                                   rtol=1.6e-2, atol=1.6e-2)
    if variant == "sm90":
        # f32, a head width of 96 and a misaligned view are not the Hopper
        # kernel's: the dispatch sends them to "simt", and forcing it raises
        f32 = _flash_args(0, FLASH_VARIANT_CASES[2], "float32")
        d96 = _flash_args(0, (1, 4, 2, 64, 64, 96, True, None, 0), "bfloat16")
        for bad in (f32, d96):
            with pytest.raises(RuntimeError, match="sm90 kernel launch failed"):
                fa._launch_variant("sm90", *bad)


# split decode: (Hq, Hkv, Smax, Dh, positions, window): positions on chunk
# edges (0, C - 1, C, Smax - 1) at GQA groups 1, 6 and 8, a window across
# two chunks, a group of 16 (more than one block's 8 heads), head width
# 64, and rows without a valid key (a position past the window's reach)
def _decode_cases(C):
    return [(8, 8, 4 * C, 128, [0, C - 1, C, 4 * C - 1], None),
            (48, 8, 16 * C, 128, [0, C - 1, C, 16 * C - 1], None),
            (16, 2, 3 * C + 5, 128, [C - 1, C, 2 * C + 3, 3 * C + 4], None),
            (48, 8, 4 * C, 128, [C + 2, 2 * C, 3 * C - 1, 4 * C - 1], C // 2),
            (16, 1, 2 * C, 64, [0, C, 2 * C - 1, C // 2], None),
            (8, 2, 2 * C, 128, [4 * C, 2 * C - 1, -1, C], 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
def test_decode_attention_split_on_card(dtype, tol):
    _need_card()
    from repro_torch.kernels import decode_attention as da
    C, _ = da.chunk_plan(1)
    for i, (hq, hkv, smax, dh, pos, window) in enumerate(_decode_cases(C)):
        B = len(pos)
        q = _rand((B, 1, hq, dh), dtype, 3 * i)
        k, v = (_rand((B, smax, hkv, dh), dtype, 3 * i + j) for j in (1, 2))
        p = torch.tensor(pos, dtype=torch.int32).reshape(B, 1).cuda()
        args = (p, q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                dh ** -0.5, window)
        ref = da.decode_attention_plain(*args).float()
        before = da.variant_launches["split"]
        out = da.decode_attention_op(*args)
        torch.cuda.synchronize()
        assert da.variant_launches["split"] == before + 1
        torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)
        # deterministic: no atomics, the same bits on a second call
        assert torch.equal(da.decode_attention_op(*args), out)


# (T, E, k): a granite decode step and its bucket-256 prefill, a ragged E
# past one lane's column, the widest E the kernel takes
ROUTER_CASES = [(4, 32, 8), (1024, 32, 8), (1000, 60, 4), (512, 64, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
@pytest.mark.parametrize("renorm", [True, False])
def test_router_kernel_on_card(renorm, dtype, tol):
    """Ids equal the plain version's, weights within tolerance, at
    ROUTER_CASES and at E of 1 to 33 (lanes past E masked, and the partly
    filled second column past 32); exact ties (bf16-rounded logits, and a
    row of equal logits) take the lowest index, and -inf logits are never
    chosen ahead of finite ones."""
    _need_card()
    from repro_torch.kernels import router
    cases = []
    for i, (T, E, k) in enumerate(ROUTER_CASES):
        x = _rand((T, E), dtype, 10 + i)
        if i == 1:
            x = x.to(torch.bfloat16).to(x.dtype)
            x[0] = 0.5
        cases.append((x, k))
    cases += [(_rand((37, E), dtype, E), min(k, E))
              for E in (1, 3, 8, 17, 32, 33) for k in (1, 4, 8)]
    ties = _rand((512, 32), "bfloat16", 3).to(getattr(torch, dtype))
    ties[0] = 0.25
    ties[1::3, ::4] = -torch.inf
    cases.append((ties, 8))
    for i, (x, k) in enumerate(cases):
        before = sum(router.launches.values())
        w, ids = router.topk_router(x, k, renorm)
        torch.cuda.synchronize()
        assert sum(router.launches.values()) == before + 1
        pw, pids = router.topk_router_plain(x, k, renorm)
        torch.testing.assert_close(ids, pids, rtol=0, atol=0,
                                   msg=lambda m: f"{tuple(x.shape)} k={k}: {m}")
        torch.testing.assert_close(w.float(), pw.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"{tuple(x.shape)} k={k}: {m}")
        if i == 1 or x is ties:
            assert ids[0].tolist() == list(range(k))
    with pytest.raises(ValueError, match="contiguous"):
        router.topk_router(_rand((32, 16), dtype).t(), 2)
    with pytest.raises(ValueError, match="E <= 64"):
        router.topk_router(_rand((4, 65), dtype), 2)


@pytest.mark.gpu
def test_reduced_granite_kernel_mode_on_card():
    """Reduced granite in float32, served stitched in kernel mode: tokens
    equal the eager ref-mode engine's, and the router kernel runs once a
    layer in the prefill and in every decode step."""
    _need_card()
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig
    cfg = replace(get_reduced("granite-moe-1b-a400m"), dtype="float32")
    model = build_model(cfg)
    params = model.init(0, "cuda")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 7))
    lens = np.array([7, 5, 6])
    scfg = dict(batch=3, max_len=32, max_new_tokens=6)
    ops.reset_launch_counts()
    with ops.kernel_mode("kernels"):
        eng = Engine(model, params, ServeConfig(**scfg, stitch_execute=True),
                     device="cuda")
        toks = eng.generate(prompts, prompt_lens=lens)
    # one prefill call and five decode steps
    assert ops.launch_counts()["router"] == 6 * cfg.n_layers
    eager = Engine(model, params, ServeConfig(**scfg), device="cuda")
    np.testing.assert_array_equal(toks, eager.generate(prompts,
                                                       prompt_lens=lens))


# widening dots (bf16 operands, f32 output) shaped as a matmul: a 3-D x @ w
# at an LM head's width, a batched product, and a contraction over lhs dim
# 1, which is not a matmul and upcasts its operands
WIDENING_DOTS = [
    ((4, 256, 2048), (2048, 4096), ((2,), (0,)), ((), ()), True),
    ((8, 128, 64), (8, 64, 128), ((2,), (1,)), ((0,), (0,)), True),
    ((64, 96), (64, 80), ((0,), (0,)), ((), ()), False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("lhs_shape,rhs_shape,contract,batch,matmul",
                         WIDENING_DOTS, ids=["x3d_at_w", "bmm", "contract_0"])
def test_widening_dot_on_card(monkeypatch, lhs_shape, rhs_shape, contract,
                              batch, matmul):
    """A widening dot shaped as a matmul runs as one bf16 GEMM with an f32
    output, and agrees with the upcast f32 dot to 1e-5 of its largest
    value: each product of two bf16 values is exact in f32, so only the
    order of the f32 sums differs.  Any other contraction upcasts."""
    _need_card()
    from repro_torch.core import codegen
    from repro_torch.core.ir import OpKind, OpNode
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    taken = []
    widening = codegen._widening_matmul

    def spy(*args):
        out = widening(*args)
        taken.append(out is not None)
        return out

    monkeypatch.setattr(codegen, "_widening_matmul", spy)
    lhs = _rand(lhs_shape, "bfloat16", 1)
    rhs = _rand(rhs_shape, "bfloat16", 2)
    want = codegen._dot_general(lhs.float(), rhs.float(), contract, batch)
    kind = OpKind.BATCHED_GEMM if batch[0] else OpKind.GEMM
    node = OpNode("dot", kind, tuple(want.shape), "float32", ("a", "b"),
                  {"contract": contract, "batch": batch})
    got = codegen.dot_accumulate(node, lhs, rhs,
                                 dimension_numbers=(contract, batch))
    assert taken == [matmul]
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-5, err


# selective-scan samples (Bb, L, Dm, N): falcon-mamba-7b's scoring shape, one
# step, a ragged L, the reduced config's N, several staged chunks
SCAN_CASES = [(4, 256, 8192, 16), (1, 1, 8192, 16), (2, 33, 128, 16),
              (2, 48, 64, 8), (1, 700, 512, 16)]


def _scan_args(Bb, L, Dm, N, dtype, seed, strided):
    """x, delta, A, B, C, D as the model makes them: delta a softplus, A =
    -(1..N), B and C f32 (column views of one projection when
    ``strided``)."""
    dt = getattr(torch, dtype)
    x = _rand((Bb, L, Dm), "float32", seed).to(dt)
    delta = torch.nn.functional.softplus(
        _rand((Bb, L, Dm), "float32", seed + 1) - 1.0).to(dt)
    A = -torch.arange(1, N + 1, dtype=torch.float32, device="cuda").repeat(Dm, 1)
    dbc = 0.5 * _rand((Bb, L, 4 + 2 * N), "float32", seed + 2)
    B, C = dbc[..., 4:4 + N], dbc[..., 4 + N:]
    if not strided:
        B, C = B.contiguous(), C.contiguous()
    return x, delta, A, B, C, _rand((Dm,), "float32", seed + 3)


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True], ids=["contiguous_bc",
                                                        "strided_bc"])
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
def test_mamba_scan_kernel_on_card(dtype, tol, strided):
    """The scan kernel against its plain version, B and C contiguous or as
    strided views; the C entry point refuses what the kernel does not
    take."""
    _need_card()
    from repro_torch.kernels import mamba_scan
    for i, case in enumerate(SCAN_CASES):
        args = _scan_args(*case, dtype, 20 + i, strided)
        before = sum(mamba_scan.launches.values())
        y = mamba_scan.mamba_scan(*args)
        torch.cuda.synchronize()
        assert sum(mamba_scan.launches.values()) == before + 1
        assert y.dtype == args[0].dtype and y.is_contiguous()
        torch.testing.assert_close(y.float(),
                                   mamba_scan.mamba_scan_plain(*args).float(),
                                   rtol=tol, atol=tol)
    x, delta, A, B, C, D = _scan_args(1, 4, 64, 8, dtype, 0, strided)
    with pytest.raises(ValueError, match="outside 1..16"):
        mamba_scan.mamba_scan(x, delta, -torch.ones(64, 17, device="cuda"),
                              torch.ones(1, 4, 17, device="cuda"),
                              torch.ones(1, 4, 17, device="cuda"), D)
    other = torch.bfloat16 if dtype == "float32" else torch.float32
    with pytest.raises(ValueError, match="differ in dtype"):
        mamba_scan.mamba_scan(x, delta.to(other), A, B, C, D)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mamba_scan.mamba_scan(x.half(), delta.half(), A, B, C, D)
    with pytest.raises(ValueError, match="empty"):
        mamba_scan.mamba_scan(x[:, :0], delta[:, :0], A, B[:, :0], C[:, :0], D)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
def test_mamba_scan_variants_on_card(dtype, tol):
    """The lanes kernel against its lane-order plain version (a step's
    states added in increasing n), with B and C as strided views; one
    launch counted a call."""
    _need_card()
    from repro_torch.kernels import mamba_scan
    for i, case in enumerate(SCAN_CASES):
        args = _scan_args(*case, dtype, 30 + i, True)
        before = sum(mamba_scan.launches.values())
        new = mamba_scan.mamba_scan_op(*args)
        torch.cuda.synchronize()
        assert sum(mamba_scan.launches.values()) == before + 1
        want = mamba_scan.mamba_scan_lanes_plain(*args).float()
        torch.testing.assert_close(new.float(), want, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_reduced_falcon_mamba_kernel_mode_on_card():
    """Reduced falcon-mamba in float32, scored through stitch() in kernel
    mode: the loss and a block's output equal eager ref mode (the oracle
    loop), with one scan launch a layer a call."""
    _need_card()
    from repro_torch.configs import get_reduced
    from repro_torch.exec import stitch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    cfg = replace(get_reduced("falcon-mamba-7b"), dtype="float32")
    model = build_model(cfg)
    params = model.init(0, "cuda")
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 40)),
                                device="cuda") for k in ("tokens", "labels")}
    x = torch.as_tensor(rng.standard_normal((2, 40, cfg.d_model)),
                        dtype=torch.float32, device="cuda")
    lp = model.layer_params(params, 0)
    ops.reset_launch_counts()
    with ops.kernel_mode("kernels"):
        score = stitch(model.train_forward, device="cuda")
        block = stitch(model.block_fn, device="cuda")
        loss, _ = score(params, batch)
        y = block(lp, x)
    torch.cuda.synchronize()
    assert ops.launch_counts()["mamba_scan"] == cfg.n_layers + 1
    assert ops.launch_counts()["rmsnorm"] == cfg.n_layers + 1
    eager_loss, _ = model.train_forward(params, batch)
    torch.testing.assert_close(loss, eager_loss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y, model.block_fn(lp, x), rtol=2e-5, atol=2e-5)


# (B, L, D): recurrentgemma-9b's scoring shape, one step, a ragged L, many
# chunks of 16 steps, D off the 128-channel block
RGLRU_CASES = [(4, 256, 4096), (1, 1, 4096), (2, 37, 256), (1, 2560, 512),
               (3, 20, 100)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
def test_rg_lru_kernel_on_card(dtype, tol):
    """The RG-LRU kernel against its plain version; the C entry point
    refuses what the kernel does not take."""
    _need_card()
    from repro_torch.kernels import rg_lru
    for i, (B, L, D) in enumerate(RGLRU_CASES):
        x, ig, rg = (_rand((B, L, D), dtype, 40 + 4 * i + j) for j in range(3))
        lam = _rand((D,), "float32", 43 + 4 * i)
        before = sum(rg_lru.launches.values())
        y = rg_lru.rg_lru(x, ig, rg, lam)
        torch.cuda.synchronize()
        assert sum(rg_lru.launches.values()) == before + 1
        assert y.dtype == x.dtype and y.is_contiguous()
        torch.testing.assert_close(
            y.float(), rg_lru.rg_lru_plain(x, ig, rg, lam).float(),
            rtol=tol, atol=tol)
    x, ig, rg = (_rand((2, 8, 64), dtype, j) for j in range(3))
    lam = _rand((64,), "float32", 3)
    other = torch.bfloat16 if dtype == "float32" else torch.float32
    with pytest.raises(ValueError, match="differ in dtype"):
        rg_lru.rg_lru(x, ig.to(other), rg, lam)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rg_lru.rg_lru(x.half(), ig.half(), rg.half(), lam)
    with pytest.raises(ValueError, match="empty"):
        rg_lru.rg_lru(x[:, :0], ig[:, :0], rg[:, :0], lam)
    # channel-major: the same values with a channel stride of 8
    xs, igs, rgs = (t.transpose(1, 2).contiguous().transpose(1, 2)
                    for t in (x, ig, rg))
    with pytest.raises(ValueError, match="contiguous"):
        rg_lru.rg_lru(xs, igs, rgs, lam)


# (B, L, D) at the tiles kernel's edges: D off its 64-channel tile (and off
# a 16-byte load: the scalar path), L one step short of a 32-step chunk, a
# whole chunk, one step past it; and the gates as strided views (columns of
# one projection), which the 16-byte path takes where their strides allow
RGLRU_EDGES = [(2, 31, 4096), (2, 32, 4096), (2, 33, 4096), (3, 65, 100),
               (1, 129, 40), (2, 64, 33)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
def test_rg_lru_variants_on_card(dtype, tol):
    """The kernel at its tiles' edges and on strided gates, against the
    plain version, one launch counted each.  A few gate inputs sit below
    -87.3, where the kernel leaves its branch-free operations for the IEEE
    ones."""
    _need_card()
    from repro_torch.kernels import rg_lru
    for i, (B, L, D) in enumerate(RGLRU_CASES + RGLRU_EDGES):
        x, ig, rg = (_rand((B, L, D), dtype, 60 + 4 * i + j) for j in range(3))
        lam = _rand((D,), "float32", 63 + 4 * i)
        if i % 2:   # the gates as views of one (B, L, 2D) projection
            gates = _rand((B, L, 2 * D), dtype, 90 + i)
            ig, rg = gates[..., :D], gates[..., D:]
        ig[..., ::37] = -88.0    # 1 + exp(88) lies in [2^126, inf)
        rg[:, ::5, ::29] = -100.0  # 1 + exp(100) is inf
        before = sum(rg_lru.launches.values())
        new = rg_lru.rg_lru(x, ig, rg, lam)
        torch.cuda.synchronize()
        assert sum(rg_lru.launches.values()) == before + 1
        want = rg_lru.rg_lru_plain(x, ig, rg, lam).float()
        torch.testing.assert_close(new.float(), want, rtol=tol, atol=tol)


@pytest.mark.gpu
def test_rg_lru_newton_ops_exact_on_card():
    """The tiles kernel's branch-free reciprocal and square root equal the
    IEEE division and sqrtf at every float of their domains."""
    _need_card()
    from repro_torch.kernels import rg_lru
    assert rg_lru.newton_mismatches("cuda") == (0, 0)


@pytest.mark.gpu
def test_reduced_recurrentgemma_kernel_mode_on_card():
    """Reduced recurrentgemma in float32, scored through stitch() in kernel
    mode at S = 128 (flash in the attention layer, window 16): the loss and
    a recurrent block's output equal eager ref mode, with one RG-LRU launch a
    recurrent layer and one flash launch an attention layer a call."""
    _need_card()
    from repro_torch.configs import get_reduced
    from repro_torch.exec import stitch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    cfg = replace(get_reduced("recurrentgemma-9b"), dtype="float32")
    model = build_model(cfg)
    params = model.init(0, "cuda")
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab, (2, 128)),
                                device="cuda") for k in ("tokens", "labels")}
    x = torch.as_tensor(rng.standard_normal((2, 128, cfg.d_model)),
                        dtype=torch.float32, device="cuda")
    lp = params["supers"][0]["l0"]
    ops.reset_launch_counts()
    with ops.kernel_mode("kernels"):
        score = stitch(model.train_forward, device="cuda")
        block = stitch(model.block_fn, device="cuda")
        loss, _ = score(params, batch)
        y = block(lp, x)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["rg_lru"] == 4 + 1
    assert counts["flash_attention"] == 1 and counts["rope"] == 2
    assert counts["rmsnorm"] == 2 * cfg.n_layers + 1 + 2
    assert counts["glu"] == cfg.n_layers + 1
    eager_loss, _ = model.train_forward(params, batch)
    torch.testing.assert_close(loss, eager_loss, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y, model.block_fn(lp, x), rtol=2e-5, atol=2e-5)


# nemotron-4-15b's main-path shapes, batch 4: decode rows and bucket-256
# prefill token rows at d_model 6144 (LayerNorm) and d_ff 24576 (squared
# ReLU); a ragged width below one block and one off the power of two
LN_SHAPES = [(4, 6144), (1024, 6144), (37, 96), (3, 200)]
SQRELU_SHAPES = [(4, 24576), (1024, 24576), (37, 96)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
def test_layernorm_kernel_on_card(dtype, tol):
    _need_card()
    from repro_torch.kernels import norms
    for i, (rows, d) in enumerate(LN_SHAPES):
        x = 2.0 * _rand((rows, d), dtype, i) + 0.5
        g = 1.0 + 0.1 * _rand((d,), dtype, 10 + i)
        b = 0.1 * _rand((d,), dtype, 20 + i)
        before = sum(norms.layernorm_launches.values())
        out = norms.layernorm_op(x, g, b, 1e-5)
        torch.cuda.synchronize()
        assert sum(norms.layernorm_launches.values()) == before + 1
        torch.testing.assert_close(
            out.float(), norms.layernorm_plain(x, g, b, 1e-5).float(),
            rtol=tol, atol=tol)
    # row-strided x (a column slice) is taken; a transposed one is refused
    wide = _rand((4, 2 * 6144), dtype, 5)[:, 6144:]
    g, b = _rand((6144,), dtype, 6), _rand((6144,), dtype, 7)
    torch.testing.assert_close(norms.layernorm_op(wide, g, b, 1e-5).float(),
                               norms.layernorm_plain(wide, g, b, 1e-5).float(),
                               rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="contiguous"):
        norms.layernorm_op(_rand((96, 37), dtype).t(), g[:96], b[:96], 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_squared_relu_kernel_on_card(dtype):
    """Bitwise equal to the plain version (one max, one product, one cast),
    on inputs half negative with exact zeros, NaN and infinities."""
    _need_card()
    from repro_torch.kernels import activations
    for i, shape in enumerate(SQRELU_SHAPES):
        x = _rand(shape, dtype, 30 + i)
        x.view(-1)[::5] = 0.0
        x.view(-1)[:3] = torch.tensor([float("nan"), float("inf"),
                                       -float("inf")])
        before = sum(activations.sqrelu_launches.values())
        out = activations.squared_relu_op(x)
        torch.cuda.synchronize()
        assert sum(activations.sqrelu_launches.values()) == before + 1
        torch.testing.assert_close(out, activations.squared_relu_plain(x),
                                   rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError, match="contiguous"):
        activations.squared_relu_op(_rand((96, 37), dtype).t())


@pytest.mark.gpu
def test_reduced_nemotron_kernel_mode_on_card():
    """Reduced nemotron in float32 with seeded norms, served stitched in
    kernel mode: tokens equal the eager ref-mode engine's, with 2L+1
    LayerNorm and L squared-ReLU launches a prefill call and a decode
    step."""
    _need_card()
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig
    cfg = replace(get_reduced("nemotron-4-15b"), dtype="float32")
    model = build_model(cfg)
    params = model.init(0, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    for norm in [lp[k] for lp in params["layers"] for k in ("norm1", "norm2")] \
            + [params["final_norm"]]:
        norm["g"] = 1 + 0.1 * torch.randn(norm["g"].shape, generator=gen,
                                          device="cuda")
        norm["b"] = 0.1 * torch.randn(norm["b"].shape, generator=gen,
                                      device="cuda")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (3, 7))
    lens = np.array([7, 5, 6])
    scfg = dict(batch=3, max_len=32, max_new_tokens=6)
    ops.reset_launch_counts()
    with ops.kernel_mode("kernels"):
        eng = Engine(model, params, ServeConfig(**scfg, stitch_execute=True),
                     device="cuda")
        toks = eng.generate(prompts, prompt_lens=lens)
    # one prefill call and five decode steps
    counts = ops.launch_counts()
    assert counts["layernorm"] == 6 * (2 * cfg.n_layers + 1)
    assert counts["squared_relu"] == 6 * cfg.n_layers
    assert counts["rmsnorm"] == counts["glu"] == 0
    eager = Engine(model, params, ServeConfig(**scfg), device="cuda")
    np.testing.assert_array_equal(toks, eager.generate(prompts,
                                                       prompt_lens=lens))


RESIDUAL_SHAPES = [(1024, 2048), (4, 2048), (7, 333)]
# (rows, d, scale): a ragged width, the reference benchmark's softmax, a
# vocabulary row (151936 columns, past the one-pass block) and a wide row
# that is no multiple of the sweep block
SOFTMAX_SHAPES = [(7, 333, 1.0), (2048, 1024, 0.125), (4, 151936, 1 / 0.7),
                  (3, 10001, 0.5)]
XENT_SHAPES = [(64, 151936), (33, 2500), (7, 333)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
def test_rmsnorm_residual_kernel_on_card(dtype, tol):
    """Both outputs against the plain version; the new residual (x + res
    rounded once) bitwise."""
    _need_card()
    from repro_torch.kernels import norms
    for i, (rows, d) in enumerate(RESIDUAL_SHAPES):
        x, r = _rand((rows, d), dtype, i), _rand((rows, d), dtype, 10 + i)
        g = 1.0 + 0.1 * _rand((d,), dtype, 20 + i)
        before = sum(norms.residual_launches.values())
        normed, new_res = norms.rmsnorm_residual_op(x, r, g, 1e-6)
        torch.cuda.synchronize()
        assert sum(norms.residual_launches.values()) == before + 1
        want = norms.rmsnorm_residual_plain(x, r, g, 1e-6)
        torch.testing.assert_close(normed.float(), want[0].float(), rtol=tol,
                                   atol=tol)
        torch.testing.assert_close(new_res, want[1], rtol=0, atol=0)
    # row-strided operands are taken; a transposed one is refused
    wide = _rand((4, 2 * 2048), dtype, 5)
    g = _rand((2048,), dtype, 6)
    got = norms.rmsnorm_residual_op(wide[:, :2048], wide[:, 2048:], g, 1e-6)
    want = norms.rmsnorm_residual_plain(wide[:, :2048], wide[:, 2048:], g, 1e-6)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="contiguous"):
        norms.rmsnorm_residual_op(wide[:, :96].t(), wide[:, 96:192].t(),
                                  g[:4], 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
def test_softmax_kernel_on_card(dtype, tol):
    """The one-pass and the two-sweep layouts against the plain version; a
    row of -inf and a row holding a NaN come out NaN, as in the
    reference."""
    _need_card()
    from repro_torch.kernels import softmax
    for i, (rows, d, scale) in enumerate(SOFTMAX_SHAPES):
        x = 3.0 * _rand((rows, d), dtype, 40 + i)
        x[1] = -float("inf")
        x[2, d // 2] = float("nan")
        before = sum(softmax.launches.values())
        out = softmax.softmax_op(x, scale)
        torch.cuda.synchronize()
        assert sum(softmax.launches.values()) == before + 1
        want = softmax.softmax_plain(x, scale)
        assert torch.isnan(want[1:3]).all() and torch.isnan(out[1:3]).all()
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=tol, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_softmax_split_on_card(masked, dtype, tol):
    """Rows wider than one block: the split layout against its plain
    version (``softmax_split_plain``), with a row of -inf (NaN) or a
    fully masked row (0); one launch counted a call."""
    _need_card()
    from repro_torch.kernels import softmax
    for i, (rows, d, scale) in enumerate([(4, 151936, 1.0), (3, 10001, 0.7),
                                          (2, 8193, 2.0)]):
        x = 3.0 * _rand((rows, d), dtype, 70 + i)
        mask = None
        if masked:
            gen = torch.Generator().manual_seed(80 + i)
            mask = (torch.rand((rows, d), generator=gen) < 0.6).cuda()
            mask[0] = False
        else:
            x[1] = -float("inf")
        counts = softmax.masked_launches if masked else softmax.launches
        before = sum(counts.values())
        new = (softmax.softmax_masked_op(x, mask, scale) if masked
               else softmax.softmax_op(x, scale))
        torch.cuda.synchronize()
        assert sum(counts.values()) == before + 1
        want = softmax.softmax_split_plain(x, scale, mask).float()
        torch.testing.assert_close(new.float(), want, rtol=tol, atol=tol,
                                   equal_nan=True)
        if masked:
            assert (new[0] == 0).all()
        else:
            assert torch.isnan(new[1]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
def test_softmax_masked_kernel_on_card(dtype, tol):
    """Random masks with a fully masked row (exactly 0), a row masked in
    its first half (the wide layout's first sweep steps see only -inf) and
    a fully kept row, in both layouts."""
    _need_card()
    from repro_torch.kernels import softmax
    for i, (rows, d, scale) in enumerate([(64, 256, 128 ** -0.5),
                                          (6, 333, 1.0), (4, 151936, 0.5),
                                          (3, 10001, 1.0)]):
        x = 3.0 * _rand((rows, d), dtype, 50 + i)
        gen = torch.Generator().manual_seed(60 + i)
        mask = (torch.rand((rows, d), generator=gen) < 0.6).cuda()
        mask[0] = False
        mask[1, : d // 2] = False
        mask[2] = True
        before = sum(softmax.masked_launches.values())
        out = softmax.softmax_masked_op(x, mask, scale)
        torch.cuda.synchronize()
        assert sum(softmax.masked_launches.values()) == before + 1
        assert (out[0] == 0).all() and (out[~mask] == 0).all()
        assert torch.isfinite(out).all()
        torch.testing.assert_close(
            out.float(), softmax.softmax_masked_plain(x, mask, scale).float(),
            rtol=tol, atol=tol)


def _same_bits(a, b) -> bool:
    """Equal bit patterns, NaN included."""
    ints = {4: torch.int32, 2: torch.int16}
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(ints[a.element_size()]),
        b.contiguous().view(ints[b.element_size()]))


def _masked_variants(x, mask, scale):
    from repro_torch.kernels import softmax
    new = softmax._launch_variant("cuda", x, mask, scale)
    old = softmax._launch_variant("triton", x, mask, scale)
    torch.cuda.synchronize()
    return new, old


def _attention_scores(dtype, seed):
    """The kernel API's masked attention rows: (4 * 16 * 256, 256) scores
    under the long prompts' padding mask, expanded over 16 q heads."""
    import chip_smoke
    lens = chip_smoke.LONG_LENS
    L = int(lens.max())
    x = 4.0 * _rand((len(lens) * 16 * L, L), dtype, seed)
    mask = chip_smoke.padding_mask(lens, L, "cuda")
    return x, mask.expand(len(lens), 16, L, L).reshape(-1, L)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_masked_cuda_equals_triton_on_card(dtype):
    """At the kernel API's (16384, 256) attention operand and its mask (a
    quarter of the rows fully masked) the CUDA kernel gives the Triton
    kernel's bits; its fully masked rows are +0."""
    _need_card()
    x, mask = _attention_scores(dtype, 90)
    new, old = _masked_variants(x, mask, 128 ** -0.5)
    assert _same_bits(new, old), int((new != old).sum())
    empty = ~mask.any(-1)
    assert empty.sum() == 4432
    assert (new[empty].view(torch.int16 if dtype == "bfloat16"
                            else torch.int32) == 0).all()


def _masked_edge_cases(dtype):
    """(name, x, mask): ragged widths from 1 to 8192 (one-pass layouts of
    1 to 8 warps a row, V of 1 to 16), rows strided in x and in the mask,
    a misaligned x, rows fully masked, masked in their first half and fully
    kept, and NaN and infinities at kept and masked lanes."""
    cases = []
    for i, (rows, d) in enumerate([(7, 1), (5, 3), (9, 16), (300, 128),
                                   (6, 333), (33, 512), (3, 1000),
                                   (4, 1024), (2, 2048), (3, 4097),
                                   (2, 8192), (1, 256), (2, 256)]):
        x = 3.0 * _rand((rows, d), dtype, 100 + i)
        gen = torch.Generator().manual_seed(200 + i)
        mask = (torch.rand((rows, d), generator=gen) < 0.6).cuda()
        if rows > 2:
            mask[0] = False
            mask[1, : d // 2] = False
            mask[2] = True
        cases.append((f"{rows}x{d}", x, mask))
    x = 3.0 * _rand((40, 640), dtype, 300)
    mask = (torch.rand((40, 640), generator=torch.Generator().manual_seed(
        301)) < 0.5).cuda()
    cases.append(("strided", x[:, 64:576], mask[:, 64:576]))
    cases.append(("misaligned", x[:, 1:257], mask[:, 3:259]))
    cases.append(("strided_ragged", x[:, 5:338], mask[:, 7:340]))
    x = 3.0 * _rand((16, 256), dtype, 302)
    mask = (torch.rand((16, 256), generator=torch.Generator().manual_seed(
        303)) < 0.5).cuda()
    x[2, 5], x[3, 7], x[4, 9], x[5, 11] = (float("nan"), float("inf"),
                                           -float("inf"), float("nan"))
    mask[2, 5] = mask[3, 7] = mask[4, 9] = True
    mask[5, 11] = False
    x[6] = -float("inf")
    mask[7] = True
    mask[8] = False
    x[9, ::2] = float("inf")
    cases.append(("special", x, mask))
    return cases


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_masked_cuda_equals_triton_at_edges_on_card(dtype):
    _need_card()
    for name, x, mask in _masked_edge_cases(dtype):
        new, old = _masked_variants(x, mask, 0.7)
        assert _same_bits(new, old), (name, int((new != old).sum()))
        rows_out = ~mask.any(-1)
        assert (new[rows_out] == 0).all() and not torch.signbit(
            new[rows_out]).any(), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
def test_softmax_masked_cuda_against_plain_on_card(dtype, tol):
    """The op's CUDA kernel against the plain version, NaN at the same
    places, at the attention operand and the edge cases; one launch
    counted a call."""
    _need_card()
    from repro_torch.kernels import softmax
    x, mask = _attention_scores(dtype, 91)
    for name, x, mask in [("attention", x, mask), *_masked_edge_cases(dtype)]:
        before = sum(softmax.masked_launches.values())
        out = softmax.softmax_masked_op(x, mask, 0.7)
        torch.cuda.synchronize()
        assert sum(softmax.masked_launches.values()) == before + 1
        want = softmax.softmax_masked_plain(x, mask, 0.7)
        assert torch.equal(torch.isnan(out), torch.isnan(want)), name
        torch.testing.assert_close(out.float(), want.float(), rtol=tol,
                                   atol=tol, equal_nan=True, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_kernel_on_card(dtype):
    """Per-row losses (f32) against the plain version within the f32
    tolerance, for f32 and bf16 logits; labels at both ends of the row."""
    _need_card()
    from repro_torch.kernels import cross_entropy
    for i, (rows, V) in enumerate(XENT_SHAPES):
        x = 4.0 * _rand((rows, V), dtype, 70 + i)
        gen = torch.Generator().manual_seed(80 + i)
        lab = torch.randint(0, V, (rows,), generator=gen, dtype=torch.int32)
        lab[0], lab[1] = 0, V - 1
        lab = lab.cuda()
        before = sum(cross_entropy.launches.values())
        out = cross_entropy.cross_entropy_op(x, lab)
        torch.cuda.synchronize()
        assert sum(cross_entropy.launches.values()) == before + 1
        assert out.shape == (rows,) and out.dtype == torch.float32
        torch.testing.assert_close(out, cross_entropy.cross_entropy_plain(x, lab),
                                   rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="int32"):
        cross_entropy.cross_entropy_op(x, lab.long())


@pytest.mark.gpu
def test_kernel_api_paths_on_card():
    """The three kernel-API functions of ``chip_smoke.py`` at a small size,
    through ``stitch()`` in kernel mode: exactly their kernels' launches
    a call, and the outputs of eager ref mode (f32), the fully masked
    query rows 0."""
    _need_card()
    import chip_smoke
    from repro_torch.exec import stitch
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    lens = [8, 5]
    cases = {
        "seam": (chip_smoke.seam_loss,
                 (rnd(2, 8, 64), rnd(2, 8, 64), 1 + 0.1 * rnd(64),
                  rnd(64, 2500) / 8,
                  torch.randint(0, 2500, (16,), generator=gen, device="cuda",
                                dtype=torch.int32)),
                 {"rmsnorm_residual": 1, "cross_entropy": 1}),
        "attn": (chip_smoke.masked_attention,
                 (rnd(2, 8, 2, 16), rnd(2, 8, 1, 16), rnd(2, 8, 1, 16),
                  chip_smoke.padding_mask(lens, 8, "cuda")),
                 {"softmax_masked": 1}),
        "probs": (chip_smoke.vocab_probs, (rnd(4, 10001),), {"softmax": 1}),
    }
    for name, (fn, args, launched) in cases.items():
        with ops.kernel_mode("kernels"):
            sf = stitch(fn, device="cuda")
            sf(*args)
        ops.reset_launch_counts()
        got = sf(*args)
        counts = ops.launch_counts()
        assert {k: v for k, v in counts.items() if v} == launched, name
        want = fn(*args)
        got, want = (o if isinstance(o, tuple) else (o,) for o in (got, want))
        for a, b in zip(got, want):
            if name == "attn":
                assert (a[1, 5:] == 0).all() and torch.isnan(b[1, 5:]).all()
                a, b = a[:, :5], b[:, :5]
            torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_cuda_library_builds_from_an_empty_directory(tmp_path):
    _need_card()
    import ctypes
    from repro_torch.kernels import build
    libs = {p.stem: build.library(p.stem, out_dir=tmp_path)
            for p in build.CSRC.glob("*.cu")}
    assert all(path.parent == tmp_path for path in libs.values())
    for stem, fn in (("decode_attention", "repro_decode_attention"),
                     ("flash_attention", "repro_flash_attention"),
                     ("flash_attention_sm90", "repro_flash_attention_sm90"),
                     ("router", "repro_topk_router"),
                     ("activations", "repro_glu"),
                     ("mamba_scan", "repro_mamba_scan"),
                     ("rg_lru", "repro_rg_lru"),
                     ("rope", "repro_rope"),
                     ("softmax", "repro_softmax_masked")):
        lib = ctypes.CDLL(str(libs[stem]))
        assert hasattr(lib, fn)
        assert "registers" in libs[stem].with_suffix(".log").read_text()
