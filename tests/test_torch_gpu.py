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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_glu_kernel_on_card(act, dtype, tol):
    _need_card()
    from repro_torch.kernels import activations
    for shape in GLU_SHAPES:
        gate, up = _rand(shape, dtype), _rand(shape, dtype, 1)
        out = activations.glu_op(gate, up, act)
        torch.testing.assert_close(
            out.float(), activations.glu_plain(gate, up, act).float(),
            rtol=tol, atol=tol)
    # row-strided operands (a column slice of a wider tensor) are taken as
    # they are; a transposed one is refused
    wide_g, wide_u = _rand((4, 2 * 6144), dtype), _rand((4, 2 * 6144), dtype, 1)
    g2, u2 = wide_g[:, :6144], wide_u[:, 6144:]
    torch.testing.assert_close(activations.glu_op(g2, u2, act).float(),
                               activations.glu_plain(g2, u2, act).float(),
                               rtol=tol, atol=tol)
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
# off the tile grid; rows without a valid key (qpos >= Lkv - 1 + window)
FLASH_CASES = [(4, 16, 8, 256, 256, 128, True, None, 0),
               (2, 8, 4, 128, 384, 128, True, 64, 256),
               (2, 4, 4, 200, 200, 64, False, 48, 0),
               (1, 4, 2, 128, 128, 128, True, 16, 100)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", KERNEL_TOL)
def test_flash_attention_kernel_on_card(dtype, tol):
    _need_card()
    from repro_torch.kernels import flash_attention as fa
    for i, (B, Hq, Hkv, Lq, Lkv, Dh, causal, window, q_offset) in \
            enumerate(FLASH_CASES):
        q = _rand((B, Lq, Hq, Dh), dtype, 3 * i)
        k, v = (_rand((B, Lkv, Hkv, Dh), dtype, 3 * i + j) for j in (1, 2))
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        args = (qt, kt, vt, Dh ** -0.5, causal, window, q_offset)
        before = sum(fa.launches.values())
        out = fa.flash_attention_op(*args)
        torch.cuda.synchronize()
        assert sum(fa.launches.values()) == before + 1
        torch.testing.assert_close(out.float(),
                                   fa.flash_attention_plain(*args).float(),
                                   rtol=tol, atol=tol)
    # the same shape with a strided last dimension is refused
    bad = qt.contiguous().transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_op(bad, kt, vt, 0.1)


@pytest.mark.gpu
def test_cuda_library_builds_from_an_empty_directory(tmp_path):
    _need_card()
    import ctypes
    from repro_torch.kernels import build
    libs = {p.stem: build.library(p.stem, out_dir=tmp_path)
            for p in build.CSRC.glob("*.cu")}
    assert all(path.parent == tmp_path for path in libs.values())
    for stem in ("decode_attention", "flash_attention"):
        lib = ctypes.CDLL(str(libs[stem]))
        assert hasattr(lib, f"repro_{stem}")
        assert "registers" in libs[stem].with_suffix(".log").read_text()
