"""The port's hand-written kernels (``repro_torch.kernels``) against the
reference's Pallas kernels.

On the CPU each kernel's custom op runs its plain version, so these tests
hold the plain versions against the reference kernels run in interpret
mode, on the same numpy inputs: RMSNorm, SwiGLU/GeGLU, RoPE, decode
attention and flash attention (LayerNorm's and squared ReLU's are in
``tests/test_torch_nemotron.py``, the MoE router's in
``tests/test_torch_moe.py``, the selective scan's in
``tests/test_torch_mamba.py``, the RG-LRU's in
``tests/test_torch_griffin.py``), in float32 (rtol/atol 2e-4, the reference's
own tolerance) and bfloat16 (1.6e-2: one bf16 rounding step of the outputs, which both sides
cast from f32).  They also run ``torch.library.opcheck`` on the custom
ops (the selective scan's and the RG-LRU's oracle ops too), check the mode switch, and drive the CUDA build with a stand-in
compiler.  The kernels themselves run only on the card
(``tests/test_torch_gpu.py``).
"""

from __future__ import annotations

import inspect
import stat
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import activations as ref_act
from repro.kernels import decode_attention as ref_decode
from repro.kernels import flash_attention as ref_flash
from repro.kernels import norms as ref_norms
from repro.kernels import rope as ref_rope
from repro_torch.kernels import activations, build, decode_attention, norms, ops
from repro_torch.kernels import cross_entropy, flash_attention, mamba_scan
from repro_torch.kernels import ref, rg_lru, rope, router, softmax

DTYPES = [("float32", 2e-4), ("bfloat16", 1.6e-2)]


def _pair(a: np.ndarray, dtype: str):
    """The same values in both frameworks (bf16 rounds the same way)."""
    if np.issubdtype(a.dtype, np.integer):
        return jnp.asarray(a), torch.as_tensor(a)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.as_tensor(a).to(getattr(torch, dtype)))


def _close(port: torch.Tensor, reference, tol: float):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(reference, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_rmsnorm_plain_matches_reference_kernel(dtype, tol):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(96)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jg, tg = _pair(g, dtype)
    out = norms.rmsnorm(tx, tg, 1e-6)
    assert out.shape == tx.shape and out.dtype == tx.dtype
    _close(out, ref_norms.rmsnorm(jx, jg, 1e-6, block_rows=4), tol)


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_glu_plain_matches_reference_kernel(act, dtype, tol):
    rng = np.random.default_rng(1)
    gate = (2.0 * rng.standard_normal((2, 6, 160))).astype(np.float32)
    up = rng.standard_normal((2, 6, 160)).astype(np.float32)
    jg, tg = _pair(gate, dtype)
    ju, tu = _pair(up, dtype)
    out = getattr(activations, act)(tg, tu)
    assert out.shape == tg.shape and out.dtype == tg.dtype
    _close(out, getattr(ref_act, act)(jg, ju, block_rows=4), tol)


# (B, L, H, Dh): a small case, nemotron's 48 q heads, head widths 64
# (granite-moe) and 256 (recurrentgemma, one kv head)
ROPE_REF_CASES = [pytest.param(dt, tol, (2, 5, 4, 16), id=f"{dt}-{tol}")
                  for dt, tol in DTYPES] + [
    pytest.param(dt, tol, shape, id=f"{dt}-{tol}-{'x'.join(map(str, shape))}")
    for shape in ((1, 3, 48, 16), (2, 3, 4, 64), (1, 4, 1, 256))
    for dt, tol in DTYPES]


@pytest.mark.parametrize("dtype,tol,shape", ROPE_REF_CASES)
def test_rope_plain_matches_reference_kernel(dtype, tol, shape):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, 127, shape[:2]).astype(np.int32)
    jx, tx = _pair(x, dtype)
    jp, tp = _pair(pos, dtype)
    out = rope.rope(tx, tp, 1e6)
    assert out.shape == tx.shape and out.dtype == tx.dtype
    _close(out, ref_rope.rope(jx, jp, 1e6, block_rows=4), tol)


@pytest.mark.parametrize("head_dim,theta", [(128, 1e6), (128, 1e4),
                                            (256, 1e4)])
def test_rope_op_matches_reference_rope_to_position_4096(head_dim, theta):
    """The port's op (on the CPU its plain version, the kernel's spec:
    freq and the trig functions through f64, each rounded once to f32)
    against the reference's ``rope`` (interpret mode) in f32 at positions
    spread over 0-4096 and drawn past 2560 (recurrentgemma's f32 check runs
    2560 tokens), at 2e-5: an ulp off in freq would be pos ulps off in the
    angle."""
    rng = np.random.default_rng(11)
    L, H = 96, 2
    x = rng.standard_normal((2, L, H, head_dim)).astype(np.float32)
    pos = np.stack([np.linspace(0, 4096, L).round(),
                    rng.integers(2561, 4097, L)]).astype(np.int32)
    assert pos.min() == 0 and pos.max() == 4096
    jx, tx = _pair(x, "float32")
    jp, tp = _pair(pos, "float32")
    out = rope.rope(tx, tp, theta)
    _close(out, ref_rope.rope(jx, jp, theta, block_rows=32), 2e-5)


# (rows, heads, half, vec): every path's q and k at a decode step (4 rows)
# and a bucket-256 prefill (1024), in bf16 (8 elements a 16-byte load) and
# f32 (4); qwen3's bucket-64 prefill; ragged heads and rows; the scalar path
ROPE_PLANS = [(rows, heads, half, vec)
              for rows in (4, 1024)
              for heads, half in ((16, 64), (8, 64), (48, 64), (16, 128),
                                  (1, 128), (16, 32), (8, 32))
              for vec in (8, 4)] + [
    (256, 16, 64, 8), (256, 8, 64, 8), (6, 3, 32, 8), (7, 5, 4, 1),
    (1, 4, 64, 8), (3, 2, 128, 1)]


@pytest.mark.parametrize("rows,heads,half,vec", ROPE_PLANS)
def test_rope_block_plan(rows, heads, half, vec):
    """The CUDA kernel's blocks: whole heads (Hc divides H, no head padded),
    2 rows a block, a row's heads whole where they fit 128 threads, at
    least 8 blocks at a decode step's 4 rows and at least 2 an SM once the
    heads allow, and no block past the kernel's 512 rotating threads."""
    R, Hc = rope.block_plan(rows, heads, half, vec)
    lanes = half // vec
    blocks = -(-rows // R) * (heads // Hc)
    assert heads % Hc == 0 and R == min(rows, 2)
    assert R * Hc * lanes <= 512
    assert Hc * lanes <= 128 or Hc == 1
    if rows == 4 and heads >= 4:
        assert blocks >= 8
    if Hc > 1:
        assert blocks >= 2 * rope.SMS
    if rows == 1024:   # prefill: the widest chunk of heads that fits
        wider = [d for d in range(Hc + 1, heads + 1) if heads % d == 0]
        assert not wider or wider[0] * lanes > 128


def test_rope_block_plan_refuses_what_no_block_takes():
    with pytest.raises(ValueError, match="whole number"):
        rope.block_plan(4, 8, 4, 8)            # half 4 of a 16-byte load
    with pytest.raises(ValueError, match="whole number"):
        rope.block_plan(4, 1, 1024, 1)         # 1024 threads a half-head
    with pytest.raises(ValueError, match="nothing to rotate"):
        rope.block_plan(0, 8, 64, 8)


@pytest.mark.parametrize("half,itemsize,ptr,stride,vec", [
    (64, 2, 0x1000, 2048, 8), (64, 4, 0x1000, 2048, 4),
    (4, 2, 0x1000, 32, 1),          # bf16 head_dim 8: 8 bytes a half
    (4, 4, 0x1000, 32, 4),          # f32 head_dim 8: 16 bytes
    (64, 2, 0x1002, 2048, 1),       # x 2 bytes off 16
    (64, 2, 0x1000, 2051, 1),       # a row 6 bytes past 16
    (64, 2, 0x1000, 2056, 8),       # rows wider by 16 bytes
    (3, 4, 0x1000, 12, 1)])
def test_rope_vector_width(half, itemsize, ptr, stride, vec):
    """16-byte loads only where every load is 16-byte aligned."""
    assert rope.vector_width(half, itemsize, ptr, stride) == vec


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("window", [None, 8])
def test_decode_attention_plain_matches_reference_kernel(window, dtype, tol):
    """Smax 48 with block_k 32: the reference's key block falls to 24, a
    divisor, so its online softmax runs over two blocks.  GQA group 2;
    positions at 0, in the middle and at Smax-1."""
    rng = np.random.default_rng(3)
    B, Hq, Hkv, S, Dh = 3, 4, 2, 48, 32
    q = rng.standard_normal((B, 1, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    pos = np.array([0, 20, S - 1], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    jp, tp = _pair(pos, dtype)
    out = decode_attention.decode_attention(tq, tk, tv, tp, window=window)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    want = ref_decode.decode_attention(jq, jk, jv, jp, window=window,
                                       block_k=32)
    _close(out, want, tol)


def test_decode_attention_takes_strided_views():
    """The kernel's operands are transposed views of the cache; the plain
    version gives the same result on the views as on contiguous copies."""
    rng = np.random.default_rng(4)
    q = torch.as_tensor(rng.standard_normal((2, 1, 4, 16)), dtype=torch.float32)
    k = torch.as_tensor(rng.standard_normal((2, 12, 2, 16)), dtype=torch.float32)
    v = torch.as_tensor(rng.standard_normal((2, 12, 2, 16)), dtype=torch.float32)
    pos = torch.tensor([[5], [11]], dtype=torch.int32)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    assert not kt.is_contiguous()
    a = decode_attention.decode_attention_plain(pos, qt, kt, vt, 0.25)
    b = decode_attention.decode_attention_plain(
        pos, qt.contiguous(), kt.contiguous(), vt.contiguous(), 0.25)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.is_contiguous() and a.shape == (2, 4, 1, 16)


# (B, Hq, Hkv, Lq, Lkv, Dh, causal, window, q_offset); with block_q =
# block_k = 32 the reference walks 2 to 4 kv blocks per q block
FLASH_CASES = {
    "causal_gqa2": (2, 4, 2, 128, 128, 16, True, None, 0),
    "causal_window40": (1, 4, 2, 128, 128, 16, True, 40, 0),
    "q_offset64_lq64_lkv128": (1, 4, 2, 64, 128, 16, True, None, 64),
    "mha_dh32": (1, 2, 2, 128, 128, 32, True, None, 0),
    # qpos 100..163 against 128 keys, window 16: rows at qpos >= 143 have
    # no valid key and come out as the mean of V
    "rows_without_a_valid_key": (1, 4, 2, 64, 128, 16, True, 16, 100),
    "window24_not_causal": (1, 2, 1, 64, 64, 16, False, 24, 0),
    # recurrentgemma's head width, one kv head: a window below L, and a
    # group of 16 as in the full config
    "mqa_dh256_window40": (1, 4, 1, 128, 128, 256, True, 40, 0),
    "mqa_g16_dh256": (1, 16, 1, 64, 64, 256, True, None, 0),
}


@pytest.mark.parametrize("dtype,tol", DTYPES)
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_plain_matches_reference_kernel(case, dtype, tol):
    B, Hq, Hkv, Lq, Lkv, Dh, causal, window, q_offset = FLASH_CASES[case]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, Lq, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, Lkv, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, Lkv, Hkv, Dh)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    kw = dict(causal=causal, window=window, q_offset=q_offset, block_q=32,
              block_k=32)
    out = flash_attention.flash_attention(tq, tk, tv, **kw)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    _close(out, ref_flash.flash_attention(jq, jk, jv, **kw), tol)
    # the op runs the plain version on the CPU, on the transposed views
    plain = flash_attention.flash_attention_plain(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
        Dh ** -0.5, causal, window, q_offset)
    torch.testing.assert_close(out, plain.transpose(1, 2), rtol=0, atol=0)
    if case == "rows_without_a_valid_key":
        empty = q_offset + np.arange(Lq) >= Lkv - 1 + window
        assert 0 < empty.sum() < Lq
        mean_v = tv.float().mean(dim=1).repeat_interleave(Hq // Hkv, dim=1)
        for i in np.flatnonzero(empty):
            _close(out[:, i], mean_v.numpy(), tol)


def _op_cases():
    rng = np.random.default_rng(5)

    def t(*shape, dtype=torch.float32):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32
                               ).to(dtype)

    cache_k, cache_v = t(2, 16, 2, 8), t(2, 16, 2, 8)
    pos = torch.tensor([[3], [15]], dtype=torch.int32)
    return [
        ("rmsnorm", norms.rmsnorm_op, (t(6, 32), t(32), 1e-6)),
        ("rmsnorm_bf16", norms.rmsnorm_op,
         (t(6, 32, dtype=torch.bfloat16), t(32, dtype=torch.bfloat16), 1e-6)),
        ("layernorm", norms.layernorm_op, (t(6, 32), t(32), t(32), 1e-5)),
        ("layernorm_bf16", norms.layernorm_op,
         (t(5, 40, dtype=torch.bfloat16), t(40, dtype=torch.bfloat16),
          t(40, dtype=torch.bfloat16), 1e-5)),
        ("glu_silu", activations.glu_op, (t(4, 24), t(4, 24), "silu")),
        ("squared_relu", activations.squared_relu_op, (t(4, 24),)),
        ("squared_relu_bf16", activations.squared_relu_op,
         (t(3, 40, dtype=torch.bfloat16),)),
        ("glu_gelu", activations.glu_op, (t(4, 24), t(4, 24), "gelu")),
        ("rope", rope.rope_op,
         (t(6, 32), torch.arange(6, dtype=torch.int32), 1e4, 8)),
        ("decode_attention", decode_attention.decode_attention_op,
         (pos, t(2, 4, 1, 8), cache_k.transpose(1, 2), cache_v.transpose(1, 2),
          0.35, None)),
        ("decode_attention_window", decode_attention.decode_attention_op,
         (pos, t(2, 4, 1, 8), cache_k.transpose(1, 2), cache_v.transpose(1, 2),
          0.35, 4)),
        ("flash_attention", flash_attention.flash_attention_op,
         (t(2, 8, 4, 8).transpose(1, 2), cache_k.transpose(1, 2),
          cache_v.transpose(1, 2), 0.35, True, None, 0)),
        ("flash_attention_window_offset", flash_attention.flash_attention_op,
         (t(2, 4, 4, 8).transpose(1, 2), cache_k.transpose(1, 2),
          cache_v.transpose(1, 2), 0.35, True, 3, 12)),
        ("flash_attention_bf16", flash_attention.flash_attention_op,
         (t(2, 8, 4, 8, dtype=torch.bfloat16).transpose(1, 2),
          cache_k.to(torch.bfloat16).transpose(1, 2),
          cache_v.to(torch.bfloat16).transpose(1, 2), 0.35, False, 5, 0)),
        ("topk_router", router.topk_router_op, (t(6, 32), 8, True)),
        ("topk_router_bf16_no_renorm", router.topk_router_op,
         (t(5, 12, dtype=torch.bfloat16), 3, False)),
        ("mamba_scan", mamba_scan.mamba_scan_op, _scan_args(t, torch.float32)),
        ("mamba_scan_bf16_strided_bc", mamba_scan.mamba_scan_op,
         _scan_args(t, torch.bfloat16, strided=True)),
        ("mamba_scan_ref", torch.ops.repro_torch.mamba_scan_ref.default,
         _scan_args(t, torch.float32, strided=True)),
        ("mamba_scan_ref_state", torch.ops.repro_torch.mamba_scan_ref_state.default,
         _scan_args(t, torch.bfloat16)),
        ("flash_attention_dh256_mqa", flash_attention.flash_attention_op,
         (t(1, 8, 4, 256).transpose(1, 2), t(1, 8, 1, 256).transpose(1, 2),
          t(1, 8, 1, 256).transpose(1, 2), 0.0625, True, 4, 0)),
        ("rg_lru", rg_lru.rg_lru_op, (t(2, 5, 6), t(2, 5, 6), t(2, 5, 6),
                                      t(6), 8.0)),
        ("rg_lru_bf16", rg_lru.rg_lru_op,
         (*(t(2, 5, 6, dtype=torch.bfloat16) for _ in range(3)), t(6), 4.0)),
        ("linear_scan_ref", torch.ops.repro_torch.linear_scan_ref.default,
         (t(2, 5, 6).sigmoid(), t(2, 5, 6))),
        ("linear_scan_ref_state",
         torch.ops.repro_torch.linear_scan_ref_state.default,
         (t(2, 5, 6).sigmoid(), t(2, 5, 6))),
        ("rmsnorm_residual", norms.rmsnorm_residual_op,
         (t(6, 32), t(6, 32), t(32), 1e-6)),
        ("rmsnorm_residual_bf16", norms.rmsnorm_residual_op,
         (t(5, 40, dtype=torch.bfloat16), t(5, 40, dtype=torch.bfloat16),
          t(40), 1e-6)),
        ("softmax", softmax.softmax_op, (t(6, 33), 0.125)),
        ("softmax_bf16", softmax.softmax_op, (t(4, 40, dtype=torch.bfloat16), 2.0)),
        ("softmax_masked", softmax.softmax_masked_op,
         (t(6, 33), t(6, 33) > 0, 0.125)),
        ("softmax_masked_bf16", softmax.softmax_masked_op,
         (t(4, 40, dtype=torch.bfloat16), t(4, 40) > 0.5, 1.0)),
        ("cross_entropy", cross_entropy.cross_entropy_op,
         (t(6, 50), torch.tensor([0, 49, 7, 3, 12, 30], dtype=torch.int32))),
        ("cross_entropy_bf16", cross_entropy.cross_entropy_op,
         (t(3, 70, dtype=torch.bfloat16),
          torch.tensor([69, 0, 35], dtype=torch.int32))),
    ]


def _scan_args(t, dtype, strided=False):
    """(x, delta, A, B, C, D) of a (2, 5, 6) scan with N = 4; B and C as
    column views of one (2, 5, 10) projection when ``strided``."""
    x, dt = t(2, 5, 6, dtype=dtype), t(2, 5, 6).abs().to(dtype)
    if strided:
        dbc = t(2, 5, 10)
        B, C = dbc[..., 2:6], dbc[..., 6:]
    else:
        B, C = t(2, 5, 4), t(2, 5, 4)
    return x, dt, -t(6, 4).abs(), B, C, t(6)


@pytest.mark.parametrize("case", _op_cases(), ids=lambda c: c[0])
def test_custom_op_opcheck(case):
    _, op, args = case
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("launch,op", [
    (norms._launch, norms.rmsnorm_op), (activations._launch, activations.glu_op),
    (rope._launch, rope.rope_op),
    (decode_attention._launch, decode_attention.decode_attention_op),
    (flash_attention._launch, flash_attention.flash_attention_op),
    (router._launch, router.topk_router_op),
    (mamba_scan._launch, mamba_scan.mamba_scan_op), (rg_lru._launch, rg_lru.rg_lru_op),
    (norms._launch_layernorm, norms.layernorm_op),
    (activations._launch_sqrelu, activations.squared_relu_op),
    (norms._launch_residual, norms.rmsnorm_residual_op),
    (softmax._launch, softmax.softmax_op),
    (softmax._launch_masked, softmax.softmax_masked_op),
    (cross_entropy._launch, cross_entropy.cross_entropy_op),
], ids=["rmsnorm", "glu", "rope", "decode_attention", "flash_attention",
        "topk_router", "mamba_scan", "rg_lru", "layernorm", "squared_relu",
        "rmsnorm_residual", "softmax", "softmax_masked", "cross_entropy"])
def test_cuda_launcher_takes_the_op_signature(launch, op):
    """The dispatcher drops an argument left at its default, so the CUDA
    implementation must declare the op's parameters with the same
    defaults."""
    def spelled(fn):
        return [(p.name, p.default)
                for p in inspect.signature(fn).parameters.values()]
    assert spelled(launch) == spelled(op._init_fn)


def test_kernel_mode_dispatch():
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((2, 3, 16)), dtype=torch.float32)
    g = torch.ones(16)
    assert ops.get_mode() == "ref"
    with ops.kernel_mode("kernels"):
        assert ops.get_mode() == "kernels"
        with ops.kernel_mode("ref"):
            assert ops.get_mode() == "ref"
        assert ops.get_mode() == "kernels"
    assert ops.get_mode() == "ref"
    with pytest.raises(ValueError, match="kernel mode"):
        with ops.kernel_mode("pallas"):
            pass
    ref_out = ops.rmsnorm(x, g)
    with ops.kernel_mode("kernels"):
        kern_out = ops.rmsnorm(x, g)
        torch.testing.assert_close(ops.geglu(x, x), ref.geglu(x, x))
        torch.testing.assert_close(ops.squared_relu(x), ref.squared_relu(x))
        torch.testing.assert_close(ops.layernorm(x, g, 0.5 * g),
                                   ref.layernorm(x, g, 0.5 * g))
        torch.testing.assert_close(ops.rmsnorm_residual(x, 2 * x, g),
                                   ref.rmsnorm_residual(x, 2 * x, g))
        torch.testing.assert_close(ops.softmax(x, 0.5), ref.softmax(x, 0.5))
        torch.testing.assert_close(ops.softmax(x, 0.5, x > -1),
                                   ref.softmax(x, 0.5, x > -1))
        labels = torch.tensor([0, 15, 7], dtype=torch.int32)
        torch.testing.assert_close(ops.cross_entropy(x[0], labels),
                                   ref.cross_entropy(x[0], labels))
        # a fully masked row: 0 through the kernel's plain version
        kern_masked = ops.softmax(x, 0.5, torch.zeros(16, dtype=torch.bool))
    assert (kern_masked == 0).all()
    assert torch.isnan(ops.softmax(x, 0.5, torch.zeros(16, dtype=torch.bool))).all()
    torch.testing.assert_close(kern_out, ref_out, rtol=0, atol=0)


def test_cpu_tensors_never_count_launches():
    ops.reset_launch_counts()
    x = torch.randn(4, 1, 2, 16)
    with ops.kernel_mode("kernels"):
        ops.rmsnorm(x, torch.ones(16))
        ops.swiglu(x, x)
        ops.rope(x, torch.zeros(4, 1, dtype=torch.int32))
        ops.decode_attention(x[:, :, :2], torch.randn(4, 8, 1, 16),
                             torch.randn(4, 8, 1, 16),
                             torch.zeros(4, dtype=torch.int32))
        ops.attention(x, x, x)
        ops.topk_router(torch.randn(4, 8), 2)
        ops.mamba_scan(x[:, 0], x[:, 0].abs(), -torch.ones(16, 3),
                       torch.randn(4, 2, 3), torch.randn(4, 2, 3), torch.ones(16))
        ops.rg_lru(x[:, 0], x[:, 0], x[:, 0], torch.ones(16))
        ops.layernorm(x, torch.ones(16), torch.zeros(16))
        ops.squared_relu(x)
        ops.rmsnorm_residual(x, x, torch.ones(16))
        ops.softmax(x, 0.5)
        ops.softmax(x, 0.5, x > 0)
        ops.cross_entropy(x[:, 0, 0], torch.zeros(4, dtype=torch.int32))
    names = ["rmsnorm", "layernorm", "glu", "squared_relu", "rope",
             "decode_attention", "flash_attention", "router", "mamba_scan",
             "rg_lru", "rmsnorm_residual", "softmax", "softmax_masked",
             "cross_entropy"]
    assert ops.launch_counts() == {k: 0 for k in names}
    assert ops.launch_counts_by_signature() == {k: {} for k in names}
    assert ops.launch_counts_by_variant() == {"flash_attention": {},
                                              "decode_attention": {}}


def test_launch_signature_keys_shapes_dtypes_and_arguments():
    x = torch.zeros(4, 2048, dtype=torch.bfloat16)
    g = torch.zeros(2048)
    assert build.signature(x, g, 1e-6) == (
        ((4, 2048), "torch.bfloat16"), ((2048,), "torch.float32"), 1e-6)
    assert build.signature(x, g, 1e-5) != build.signature(x, g, 1e-6)
    assert build.signature(x[:2], g, 1e-6) != build.signature(x, g, 1e-6)


# -- the CUDA build, with a stand-in for nvcc -----------------------------------

def _fake_nvcc(tmp_path: Path, body: str) -> Path:
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\n" + body)
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    return script


def test_build_rebuilds_only_on_a_changed_source(tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    # writes its -o argument and logs one line per run
    nvcc = _fake_nvcc(tmp_path, f'''
out=""
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then out="$2"; fi
  shift
done
echo run >> {calls}
echo "ptxas info" >&2
echo lib > "$out"
''')
    monkeypatch.setattr(build, "nvcc", lambda: str(nvcc))
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    out = tmp_path / "out"
    first = build.library("k", tmp_path, out)
    assert first.exists() and first.with_suffix(".log").read_text() == "ptxas info\n"
    assert build.library("k", tmp_path, out) == first
    assert calls.read_text().count("run") == 1
    src.write_text("// two\n")
    second = build.library("k", tmp_path, out)
    assert second != first and second.exists()
    assert calls.read_text().count("run") == 2
    assert not list(out.glob("*.tmp"))


def test_build_failure_raises_with_nvcc_output(tmp_path, monkeypatch):
    nvcc = _fake_nvcc(tmp_path, 'echo "error: expected a ;" >&2\nexit 2\n')
    monkeypatch.setattr(build, "nvcc", lambda: str(nvcc))
    src = tmp_path / "bad.cu"
    src.write_text("int x\n")
    with pytest.raises(build.BuildError, match="expected a ;"):
        build.library("bad", tmp_path, tmp_path / "out")
    assert not list((tmp_path / "out").iterdir())


def test_csrc_sources_are_found():
    stems = {p.stem for p in build.CSRC.glob("*.cu")}
    assert {"decode_attention", "flash_attention", "flash_attention_sm90",
            "router", "mamba_scan", "rg_lru", "rope", "norms",
            "activations"} <= stems
    assert build.build_dir().parts[-2:] == ("build", "kernels")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
