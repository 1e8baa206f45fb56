"""The attention kernels' dispatch and plans, on the CPU.

Flash attention has two CUDA kernels, the Hopper one (``"sm90"``: wgmma
fed by TMA) and the CUDA-core one (``"simt"``); :func:`_variant` picks one
from the dtype, the head width, the alignment and the strides alone.  The
split decode kernel cuts the cache's keys into chunks fixed by ``Smax``
and folds the chunks' partials in order; its algorithm in PyTorch
(``decode_attention_split_plain``) must equal the plain version and the
reference's Pallas kernel (interpret mode) at positions on chunk edges,
with a window and at a GQA group of 6.  The flash plain version is held
against the reference's Pallas kernel at the model paths' head layouts,
narrowed: head width 256 with a group of 16, and 48 q heads on 8.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as ref_decode
from repro.kernels import flash_attention as ref_flash
from repro_torch.kernels import decode_attention, flash_attention

BF16, F32 = torch.bfloat16, torch.float32
ALIGNED = [0x10000, 0x20000, 0x30000]
# (B, L, H, Dh) activations seen as (B, H, L, Dh): the strides of q, k, v
STRIDES = [256 * 16 * 128, 128, 16 * 128] * 3


@pytest.mark.parametrize("dtype,dh,ptrs,strides,want", [
    (BF16, 64, ALIGNED, STRIDES, "sm90"),
    (BF16, 128, ALIGNED, STRIDES, "sm90"),
    (BF16, 256, ALIGNED, STRIDES, "sm90"),
    # f32 would run in TF32 on the tensor cores
    (F32, 128, ALIGNED, STRIDES, "simt"),
    (F32, 256, ALIGNED, STRIDES, "simt"),
    # head widths the Hopper kernel has no instance for
    (BF16, 96, ALIGNED, STRIDES, "simt"),
    (BF16, 32, ALIGNED, STRIDES, "simt"),
    (torch.float16, 128, ALIGNED, STRIDES, "simt"),
    # a base pointer off 16 bytes, a stride off 8 elements, a zero stride
    (BF16, 128, [0x10000, 0x20008, 0x30000], STRIDES, "simt"),
    (BF16, 128, ALIGNED, STRIDES[:4] + [124] + STRIDES[5:], "simt"),
    (BF16, 128, ALIGNED, [0] + STRIDES[1:], "simt"),
], ids=["bf16_64", "bf16_128", "bf16_256", "f32_128", "f32_256", "bf16_96",
        "bf16_32", "f16_128", "ptr_off16", "stride_off8", "stride_0"])
def test_flash_variant_choice(dtype, dh, ptrs, strides, want):
    assert flash_attention._variant(dtype, dh, ptrs, strides) == want


def test_flash_variant_of_views_strided_from_activations():
    """The model paths' operands, transposed views of (B, L, H, Dh)
    tensors, go to the Hopper kernel in bf16; a narrowed head width does
    not."""
    for dh, want in ((128, "sm90"), (256, "sm90"), (40, "simt")):
        q = torch.zeros(2, 64, 4, dh, dtype=BF16).transpose(1, 2)
        k = torch.zeros(2, 64, 2, dh, dtype=BF16).transpose(1, 2)
        ts = (q, k, k)
        strides = [s for t in ts for s in t.stride()[:3]]
        got = flash_attention._variant(BF16, dh, [t.data_ptr() for t in ts],
                                       strides)
        assert got == want


@pytest.mark.parametrize("smax,chunks", [(1, 1), (31, 1), (32, 1), (33, 2),
                                         (128, 4), (512, 16), (1000, 32)])
def test_decode_chunk_plan_from_smax(smax, chunks):
    chunk, n = decode_attention.chunk_plan(smax)
    assert chunk == decode_attention.CHUNK == 32
    assert n == chunks and (n - 1) * chunk < smax <= n * chunk


def test_decode_chunk_plan_refuses_an_empty_cache():
    with pytest.raises(ValueError):
        decode_attention.chunk_plan(0)


def _pair(a: np.ndarray, dtype: str):
    if np.issubdtype(a.dtype, np.integer):
        return jnp.asarray(a), torch.as_tensor(a)
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.as_tensor(a).to(getattr(torch, dtype)))


C = decode_attention.CHUNK
# (Hq, Hkv, Smax, positions, window): positions at 0, C - 1, C, Smax - 1;
# a GQA group of 6 over 4 chunks; a window across two chunks; a group of 16
# (above the single-pass kernel's 8); a row past the window's reach and a
# negative position (no valid key: the mean of V in every version)
DECODE_CASES = {
    "edges_g1": (4, 4, 4 * C, [0, C - 1, C, 4 * C - 1], None),
    "edges_g6": (12, 2, 4 * C, [0, C - 1, C, 4 * C - 1], None),
    "window_two_chunks_g6": (12, 2, 4 * C, [C + 2, 2 * C, 3 * C - 1, 4 * C - 1],
                             C // 2),
    "g16": (16, 1, 2 * C, [C - 1, C, 2 * C - 1, 5], None),
    "no_valid_key": (4, 2, 2 * C, [4 * C, 2 * C - 1, -1, C], 3),
}


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 1.6e-2)])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_split_plain_matches_plain_and_reference(case, dtype, tol):
    """The split-and-combine (chunks, sentinel partials, the ordered fold)
    equals the plain version (f32: to rounding; bf16: within one bf16
    step), and both equal the reference's Pallas kernel in interpret mode
    within the tolerance."""
    hq, hkv, smax, pos, window = DECODE_CASES[case]
    rng = np.random.default_rng(len(case))
    B, dh = len(pos), 32
    q = rng.standard_normal((B, 1, hq, dh)).astype(np.float32)
    k = rng.standard_normal((B, smax, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, smax, hkv, dh)).astype(np.float32)
    p = np.array(pos, np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    jp, tp = _pair(p, dtype)
    args = (tp.reshape(B, 1), tq.transpose(1, 2), tk.transpose(1, 2),
            tv.transpose(1, 2), dh ** -0.5, window)
    split = decode_attention.decode_attention_split_plain(*args)
    plain = decode_attention.decode_attention_plain(*args)
    assert split.shape == plain.shape and split.dtype == plain.dtype
    torch.testing.assert_close(split.float(), plain.float(),
                               rtol=tol / 10, atol=tol / 10)
    want = np.asarray(ref_decode.decode_attention(
        jq, jk, jv, jp, window=window, block_k=C), np.float32)
    for got in (split, plain):
        np.testing.assert_allclose(got.transpose(1, 2).float().numpy(), want,
                                   rtol=tol, atol=tol)
    if case == "no_valid_key":
        # the mean of V over all keys, for the rows with no valid key
        mean_v = v.mean(axis=1)                           # (B, Hkv, dh)
        for b in (0, 2):
            np.testing.assert_allclose(
                want[b, 0, ::hq // hkv], mean_v[b], rtol=tol, atol=tol)


def test_decode_split_plain_writes_sentinels_for_empty_chunks():
    """A chunk past every row's position contributes the sentinel partial:
    with positions in the first chunk of four, the result is the first
    chunk's attention alone, and no NaN comes from exp(-inf - -inf)."""
    rng = np.random.default_rng(11)
    q = torch.as_tensor(rng.standard_normal((2, 4, 1, 16)), dtype=F32)
    k = torch.as_tensor(rng.standard_normal((2, 2, 4 * C, 16)), dtype=F32)
    v = torch.as_tensor(rng.standard_normal((2, 2, 4 * C, 16)), dtype=F32)
    pos = torch.tensor([[0], [C - 1]], dtype=torch.int32)
    full = decode_attention.decode_attention_split_plain(pos, q, k, v, 0.25)
    first = decode_attention.decode_attention_split_plain(
        pos, q, k[:, :, :C], v[:, :, :C], 0.25)
    assert torch.isfinite(full).all()
    torch.testing.assert_close(full, first, rtol=0, atol=0)


# (B, Hq, Hkv, L, Dh, window): recurrentgemma's 16 q heads on one kv head
# of 256, and nemotron-4-15b's 48 q heads on 8, narrowed to short rows
FLASH_MODEL_CASES = {
    "dh256_g16": (1, 16, 1, 64, 256, None),
    "dh256_g16_window24": (1, 16, 1, 64, 256, 24),
    "nemotron_48_on_8": (1, 48, 8, 32, 16, None),
}


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 1.6e-2)])
@pytest.mark.parametrize("case", list(FLASH_MODEL_CASES))
def test_flash_plain_matches_reference_at_model_heads(case, dtype, tol):
    B, hq, hkv, L, dh, window = FLASH_MODEL_CASES[case]
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, L, hq, dh)).astype(np.float32)
    k = rng.standard_normal((B, L, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, L, hkv, dh)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    kw = dict(causal=True, window=window, block_q=32, block_k=32)
    got = flash_attention.flash_attention_plain(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
        dh ** -0.5, True, window, 0).transpose(1, 2)
    want = np.asarray(ref_flash.flash_attention(jq, jk, jv, **kw), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
