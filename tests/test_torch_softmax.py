"""The masked softmax's CUDA kernel (``csrc/softmax.cu``) on the CPU.

The kernel gives the bits of the Triton kernel it replaced (deleted since), so each
row is summed over the lanes and in the order the Triton program used:
:func:`softmax.masked_plan` derives that layout from Triton's view of the
operand's pointers and strides.  Here the plan is held to hand-worked
layouts (two of them as Triton 3.6's TTGIR gave them on the card: the
kernel API's (16384, 256) attention rows and a ragged (6, 333)); a torch
spec of the kernel's arithmetic in that order (each lane's elements in
register order, the butterfly over lanes, then over warps) is held to the
plain version and to the reference's Pallas kernel in interpret mode
(float32 at the reference's softmax tolerance, bfloat16 within one bf16
rounding step), and shown not to depend on what masked lanes hold, which
the kernel never reads; the ``ctypes`` binding against the C declaration;
and the wrapper's refusals.  The kernel itself runs on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import softmax as ref_softmax
from repro_torch.kernels import build, softmax

BF16, F32 = torch.bfloat16, torch.float32
A = 0x1000            # a 16-byte-aligned address
SMS = 132             # an H100 SXM's SMs
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)

# (rows, d, dtype, x address, x row stride, mask address, mask row stride)
# -> (V, lanes, warps, elements a lane, CUDA threads)
PLANS = [
    # the kernel API's attention rows (Triton 3.6's TTGIR: sizePerThread
    # [1, 8], threadsPerWarp [1, 32], warpsPerCTA [4, 1]), bf16 and f32 (x's
    # own 4-element vector widened to the mask's, capped at 8 a thread)
    ((16384, 256, BF16, A, 256, A, 256), (8, 32, 1, 8, 128)),
    ((16384, 256, F32, A, 256, A, 256), (8, 32, 1, 8, 128)),
    ((64, 256, BF16, A, 256, A, 256), (8, 32, 1, 8, 128)),
    # a ragged row (TTGIR: [1, 1], [1, 32], [1, 4]): nothing divisible
    ((6, 333, BF16, A, 333, A, 333), (1, 32, 4, 4, 128)),
    # narrow rows: several a warp
    ((64, 128, BF16, A, 128, A, 128), (8, 16, 1, 8, 128)),
    ((7, 1, F32, A, 1, A, 1), (1, 1, 1, 1, 128)),
    # few rows: the program's elements a thread cap the vector
    ((2, 256, F32, A, 256, A, 256), (4, 32, 2, 4, 128)),
    # one-row programs past 2048 columns: the mask's 16-byte vector
    ((4, 2048, BF16, A, 2048, A, 2048), (16, 32, 4, 16, 128)),
    ((1, 8192, BF16, A, 8192, A, 8192), (16, 32, 8, 32, 256)),
    ((3, 4097, F32, A, 4097, A, 4097), (1, 32, 8, 32, 256)),
    # misaligned x, aligned mask: the mask's vector holds
    ((64, 256, BF16, A + 2, 640, A, 256), (8, 32, 1, 8, 128)),
    # x aligned with a 16-divisible stride, d ragged, mask not
    ((5, 333, BF16, A, 336, A + 3, 333), (8, 32, 2, 8, 128)),
]


@pytest.mark.parametrize("operand,want", PLANS)
def test_masked_plan_takes_tritons_layout(operand, want):
    plan = softmax.masked_plan(*operand, SMS)
    assert (plan.vec, plan.lanes, plan.warps, plan.elems,
            plan.threads) == want
    rows, d = operand[:2]
    _, block_d, _ = softmax._layout(rows, d)
    assert plan.elems * plan.lanes * plan.warps == block_d
    assert plan.elems % plan.vec == 0 and plan.elems <= 32
    groups = -(-rows // (plan.threads // (plan.lanes * plan.warps)))
    assert plan.blocks == min(groups, SMS * softmax.BLOCKS_PER_SM)


def test_masked_plan_refuses_what_the_one_pass_kernel_does_not_take():
    with pytest.raises(ValueError, match="one-pass"):
        softmax.masked_plan(0, 256, BF16, A, 256, A, 256, SMS)
    with pytest.raises(ValueError, match="one-pass"):
        softmax.masked_plan(4, softmax.MAX_ONE_PASS + 1, BF16, A, 8193, A,
                            8193, SMS)


def masked_spec(x, mask, scale: float):
    """The kernel's arithmetic in its order on tensors, every value in f32:
    v = x * scale where kept, else -inf; the row max, 0 where not finite;
    e = 2^((v - mx) * log2 e) (torch's exp2 for the card's ex2.approx); each
    lane's sum of its elements in register order (V columns, then the next
    repetition V * lanes * warps columns on), the butterfly over its row's
    lanes (offsets lanes / 2 down to 1), then over the row's warps; s =
    max(sum, 1e-30), NaN kept; e / s where kept or s is NaN, else 0."""
    rows, d = x.shape
    p = softmax.masked_plan(rows, d, x.dtype, 0, 16, 0, 16, SMS)  # aligned
    V, L, W, E = p.vec, p.lanes, p.warps, p.elems
    block_d = E * L * W
    v = torch.where(mask, x.float() * scale, -torch.inf)
    mx = v.amax(-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    e = torch.where(mask, torch.exp2((v - mx) * LOG2E), 0.0)
    pad = torch.zeros(rows, block_d - d)
    # column = r * V*L*W + q * V + j: (rows, reps, lanes of the row, V)
    lanes = torch.cat([e, pad], 1).reshape(rows, E // V, L * W, V)
    acc = lanes[:, 0, :, 0]
    for r in range(E // V):
        for j in range(V):
            if r or j:
                acc = acc + lanes[:, r, :, j]
    acc = acc.reshape(rows, W, L)
    idx = torch.arange(L)
    o = L // 2
    while o:
        acc = acc + acc[:, :, idx ^ o]
        o //= 2
    acc = acc[:, :, 0]
    idx = torch.arange(W)
    o = W // 2
    while o:
        acc = acc + acc[:, idx ^ o]
        o //= 2
    s = torch.maximum(acc[:, :1], torch.tensor(1e-30))
    out = torch.where(mask | torch.isnan(s), e / s, 0.0)
    return out.to(x.dtype)


def _operand(rows, d, seed, dtype):
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal((rows, d))).astype(np.float32)
    m = rng.random((rows, d)) < 0.6
    if rows > 2:
        m[0] = False
        m[1, : d // 2] = False
        m[2] = True
    return torch.as_tensor(x).to(dtype), torch.as_tensor(m), x, m


# the reference's softmax tolerance in f32 (rtol 2e-5, atol 2e-6); bf16
# within one rounding step
SPEC_TOL = [(F32, (2e-5, 2e-6)), (BF16, (1.6e-2, 1.6e-2))]
SPEC_SHAPES = [(64, 256), (6, 333), (9, 16), (3, 1000), (2, 2048),
               (3, 4097), (1, 8192), (7, 1)]


@pytest.mark.parametrize("dtype,tol", SPEC_TOL)
@pytest.mark.parametrize("rows,d", SPEC_SHAPES)
def test_spec_matches_plain_and_reference(rows, d, dtype, tol):
    tx, tm, x, m = _operand(rows, d, rows * d, dtype)
    got = masked_spec(tx, tm, 0.7)
    assert got.dtype == dtype and got.shape == tx.shape
    if rows > 2:
        assert (got[0] == 0).all() and not torch.signbit(got[0]).any()
    assert (got[~tm] == 0).all()
    rtol, atol = tol
    torch.testing.assert_close(got.float(), softmax.softmax_masked_plain(
        tx, tm, 0.7).float(), rtol=rtol, atol=atol)
    jx = jnp.asarray(x, jnp.float32 if dtype == F32 else jnp.bfloat16)
    want = np.asarray(ref_softmax.softmax(jx, 0.7, jnp.asarray(m)),
                      np.float32)
    keep = m.any(-1)            # the reference's fully masked rows are 0 too
    np.testing.assert_allclose(got.float().numpy()[keep], want[keep],
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_spec_never_reads_masked_lanes(dtype):
    """What a masked lane holds (NaN, infinities, huge values) changes no
    bit of the spec's or the plain version's output: the kernel reads x
    only where the mask keeps a lane.  A NaN or +inf at a kept lane does
    change the row, as in the Triton kernel."""
    tx, tm, _, _ = _operand(16, 256, 7, dtype)
    junk = tx.clone()
    junk[~tm] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                              3e38]).to(dtype).repeat(
        int((~tm).sum()) // 4 + 1)[: int((~tm).sum())]
    for fn in (masked_spec, softmax.softmax_masked_plain):
        assert torch.equal(fn(tx, tm, 0.5).view(torch.int16 if dtype == BF16
                                                else torch.int32),
                           fn(junk, tm, 0.5).view(torch.int16 if dtype == BF16
                                                  else torch.int32))
    bad = tx.clone()
    kept = tm[3].nonzero()[0, 0]
    bad[3, kept] = float("nan")
    bad[4, tm[4].nonzero()[0, 0]] = float("inf")
    out = masked_spec(bad, tm, 0.5)
    assert torch.isnan(out[3]).all()                 # s is NaN: every lane
    assert torch.isnan(out[4]).sum() == 1 and (out[4][~torch.isnan(
        out[4])] == 0).all()                         # inf / inf, the rest 0
    for fn in (softmax.softmax_masked_plain,):
        ref = fn(bad, tm, 0.5)
        assert torch.equal(torch.isnan(ref), torch.isnan(out))


_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float}


def test_binding_matches_the_c_declaration():
    """``softmax.bind`` declares each argument as the source declares it (a
    pointer or the stream as c_void_p, 64-bit counts as c_longlong), so
    ctypes cuts no pointer and shifts no argument."""
    src = (build.CSRC / "softmax.cu").read_text()
    fn = "repro_softmax_masked"
    decl = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src).group(1)
    want = [_CTYPES[re.sub(r"\s*\w+$", "", p.strip())]
            for p in decl.split(",")]

    class Lib:
        pass

    lib = Lib()
    for name in (fn, "repro_cuda_error_string"):
        setattr(lib, name, type("Fn", (), {})())
    softmax.bind(lib)
    assert lib.repro_softmax_masked.argtypes == want
    assert lib.repro_softmax_masked.restype is ctypes.c_int


@pytest.mark.parametrize("variant", ["cuda", "op"])
def test_wrapper_refuses_what_the_kernels_do_not_take(variant):
    """A column stride, another dtype, or a mask of another shape or dtype
    is refused before any build or launch, by the uncounted launch of the
    CUDA kernel (``"cuda"``, which also refuses rows past the one-pass
    block) and by the op's own launcher (``"op"``, which sends those rows
    to the split layout)."""
    launch = {"cuda": softmax._launch_cuda, "op": softmax._launch_masked}[variant]
    x, m = torch.randn(4, 16), torch.rand(4, 16) < 0.5
    with pytest.raises(ValueError, match="contiguous"):
        launch(torch.randn(16, 4).t(), m.t().contiguous().t(), 1.0)
    with pytest.raises(ValueError, match="f32 or bf16"):
        launch(x.half(), m, 1.0)
    with pytest.raises(ValueError, match="x's shape"):
        launch(x, m[:, :8], 1.0)
    with pytest.raises(ValueError, match="x's shape"):
        launch(x, m.to(torch.uint8), 1.0)
    if variant == "cuda":
        wide = torch.randn(2, softmax.MAX_ONE_PASS + 1)
        with pytest.raises(ValueError, match="split layout"):
            launch(wide, wide > 0, 1.0)
