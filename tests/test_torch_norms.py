"""RMSNorm and LayerNorm (``repro_torch.kernels.norms``) on the CPU.

The CUDA kernels (``csrc/norms.cu``) give the bits of the Triton kernels
they replaced, so each row is summed over the lanes and in the order the
Triton program used: :func:`norms.block_plan` derives that layout from
Triton's view of an operand's pointers and strides.  Here the plan is held
to the layouts Triton 3.6 compiled on the card (its TTGIR's ``#blocked``
load layouts, read before the Triton kernels were deleted) at every path
operand and at
strided, misaligned and ragged ones; the ``ctypes`` binding to the C
declarations in the source; the wrappers' refusals; and the plain versions
to the reference's Pallas kernels in interpret mode (float32 at 2e-4, the
reference's tolerance; bfloat16 at 1.6e-2, one bf16 rounding step).  The
kernels themselves run on the card (``tests/test_torch_gpu.py``,
``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import norms as ref_norms
from repro_torch.kernels import build, norms

BF16, F32 = torch.bfloat16, torch.float32
ALIGNED = 0x1000

# (rows, d, dtype, x pointer, row stride) -> Triton's load layout as
# (sizePerThread[1], threadsPerWarp[1], warpsPerCTA[1]), from the TTGIR
LAYOUTS = [
    # the paths' operands (16-byte aligned, rows of d)
    ((4, 2048, BF16, ALIGNED, 2048), (8, 32, 4)),
    ((64, 128, BF16, ALIGNED, 128), (8, 16, 1)),
    ((4, 1024, BF16, ALIGNED, 1024), (8, 32, 4)),
    ((4, 4096, BF16, ALIGNED, 4096), (8, 32, 8)),
    ((4, 6144, BF16, ALIGNED, 6144), (8, 32, 8)),
    ((256, 2048, BF16, ALIGNED, 2048), (8, 32, 4)),
    ((64, 128, F32, ALIGNED, 128), (4, 32, 1)),
    ((4, 2048, F32, ALIGNED, 2048), (4, 32, 4)),
    ((4, 6144, F32, ALIGNED, 6144), (4, 32, 8)),
    # d a multiple of 16: the output's rows keep the full vector, whatever x
    ((4, 2048, BF16, ALIGNED + 2, 2048), (8, 32, 4)),
    ((4, 2048, BF16, ALIGNED, 2056), (8, 32, 4)),
    ((64, 128, BF16, ALIGNED + 2, 136), (8, 16, 1)),
    ((37, 96, BF16, ALIGNED + 2, 104), (8, 16, 1)),
    ((37, 96, F32, ALIGNED + 4, 104), (4, 32, 1)),
    # d = 200: x's pointer and row stride decide
    ((4, 200, BF16, ALIGNED, 200), (1, 32, 4)),
    ((4, 200, BF16, ALIGNED, 208), (8, 32, 1)),
    ((4, 200, BF16, ALIGNED + 2, 208), (1, 32, 4)),
    ((3, 200, BF16, ALIGNED, 208), (8, 32, 1)),
    ((4, 200, F32, ALIGNED, 200), (1, 32, 4)),
    ((4, 200, F32, ALIGNED, 208), (4, 32, 2)),
    ((3, 200, F32, ALIGNED + 4, 208), (1, 32, 4)),
]


@pytest.mark.parametrize("operand,layout", LAYOUTS)
def test_block_plan_takes_tritons_layout(operand, layout):
    """A lane's consecutive columns, a row's lanes in a warp and its warps
    as Triton laid the load out; a lane's elements fill BLOCK_D."""
    rows, d, dtype, ptr, stride = operand
    plan = norms.block_plan(rows, d, dtype, ptr, stride)
    assert (plan.vec, plan.lanes, plan.warps) == layout
    _, block_d, _ = norms._blocks(rows, d)
    assert plan.elems * plan.lanes * plan.warps == block_d
    assert plan.elems % plan.vec == 0


# the paths' operands (bf16): a block's threads and LayerNorm's early loads
PATH_PLANS = [(4, 2048), (64, 128), (32, 128), (256, 2048), (4096, 128),
              (2048, 128), (1024, 2048), (16384, 128), (8192, 128),
              (4, 1024), (1024, 1024), (1024, 4096), (4, 6144), (1024, 6144)]


@pytest.mark.parametrize("rows,d", PATH_PLANS)
def test_block_plan_blocks(rows, d):
    """Whole rows a block, a power of two of at least MIN_THREADS threads
    within the kernel's limits (256 threads, 64 partial sums); gamma and
    beta early exactly where the grid has at most one block an SM."""
    plan = norms.block_plan(rows, d, BF16, ALIGNED, d)
    row_threads = plan.lanes * plan.warps
    groups = plan.threads // row_threads
    assert plan.threads & (plan.threads - 1) == 0
    assert norms.MIN_THREADS <= plan.threads <= 256
    assert plan.threads % row_threads == 0
    if plan.warps > 1:
        assert groups * plan.warps <= 64
    assert plan.early == (-(-rows // groups) <= norms.SMS)
    assert plan.early == (rows <= 64)      # the decode steps' rows


def test_block_plan_gamma_joins_one_row_programs():
    """In a program of one row Triton vectorises x's load as widely as
    gamma's (same shape): an unaligned x of d = 200 at one row takes the
    aligned gamma's vector, capped by the program's elements a thread."""
    assert norms.block_plan(1, 200, BF16, ALIGNED + 2, 200).vec == 2
    assert norms.block_plan(1, 200, BF16, ALIGNED + 2, 200,
                            vectors_aligned=False).vec == 1
    with pytest.raises(ValueError, match="nothing to normalise"):
        norms.block_plan(0, 128, BF16, ALIGNED, 128)


_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
           "int": ctypes.c_int, "long long": ctypes.c_longlong,
           "float": ctypes.c_float}


@pytest.mark.parametrize("fn", ["repro_rmsnorm", "repro_layernorm"])
def test_binding_matches_the_c_declaration(fn):
    """``norms.bind`` declares each entry point's arguments as the source
    declares them (a pointer or the stream as c_void_p, 64-bit counts as
    c_longlong), so ctypes cuts no pointer and shifts no argument."""
    src = (build.CSRC / "norms.cu").read_text()
    decl = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src).group(1)
    want = [_CTYPES[re.sub(r"\s*\w+$", "", p.strip())]
            for p in decl.split(",")]

    class Lib:
        pass

    lib = Lib()
    for name in ("repro_rmsnorm", "repro_layernorm",
                 "repro_cuda_error_string"):
        setattr(lib, name, type("Fn", (), {})())
    norms.bind(lib)
    assert getattr(lib, fn).argtypes == want
    assert getattr(lib, fn).restype is ctypes.c_int


@pytest.mark.parametrize("launch", ["rms", "ln"])
def test_wrappers_refuse_what_the_kernels_do_not_take(launch):
    """Row-strided x is taken (its row stride is passed); a column stride,
    another dtype or a vector of another length is refused before any
    build or launch."""
    def call(x, g):
        if launch == "rms":
            return norms._launch(x, g, 1e-6)
        return norms._launch_layernorm(x, g, g, 1e-5)

    x, g = torch.randn(8, 16), torch.randn(16)
    with pytest.raises(ValueError, match="contiguous"):
        call(torch.randn(16, 8).t(), g)
    with pytest.raises(TypeError, match="dtypes"):
        call(x.half(), g.half())
    with pytest.raises(ValueError, match=r"\(rows, d\)"):
        call(x, g[:8])


NORM_CASES = [(8, 128), (3, 200), (2, 1024), (5, 96)]


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 1.6e-2)])
@pytest.mark.parametrize("rows,d", NORM_CASES)
def test_plain_versions_match_reference_kernels(rows, d, dtype, tol):
    """RMSNorm's and LayerNorm's plain versions (the ops' CPU
    implementations) against the reference's Pallas kernels in interpret
    mode, at the qk-norm's width, ragged widths and granite's."""
    rng = np.random.default_rng(rows * d)
    x = (2.0 * rng.standard_normal((rows, d)) + 0.5).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jg, jb = (jnp.asarray(a, jdt) for a in (x, g, b))
    tx, tg, tb = (torch.as_tensor(a).to(tdt) for a in (x, g, b))
    pairs = [
        (norms.rmsnorm(tx, tg, 1e-6),
         ref_norms.rmsnorm(jx, jg, 1e-6, block_rows=4)),
        (norms.layernorm(tx, tg, tb, 1e-5),
         ref_norms.layernorm(jx, jg, jb, 1e-5, block_rows=4)),
    ]
    for port, want in pairs:
        np.testing.assert_allclose(port.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)
