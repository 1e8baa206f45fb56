"""Where a router and a GLU launch's time goes, on the paths' operands, and
what Triton compiled for the Triton GLU kernel.

Device us a launch, paired (``chip_smoke.paired_device_times``: the median
of 5 alternations of 100-launch CUDA-graph replays, every column of an
operand in turn; the least and the most of the 5 beside it), of:

* the MoE router (``repro_torch.kernels.router``), f32 logits (T, E) and k
  at granite-moe-1b-a400m's decode step (4, 32, 8) and bucket-256 prefill
  (1024, 32, 8), and the card check's samples (1000, 60, 4) and (512, 64,
  8): ``empty``, an empty CUDA kernel at the round kernel's grid; ``copy``,
  its loads and stores alone; ``softmax``, the loads, the softmax and the
  stores; ``rounds``, the kernel of k argmax rounds it replaced; ``rank``,
  the kernel the op launches (``csrc/router.cu``);
* the GLU (``repro_torch.kernels.activations``), bf16 (rows, F) at
  qwen3-1.7b's decode step (4, 6144) and bucket-64 prefill (256, 6144),
  granite-moe-1b-a400m's experts at decode (256, 512) and bucket-256
  prefill (10240, 512), SiLU, and recurrentgemma-9b's scoring call (1024,
  12288), GeGLU:
  ``empty``, an empty Triton kernel at ``_glu_kernel``'s grid and warps;
  ``copy``, its loads and store alone; ``triton``, the Triton kernel;
  ``triton_narrow``, the same Triton kernel with ``BLOCK`` cut to
  ``min(1024, next_pow2(F))`` and its warps with it (a 512-wide MoE
  expert's row: 2 warps, no masked half program);
  ``empty_cuda``, an empty CUDA kernel at the CUDA kernel's grid and
  threads (before the CUDA kernel existed: one 16-byte chunk a thread,
  one warp a block); ``cuda``, the CUDA kernel the op launches
  (``csrc/activations.cu``).

It first holds the new kernels against the kernels they replaced bit for
bit, f32 and bf16: the router at the operands above, renormalised or not,
at E of 1 to 64, with exact ties, rows of equal logits, -inf logits and
strided rows; the GLU at the operands above, both activations, with
ragged widths, strided and misaligned operands and special values (zeros,
infinities, saturating and tiny gates).

With ``--asm DIR`` it also writes ``_glu_kernel``'s TTGIR, PTX and SASS,
SiLU and GeGLU, bf16 and f32, at (4, 6144).  Needs one card:

    PYTHONPATH=src python3 examples/torch_router_glu_breakdown.py [--asm DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (paired_device_times: CUDA-graph replays)

from repro_torch.kernels import activations, build, router  # noqa: E402

tl = None             # triton.language, bound by build.triton_jit at launch

# (path, T, E, k, launches a step or call)
ROUTER_OPERANDS = [
    ("granite decode", 4, 32, 8, 24),
    ("granite prefill 256", 1024, 32, 8, 24),
    ("sample", 1000, 60, 4, 0),
    ("sample", 512, 64, 8, 0),
]
# (path, rows, F, act, launches a step or call)
GLU_OPERANDS = [
    ("qwen3 decode", 4, 6144, "silu", 28),
    ("qwen3 prefill 64", 256, 6144, "silu", 28),
    ("granite experts decode", 256, 512, "silu", 24),
    ("granite experts prefill 256", 10240, 512, "silu", 24),
    ("recurrentgemma scoring", 1024, 12288, "gelu", 38),
]

# The round kernel's stages (one warp a row, 8 rows a block, lane l holding
# columns l and l + 32, as csrc/router.cu lays it out), and an empty kernel
# of any grid.  Stage 0 loads the logits and stores k weights and ids a
# row; stage 1 computes the softmax between.  A store no run takes keeps
# every load live.
PROBES = r"""
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void empty_kernel() {}

template <int kStage>
__global__ void __launch_bounds__(kRows * 32)
stage_kernel(const float* __restrict__ x, float* __restrict__ w,
             int* __restrict__ ids, int rows, int e, int k, long long x_rs) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRows + threadIdx.x / 32;
  if (row >= rows) return;
  const float* xr = x + row * x_rs;
  float p[2];
  for (int j = 0; j < 2; ++j) p[j] = lane + 32 * j < e ? xr[lane + 32 * j]
                                                       : -INFINITY;
  if (kStage == 1) {
    float mx = fmaxf(p[0], p[1]);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    float s = 0.f;
    for (int j = 0; j < 2; ++j) {
      p[j] = lane + 32 * j < e ? expf(p[j] - mx) : 0.f;
      s += p[j];
    }
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(kFull, s, off);
    for (int j = 0; j < 2; ++j)
      p[j] = lane + 32 * j < e ? p[j] / s : -INFINITY;
  }
  for (int j = 0; j < 2; ++j) {
    const int c = lane + 32 * j;
    if (c < k) {
      w[(long long)row * k + c] = p[j];
      ids[(long long)row * k + c] = c;
    }
  }
  if (p[0] + p[1] == 1234.5f) w[(long long)row * k] = p[0];
}

}  // namespace

extern "C" int probe_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_router(int stage, const void* x, void* w, void* ids,
                            int rows, int e, int k, long long x_rs,
                            void* stream) {
  const dim3 grid((rows + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  if (stage == 0)
    stage_kernel<0><<<grid, kRows * 32, 0, s>>>(
        xf, static_cast<float*>(w), static_cast<int*>(ids), rows, e, k, x_rs);
  else
    stage_kernel<1><<<grid, kRows * 32, 0, s>>>(
        xf, static_cast<float*>(w), static_cast<int*>(ids), rows, e, k, x_rs);
  return static_cast<int>(cudaGetLastError());
}
"""

_PROBES: ctypes.CDLL | None = None


def probes() -> ctypes.CDLL:
    """The probe library, built from ``PROBES`` into ``build/probes``."""
    global _PROBES
    if _PROBES is None:
        out = build.build_dir().parent / "probes"
        out.mkdir(parents=True, exist_ok=True)
        src = out / "router_probes.cu"
        src.write_text(PROBES)
        lib = ctypes.CDLL(str(build.library("router_probes", out, out)))
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.probe_empty.argtypes = [ci, ci, vp]
        lib.probe_router.argtypes = [ci, vp, vp, vp, ci, ci, ci, cl, vp]
        lib.probe_empty.restype = lib.probe_router.restype = ci
        _PROBES = lib
    return _PROBES


def _checked(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed ({err})")


def empty_cuda(blocks: int, threads: int):
    def run():
        _checked(probes().probe_empty(blocks, threads,
                                      torch.cuda.current_stream().cuda_stream),
                 "empty kernel")
    return run


def router_stage(stage: int, x, k: int):
    T, E = x.shape
    w = torch.empty((T, k), dtype=x.dtype, device=x.device)
    ids = torch.empty((T, k), dtype=torch.int32, device=x.device)

    def run():
        _checked(probes().probe_router(
            stage, x.data_ptr(), w.data_ptr(), ids.data_ptr(), T, E, k,
            x.stride(0), torch.cuda.current_stream().cuda_stream),
            "router probe")
    return run


def router_variants(x, k: int) -> dict:
    """name -> a function of no arguments launching that variant once."""
    T = x.shape[0]
    return {
        "empty": empty_cuda(-(-T // 8), 256),
        "copy": router_stage(0, x, k),
        "softmax": router_stage(1, x, k),
        "rounds": lambda: router._launch_variant("rounds", x, k, True),
        "rank": lambda: router._launch_variant("rank", x, k, True),
    }


def _glu_empty_kernel(g_ptr, BLOCK: tl.constexpr):
    pass


def _glu_copy_kernel(g_ptr, u_ptr, o_ptr, F, stride_g, stride_u,
                     BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    col = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
    mask = col < F
    g = tl.load(g_ptr + row * stride_g + col, mask=mask, other=0.0).to(tl.float32)
    u = tl.load(u_ptr + row * stride_u + col, mask=mask, other=0.0).to(tl.float32)
    tl.store(o_ptr + row * F + col, (g + u).to(o_ptr.dtype.element_ty), mask=mask)


_JITS: dict = {}


def _jit(fn):
    if fn not in _JITS:
        _JITS[fn] = build.triton_jit(fn)
    return _JITS[fn]


def glu_variants(g, u, act: str) -> dict:
    rows, F = g.shape
    grid = (rows, -(-F // activations.BLOCK))
    out = torch.empty_like(g)
    narrow = min(activations.BLOCK, build.next_pow2(F))
    # csrc/activations.cu's grid: a row over up to a block's 128 threads,
    # rows side by side where a row takes fewer
    threads = 128
    chunks = F // (16 // g.element_size())
    lanes = min(threads, 1 << (chunks - 1).bit_length())
    blocks = -(-rows // (threads // lanes)) * -(-chunks // lanes)
    return {
        "empty": lambda: _jit(_glu_empty_kernel)[grid](
            g, BLOCK=activations.BLOCK, num_warps=4),
        "copy": lambda: _jit(_glu_copy_kernel)[grid](
            g, u, out, F, g.stride(0), u.stride(0), BLOCK=activations.BLOCK,
            num_warps=4),
        "triton": lambda: activations._launch_variant("triton", g, u, act),
        "triton_narrow": lambda: _jit(activations._glu_kernel)[
            (rows, -(-F // narrow))](
            g, u, out, F, g.stride(0), u.stride(0), ACT=activations._ACTS[act],
            BLOCK=narrow, num_warps=max(1, narrow // 256)),
        "empty_cuda": empty_cuda(blocks, threads),
        "cuda": lambda: activations._launch_variant("cuda", g, u, act),
    }


def logits(T, E, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return (2.0 * torch.randn(T, E, generator=gen)).to(dtype).cuda()


def glu_operand(rows, F, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return tuple((2.0 * torch.randn(rows, F, generator=gen)).to(dtype).cuda()
                 for _ in range(2))


def same_bits(a, b) -> bool:
    """Equal bit patterns (NaNs included), as ``torch.equal`` of integer
    views."""
    ints = {4: torch.int32, 2: torch.int16}
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    return torch.equal(a.contiguous().view(ints[a.element_size()]),
                       b.contiguous().view(ints[b.element_size()]))


def router_cases():
    """(name, logits, k, renormalize): the operands above in f32 and bf16,
    E of 1 to 64 at every k shape class, bf16-rounded f32 logits (exact
    ties), rows of equal logits and of -inf logits, strided rows."""
    out = []
    for dt in (torch.float32, torch.bfloat16):
        t = str(dt)[6:]
        for _, T, E, k, _ in ROUTER_OPERANDS:
            for renorm in (True, False):
                out.append((f"{t}_{T}x{E}_k{k}_r{int(renorm)}",
                            logits(T, E, dtype=dt), k, renorm))
        for E in (1, 2, 3, 5, 8, 9, 16, 17, 31, 32, 33, 47, 60, 64):
            for k in sorted({1, min(2, E), min(4, E), min(8, E), E}):
                out.append((f"{t}_37x{E}_k{k}", logits(37, E, E, dt), k,
                            True))
    ties = logits(2048, 32, 1, torch.bfloat16).float()
    ties[0] = 0.25
    ties[1, ::3] = -torch.inf
    ties[2, :20] = -torch.inf
    out += [("bf16_rounded_ties_k8", ties, 8, True),
            ("bf16_rounded_ties_k8_r0", ties, 8, False)]
    for E in (8, 33, 64):
        x = logits(100, E, E)
        x[::2, 1:E:2] = -torch.inf
        x[1::4] = 0.5
        out.append((f"inf_and_equal_rows_{E}", x, min(8, E), True))
    wide = logits(64, 80, 5)
    out.append(("strided_64x60_of_80", wide[:, 3:63], 8, True))
    return out


def glu_cases():
    """(name, gate, up, act): the operands above in f32 and bf16 with both
    activations, ragged widths, a column slice of wider rows, operands off
    16-byte alignment, and gates of zeros, infinities, saturating and tiny
    values."""
    out = []
    for dt in (torch.float32, torch.bfloat16):
        t = str(dt)[6:]
        for act in ("silu", "gelu"):
            shapes = [(r, F) for _, r, F, _, _ in GLU_OPERANDS]
            for rows, F in shapes + [(7, 333), (3, 6150), (1, 8), (5, 4),
                                     (37, 40), (9, 256), (3, 1032)]:
                out.append((f"{act}_{t}_{rows}x{F}", *glu_operand(
                    rows, F, dt, rows + F), act))
            g, u = glu_operand(4, 2 * 6144 + 8, dt, 3)
            out.append((f"{act}_{t}_slice", g[:, 8:6152], u[:, 6144:12288],
                        act))
            out.append((f"{act}_{t}_misaligned", g[:, 1:6145], u[:, 3:6147],
                        act))
            g, u = glu_operand(16, 1024, dt, 4)
            g.view(-1)[0::7] = 0.0
            g.view(-1)[1::11] = -0.0
            g.view(-1)[2::13] = torch.inf
            g.view(-1)[3::17] = -torch.inf
            g.view(-1)[4::19] = 40.0
            g.view(-1)[5::23] = -12.0
            g.view(-1)[6::29] = 3e-20
            g.view(-1)[8::31] = -1e-38
            out.append((f"{act}_{t}_special", g, u, act))
    return out


def bits() -> bool:
    """The new kernels against the kernels they replaced, bit for bit."""
    bad, n = [], 0
    for name, x, k, renorm in router_cases():
        new = router._launch_variant("rank", x, k, renorm)
        old = router._launch_variant("rounds", x, k, renorm)
        n += 1
        if not (same_bits(new[0], old[0]) and same_bits(new[1], old[1])):
            bad.append(f"router {name}: ids differ on "
                       f"{int((new[1] != old[1]).any(-1).sum())} rows")
    for name, g, u, act in glu_cases():
        new = activations._launch_variant("cuda", g, u, act)
        old = activations._launch_variant("triton", g, u, act)
        n += 1
        if not same_bits(new, old):
            diff = new.float() != old.float()
            bad.append(f"glu {name}: {int(diff.sum())} of {new.numel()} "
                       f"differ")
    torch.cuda.synchronize()
    print(f"new kernels vs the replaced, bit for bit: {n - len(bad)} of {n} "
          f"operands equal" + "".join(f"\n  {b}" for b in bad), flush=True)
    return not bad


def paired(fns: dict) -> dict:
    """name -> (median, least, most) device us a launch of each function,
    ``chip_smoke.paired_device_times`` (5 alternations of 100-launch
    CUDA-graph replays)."""
    times = chip_smoke.paired_device_times(*fns.values())
    return {n: (1e3 * float(np.median(t)), 1e3 * min(t), 1e3 * max(t))
            for n, t in zip(fns, times)}


def timed_columns(title: str, cases) -> None:
    """``cases``: (label, variants); each operand's variants timed paired,
    the median and, in brackets, the least and the most of the rounds."""
    print(f"{title}, device us a launch, paired: median [least-most]")
    for label, fns in cases:
        us = paired(fns)
        print(f"  {label}: " + " ".join(
            f"{n}={m:.3f}[{lo:.3f}-{hi:.3f}]" for n, (m, lo, hi) in us.items()),
            flush=True)


def breakdown() -> None:
    timed_columns("router (f32 logits)", [
        (f"{path} (T {T}, E {E}, k {k}) x{n}", router_variants(
            logits(T, E), k)) for path, T, E, k, n in ROUTER_OPERANDS])
    timed_columns("GLU (bf16)", [
        (f"{path} {act} ({rows}, {F}) x{n}", glu_variants(
            *glu_operand(rows, F, torch.bfloat16), act))
        for path, rows, F, act, n in GLU_OPERANDS])


def _sass(compiled) -> str:
    try:
        return compiled.asm["sass"]
    except Exception:  # older Triton: disassemble the cubin ourselves
        import tempfile
        with tempfile.NamedTemporaryFile(suffix=".cubin") as f:
            f.write(compiled.asm["cubin"])
            f.flush()
            for tool in (Path(build.nvcc()).parent / "cuobjdump", "cuobjdump"):
                try:
                    return subprocess.run([str(tool), "-sass", f.name],
                                          capture_output=True, text=True,
                                          check=True).stdout
                except (OSError, subprocess.CalledProcessError):
                    continue
    return "no disassembler found"


def dump_asm(out: Path) -> None:
    out.mkdir(parents=True, exist_ok=True)
    import triton
    print(f"triton {triton.__version__}")
    for act in ("silu", "gelu"):
        for dt in (torch.bfloat16, torch.float32):
            g, u = glu_operand(4, 6144, dt)
            o = torch.empty_like(g)
            k = _jit(activations._glu_kernel)[(4, 6)](
                g, u, o, 6144, g.stride(0), u.stride(0),
                ACT=activations._ACTS[act], BLOCK=activations.BLOCK,
                num_warps=4)
            torch.cuda.synchronize()
            stem = f"glu_{act}_{str(dt)[6:]}"
            (out / f"{stem}.ttgir").write_text(k.asm["ttgir"])
            (out / f"{stem}.ptx").write_text(k.asm["ptx"])
            (out / f"{stem}.sass").write_text(_sass(k))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--asm", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    if args.asm is not None:
        dump_asm(args.asm)
    same = bits()
    breakdown()
    if not same:
        raise SystemExit("the new kernels differ from the kernels they "
                         "replaced")


if __name__ == "__main__":
    main()
