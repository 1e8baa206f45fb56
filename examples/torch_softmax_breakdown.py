"""Where a masked softmax launch's time goes, on the kernel API's attention
operand and the card check's samples, and what Triton compiled for the
Triton masked softmax.

Device us a launch, paired (``chip_smoke.paired_device_times``: the median
of 5 alternations of 100-launch CUDA-graph replays, every column of an
operand in turn; the least and the most of the 5 beside it), of:

* ``empty_triton``, an empty Triton kernel at the Triton kernel's grid
  and warps (``softmax._layout``);
* ``empty_cuda``, an empty CUDA kernel at the CUDA kernel's grid and
  threads (``softmax.masked_plan``);
* ``copy``, a CUDA kernel that reads the mask and every x vector and
  writes x where the mask keeps it, else 0, a warp a row (Triton's layout
  of a 256-column row) over the CUDA kernel's grid;
* ``copy_kept``, the same reading x only in the 16-byte vectors that hold
  a kept lane;
* ``triton``, the Triton kernel the op launched before
  (``softmax._launch_variant("triton", ...)``);
* ``cuda``, the CUDA kernel the op launches (``csrc/softmax.cu``: the mask
  first, then x only in the 16-byte words that hold a kept lane, the next
  group's x and the mask of the group after it in flight);
* ``cuda_xm1`` and ``cuda_xm2``, the same kernel with x's words loaded
  together with their mask, every word inside the row, one or two groups
  ahead (``LOOP_VARIANTS``: the mask-to-x dependency gone, the warps whose
  rows are all masked still skipping their arithmetic);
* the op's kernel at other grids (``cuda_g<k>``: k blocks an SM, through
  the library's C entry, as the plan's grid is fixed at
  ``softmax.BLOCKS_PER_SM``).

The operands: scores (16384, 256) of the kernel API's masked GQA
attention (qwen3-1.7b's 16 q heads over the long prompts' padding mask,
``chip_smoke.padding_mask``), bf16 as the path runs them and f32 as its
f32 check does, and ``chip_smoke.api_samples``' (64, 256) with its random
mask.  Each line gives the share of kept lanes, of x's 32-byte sectors
holding a kept lane and the fully masked rows, and both bounds at 3.35
TB/s: all of x, the mask and the output, and only the kept sectors of x.

It first holds the CUDA kernel against the Triton kernel, and each loop
variant against the CUDA kernel, bit for bit (as ``torch.equal`` of
integer views, NaN included), f32 and bf16, at those operands and at
ragged widths, strided rows, and NaN and infinities at kept and masked
lanes.

With ``--asm DIR`` it also writes the Triton kernel's TTGIR, PTX and SASS
(the masked path, bf16 and f32, at (16384, 256), (6, 333) and (1, 8192))
and the CUDA library's ptxas report and SASS.  Needs one card:

    PYTHONPATH=src python3 examples/torch_softmax_breakdown.py [--asm DIR]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (paired_device_times, padding_mask)

from repro_torch.kernels import build, softmax  # noqa: E402

tl = None             # triton.language, bound by build.triton_jit at launch

HEADS = 16            # qwen3-1.7b's q heads
GRIDS = (2, 4, 8, 16)  # blocks an SM of the cuda_g<k> designs

# The op kernel's row loop (csrc/softmax.cu: softmax_masked_kernel), and
# the designs that load x together with the mask: every word of x inside
# the row (`inb`), with its mask, one group ahead (xm1) or two (xm2).
LOOP = """  typename Ln::Mask m;
  typename Ln::X x, xn;
  long long g = blockIdx.x;
  Ln::load_mask(m, a, row_of(g), col);
  unsigned kb = Ln::bits(m), kn = 0;
  Ln::load_x(x, a, row_of(g), col, kb);
  if (g + G < a.groups) Ln::load_mask(m, a, row_of(g + G), col);
  for (; g < a.groups; g += G) {
    if (g + G < a.groups) {
      kn = Ln::bits(m);
      Ln::load_x(xn, a, row_of(g + G), col, kn);
      if (g + 2 * G < a.groups) Ln::load_mask(m, a, row_of(g + 2 * G), col);
    }
    row_softmax<T, E, kV, kWarpRow>(a, row_of(g), kb, x, col, slot, wr, ln,
                                    part);
    kb = kn;
    x = xn;
  }
"""
IN_ROW = """  unsigned inb = 0;  // the lane's elements inside the row
#pragma unroll
  for (int e = 0; e < E; ++e) inb |= (col(e) < a.d ? 1u : 0u) << e;
"""
LOOP_VARIANTS = {
    "xm1": IN_ROW + """  typename Ln::Mask m, mn;
  typename Ln::X x, xn;
  long long g = blockIdx.x;
  Ln::load_mask(m, a, row_of(g), col);
  Ln::load_x(x, a, row_of(g), col, inb);
  for (; g < a.groups; g += G) {
    if (g + G < a.groups) {
      Ln::load_mask(mn, a, row_of(g + G), col);
      Ln::load_x(xn, a, row_of(g + G), col, inb);
    }
    row_softmax<T, E, kV, kWarpRow>(a, row_of(g), Ln::bits(m), x, col, slot,
                                    wr, ln, part);
    m = mn;
    x = xn;
  }
""",
    "xm2": IN_ROW + """  typename Ln::Mask m0, m1, m2;
  typename Ln::X x0, x1, x2;
  long long g = blockIdx.x;
  Ln::load_mask(m0, a, row_of(g), col);
  Ln::load_x(x0, a, row_of(g), col, inb);
  if (g + G < a.groups) {
    Ln::load_mask(m1, a, row_of(g + G), col);
    Ln::load_x(x1, a, row_of(g + G), col, inb);
  }
  for (; g < a.groups; g += G) {
    if (g + 2 * G < a.groups) {
      Ln::load_mask(m2, a, row_of(g + 2 * G), col);
      Ln::load_x(x2, a, row_of(g + 2 * G), col, inb);
    }
    row_softmax<T, E, kV, kWarpRow>(a, row_of(g), Ln::bits(m0), x0, col,
                                    slot, wr, ln, part);
    m0 = m1;
    x0 = x1;
    m1 = m2;
    x1 = x2;
  }
""",
}

# An empty kernel of any grid, and the copies: one warp a row of d columns
# (d a multiple of 256: 8 columns a lane, the lane's mask bytes as one
# 8-byte load), rows over the grid's warps.  kAll reads every x vector,
# else only the 16-byte vectors holding a kept lane; the x loads are
# volatile, so the compiler keeps each one that the source issues.
PROBES = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void empty_kernel() {}

// a 16-byte load the compiler may neither drop nor predicate
__device__ __forceinline__ uint4 ld16(const void* p) {
  uint4 r;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

__device__ __forceinline__ unsigned keep_bits(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x08040201u) * 0x01010101u) >> 24;
}

// 8 elements of T as 16-byte words (1 for bf16, 2 for f32), kept by `kb`
template <typename T, bool kAll>
__global__ void copy_kernel(const T* __restrict__ x,
                            const uint8_t* __restrict__ m, T* __restrict__ o,
                            long long rows, int d, long long xs,
                            long long ms) {
  constexpr int kWords = 8 * sizeof(T) / 16;
  constexpr int kPer = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long r = blockIdx.x * (long long)(blockDim.x >> 5) +
                     (threadIdx.x >> 5);
       r < rows; r += warps) {
    for (int c = lane * 8; c < d; c += 256) {
      const uint2 mk = *reinterpret_cast<const uint2*>(m + r * ms + c);
      const unsigned kb = keep_bits(mk.x) | (keep_bits(mk.y) << 4);
      uint4 w[kWords];
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        const unsigned part = (kb >> (k * kPer)) & ((1u << kPer) - 1);
        w[k] = make_uint4(0u, 0u, 0u, 0u);
        if (kAll || part) w[k] = ld16(x + r * xs + c + k * kPer);
        if (!part) w[k] = make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < kWords; ++k)
        *reinterpret_cast<uint4*>(o + r * d + c + k * kPer) = w[k];
    }
  }
}

template <typename T>
int copy(int all, const void* x, const void* m, void* o, long long rows,
         int d, long long xs, long long ms, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto xt = static_cast<const T*>(x);
  const auto mt = static_cast<const uint8_t*>(m);
  const auto ot = static_cast<T*>(o);
  if (all)
    copy_kernel<T, true><<<blocks, 128, 0, s>>>(xt, mt, ot, rows, d, xs, ms);
  else
    copy_kernel<T, false><<<blocks, 128, 0, s>>>(xt, mt, ot, rows, d, xs, ms);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int probe_empty(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_copy(int dtype, int all, const void* x, const void* m,
                          void* o, long long rows, int d, long long xs,
                          long long ms, int blocks, void* stream) {
  if (dtype == 0)
    return copy<float>(all, x, m, o, rows, d, xs, ms, blocks, stream);
  return copy<__nv_bfloat16>(all, x, m, o, rows, d, xs, ms, blocks, stream);
}
"""

_LIBS: dict = {}


def variant_source(name: str) -> str:
    """``csrc/softmax.cu`` with its row loop replaced by
    ``LOOP_VARIANTS[name]``."""
    src = (build.CSRC / "softmax.cu").read_text()
    if src.count(LOOP) != 1:
        raise RuntimeError("csrc/softmax.cu's row loop is not LOOP")
    return src.replace(LOOP, LOOP_VARIANTS[name])


def libraries() -> dict:
    """name -> library: ``probes`` (built from ``PROBES``) and each loop
    variant (bound as the op's library is), built side by side into
    ``build/probes``."""
    if not _LIBS:
        out = build.build_dir().parent / "probes"
        out.mkdir(parents=True, exist_ok=True)
        (out / "softmax_probes.cu").write_text(PROBES)
        for name in LOOP_VARIANTS:
            (out / f"softmax_{name}.cu").write_text(variant_source(name))
        stems = ["probes", *LOOP_VARIANTS]
        with ThreadPoolExecutor(len(stems)) as pool:
            paths = list(pool.map(
                lambda n: build.library(f"softmax_{n}", out, out), stems))
        lib = ctypes.CDLL(str(paths[0]))
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.probe_empty.argtypes = [ci, ci, vp]
        lib.probe_copy.argtypes = [ci, ci, vp, vp, vp, cl, ci, cl, cl, ci, vp]
        lib.probe_empty.restype = lib.probe_copy.restype = ci
        _LIBS["probes"] = lib
        for name, path in zip(stems[1:], paths[1:]):
            _LIBS[name] = softmax.bind(ctypes.CDLL(str(path)))
    return _LIBS


def probes() -> ctypes.CDLL:
    return libraries()["probes"]


def launch_masked(lib, x, m, scale: float, blocks: int | None = None):
    """One launch of ``lib``'s ``repro_softmax_masked`` on x and its bool
    mask at the op's plan, on a grid of ``blocks`` (default the plan's)."""
    rows, d = x.shape
    mu = m.view(torch.uint8)
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    plan = softmax.masked_plan(rows, d, x.dtype, x.data_ptr(), x.stride(0),
                               mu.data_ptr(), mu.stride(0),
                               softmax.sm_count(x.device.index))
    _checked(lib.repro_softmax_masked(
        x.data_ptr(), mu.data_ptr(), out.data_ptr(),
        0 if x.dtype == torch.float32 else 1, rows, d, x.stride(0),
        mu.stride(0), float(scale), plan.vec, plan.lanes, plan.warps,
        plan.threads, blocks or plan.blocks, _stream()), "softmax_masked")
    return out


def _checked(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed ({err})")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _empty_triton_kernel(x_ptr, BLOCK: tl.constexpr):
    pass


_JITS: dict = {}


def _jit(fn):
    if fn not in _JITS:
        _JITS[fn] = build.triton_jit(fn)
    return _JITS[fn]


def variants(x, m, scale: float) -> dict:
    """name -> a function of no arguments launching that variant once."""
    rows, d = x.shape
    mu = m.view(torch.uint8)
    out = torch.empty_like(x)
    block_r, block_d, warps = softmax._layout(rows, d)
    sms = softmax.sm_count(x.device.index)
    plan = softmax.masked_plan(rows, d, x.dtype, x.data_ptr(), x.stride(0),
                               mu.data_ptr(), mu.stride(0), sms)
    blocks, threads = plan.blocks, plan.threads
    dt = 0 if x.dtype == torch.float32 else 1

    def empty(b, t):
        return lambda: _checked(probes().probe_empty(b, t, _stream()),
                                "empty kernel")

    def copy(all_x):
        def run():
            _checked(probes().probe_copy(
                dt, int(all_x), x.data_ptr(), mu.data_ptr(), out.data_ptr(),
                rows, d, x.stride(0), mu.stride(0), blocks, _stream()), "copy")
        return run

    fns = {
        "empty_triton": lambda: _jit(_empty_triton_kernel)[
            (-(-rows // block_r),)](x, BLOCK=block_d, num_warps=warps),
        "empty_cuda": empty(blocks, threads),
    }
    if d % 256 == 0:
        fns["copy"] = copy(True)
        fns["copy_kept"] = copy(False)
    fns["triton"] = lambda: softmax._launch_variant("triton", x, m, scale)
    fns["cuda"] = lambda: softmax._launch_variant("cuda", x, m, scale)
    for name in LOOP_VARIANTS:
        fns[f"cuda_{name}"] = (lambda lib=libraries()[name]: launch_masked(
            lib, x, m, scale))
    for k in GRIDS:
        fns[f"cuda_g{k}"] = (lambda k=k: launch_masked(
            softmax._lib(), x, m, scale, sms * k))
    return fns


def attention_operand(dtype, seed=0):
    """(scores (16384, 256), mask (16384, 256), scale): the kernel API's
    masked attention rows, the mask expanded over the q heads as
    ``softmax()`` expands it."""
    gen = torch.Generator().manual_seed(seed)
    lens = chip_smoke.LONG_LENS
    L = int(lens.max())
    x = torch.randn(len(lens) * HEADS * L, L, generator=gen).to(dtype).cuda()
    mask = chip_smoke.padding_mask(lens, L, "cuda")
    mask = mask.expand(len(lens), HEADS, L, L).reshape(-1, L)
    return x, mask, 128 ** -0.5


def sample_operand(rows, d, dtype, seed=0):
    """``chip_smoke.api_samples``' masked operand: random keep lanes and,
    past two rows, row 0 fully masked and row 1 masked in its first half."""
    gen = torch.Generator().manual_seed(seed)
    mask = torch.rand((rows, d), generator=gen) < 0.6
    if rows > 2:
        mask[0] = False
        mask[1, : d // 2] = False
    x = 3.0 * torch.randn(rows, d, generator=gen)
    return x.to(dtype).cuda(), mask.cuda(), 128 ** -0.5


def operands():
    """(label, x, mask, scale)."""
    out = []
    for dt in (torch.bfloat16, torch.float32):
        t = str(dt)[6:]
        out.append((f"attention {t}", *attention_operand(dt)))
        out.append((f"sample {t}", *sample_operand(64, 256, dt)))
    return out


def data_terms(x, mask) -> str:
    """Kept lanes, kept 32-byte sectors of x, fully masked rows, and the
    two bounds (us at 3.35 TB/s)."""
    rows, d = x.shape
    per = 32 // x.element_size()
    kept = mask.float().mean().item()
    pad = (-d) % per
    mpad = torch.nn.functional.pad(mask, (0, pad)).reshape(rows, -1, per)
    sectors = int(mpad.any(-1).sum())
    full = 2 * x.numel() * x.element_size() + mask.numel()
    least = 32 * sectors + x.numel() * x.element_size() + mask.numel()
    return (f"kept lanes {100 * kept:.1f} %, kept sectors "
            f"{100 * sectors / mpad[..., 0].numel():.1f} %, fully masked rows "
            f"{int((~mask.any(-1)).sum())} of {rows}; bound all bytes "
            f"{1e6 * full / chip_smoke.HBM_BW:.3f} us, kept sectors "
            f"{1e6 * least / chip_smoke.HBM_BW:.3f} us")


def same_bits(a, b) -> bool:
    """Equal bit patterns (NaNs included)."""
    ints = {4: torch.int32, 2: torch.int16}
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.contiguous().view(ints[a.element_size()]),
                       b.contiguous().view(ints[b.element_size()]))


def bit_cases():
    """(name, x, mask, scale): the operands, ragged widths 1 to 8192,
    strided rows, a misaligned x, and NaN and infinities at kept and
    masked lanes."""
    out = [(n, x, m, s) for n, x, m, s in operands()]
    for dt in (torch.float32, torch.bfloat16):
        t = str(dt)[6:]
        for rows, d in ((7, 1), (5, 3), (9, 16), (6, 333), (3, 1000),
                        (4, 1024), (2, 2048), (3, 4097), (2, 8192),
                        (300, 128), (33, 512), (1, 256)):
            x, m, _ = sample_operand(rows, d, dt, rows + d)
            out.append((f"{t}_{rows}x{d}", x, m, 0.7))
        x, m, _ = sample_operand(40, 640, dt, 3)
        out.append((f"{t}_strided", x[:, 64:576], m[:, 64:576], 1.0))
        out.append((f"{t}_misaligned", x[:, 1:257], m[:, 3:259], 1.0))
        x, m, _ = sample_operand(16, 256, dt, 4)
        x[2, 5], x[3, 7], x[4, 9], x[5, 11] = (float("nan"), float("inf"),
                                               -float("inf"), float("nan"))
        m[2, 5] = m[3, 7] = m[4, 9] = True
        m[5, 11] = False
        x[6] = -float("inf")
        m[7] = True
        out.append((f"{t}_special", x, m, 1.0))
    return out


def bits() -> bool:
    bad, n = [], 0
    for name, x, m, scale in bit_cases():
        new = softmax._launch_variant("cuda", x, m, scale)
        pairs = [("triton", softmax._launch_variant("triton", x, m, scale))]
        pairs += [(v, launch_masked(libraries()[v], x, m, scale))
                  for v in LOOP_VARIANTS]
        for other, old in pairs:
            n += 1
            if not same_bits(new, old):
                diff = ~((new == old) | (torch.isnan(new) & torch.isnan(old)))
                bad.append(f"{name} against {other}: {int(diff.sum())} of "
                           f"{new.numel()} differ")
    torch.cuda.synchronize()
    print(f"cuda vs triton and the loop variants, masked softmax, bit for "
          f"bit: {n - len(bad)} of {n} pairs equal"
          + "".join(f"\n  {b}" for b in bad), flush=True)
    return not bad


def breakdown() -> None:
    print("masked softmax, device us a launch, paired: median [least-most]")
    for label, x, m, scale in operands():
        fns = variants(x, m, scale)
        times = chip_smoke.paired_device_times(*fns.values())
        print(f"  {label} {tuple(x.shape)}: {data_terms(x, m)}")
        print("    " + " ".join(
            f"{n}={1e3 * float(np.median(t)):.3f}[{1e3 * min(t):.3f}-"
            f"{1e3 * max(t):.3f}]" for n, t in zip(fns, times)), flush=True)


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
    for dt in (torch.bfloat16, torch.float32):
        for rows, d in ((16384, 256), (6, 333), (1, 8192)):
            if (rows, d) == (16384, 256):
                x, m, scale = attention_operand(dt)
            else:
                x, m, scale = sample_operand(rows, d, dt)
            mu = m.view(torch.uint8)
            o = torch.empty_like(x)
            block_r, block_d, warps = softmax._layout(rows, d)
            k = _jit(softmax._softmax_kernel)[(-(-rows // block_r),)](
                x, mu, o, rows, d, x.stride(0), mu.stride(0), float(scale),
                HAS_MASK=True, BLOCK_R=block_r, BLOCK_D=block_d,
                num_warps=warps)
            torch.cuda.synchronize()
            stem = f"softmax_masked_{str(dt)[6:]}_{rows}x{d}"
            (out / f"{stem}.ttgir").write_text(k.asm["ttgir"])
            (out / f"{stem}.ptx").write_text(k.asm["ptx"])
            (out / f"{stem}.sass").write_text(_sass(k))
    lib = build.library("softmax")
    (out / "softmax_cu_ptxas.log").write_text(
        lib.with_suffix(".log").read_text())
    for tool in (Path(build.nvcc()).parent / "cuobjdump", "cuobjdump"):
        try:
            (out / "softmax_cu.sass").write_text(subprocess.run(
                [str(tool), "-sass", str(lib)], capture_output=True,
                text=True, check=True).stdout)
            break
        except (OSError, subprocess.CalledProcessError):
            continue


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
        raise SystemExit("the CUDA kernel differs from the Triton kernel "
                         "or a loop variant")


if __name__ == "__main__":
    main()
