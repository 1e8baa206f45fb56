"""Where a norm launch's time goes, on the paths' operands, and what Triton
compiled for the Triton norm kernels.

For RMSNorm and LayerNorm (``repro_torch.kernels.norms``) at every operand
the serving and scoring paths launch them on (bf16), device us a launch in
a CUDA-graph replay (``chip_smoke.device_ms``) of:

* ``empty``: a Triton kernel with no body, at the norm's grid and warps;
* ``copy``: the norm's loads and stores alone (x read, x written);
* ``reduce``: the loads, the row reduction(s) and the normalisation, no
  gamma or beta;
* ``triton``: the whole Triton kernel;
* ``cuda``: the CUDA kernel the op launches (``csrc/norms.cu``), and its
  block plan.

It first holds the CUDA kernels against the Triton kernels bit for bit at
every path operand in bf16 and f32 and at operands Triton lays out
otherwise (strided, misaligned, ragged), and last times the CUDA
LayerNorm with gamma and beta loaded early and late (the same bits).

With ``--asm DIR`` it also writes the Triton kernels' TTGIR, PTX and SASS
at the paths' program shapes ``(BLOCK_R, BLOCK_D, num_warps)`` = (1, 2048,
4), (8, 128, 4), (1, 1024, 4), (1, 4096, 8), (1, 8192, 8) in bf16 and f32,
and the TTGIR of RMSNorm at misaligned and row-strided operands (the
layout Triton takes depends on its divisibility-by-16 specialisation of
the pointers and the strides).  Needs one card:

    PYTHONPATH=src python3 examples/torch_norm_breakdown.py [--asm DIR]
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (device_ms: a CUDA-graph replay)

from repro_torch.kernels import build, norms  # noqa: E402

tl = None             # triton.language, bound by build.triton_jit at launch

# (path, kernel, rows, d, launches a step or call)
OPERANDS = [
    ("qwen3 decode", "rmsnorm", 4, 2048, 57),
    ("qwen3 decode", "rmsnorm", 64, 128, 28),
    ("qwen3 decode", "rmsnorm", 32, 128, 28),
    ("qwen3 prefill 64", "rmsnorm", 256, 2048, 57),
    ("qwen3 prefill 64", "rmsnorm", 4096, 128, 28),
    ("qwen3 prefill 64", "rmsnorm", 2048, 128, 28),
    ("qwen3 prefill 256", "rmsnorm", 1024, 2048, 57),
    ("qwen3 prefill 256", "rmsnorm", 16384, 128, 28),
    ("qwen3 prefill 256", "rmsnorm", 8192, 128, 28),
    ("granite decode", "rmsnorm", 4, 1024, 49),
    ("granite prefill 256", "rmsnorm", 1024, 1024, 49),
    ("falcon / rg scoring", "rmsnorm", 1024, 4096, 33),
    ("nemotron decode", "layernorm", 4, 6144, 65),
    ("nemotron prefill 256", "layernorm", 1024, 6144, 65),
]


def _empty_kernel(x_ptr, BLOCK_D: tl.constexpr):
    pass


def _copy_kernel(x_ptr, o_ptr, rows, d, stride_x,
                 BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
    r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)[:, None]
    c = tl.arange(0, BLOCK_D)[None, :]
    mask = (r < rows) & (c < d)
    r64 = r.to(tl.int64)
    x = tl.load(x_ptr + r64 * stride_x + c, mask=mask, other=0.0)
    tl.store(o_ptr + r64 * d + c, x, mask=mask)


def _rms_reduce_kernel(x_ptr, o_ptr, rows, d, stride_x, eps,
                       BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
    r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)[:, None]
    c = tl.arange(0, BLOCK_D)[None, :]
    mask = (r < rows) & (c < d)
    r64 = r.to(tl.int64)
    x = tl.load(x_ptr + r64 * stride_x + c, mask=mask, other=0.0).to(tl.float32)
    var = tl.div_rn(tl.sum(x * x, axis=1)[:, None], 1.0 * d)
    y = x * tl.rsqrt(var + eps)
    tl.store(o_ptr + r64 * d + c, y.to(o_ptr.dtype.element_ty), mask=mask)


def _ln_reduce_kernel(x_ptr, o_ptr, rows, d, stride_x, eps,
                      BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
    r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)[:, None]
    c = tl.arange(0, BLOCK_D)[None, :]
    mask = (r < rows) & (c < d)
    r64 = r.to(tl.int64)
    x = tl.load(x_ptr + r64 * stride_x + c, mask=mask, other=0.0).to(tl.float32)
    mu = tl.div_rn(tl.sum(x, axis=1)[:, None], 1.0 * d)
    xc = tl.where(mask, x - mu, 0.0)
    var = tl.div_rn(tl.sum(xc * xc, axis=1)[:, None], 1.0 * d)
    y = xc * tl.rsqrt(var + eps)
    tl.store(o_ptr + r64 * d + c, y.to(o_ptr.dtype.element_ty), mask=mask)


_JITS: dict = {}


def _jit(fn):
    if fn not in _JITS:
        _JITS[fn] = build.triton_jit(fn)
    return _JITS[fn]


def variants(kernel, x, g, b):
    """name -> a function of no arguments launching that variant once."""
    rows, d = x.shape
    block_r, block_d, warps = norms._blocks(rows, d)
    grid = (-(-rows // block_r),)
    out = torch.empty_like(x)
    reduce = _rms_reduce_kernel if kernel == "rmsnorm" else _ln_reduce_kernel
    whole = ((lambda: norms._launch_variant("triton", x, g, 1e-6))
             if kernel == "rmsnorm" else
             (lambda: norms._launch_layernorm_variant("triton", x, g, b, 1e-5)))
    cuda = ((lambda: norms._launch_variant("cuda", x, g, 1e-6))
            if kernel == "rmsnorm" else
            (lambda: norms._launch_layernorm_variant("cuda", x, g, b, 1e-5)))
    return {
        "empty": lambda: _jit(_empty_kernel)[grid](x, BLOCK_D=block_d,
                                                   num_warps=warps),
        "copy": lambda: _jit(_copy_kernel)[grid](
            x, out, rows, d, x.stride(0), BLOCK_R=block_r, BLOCK_D=block_d,
            num_warps=warps),
        "reduce": lambda: _jit(reduce)[grid](
            x, out, rows, d, x.stride(0), 1e-6, BLOCK_R=block_r,
            BLOCK_D=block_d, num_warps=warps),
        "triton": whole,
        "cuda": cuda,
    }


def operand(rows, d, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (2.0 * torch.randn(rows, d, generator=gen) + 0.5).to(dtype).cuda()
    g = (1 + 0.1 * torch.randn(d, generator=gen)).to(dtype).cuda()
    b = (0.1 * torch.randn(d, generator=gen)).to(dtype).cuda()
    return x, g, b


def breakdown():
    print("device us a launch, CUDA-graph replay (empty / copy / reduce / "
          "triton / cuda), and the CUDA kernel's plan:")
    for path, kernel, rows, d, n in OPERANDS:
        x, g, b = operand(rows, d, torch.bfloat16)
        us = {}
        for name, fn in variants(kernel, x, g, b).items():
            try:
                us[name] = 1e3 * chip_smoke.device_ms(fn, 50)
            except Exception as e:  # report and go on: a breakdown, not a gate
                us[name] = float("nan")
                print(f"  {name} failed at {rows}x{d}: {e}")
        plan = norms.block_plan(rows, d, torch.bfloat16, x.data_ptr(),
                                x.stride(0))
        print(f"{path} {kernel} ({rows}, {d}) x{n}: "
              + " ".join(f"{k}={v:.3f}" for k, v in us.items())
              + f" triton_blocks={norms._blocks(rows, d)} cuda_plan={plan}",
              flush=True)


def cuda_with(kernel, x, g, b, plan):
    """One launch of the CUDA kernel on x with ``plan`` in place of
    ``norms.block_plan``'s."""
    out = torch.empty_like(x)
    vectors = (g,) if kernel == "rmsnorm" else (g, b)
    err = getattr(norms._lib(), f"repro_{kernel}")(
        x.data_ptr(), *(v.data_ptr() for v in vectors), out.data_ptr(),
        norms._FLOAT[x.dtype], x.shape[0], x.shape[1], x.stride(0),
        1e-6 if kernel == "rmsnorm" else 1e-5, plan.vec, plan.lanes,
        plan.warps, plan.threads, int(plan.early),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(norms._lib().repro_cuda_error_string(err).decode())
    return out


def blocks():
    """Device us a launch of the CUDA LayerNorm at each of its operands
    with gamma and beta loaded early (with x) and late (after the
    reductions), each output bit for bit the plan's."""
    print("CUDA LayerNorm, gamma and beta early or late, device us a launch:")
    for path, kernel, rows, d, n in OPERANDS:
        if kernel != "layernorm":
            continue
        x, g, b = operand(rows, d, torch.bfloat16)
        plan = norms.block_plan(rows, d, x.dtype, x.data_ptr(), x.stride(0))
        ref = cuda_with(kernel, x, g, b, plan)
        us = {}
        for early in (True, False):
            p = plan._replace(early=early)
            if not torch.equal(cuda_with(kernel, x, g, b, p), ref):
                raise SystemExit(f"{kernel} {rows}x{d}: plan {p} changes the "
                                 f"bits")
            us["early" if early else "late"] = 1e3 * chip_smoke.device_ms(
                lambda p=p: cuda_with(kernel, x, g, b, p), 50)
        print(f"{path} {kernel} ({rows}, {d}): plan "
              f"{'early' if plan.early else 'late'} "
              + " ".join(f"{k}={v:.3f}" for k, v in us.items()), flush=True)


def operands_for_bits():
    """(name, kernel, x, g, b): every path operand in bf16 and f32, and
    operands whose layout Triton takes otherwise: a row stride not a
    multiple of 16 elements, an x or gamma not 16-byte aligned, widths off
    a multiple of 16, programs of fewer rows than threads."""
    out = []
    for dt in (torch.bfloat16, torch.float32):
        t = str(dt)[6:]
        for _, kernel, rows, d, _ in OPERANDS:
            x, g, b = operand(rows, d, dt)
            out.append((f"{kernel}_{t}_{rows}x{d}", kernel, x, g, b))
        for kernel in ("rmsnorm", "layernorm"):
            for rows, d in ((1, 128), (2, 128), (3, 200), (12, 200), (37, 96),
                            (1, 200), (1, 2000), (5, 6144), (4, 2048)):
                x, g, b = operand(rows, d + 8, dt, seed=rows)
                buf = torch.empty(rows * (d + 8) + 8, dtype=dt, device="cuda")
                mis = buf[1:1 + rows * (d + 8)].view(rows, d + 8)
                mis.copy_(x)
                gbuf = torch.empty(d + 8, dtype=dt, device="cuda")
                gmis = gbuf[1:1 + d]
                gmis.copy_(g[:d])
                gc, bc = g[:d].contiguous(), b[:d].contiguous()
                name = f"{kernel}_{t}_{rows}x{d}"
                out += [(f"{name}", kernel, x[:, :d].contiguous(), gc, bc),
                        (f"{name}_stride{d + 8}", kernel, x[:, :d], gc, bc),
                        (f"{name}_x_misaligned", kernel, mis[:, :d], gc, bc),
                        (f"{name}_gamma_misaligned", kernel,
                         x[:, :d].contiguous(), gmis, bc)]
    return out


def bits():
    """The CUDA kernel against the Triton kernel, bit for bit."""
    bad = []
    cases = operands_for_bits()
    for name, kernel, x, g, b in cases:
        if kernel == "rmsnorm":
            new = norms._launch_variant("cuda", x, g, 1e-6)
            old = norms._launch_variant("triton", x, g, 1e-6)
        else:
            new = norms._launch_layernorm_variant("cuda", x, g, b, 1e-5)
            old = norms._launch_layernorm_variant("triton", x, g, b, 1e-5)
        if not torch.equal(new, old):
            plan = norms.block_plan(*x.shape, x.dtype, x.data_ptr(),
                                    x.stride(0), g.data_ptr() % 16 == 0)
            bad.append(f"{name} ({int((new != old).sum())} of {new.numel()} "
                       f"differ, {plan})")
    print(f"CUDA vs Triton bit for bit: {len(cases) - len(bad)} of "
          f"{len(cases)} operands equal" + "".join(f"\n  {b}" for b in bad),
          flush=True)
    return not bad


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


def _compiled(kernel, x, g, b):
    """Launch the Triton kernel once on x and return Triton's compiled
    kernel object."""
    rows, d = x.shape
    block_r, block_d, warps = norms._blocks(rows, d)
    out = torch.empty((rows, d), dtype=x.dtype, device=x.device)
    grid = (-(-rows // block_r),)
    if kernel == "rmsnorm":
        k = _jit(norms._rmsnorm_kernel)[grid](
            x, g, out, rows, d, x.stride(0), 1e-6, BLOCK_R=block_r,
            BLOCK_D=block_d, num_warps=warps)
    else:
        k = _jit(norms._layernorm_kernel)[grid](
            x, g, b, out, rows, d, x.stride(0), 1e-5, BLOCK_R=block_r,
            BLOCK_D=block_d, num_warps=warps)
    torch.cuda.synchronize()
    return k


def dump_asm(out: Path):
    out.mkdir(parents=True, exist_ok=True)
    import triton
    print(f"triton {triton.__version__}")
    for kernel in ("rmsnorm", "layernorm"):
        for dt in (torch.bfloat16, torch.float32):
            for rows, d in ((4, 2048), (64, 128), (4, 1024), (4, 4096),
                            (4, 6144)):
                x, g, b = operand(rows, d, dt)
                k = _compiled(kernel, x, g, b)
                stem = (f"{kernel}_{str(dt)[6:]}_"
                        + "x".join(map(str, norms._blocks(rows, d))))
                (out / f"{stem}.ttgir").write_text(k.asm["ttgir"])
                (out / f"{stem}.ptx").write_text(k.asm["ptx"])
                (out / f"{stem}.sass").write_text(_sass(k))
    # the layout at operands that are not 16-byte aligned or whose row
    # stride is not a multiple of 16 elements
    for dt in (torch.bfloat16, torch.float32):
        for rows, d in ((4, 2048), (64, 128), (256, 2048), (4, 200),
                        (37, 96), (3, 200)):
            x, g, b = operand(rows, d + 8, dt)
            buf = torch.empty(rows * (d + 8) + 8, dtype=dt, device="cuda")
            cases = {
                "aligned": x[:, :d].contiguous(),
                "stride_plus8": x[:, :d],
                "ptr_plus1": buf[1:1 + rows * d].view(rows, d),
                "stride_plus8_ptr_plus1": buf[1:1 + rows * (d + 8)].view(
                    rows, d + 8)[:, :d],
            }
            for case, xv in cases.items():
                for kernel in ("rmsnorm", "layernorm"):
                    k = _compiled(kernel, xv, g[:d].contiguous(),
                                  b[:d].contiguous())
                    (out / f"layout_{kernel}_{str(dt)[6:]}_{rows}x{d}_"
                           f"{case}.ttgir").write_text(k.asm["ttgir"])


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
    blocks()
    if not same:
        raise SystemExit("the CUDA kernels differ from the Triton kernels")


if __name__ == "__main__":
    main()
