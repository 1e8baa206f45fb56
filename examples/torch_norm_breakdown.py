"""The CUDA norms' launches on the paths' operands.

For RMSNorm and LayerNorm (``repro_torch.kernels.norms``, ``csrc/norms.cu``)
at every operand the serving and scoring paths launch them on (bf16),
device us a launch in a CUDA-graph replay (``chip_smoke.device_ms``) of the
kernel the op launches, beside its block plan (``norms.block_plan``), and
of the CUDA LayerNorm with gamma and beta loaded early and late (the same
bits).  The Triton kernels they replaced, and the Triton probes that broke
their time down (an empty kernel, the loads, the reductions), are deleted;
``PERF.md`` keeps their times.  Needs one card:

    PYTHONPATH=src python3 examples/torch_norm_breakdown.py
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (device_ms: a CUDA-graph replay)

from repro_torch.kernels import norms  # noqa: E402

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


def cuda(kernel, x, g, b):
    """A function of no arguments launching the op's kernel once."""
    if kernel == "rmsnorm":
        return lambda: norms._launch(x, g, 1e-6)
    return lambda: norms._launch_layernorm(x, g, b, 1e-5)


def operand(rows, d, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (2.0 * torch.randn(rows, d, generator=gen) + 0.5).to(dtype).cuda()
    g = (1 + 0.1 * torch.randn(d, generator=gen)).to(dtype).cuda()
    b = (0.1 * torch.randn(d, generator=gen)).to(dtype).cuda()
    return x, g, b


def breakdown():
    print("device us a launch, CUDA-graph replay, and the kernel's plan:")
    for path, kernel, rows, d, n in OPERANDS:
        x, g, b = operand(rows, d, torch.bfloat16)
        us = 1e3 * chip_smoke.device_ms(cuda(kernel, x, g, b), 50)
        plan = norms.block_plan(rows, d, torch.bfloat16, x.data_ptr(),
                                x.stride(0))
        print(f"{path} {kernel} ({rows}, {d}) x{n}: cuda={us:.3f} "
              f"plan={plan}", flush=True)


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    breakdown()
    blocks()


if __name__ == "__main__":
    main()
