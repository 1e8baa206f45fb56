"""A router and a GLU launch's time on the paths' operands.

Device us a launch, paired (``chip_smoke.paired_device_times``: the median
of 5 alternations of 100-launch CUDA-graph replays, every column of an
operand in turn; the least and the most of the 5 beside it), of:

* the MoE router (``repro_torch.kernels.router``, ``csrc/router.cu``), f32
  logits (T, E) and k at granite-moe-1b-a400m's decode step (4, 32, 8) and
  bucket-256 prefill (1024, 32, 8), and the card check's samples (1000, 60,
  4) and (512, 64, 8);
* the GLU (``repro_torch.kernels.activations``, ``csrc/activations.cu``),
  bf16 (rows, F) at qwen3-1.7b's decode step (4, 6144) and bucket-64
  prefill (256, 6144), granite-moe-1b-a400m's experts at decode (256, 512)
  and bucket-256 prefill (10240, 512), SiLU, and recurrentgemma-9b's
  scoring call (1024, 12288), GeGLU;

each beside ``empty``, the port's empty CUDA kernel (one warp a block) at
the kernel's grid.  The kernels these replaced, the round router and the
Triton GLU, are retired; ``PERF.md`` keeps their times.  Needs one card:

    PYTHONPATH=src python3 examples/torch_router_glu_breakdown.py
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (paired_device_times: CUDA-graph replays)

from repro_torch.kernels import activations, router, rope  # noqa: E402

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


def empty(blocks: int):
    """The port's empty kernel, ``blocks`` blocks of one warp."""
    lib = rope._lib()

    def run():
        err = lib.repro_empty_kernel(blocks,
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"empty kernel launch failed ({err})")
    return run


def logits(T, E, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return (2.0 * torch.randn(T, E, generator=gen)).to(dtype).cuda()


def glu_operand(rows, F, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return tuple((2.0 * torch.randn(rows, F, generator=gen)).to(dtype).cuda()
                 for _ in range(2))


def glu_blocks(rows: int, F: int, itemsize: int) -> int:
    """csrc/activations.cu's grid: a row over up to a block's 128 threads
    of one 16-byte chunk, rows side by side where a row takes fewer."""
    chunks = F // (16 // itemsize)
    lanes = min(128, 1 << (chunks - 1).bit_length())
    return -(-rows // (128 // lanes)) * -(-chunks // lanes)


def timed_columns(title: str, cases) -> None:
    """``cases``: (label, {name: function}); each operand's functions timed
    paired, the median and, in brackets, the least and the most."""
    print(f"{title}, device us a launch, paired: median [least-most]")
    for label, fns in cases:
        times = chip_smoke.paired_device_times(*fns.values())
        print(f"  {label}: " + " ".join(
            f"{n}={1e3 * float(np.median(t)):.3f}[{1e3 * min(t):.3f}-"
            f"{1e3 * max(t):.3f}]" for n, t in zip(fns, times)), flush=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    timed_columns("router (f32 logits)", [
        (f"{path} (T {T}, E {E}, k {k}) x{n}", {
            "empty": empty(-(-T // 8)),
            "rank": lambda x=logits(T, E), k=k: router._launch(x, k, True)})
        for path, T, E, k, n in ROUTER_OPERANDS])
    timed_columns("GLU (bf16)", [
        (f"{path} {act} ({rows}, {F}) x{n}", {
            "empty": empty(glu_blocks(rows, F, 2)),
            "cuda": lambda gu=glu_operand(rows, F, torch.bfloat16), a=act:
                activations._launch(*gu, a)})
        for path, rows, F, act, n in GLU_OPERANDS])


if __name__ == "__main__":
    main()
