"""RoPE block plans on the card: device us a launch of the CUDA kernel
(``csrc/rope.cu``) at every (R rows, Hc heads) a block of R 1, 2 and 4 and
each divisor Hc of the heads, at the q and k shapes of every path's decode
step and prefill (bf16, batch 4), beside the plan ``rope.block_plan``
picks; every plan's output is held against the default plan's bit for
bit.  Times are CUDA-graph replays (L2-warm).  Prints the card's name and power limit first.  Needs one card:

    PYTHONPATH=src python3 examples/torch_rope_plans.py
"""

import subprocess

import torch

from repro_torch.kernels import rope

# (path, rows, heads, head_dim, theta): batch 4 at a decode step, 4 x 256
# token rows at a bucket-256 prefill or scoring call, 4 x 64 at qwen3's
# bucket-64 prefill
SHAPES = [("qwen3 decode q", 4, 16, 128, 1e6), ("qwen3 decode k", 4, 8, 128, 1e6),
          ("nemotron decode q", 4, 48, 128, 1e4),
          ("nemotron decode k", 4, 8, 128, 1e4),
          ("granite-moe decode q", 4, 16, 64, 1e4),
          ("granite-moe decode k", 4, 8, 64, 1e4),
          ("qwen3 prefill 64 q", 256, 16, 128, 1e6),
          ("qwen3 prefill 64 k", 256, 8, 128, 1e6),
          ("qwen3 prefill q", 1024, 16, 128, 1e6),
          ("qwen3 prefill k", 1024, 8, 128, 1e6),
          ("nemotron prefill q", 1024, 48, 128, 1e4),
          ("nemotron prefill k", 1024, 8, 128, 1e4),
          ("recurrentgemma q", 1024, 16, 256, 1e4),
          ("recurrentgemma k", 1024, 1, 256, 1e4),
          ("granite-moe prefill q", 1024, 16, 64, 1e4),
          ("granite-moe prefill k", 1024, 8, 64, 1e4)]


def device_us(fn, reps: int = 50) -> float:
    """Device us a call: ``reps`` calls captured in one CUDA graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    graph.replay()
    e.record()
    torch.cuda.synchronize()
    return 1e3 * s.elapsed_time(e) / reps


def launch(x, pos, theta, hd, R, Hc):
    """One launch of the CUDA kernel with the plan (R, Hc)."""
    rows, width = x.shape
    half = hd // 2
    out = torch.empty_like(x)
    vec = rope.vector_width(half, x.element_size(), x.data_ptr(), x.stride(0))
    err = rope._lib().repro_rope(
        x.data_ptr(), pos.data_ptr(), rope._freq(x.device, theta, half).data_ptr(),
        out.data_ptr(), rope._FLOAT[x.dtype], rope._POSITIONS[pos.dtype],
        rows, width // hd, half, x.stride(0), pos.stride(0), R, Hc, vec,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(rope._lib().repro_cuda_error_string(err).decode())
    return out


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip())
    gen = torch.Generator().manual_seed(0)
    for name, rows, heads, hd, theta in SHAPES:
        x = torch.randn(rows, heads * hd, generator=gen).to(torch.bfloat16).cuda()
        pos = (torch.arange(rows, dtype=torch.int32) % 256
               + (300 if rows == 4 else 0)).cuda()
        want = rope._launch_kernel(x, pos, theta, hd)
        plan = rope.block_plan(rows, heads, hd // 2, 8)
        times = {}
        for R in (1, 2, 4):
            for Hc in (d for d in range(1, heads + 1) if heads % d == 0):
                if R > rows or R * Hc * hd // 16 > 512:
                    continue
                if not torch.equal(launch(x, pos, theta, hd, R, Hc), want):
                    raise SystemExit(f"{name}: plan R{R} Hc{Hc} differs from "
                                     f"the default plan")
                times[R, Hc] = device_us(lambda: launch(x, pos, theta, hd, R, Hc))
        best = min(times, key=times.get)
        print(f"{name} ({rows}, {heads}x{hd}): plan R{plan[0]} Hc{plan[1]} "
              f"{times[plan]:.2f} us, best R{best[0]} Hc{best[1]} "
              f"{times[best]:.2f} us ({times[plan] / times[best] - 1:+.1%}); "
              f"all: " + " ".join(
                  f"R{r}Hc{h}={t:.2f}" for (r, h), t in times.items()))


if __name__ == "__main__":
    main()
