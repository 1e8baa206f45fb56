"""Where a full-width scoring call's device time goes, by kernel.

Builds an architecture at full width (random weights from seed 0, cut to
``--layers`` layers when given), scores the card check's 4 x 256 tokens
through ``stitch(train_forward)`` in kernel mode, and profiles one call
after a warm one.  Prints the card's name and power limit, the plan's
groups by kind, and the call's device time: in total, by class of kernel
(generated stitched kernels, hand-written kernels by name, library GEMMs,
PyTorch's elementwise, reduction, copy and other kernels) and for the
kernels that take the most.  With ``--json PATH`` the split is also
written to PATH.  Needs one card; it uses only ``chip_smoke.py``'s helpers
that earlier trees have too, so a copy of it can split an older tree's
call the same way:

    PYTHONPATH=src python3 examples/torch_call_split.py [--arch NAME]
"""

import argparse
import json
import subprocess
import sys
from collections import defaultdict
from dataclasses import replace
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the card check's batch and stitch helpers)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

# (class, substrings of a kernel name), the first match wins
CLASSES = [
    ("stitched", ("stitched_kernel",)),
    ("gemm", ("gemm", "xmma", "nvjet", "cutlass", "cublas", "splitk")),
    ("flash_attention", ("flash",)),
    ("rg_lru", ("rg_lru", "rglru")),
    ("mamba_scan", ("mamba_scan",)),
    ("decode_attention", ("decode_attn", "decode_attention")),
    ("router", ("router",)),
    ("rope", ("rope_kernel",)),
    ("hand_triton", ("_rmsnorm", "_glu_kernel", "_layernorm", "_sqrelu",
                     "_softmax", "_xent")),
    ("reduce", ("reduce_kernel",)),
    ("copy", ("copy", "Copy", "cat")),
    ("elementwise", ("elementwise",)),
    ("index", ("index", "gather", "scatter")),
]


def classify(name: str) -> str:
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-9b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = replace(cfg, n_layers=args.layers)
    model = build_model(cfg)
    params = model.init(0, dev)
    batch = chip_smoke.score_batch(cfg, 0, dev)
    sf = chip_smoke.stitched_call(f"{cfg.name} score", model.train_forward,
                                  (params, batch), dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip())
    plan = sf.report()["plan"]
    print("plan: " + json.dumps({k: plan[k] for k in (
        "n_ops", "n_kernels", "triton_groups", "torch_groups", "op_groups")}))
    sf(params, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sf(params, batch)
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0]
    total = sum(ms for _, _, ms in rows)
    by_class = defaultdict(lambda: [0, 0.0])
    for name, n, ms in rows:
        by_class[classify(name)][0] += n
        by_class[classify(name)][1] += ms
    print(f"device busy: {total:.4f} ms in "
          f"{sum(n for _, n, _ in rows)} kernels")
    for cls, (n, ms) in sorted(by_class.items(), key=lambda kv: -kv[1][1]):
        print(f"class {cls}: {ms:.4f} ms in {n} launches")
    rows.sort(key=lambda r: -r[2])
    for name, n, ms in rows[:args.top]:
        print(f"kernel {ms:.4f} ms {n} launches [{classify(name)}] {name[:160]}")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({
            "arch": cfg.name, "layers": cfg.n_layers, "plan": {
                k: plan[k] for k in ("n_ops", "n_kernels", "triton_groups",
                                     "torch_groups", "op_groups")},
            "device_busy_ms": total,
            "classes": {k: {"launches": n, "ms": ms}
                        for k, (n, ms) in by_class.items()},
            "kernels": [{"name": a, "launches": n, "ms": ms}
                        for a, n, ms in rows]}, indent=1))


if __name__ == "__main__":
    main()
