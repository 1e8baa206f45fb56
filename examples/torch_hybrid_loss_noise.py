"""The spread of the card check's recurrentgemma bf16 loss reading.

``chip_smoke.py`` holds full-width recurrentgemma-9b's kernel-mode scoring
loss against the eager ref-mode model's over three weight seeds, at a
limit of 6.8e-5 (|diff| / |eager|).  This script takes the same reading
over more seeds with flash attention on each of its two kernels: the
Hopper one (``"sm90"``, what kernel mode runs) and the CUDA-core one
(``"simt"``), so the reading's spread can be set beside the limit.  Needs
one card:

    PYTHONPATH=src python3 examples/torch_hybrid_loss_noise.py [seeds]
"""

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the card check's batch and stitch helpers)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def main(seeds: int = 5) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("recurrentgemma-9b")
    model = build_model(cfg)
    params = model.init(0, dev)
    batch = chip_smoke.score_batch(cfg, 0, dev)
    score = chip_smoke.stitched_call("hybrid score", model.train_forward,
                                     (params, batch), dev)
    dispatch = flash_attention._variant
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip())
    for seed in range(seeds):
        if seed:
            params = None
            torch.cuda.empty_cache()
            params = model.init(seed, dev)
        batch = chip_smoke.score_batch(cfg, seed, dev)
        eager = float(model.train_forward(params, batch)[0])
        row = {}
        for variant in ("sm90", "simt"):
            flash_attention._variant = (
                dispatch if variant == "sm90" else lambda *a: "simt")
            try:
                loss = float(score(params, batch)[0])
            finally:
                flash_attention._variant = dispatch
            row[variant] = abs(loss - eager) / abs(eager)
        print(f"seed {seed}: loss reading "
              + " ".join(f"{k}={v:.4g}" for k, v in row.items()), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 5)
