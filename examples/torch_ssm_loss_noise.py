"""The spread of the card check's falcon-mamba bf16 readings, by scan kernel.

``chip_smoke.py`` holds full-width falcon-mamba-7b's (cut to
``chip_smoke.SSM_LAYERS`` layers) kernel-mode scoring loss and its first
block's output against the eager ref-mode model's over three weight seeds
(|diff| / |eager| for the loss, max |diff| / max |eager| for the block),
under ``chip_smoke.SSM_TOL``.  This script takes the same readings over
more seeds with the selective scan on each of these kernels, on the same
weights and inputs:

* ``lanes``: the lanes kernel, what kernel mode runs;
* ``lanes_exp2f``: the lanes kernel with its exponential spelled as
  ``exp2f(dt * (A * log2 e))``, the product ``A * log2 e`` hoisted;
* ``lanes_bf16_state``: a lower-precision control, the lanes kernel with
  its state rounded to bf16 at every step.

The last two are built from ``csrc/mamba_scan.cu`` with one text change
each (``VARIANTS``) into ``build/kernels/scan_variants``.  The summary
gives each kernel's largest readings over the check's seeds and over all,
beside the limits.  Needs one card:

    PYTHONPATH=src python3 examples/torch_ssm_loss_noise.py [seeds]
"""

import ctypes
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the card check's batch and stitch helpers)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, mamba_scan  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

_A = "a[i] = (live && on[i]) ? A[(long long)c * n_state + n] : 0.f;"
_H = "h[i] = expf(dj * a[i]) * h[i] + dx * bs[i];"
# the lanes kernel's variants: (sound text, changed text) pairs
VARIANTS = {
    "lanes_exp2f": [
        (_A, _A.replace(" : 0.f;", " * 1.4426950408889634f : 0.f;")),
        (_H, _H.replace("expf(", "exp2f("))],
    "lanes_bf16_state": [
        (_H, "h[i] = __bfloat162float(__float2bfloat16(expf(dj * a[i]) * "
             "h[i] + dx * bs[i]));")],
}


def variant_library(name: str) -> ctypes.CDLL:
    """The scan library with the text changes of ``VARIANTS[name]``."""
    src = (build.CSRC / "mamba_scan.cu").read_text()
    for sound, changed in VARIANTS[name]:
        if src.count(sound) != 1:
            raise SystemExit(f"the scan source lost the text {name} changes")
        src = src.replace(sound, changed)
    out = build.build_dir() / "scan_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "mamba_scan.cu").write_text(src)
    return mamba_scan.bind(ctypes.CDLL(str(build.library(
        "mamba_scan", src_dir=out, out_dir=out))))


def main(seeds: int = 5) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = replace(get_config("falcon-mamba-7b"),
                  n_layers=chip_smoke.SSM_LAYERS)
    model = build_model(cfg)
    params = model.init(0, dev)
    lp = chip_smoke.block_params(model, params)
    batch = chip_smoke.score_batch(cfg, 0, dev)
    x = chip_smoke.block_input(cfg, 0, dev)
    score = chip_smoke.stitched_call("ssm score", model.train_forward,
                                     (params, batch), dev)
    block = chip_smoke.stitched_call("ssm block", model.block_fn, (lp, x), dev)
    sound = mamba_scan._lib()
    libs = {"lanes": sound}
    libs.update({name: variant_library(name) for name in VARIANTS})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip())
    readings = {name: {"loss": [], "block": []} for name in libs}
    for seed in range(seeds):
        if seed:
            params = lp = None
            torch.cuda.empty_cache()
            params = model.init(seed, dev)
            lp = chip_smoke.block_params(model, params)
        batch = chip_smoke.score_batch(cfg, seed, dev)
        x = chip_smoke.block_input(cfg, seed, dev)
        eager = float(model.train_forward(params, batch)[0])
        eager_block = model.block_fn(lp, x).float()
        row = {}
        for name, lib in libs.items():
            mamba_scan._LIB = lib
            try:
                loss = float(score(params, batch)[0])
                out = block(lp, x).float()
            finally:
                mamba_scan._LIB = sound
            row[f"{name} loss"] = abs(loss - eager) / abs(eager)
            row[f"{name} block"] = chip_smoke.rel_diff(out, eager_block)
            readings[name]["loss"].append(row[f"{name} loss"])
            readings[name]["block"].append(row[f"{name} block"])
        print(f"seed {seed}: readings "
              + " ".join(f"{k}={v:.4g}" for k, v in row.items()), flush=True)
    tol = chip_smoke.SSM_TOL
    checked = chip_smoke.LOGIT_SEEDS
    for name, r in readings.items():
        first = {k: max(v[:checked]) for k, v in r.items()}
        print(f"{name}: largest over the check's {checked} seeds "
              + " ".join(f"{k}={v:.4g}" for k, v in first.items())
              + f" ({'within' if all(first[k] <= tol[k] for k in tol) else 'past'}"
              f" {tol}); over {seeds} seeds "
              + " ".join(f"{k}={max(v):.4g} mean {sum(v) / len(v):.4g}"
                         for k, v in r.items()))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 5)
