"""The spread of the card check's recurrentgemma bf16 loss reading, and
each flash kernel's error against an f64 attention.

``chip_smoke.py`` holds full-width recurrentgemma-9b's kernel-mode scoring
loss against the eager ref-mode model's over several weight seeds
(|diff| / |eager|, limit ``HYBRID_TOL["loss"]``).  This script takes the
same reading over more seeds with flash attention on each of its two
kernels: the Hopper one (``"sm90"``, what kernel mode runs) and the
CUDA-core one (``"simt"``), and on probes of the Hopper kernel that change
one term of its arithmetic each (copies of its source under
``build/flash_probe``, never a switch of the program):

* ``sm90_expf``: the softmax on the unfolded scores, ``expf`` of their
  difference from the row's max, as the CUDA-core kernel takes it (the
  kernel folds log2(e) into the scale and calls ``exp2f``);
* ``sm90_p_bf16``: V multiplied by p rounded once to bf16, where the
  kernel keeps p's f32 value in three bf16 parts.

It also takes the reading with two lower-precision copies of the RG-LRU
kernel (the Hopper flash kernel beside them): ``rg_lru_bf16_state``, the
chain's state rounded to bf16 at every step, and ``rg_lru_bf16_decay``,
the chain's decay a rounded to bf16.  A limit over the sound kernels'
readings that such a copy still fails could replace the check's limit
(ROADMAP, "How each slice is held").

For every seed it also holds each flash launch of the scoring call, every
kernel on the same operands, against an f64 attention
(``chip_smoke.flash_against_f64``): the largest error over the largest
|f64| value, and the share of outputs that are not the f64 value rounded
to bf16, and on how many launches the Hopper kernel's share exceeds the
CUDA-core kernel's; and each kernel's device us a launch on the first
seed's first launch (a CUDA-graph replay).  Needs one card:

    PYTHONPATH=src python3 examples/torch_hybrid_loss_noise.py [seeds]
"""

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the card check's batch, stitch, f64 helpers)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build, flash_attention  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

# each probe's source (a CUDA stem) and edits of it: (sound text, what the
# probe puts in its place, every occurrence)
PROBES = {
    "sm90_expf": ("flash_attention_sm90",
                  [("scale * kLog2e, causal", "scale, causal"),
                   ("exp2f(", "expf(")]),
    "sm90_p_bf16": ("flash_attention_sm90",
                    [("    x0 -= hf.x;\n    x1 -= hf.y;\n",
                      "    x0 = 0.f;\n    x1 = 0.f;\n")]),
    "rg_lru_bf16_state": ("rg_lru",
                          [("h = __fadd_rn(__fmul_rn(av[j], h), gv[j]);",
                            "h = __bfloat162float(__float2bfloat16(__fadd_rn("
                            "__fmul_rn(av[j], h), gv[j])));")]),
    "rg_lru_bf16_decay": ("rg_lru",
                          [("h = __fadd_rn(__fmul_rn(av[j], h), gv[j]);",
                            "h = __fadd_rn(__fmul_rn(__bfloat162float("
                            "__float2bfloat16(av[j])), h), gv[j]);")]),
}
KERNELS = ("sm90", "sm90_expf", "sm90_p_bf16", "simt")
RG_LRU = ("rg_lru_bf16_state", "rg_lru_bf16_decay")


def probe_sources() -> dict:
    """Each probe's (CUDA stem, source text)."""
    out = {}
    for name, (stem, edits) in PROBES.items():
        text = (build.CSRC / f"{stem}.cu").read_text()
        for sound, probe in edits:
            if sound not in text:
                raise SystemExit(f"probe {name}: {stem} lost {sound!r}")
            text = text.replace(sound, probe)
        out[name] = (stem, text)
    return out


def probe_libraries() -> tuple[dict, dict]:
    """Each of ``probe_sources`` built with nvcc (all at once) into
    ``build/flash_probe/<name>``: the flash copies and the RG-LRU ones."""
    from repro_torch.kernels import rg_lru
    dirs = {}
    for name, (stem, text) in probe_sources().items():
        d = build.build_dir().parent / "flash_probe" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{stem}.cu").write_text(text)
        dirs[name] = (stem, d)
    with ThreadPoolExecutor(len(dirs)) as ex:
        paths = dict(zip(dirs, ex.map(lambda job: build.library(job[0], job[1],
                                                                job[1]),
                                      dirs.values())))
    return ({n: flash_attention.bind(ctypes.CDLL(str(paths[n])))
             for n in KERNELS if n in paths},
            {n: rg_lru.bind(ctypes.CDLL(str(paths[n]))) for n in RG_LRU})


class Kernels:
    """Runs flash attention on one named kernel; records the operands of
    the launches while ``recording``."""

    def __init__(self, libs):
        self.libs = libs
        self.kernel = "sm90"
        self.recording = None
        self._launch = flash_attention._launch_variant
        self._sm90 = flash_attention._lib_sm90()
        flash_attention._launch_variant = self.launch_variant

    def launch_variant(self, variant, qt, kt, vt, *rest):
        if self.recording is not None:
            self.recording.append((qt.clone(), kt.clone(), vt.clone(), *rest))
        return self.run(self.kernel, qt, kt, vt, *rest)

    def run(self, kernel, qt, kt, vt, *rest):
        flash_attention._LIB_SM90 = self.libs.get(kernel, self._sm90)
        try:
            return self._launch("simt" if kernel == "simt" else "sm90",
                                qt, kt, vt, *rest)
        finally:
            flash_attention._LIB_SM90 = self._sm90


def launch_errors(kern, launches) -> tuple[dict, int]:
    """Per kernel, over the recorded launches: the largest max |out - f64|
    / max |f64|, and the largest share of outputs that are not the f64
    value rounded to bf16; and on how many launches the Hopper kernel's
    share exceeds the CUDA-core kernel's."""
    rows = chip_smoke.flash_against_f64(launches, {
        k: (lambda *a, k=k: kern.run(k, *a)) for k in KERNELS})
    out = {k: [max(r[k][0] for r in rows), max(r[k][1] for r in rows)]
           for k in KERNELS}
    return out, sum(r["sm90"][1] > r["simt"][1] for r in rows)


def main(seeds: int = 5) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip())
    from repro_torch.kernels import rg_lru
    libs, rg_libs = probe_libraries()
    kern = Kernels(libs)
    cfg = get_config("recurrentgemma-9b")
    model = build_model(cfg)
    params = model.init(0, dev)
    batch = chip_smoke.score_batch(cfg, 0, dev)
    score = chip_smoke.stitched_call("hybrid score", model.train_forward,
                                     (params, batch), dev)
    worst = dict.fromkeys((*KERNELS, *RG_LRU), 0.0)
    for seed in range(seeds):
        if seed:
            params = None
            torch.cuda.empty_cache()
            params = model.init(seed, dev)
        batch = chip_smoke.score_batch(cfg, seed, dev)
        eager = float(model.train_forward(params, batch)[0])
        row = {}
        for k in KERNELS:
            kern.kernel = k
            kern.recording = [] if k == "sm90" else None
            try:
                loss = float(score(params, batch)[0])
            finally:
                kern.kernel = "sm90"
            if k == "sm90":
                launches, kern.recording = kern.recording, None
            row[k] = abs(loss - eager) / abs(eager)
            worst[k] = max(worst[k], row[k])
        rg_lru._lib()
        sound = rg_lru._LIB
        for k, lib in rg_libs.items():
            rg_lru._LIB = lib
            try:
                loss = float(score(params, batch)[0])
            finally:
                rg_lru._LIB = sound
            row[k] = abs(loss - eager) / abs(eager)
            worst[k] = max(worst[k], row[k])
        (errs, worse), n = launch_errors(kern, launches), len(launches)
        if seed == 0:
            qt, kt, vt, *rest = launches[0]
            print(f"flash device us a launch at {tuple(qt.shape)} / "
                  f"{tuple(kt.shape)}: " + " ".join(
                      f"{k}={1e3 * chip_smoke.device_ms(lambda k=k: kern.run(k, qt, kt, vt, *rest)):.2f}"
                      for k in KERNELS), flush=True)
        del launches
        print(f"seed {seed}: loss reading "
              + " ".join(f"{k}={v:.4g}" for k, v in row.items()), flush=True)
        print(f"seed {seed}: flash launches vs f64 (max err / max |f64|, "
              f"share not the f64 value in bf16), worst of "
              f"{n} launches: "
              + " ".join(f"{k}={e:.4g}/{f:.4g}" for k, (e, f) in errs.items())
              + f"; launches where sm90's share exceeds simt's: {worse} of {n}",
              flush=True)
    print("largest loss reading over seeds 0-%d: " % (seeds - 1)
          + " ".join(f"{k}={v:.4g}" for k, v in worst.items())
          + f" (limit {chip_smoke.HYBRID_TOL['loss']})")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 5)
