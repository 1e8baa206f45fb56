"""The Hopper flash kernel's pipeline depths on the card: device us a
launch of ``csrc/flash_attention_sm90.cu`` at each path's prefill or
scoring shape (bf16, q, k and v strided views of (B, L, H, Dh) activations,
as the models hand them over), for copies of its source that change the
wgmma groups it keeps in flight (``kSDepth``: S's k-steps; ``kPvDepth``:
P V's 64-column chunks) or the registers its warpgroups take
(``setmaxnreg``), each built under ``build/flash_depths/<variant>``.  The
variants change when a sum is taken, never its order, so every variant's
output is held against the kernel's own bit for bit, and against any
other source named on the command line (``name=path``: an older version of
the kernel, say).  Times are CUDA-graph replays (L2-warm); ptxas's spill
report is printed per variant.  Prints the card's name and power limit
first.  Needs one card:

    PYTHONPATH=src python3 examples/torch_flash_depths.py [name=path.cu ...]
"""

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels import build, flash_attention

# (path, B, Hq, Hkv, L, Dh, window)
SHAPES = [("qwen3 prefill", 4, 16, 8, 256, 128, None),
          ("nemotron prefill", 4, 48, 8, 256, 128, None),
          ("recurrentgemma scoring", 4, 16, 1, 256, 256, 2048),
          ("granite-moe prefill", 4, 16, 8, 256, 64, None)]

ROOT = build.build_dir().parent / "flash_depths"
_S = "constexpr int kSDepth = L::kChunks >= 4 ? 2 : 3;"
_PV = "constexpr int kPvDepth = L::kChunks >= 4 ? 1 : 2;"
_REGS = ("constexpr int kProducerRegs = 40;\n"
         "constexpr int kConsumerRegs = 232;")
_REGS_240 = ("constexpr int kProducerRegs = 24;\n"
             "constexpr int kConsumerRegs = 240;")


def depths(s256: int, s: int, pv256: int, pv: int) -> list:
    """Edits setting kSDepth and kPvDepth at Dh=256 and below it."""
    return [(_S, _S.replace("? 2 : 3", f"? {s256} : {s}")),
            (_PV, _PV.replace("? 1 : 2", f"? {pv256} : {pv}"))]


# each variant's edits of the sound source: (sound text, its replacement)
VARIANTS = {
    "serial": depths(1, 1, 1, 1),
    "s1_256": depths(1, 3, 1, 2),
    "s4": depths(2, 4, 1, 2),
    "pv2_256": depths(2, 3, 2, 2),
    "regs240": [(_REGS, _REGS_240)],
}


def sources(extra: dict) -> dict:
    """Each variant's source file, the kernel's own first."""
    src = (build.CSRC / "flash_attention_sm90.cu").read_text()
    texts = {name: Path(path).read_text() for name, path in extra.items()}
    for name, edits in VARIANTS.items():
        text = src
        for sound, new in edits:
            if text.count(sound) != 1:
                raise SystemExit(f"variant {name}: the kernel lost {sound!r}")
            text = text.replace(sound, new)
        texts[name] = text
    out = {"kernel": build.CSRC / "flash_attention_sm90.cu"}
    for name, text in texts.items():
        out[name] = ROOT / name / "flash_attention_sm90.cu"
        out[name].parent.mkdir(parents=True, exist_ok=True)
        out[name].write_text(text)
    return out


def main(argv: list) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip(), flush=True)
    extra = dict(a.split("=", 1) for a in argv)
    srcs = sources(extra)
    with ThreadPoolExecutor(len(srcs)) as ex:
        libs = dict(zip(srcs, ex.map(
            lambda p: build.library("flash_attention_sm90", p.parent,
                                    ROOT / p.parent.name),
            srcs.values())))
    for name, lib in libs.items():
        report = lib.with_suffix(".log").read_text()
        spills = [ln.strip().split("ptxas info    : ")[-1]
                  for ln in report.splitlines() if "spill" in ln]
        print(f"{name}: ptxas {spills}", flush=True)
    bound = {n: flash_attention.bind(ctypes.CDLL(str(p)))
             for n, p in libs.items()}
    own = flash_attention._lib_sm90()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    try:
        for path, B, hq, hkv, L, dh, window in SHAPES:
            q, k, v = (torch.randn(B, L, h, dh, generator=gen, device=dev,
                                   dtype=torch.bfloat16).transpose(1, 2)
                       for h in (hq, hkv, hkv))
            args = (q, k, v, dh ** -0.5, True, window, 0)
            outs, us = {}, {}
            for name, lib in bound.items():
                flash_attention._LIB_SM90 = lib
                run = (lambda: flash_attention._launch_variant("sm90", *args))
                outs[name] = run()
                us[name] = 1e3 * device_ms(run)
            same = {n: bool(torch.equal(o, outs["kernel"]))
                    for n, o in outs.items()}
            print(f"{path} (B={B} Hq={hq} Hkv={hkv} L={L} Dh={dh}): device us "
                  + " ".join(f"{n}={t:.2f}" for n, t in us.items())
                  + "; bit for bit the kernel's: "
                  + " ".join(f"{n}={s}" for n, s in same.items()), flush=True)
    finally:
        flash_attention._LIB_SM90 = own


def device_ms(fn, reps: int = 50) -> float:
    """Device ms a call: ``reps`` calls captured in one CUDA graph."""
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
    return s.elapsed_time(e) / reps


if __name__ == "__main__":
    main(sys.argv[1:])
