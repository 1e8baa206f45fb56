"""Serving launcher of the port: a static batch through the stitched engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
        --stitch --dense --mode static

Random weights from ``--seed`` (nothing is downloaded).  ``--stitch`` builds
a :class:`repro_torch.cache.CompilationService` (persistent when
``--cache-dir DIR`` is given: plans are written there and a later run
replays them from disk) and serves prefill and decode through ``stitch()``
in ``stitch`` mode: the cold batch is answered by the fallback plan while
the stitched plans compile in the background, the launcher then waits for
them to land, and the warm batch runs the stitched plans.  It prints the
plan, call and cache report at exit, and exits non-zero when a plan did not
land or a background compile failed; without ``--stitch`` the model runs
eagerly.  ``--reduced`` selects the tiny
same-family config; ``--device cpu`` runs on the CPU (the default is the
card, and the launcher refuses to run without one).  Continuous batching
needs the scheduler, which is not ported yet, and so is serving the ssm
and hybrid families (``--arch falcon-mamba-7b`` and ``--arch
recurrentgemma-9b`` raise ``NotImplementedError``).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.cache import CompilationService, StitchCache
from repro_torch.configs import get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import Engine, ServeConfig


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--stitch", action="store_true")
    ap.add_argument("--dense", action="store_true",
                    help="dense KV rectangles (the only layout ported)")
    ap.add_argument("--mode", choices=("static", "continuous"),
                    default="static")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--plan-budget", type=float, default=20.0,
                    help="seconds before a plan solve degrades to greedy")
    ap.add_argument("--cache-dir", default=None,
                    help="directory of the persistent plan cache (--stitch)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.mode == "continuous":
        raise NotImplementedError(
            "continuous batching needs the scheduler, which is not ported "
            "yet; use --mode static")
    device = resolve_device(args.device)
    if device.type == "cuda":
        # one rounding per GEMM: f32 accumulation, no TF32
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.family} serving is not ported yet ({cfg.name}); the model "
            f"scores through Model.train_forward and Model.block_fn")
    model = build_model(cfg)
    params = model.init(args.seed, device)
    scfg = ServeConfig(batch=args.slots, max_len=args.max_len,
                       max_new_tokens=args.new_tokens,
                       stitch_execute=args.stitch, paged=False)
    svc = None
    if args.stitch:
        svc = CompilationService(StitchCache(directory=args.cache_dir),
                                 plan_budget=args.plan_budget)
    eng = Engine(model, params, scfg, device=device, stitch_service=svc)
    rng = np.random.default_rng(args.seed)
    lo = max(1, args.prompt_len // 2)
    lens = rng.integers(lo, args.prompt_len + 1, args.slots).astype(np.int32)
    prompts = rng.integers(0, cfg.vocab, (args.slots, args.prompt_len))
    print(f"arch={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
          f"device={device} stitch={args.stitch} kv_layout=dense")
    results = {}
    for phase in ("cold", "warm"):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = eng.generate(prompts, prompt_lens=lens)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        results[phase] = {"seconds": dt,
                          "tokens_per_s": toks.size / dt}
        print(f"{phase}: {toks.size} tokens in {dt:.3f}s "
              f"({toks.size / dt:.1f} tokens/s)")
        if svc is not None and phase == "cold":
            t0 = time.perf_counter()
            unlanded = eng.land_plans()
            print(f"plans landed in {time.perf_counter() - t0:.3f}s "
                  f"({unlanded} without a stitched plan)")
            if unlanded or svc.last_error is not None:
                raise SystemExit(f"{unlanded} plan(s) did not land; "
                                 f"service_error={svc.last_error}")
    rep = eng.report()
    for tag in ("prefill", "decode"):
        r = rep[tag]
        print(f"{tag}: calls={r['calls']} plan_calls={r['plan_calls']} "
              f"plan={json.dumps(r['plan'])}")
    if svc is not None:
        print(f"cache: {json.dumps(svc.cache.report())} "
              f"service_error={svc.last_error}")
    results["report"] = {k: rep[k]["plan"] for k in ("prefill", "decode")}
    return results


if __name__ == "__main__":
    main()
