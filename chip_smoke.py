"""Chip smoke test of the PyTorch port (``repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

0. Build: the CUDA C++ libraries (``src/repro_torch/csrc``) and their
   planted-fault copies from an empty ``build/kernels``, one nvcc each, all
   started together, with each one's build seconds and ptxas report.
1. Sample kernels: generated Triton stitched kernels for a softmax, an
   RMSNorm chain and a SwiGLU chain, and the six hand-written kernels
   (RMSNorm, SwiGLU/GeGLU, RoPE, decode attention, flash attention, the MoE
   router) at sample shapes, each held against its plain PyTorch version on
   the card (the router's ids exactly on rows without a near tie, ties to
   the lowest index).
2. Ref-mode path: full-width qwen3-1.7b (random weights from a seed)
   answers 4 requests through ``Engine(stitch_execute=True)``: the stitched
   prefill and the stitched decode on every step.  Launch counts are zeroed
   just before this run and read just after.  Every generated kernel of the
   decode and prefill plans is then called on the inputs the main path gives
   it and held against its plain version; its time, its bound and its
   launches go into the ``kernels`` line.  A generated kernel that computes
   an RMSNorm chain is also timed against ``F.rms_norm``.  Per plan, the
   bytes moved by generated kernels, fused-torch groups and single ops.
   Then the first decode step's bf16 logits against the eager decode over
   several weight seeds, with faults planted in the stitched RMSNorm
   kernels.
3. Kernel-mode path: the same model and requests served inside
   ``kernel_mode("kernels")``, where the norms, rotaries, GLUs and decode
   attention are the hand-written kernels.  The hand-written kernels'
   launches per prefill call and per decode step must be exactly 4L+1 / 2L /
   L / L (113 / 56 / 28 / 28 at 28 layers, no decode attention in the
   prefill).  Every kernel of the path, generated and hand-written, is held
   against its plain version on the path's own operands and timed beside its
   bound and, where one PyTorch call computes the same function, that call
   (``F.rms_norm``, ``F.scaled_dot_product_attention``).  Both decode plans
   are printed side by side; the kernel-mode bf16 logits are held against
   the eager ref-mode decode over several weight seeds.
4. Float32 checks: full width cut to 4 layers, the first decode step of the
   stitched ref-mode and kernel-mode engines against the eager one over
   several weight seeds, with faults planted in the stitched RMSNorm
   kernels and in the decode-attention kernel (``kpos < pos``); and a
   reduced model served stitched (both modes) vs eager.
5. MoE phase (after the long-prompt phase): full-width granite-moe-1b-a400m
   (24 layers, 32 experts top-8, random weights from a seed) served in
   kernel mode at the long prompts (bucket 256): exact launches per prefill
   call and decode step from the config, every kernel of the path held
   against its plain version, the router beside the ``softmax -> topk ->
   div`` chain; bf16 prefill and first-step logits against the eager
   ref-mode engine over several weight seeds; then (with the float32
   checks) the model cut to 4 layers in float32, with a fault planted in
   the router kernel.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

HBM_BW = 3.35e12          # H100 SXM bytes/s
F32_PEAK = 67e12          # H100 SXM f32 FLOP/s outside the tensor cores
BF16_PEAK = 989e12        # H100 SXM bf16 FLOP/s on the tensor cores, dense
REPLACES = "src/repro/kernels/stitched.py:450"
SOURCE = "src/repro_torch/kernels/stitched.py"
# kernel vs plain version: f32 differs only by approximate exp/rsqrt and
# the order of sums; bf16 outputs may differ by one rounding step
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1.6e-2, 1.6e-2)}
# first decode step, stitched vs eager, full width in bf16, as max |diff| /
# max |eager logit|: the stitched graph rounds scalar constants to bf16 and
# computes the lm-head dot in f32 (the widening-convert fold), so both differ
# by rounding noise that 28 layers carry to the logits.  Sound readings over
# 3 weight seeds on an H100: 0.0156-0.0178; the limit is 1.4x the largest.
# Faults of 1 % or less planted in the RMSNorm kernels stay inside this
# noise; the float32 check below is the one that sees them.
LOGIT_TOL = 0.025
# the same in float32 (full width, 4 layers): only the order of sums and
# Triton's approximate exp/rsqrt differ.  Sound readings over 5 seeds, in
# three runs on an H100: 9.7e-7 to 1.19e-6 stitched, 1.07e-6 to 1.37e-6 in
# kernel mode; the limit is 7.3x the largest.  Planted faults read 3.3e-3
# (norm in bf16) to 9.1e-3 (norm output x (1+2^-7)) and 0.41 (decode
# attention dropping the row's own key).  At bucket 256 in kernel mode (the
# flash kernel in every prefill layer): prefill 1.80e-6 to 2.08e-6, first
# step 1.23e-6 to 1.46e-6 over 5 seeds; the flash fault (acc not rescaled
# between kv tiles) reads 0.60 and 0.93.  granite-moe-1b-a400m (4 layers,
# kernel mode, bucket 256, the router kernel in every layer): prefill
# 9.5e-7 to 1.13e-6, first step 6.5e-7 to 6.9e-7 over 5 seeds; the router
# fault (the chosen column not masked) reads 0.93 and 1.10.
F32_LOGIT_TOL = 1e-5
# kernel mode (the hand-written kernels) against the eager ref-mode decode,
# full width in bf16: besides the rounding noise above, the decode-attention
# kernel keeps the probabilities in f32 where the ref-mode chain rounds them
# to bf16.  Sound readings over 3 seeds, in three runs on an H100: 0.0166
# to 0.0189; the limit is 1.3x the largest.
KM_LOGIT_TOL = 0.025
# the long-prompt phase (bucket 256): kernel mode against the eager
# ref-mode engine in bf16, prefill (last true position) and first decode
# step, as rel_diff.  Sound readings over 3 seeds on an H100: prefill
# 0.0156 to 0.0179, first step 0.0155 to 0.0185; the limit is 1.35x the
# largest.
KM_LONG_LOGIT_TOL = 0.025
SEED = 0
LOGIT_SEEDS = 3           # weight seeds of the full-width bf16 logit check
F32_SEEDS = 5             # weight seeds of the 4-layer f32 logit check


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def timed(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` warm calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def device_ms(fn, reps: int = 20) -> float:
    """Mean device time per call (ms): ``reps`` calls captured in one CUDA
    graph and replayed, so the host's launch path is not in the time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    graph.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def device_busy_ms(fn):
    """Summed device time of every kernel ``fn`` runs (ms), from the
    profiler's CUDA activity; None when the profiler records none."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = sum(getattr(evt, "self_device_time_total", 0.0)
                for evt in prof.key_averages())
    return total / 1e3 if total > 0 else None


def max_err(outs, refs):
    return max(float((o.float() - r.float()).abs().max()) for o, r in zip(outs, refs))


def within(outs, refs) -> bool:
    for o, r in zip(outs, refs):
        if o.dtype == torch.bool or not o.dtype.is_floating_point:
            if not torch.equal(o, r):
                return False
            continue
        rtol, atol = TOL.get(str(o.dtype).replace("torch.", ""), TOL["bfloat16"])
        if not torch.allclose(o.float(), r.float(), rtol=rtol, atol=atol):
            return False
    return True


def kernel_bound(k) -> tuple[float, str]:
    """Least time for the kernel's work: its inputs read once and outputs
    written once over the memory rate, or its elementwise operations over
    the f32 rate, whichever is larger."""
    g = k.pattern.graph
    nbytes = sum(g[n].bytes for n in k.pattern.external_inputs) + \
        sum(g[n].bytes for n in k.pattern.external_outputs)
    ops = sum(n.size for n in k.pattern.compute_members)
    tb, to = nbytes / HBM_BW, ops / F32_PEAK
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def rms_chain(p):
    """The RMSNorm chain of a pattern, or None: ``xf = convert(x)`` (or x
    itself), ``r = rsqrt(mean(xf * xf, last axis) + eps)``, ``y = xf * r *
    gamma`` and an optional convert back.  Returns (x, gamma input, eps, y,
    the chain's node names); every chain node but ``y`` must be used only
    inside the chain, so the chain can be swapped for one ``F.rms_norm``."""
    from repro_torch.core.ir import OpKind
    g = p.graph
    members = p.members

    def users(name):
        return [u for u in g.users(name) if u in members]

    def only_user(name, kind, op=None):
        us = users(name)
        if len(us) != 1 or name in p.external_outputs:
            return None
        node = g[us[0]]
        if node.kind is not kind or (op and node.attrs.get("op") != op):
            return None
        return node

    EW = OpKind.ELEMENTWISE
    for red in p.compute_members:
        if red.kind is not OpKind.REDUCTION or red.attrs.get("op") != "mean":
            continue
        sq = g[red.operands[0]]
        if not (sq.name in members and sq.kind is EW and sq.attrs.get("op") == "mul"
                and sq.operands[0] == sq.operands[1]):
            continue
        if tuple(red.attrs["axes"]) != (len(sq.shape) - 1,):
            continue
        d, xf = sq.shape[-1], sq.operands[0]
        add = only_user(red.name, EW, "add")
        if add is None:
            continue
        lit = g[[o for o in add.operands if o != red.name][0]]
        if lit.kind is not OpKind.CONSTANT or lit.shape or "value" not in lit.attrs:
            continue
        rs = only_user(add.name, EW, "rsqrt")
        bc = rs and only_user(rs.name, OpKind.BROADCAST)
        m1 = bc and only_user(bc.name, EW, "mul")
        if m1 is None or set(m1.operands) != {xf, bc.name}:
            continue
        m2 = only_user(m1.name, EW, "mul")
        if m2 is None:
            continue
        gam = [o for o in m2.operands if o != m1.name][0]
        chain = {sq.name, red.name, add.name, rs.name, bc.name, m1.name}
        while gam in members and g[gam].kind is OpKind.BROADCAST:
            chain.add(gam)
            gam = g[gam].operands[0]
        if gam not in p.external_inputs or g[gam].shape[-1] != d:
            continue
        x = xf
        if (xf in members and g[xf].kind is EW
                and g[xf].attrs.get("op") == "convert"):
            x = g[xf].operands[0]
            if set(users(xf)) <= chain | {m1.name}:
                chain.add(xf)
        elif set(users(xf)) - {sq.name, m1.name}:
            continue
        y = m2
        conv = only_user(m2.name, EW, "convert")
        if conv is not None:
            chain.add(m2.name)
            y = conv
        if str(y.dtype) != str(g[x].dtype):
            continue
        return x, gam, float(lit.attrs["value"]), y.name, chain, d
    return None


def rms_library(k, args, *, eps_scale=1.0, dtype=None, out_scale=1.0):
    """The pattern computed with its RMSNorm chain swapped for one
    ``F.rms_norm`` call on its own inputs (bf16 in, bf16 out where the
    pattern is: the same casts as the kernel); the other members, a
    residual add and reshapes, run eagerly.  The keyword arguments plant
    faults: a scaled eps, the norm in another dtype, a scaled output."""
    from repro_torch.core.codegen import canonical_dtype, eval_node
    m = rms_chain(k.pattern)
    if m is None:
        return None
    x, gam, eps, y, chain, d = m
    p, g = k.pattern, k.pattern.graph
    env0 = dict(zip(p.external_inputs, args))
    xdt = canonical_dtype(g[x].dtype)
    cdt = dtype or xdt
    # gamma arrives as a (d,) vector or broadcast to the full shape: one
    # row, cast once here (outside the timed call) to the norm's dtype
    w = env0[gam].reshape(-1, d)[0].to(cdt)
    eps = eps * eps_scale

    def run():
        env = dict(env0)
        for node in p.nodes:
            if node.name in env or node.name in chain:
                continue
            if node.name == y:
                out = F.rms_norm(env[x].to(cdt), (d,), w, eps)
                if out_scale != 1.0:
                    out = out * out_scale
                env[y] = out.to(xdt)
                continue
            env[node.name] = eval_node(node, [env[o] for o in node.operands], g)
        return tuple(env[n] for n in p.external_outputs)

    return run


def check_kernel(name, k, args, library=None, launches=None):
    out = k.launch(*args)
    torch.cuda.synchronize()
    ref = k.plain(*args)
    err = max_err(out, ref)
    if not within(out, ref):
        fail(f"kernel {name} disagrees with its plain version (max err {err})")
    ms = timed(lambda: k.launch(*args), 50)
    dev_ms = device_ms(lambda: k.launch(*args))
    plain_ms = timed(lambda: k.plain(*args), 20)
    lib = library if library is not None else rms_library(k, args)
    lib_ms = lib_dev_ms = lib_err = None
    if lib is not None:
        lib_out = lib()
        lib_err = max_err(lib_out, ref)
        if not within(lib_out, ref):
            fail(f"library call of {name} disagrees with the plain version "
                 f"(max err {lib_err})")
        # timed as the kernel is: back-to-back launches (host path
        # included), and replayed from a CUDA graph (device time)
        lib_ms = timed(lib, 50)
        lib_dev_ms = device_ms(lib)
    bound_ms, bound_by = kernel_bound(k)
    row = {"name": name, "route": "triton", "source": SOURCE,
           "generated": f"build/stitched/k_{k.digest}.py",
           "replaces": REPLACES}
    if launches is not None:
        row["launches"] = launches
    row.update({"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                "build_s": k.build_seconds,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                "library_max_abs_err": lib_err,
                "ops": len(k.pattern.compute_members),
                "grid": k.emitted.grid, "block_r": k.emitted.block_r})
    return row


# ---------------------------------------------------------------------------
# phase 1: sample kernels
# ---------------------------------------------------------------------------

def whole_graph_kernel(fn, args, name):
    from repro_torch.core.codegen import source_value
    from repro_torch.core.pattern import FusionPattern
    from repro_torch.core.trace import trace_to_graph
    from repro_torch.kernels.stitched import build_stitched_callable
    g, names = trace_to_graph(fn, *args, name=name)
    k = build_stitched_callable(FusionPattern(
        g, frozenset(n.name for n in g.compute_nodes())))
    env = dict(zip(names, args))
    kargs = [source_value(g[i], env, args[0].device)
             for i in k.pattern.external_inputs]
    return k, kargs


def sample_kernels(dev):
    gen = torch.Generator().manual_seed(SEED)

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dtype).to(dev)

    def rms(x, g):
        xf = x.float()
        var = (xf * xf).mean(-1, keepdim=True)
        return (xf * torch.rsqrt(var + 1e-6) * g.float()).to(x.dtype)

    def swiglu(a, b):
        return (F.silu(a.float()) * b.float()).to(torch.bfloat16)

    x_sm = rnd(64, 256)
    # gamma holds bf16 values in f32, as the model's params do after their
    # cast at use: the library call's bf16 weight is then the same gamma
    x_rms = rnd(4, 1, 2048, dtype=torch.bfloat16)
    g_rms = rnd(2048).to(torch.bfloat16).float()
    a_sw, b_sw = (rnd(4, 1, 6144, dtype=torch.bfloat16),
                  rnd(4, 1, 6144, dtype=torch.bfloat16))
    cases = [
        ("softmax_f32_64x256", lambda x: torch.softmax(x, -1), (x_sm,),
         lambda: (torch.softmax(x_sm, -1),)),
        # the library side of the RMSNorm comes from its RMSNorm chain
        ("rmsnorm_bf16_4x1x2048", rms, (x_rms, g_rms), None),
        ("swiglu_bf16_4x1x6144", swiglu, (a_sw, b_sw), None),
    ]
    rows = []
    for name, fn, args, lib in cases:
        k, kargs = whole_graph_kernel(fn, args, name)
        rows.append(check_kernel(name, k, kargs, library=lib))
    if rows[1]["library_ms"] is None:
        fail("the RMSNorm sample kernel has no library call")
    return rows


# ---------------------------------------------------------------------------
# phase 2: serve full-width qwen3-1.7b
# ---------------------------------------------------------------------------

def plan_bytes(compiled):
    """Bytes each group kind moves per call: every group's external inputs
    read once and outputs written once (GB, and the share of the plan)."""
    from repro_torch.core.pattern import FusionPattern
    g = compiled.graph
    by_kind = {"triton": 0, "torch": 0, "op": 0}
    for grp in compiled.groups:
        p = FusionPattern(g, grp.members)
        by_kind[grp.kind] += (sum(g[n].bytes for n in p.external_inputs)
                              + sum(g[n].bytes for n in p.external_outputs))
    total = sum(by_kind.values())
    return {k: (v / 1e9, v / total) for k, v in by_kind.items()}


def plan_line(tag, rep, compiled):
    plan = rep["plan"]
    diags = {}
    for d in rep["diagnostics"]:
        # one record per torch group; node names stripped so reasons count
        reason = re.sub(r"\b[a-z_]+_\d+\b", "*", d["reason"])
        diags[reason] = diags.get(reason, 0) + 1
    top = sorted(diags.items(), key=lambda kv: -kv[1])
    stages = {k: round(v, 2) for k, v in plan["stage_seconds"].items()}
    print(f"plan {tag}: n_ops={plan['n_ops']} n_kernels={plan['n_kernels']} "
          f"triton={plan['triton_groups']} torch={plan['torch_groups']} "
          f"op={plan['op_groups']} packs={plan['packs']} "
          f"ilp={plan['ilp_method']} trace_s={plan['trace_seconds']:.2f} "
          f"stages_s={stages}")
    print(f"plan {tag} torch groups by reason: {top}")
    share = plan_bytes(compiled)
    print(f"plan {tag} bytes per call by group kind: " + " ".join(
        f"{k}={gb:.4f}GB({frac:.4f})" for k, (gb, frac) in share.items()))


def group_inputs(compiled, inputs):
    """Run ``compiled`` once, eagerly, keeping the inputs of the first
    ``triton`` group of every generated kernel (by digest); also returns
    how many groups of the plan launch each kernel per call, and, for every
    hand-written kernel node (by kernel and operand signature), its first
    node, operands and count per call."""
    from repro_torch.core.codegen import eval_node, source_value
    g = compiled.graph
    device = next(v.device for v in inputs.values() if hasattr(v, "device"))
    env = {n: source_value(node, inputs, device)
           for n, node in g.nodes.items() if node.is_source()}
    seen, per_call, hand = {}, {}, {}
    for grp, members in zip(compiled._order, compiled._members_topo):
        if grp.kind == "triton":
            k = grp.tuned.callable
            args = [env[i] for i in k.pattern.external_inputs]
            per_call[k.digest] = per_call.get(k.digest, 0) + 1
            if k.digest not in seen:
                seen[k.digest] = (k, args)
            outs = k.plain(*args)
            for nm, val in zip(k.pattern.external_outputs, outs):
                env[nm] = val
        else:
            for nm in members:
                node = g[nm]
                args = [env[o] for o in node.operands]
                tag = node.attrs.get("kernel")
                if tag is not None and "project" not in node.attrs:
                    key = (tag, tuple((tuple(a.shape), str(a.dtype)) for a in args),
                           node.attrs["params_sig"])
                    hand.setdefault(key, [node, args, 0])[2] += 1
                env[nm] = eval_node(node, args, g)
    return seen, per_call, hand


def spec_inputs(sf, args):
    from torch.utils import _pytree as pytree
    sp = sf._active
    return dict(zip(sp.names, pytree.tree_flatten((tuple(args), {}))[0]))


def warm_serve(eng, prompts, lens, steps, tag):
    """Traces and compiles the prefill and decode plans and builds every
    generated kernel: a prefill, one decode step, then the rest."""
    t0 = time.perf_counter()
    px = eng.prefill(prompts, prompt_lens=lens)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for row in range(len(lens)):
        eng.insert(px, slot=row, row=row)
    eng.generate_step(steps=1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    eng.generate_step(steps=steps - 1)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    for row in range(len(lens)):
        eng.release(row)
    print(f"{tag} warm run: first prefill {t1 - t0:.1f}s, first decode step "
          f"{t2 - t1:.1f}s (trace + plan + kernel builds), "
          f"{steps - 1} more steps {t3 - t2:.1f}s")
    rep = eng.report()
    plan_line(f"{tag} prefill", rep["prefill"], eng._prefill_exec.compiled)
    plan_line(f"{tag} decode", rep["decode"], eng._exec.compiled)


def measured_serve(eng, prompts, lens, steps, dev, tag, vocab):
    """The main-path run: every launch count is zeroed just before it, the
    hand-written kernels' counts are read after the prefill and after the
    decode steps, the generated kernels' after the decode steps."""
    from repro_torch.kernels import ops, stitched
    n = len(lens)
    dec0 = dict(eng.report()["decode"]["calls"])
    torch.cuda.reset_peak_memory_stats()
    stitched.reset_launch_counts()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    px = eng.prefill(prompts, prompt_lens=lens)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hand_prefill = ops.launch_counts()
    hand_prefill_sig = ops.launch_counts_by_signature()
    for row in range(n):
        eng.insert(px, slot=row, row=row)
    cache_before = {k: v.clone() for k, v in eng.kv.decode_cache().items()}
    tok_before = torch.as_tensor(eng._tok.copy(), device=dev)
    torch.cuda.synchronize()
    t1b = time.perf_counter()
    toks = eng.generate_step(steps=steps)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = stitched.launch_counts()
    hand_total = ops.launch_counts()
    hand_total_sig = ops.launch_counts_by_signature()
    dec1 = eng.report()["decode"]["calls"]
    # device busy share of one decode step (the profiler's kernel time over
    # the step's wall time)
    t3 = time.perf_counter()
    busy = device_busy_ms(lambda: eng.generate_step(steps=1))
    wall = (time.perf_counter() - t3) * 1e3
    for row in range(n):
        eng.release(row)
    peak = torch.cuda.max_memory_allocated()
    prefill_ms = (t1 - t0) * 1e3
    decode_ms = (t2 - t1b) * 1e3 / steps
    tokens = n * (steps + 1)
    print(f"{tag} serve: prefill_ms={prefill_ms:.2f} "
          f"decode_ms_per_step={decode_ms:.2f} "
          f"tokens_per_s={tokens / (prefill_ms / 1e3 + (t2 - t1b)):.2f} "
          f"peak_mem_gb={peak / 2**30:.2f} "
          f"stitched_launches={sum(counts.values())} "
          f"hand_launches={sum(hand_total.values())}")
    print(f"{tag} decode step device busy: {busy} ms of {wall:.2f} ms wall "
          f"(profiled)")
    if toks.shape != (n, steps) or not np.all((toks >= 0) & (toks < vocab)):
        fail(f"{tag} decode tokens malformed: {toks.shape}")
    served = dec1["stitched"] - dec0["stitched"]
    fallbacks = dec1["fallback"] - dec0["fallback"]
    if served != steps or fallbacks:
        fail(f"{tag} stitched decode served {served}/{steps} steps, "
             f"{fallbacks} fallbacks")
    if eng.report()["prefill"]["calls"]["fallback"]:
        fail(f"{tag} prefill fell back to eager")
    return {"px": px, "cache_before": cache_before, "tok_before": tok_before,
            "counts": counts, "hand_prefill": hand_prefill,
            "hand_total": hand_total, "hand_prefill_sig": hand_prefill_sig,
            "hand_total_sig": hand_total_sig, "prefill_ms": prefill_ms,
            "decode_ms": decode_ms, "busy_ms": busy, "steps": steps}


def path_inputs(eng, params, prompts, run, dev):
    """Each plan run once more, eagerly, on the measured run's inputs:
    generated kernels and hand-written kernel nodes with their operands."""
    px = run["px"]
    padded = np.zeros((len(prompts), px.bucket), np.int64)
    padded[:, :prompts.shape[1]] = prompts
    pre_in = spec_inputs(eng._prefill_exec, (
        params, torch.as_tensor(padded, device=dev),
        torch.as_tensor(px.lengths, device=dev)))
    pre = group_inputs(eng._prefill_exec.compiled, pre_in)
    dec_in = spec_inputs(eng._exec, (params, run["cache_before"],
                                     run["tok_before"]))
    dec = group_inputs(eng._exec.compiled, dec_in)
    return pre, dec, dec_in


def stitched_rows(pre, dec, counts, tag, checked):
    """Every generated kernel of the two plans not checked yet: held
    against its plain version, timed, and its launches in this path's run
    (fatal when a kernel of the path was never launched)."""
    rows = []
    seen = dict(pre[0])
    seen.update(dec[0])
    for digest, (k, args) in seen.items():
        n = counts.get(digest, 0)
        if n <= 0:
            fail(f"{tag}: kernel {digest} of the path was never launched")
        if digest in checked:
            checked[digest]["launches"] += n
            continue
        members = sorted({m.attrs.get("op") or m.kind.value
                          for m in k.pattern.compute_members})
        row = check_kernel(f"stitched_{digest}[{','.join(members)}]", k, args,
                           launches=n)
        checked[digest] = row
        rows.append(row)
    print(f"{tag} path kernels: {len(seen)} distinct generated kernels, "
          f"{len(rows)} new")
    for what, per_call in (("prefill call", pre[1]), ("decode step", dec[1])):
        agg = {key: sum(n * checked[d][key] for d, n in per_call.items())
               for key in ("ms", "device_ms", "plain_ms", "bound_ms")}
        print(f"{tag} stitched kernels per {what}: kernels={len(per_call)} "
              f"launches={sum(per_call.values())} "
              + " ".join(f"{k}={v:.4f}" for k, v in agg.items()))
    return rows


def group_kind(grp, g) -> str:
    """The group's kind (``triton``, ``torch`` or ``op``), with ``_hand``
    added when it holds a hand-written kernel node.  The planner prices a
    ``torch_hand`` group as one fused kernel, but the executor runs it
    member by member; an ``op_hand`` group is the kernel node alone."""
    if grp.kind != "triton" and any(g[m].attrs.get("kernel")
                                    for m in grp.members):
        return grp.kind + "_hand"
    return grp.kind


def group_costs(compiled, inputs, reps: int = 3) -> dict:
    """Per group kind of a plan: groups; GB per call as planned (each
    group's external inputs read once and outputs written once) and as run
    (a torch group runs member by member, every member reading its operands
    and writing its value: an upper estimate, since views move nothing);
    and host ms per call spent launching the kind's groups (the executor's
    loop timed group by group, ``reps`` calls, one synchronize a call).
    Also the ms of a whole call of the plan, timed in one piece, to show
    what the timing group by group adds."""
    from repro_torch.core.codegen import eval_node, source_value
    from repro_torch.core.pattern import FusionPattern
    g = compiled.graph
    out = {}
    for grp in compiled.groups:
        c = out.setdefault(group_kind(grp, g), {"groups": 0, "planned_gb": 0.0,
                                                "run_gb": 0.0, "host_ms": 0.0})
        p = FusionPattern(g, grp.members)
        planned = (sum(g[n].bytes for n in p.external_inputs)
                   + sum(g[n].bytes for n in p.external_outputs)) / 1e9
        run = planned
        if grp.kind == "torch":
            run = sum(g[o].bytes for m in p.compute_members
                      for o in m.operands) / 1e9 \
                + sum(m.bytes for m in p.compute_members) / 1e9
        c["groups"] += 1
        c["planned_gb"] += planned
        c["run_gb"] += run
    device = next(v.device for v in inputs.values() if hasattr(v, "device"))
    for _ in range(reps):
        env = {n: source_value(node, inputs, device)
               for n, node in g.nodes.items() if node.is_source()}
        torch.cuda.synchronize()
        for grp, members, dead in zip(compiled._order, compiled._members_topo,
                                      compiled._free_after):
            t0 = time.perf_counter()
            if grp.kind == "triton" and grp.tuned and grp.tuned.callable:
                pat = grp.tuned.pattern
                outs = grp.tuned.callable(*[env[i] for i in pat.external_inputs])
                env.update(zip(pat.external_outputs, outs))
            else:
                for nm in members:
                    node = g[nm]
                    env[nm] = eval_node(node, [env[o] for o in node.operands], g)
            out[group_kind(grp, g)]["host_ms"] += \
                (time.perf_counter() - t0) * 1e3 / reps
            for nm in dead:
                env.pop(nm, None)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        compiled(inputs)
        torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3 / reps
    return {k: {f: round(v, 4) if isinstance(v, float) else v
                for f, v in c.items()} for k, c in sorted(out.items())}, call_ms


def plan_summary(eng, run, dec_in):
    plan = eng.report()["decode"]["plan"]
    out = {k: plan[k] for k in ("n_ops", "n_kernels", "triton_groups",
                                "torch_groups", "op_groups")}
    out["bytes_gb"] = {k: round(gb, 4)
                       for k, (gb, _) in plan_bytes(eng._exec.compiled).items()}
    out["compile_s"] = round(plan["compile_seconds"] + plan["trace_seconds"], 2)
    out["decode_ms_per_step"] = round(run["decode_ms"], 2)
    g = eng._exec.graph
    out["groups_with_hand_kernel"] = sum(
        1 for grp in eng._exec.compiled.groups
        if any(g[m].attrs.get("kernel") for m in grp.members))
    out["by_group_kind"], call_ms = group_costs(eng._exec.compiled, dec_in)
    out["plan_call_ms"] = round(call_ms, 2)
    return out


def serve_phase(dev, model, params, lens, prompts, checked):
    """The ref-mode path: full width, stitched prefill and decode, every
    generated kernel held against its plain version; then the bf16 logit
    check against the eager decode over several weight seeds."""
    from repro_torch.core import StitchCompiler
    from repro_torch.serve import Engine, ServeConfig
    cfg = model.cfg
    scfg = ServeConfig(batch=4, max_len=128, max_new_tokens=16,
                       stitch_execute=True, paged=False)
    eng = Engine(model, params, scfg, device=dev,
                 compiler=StitchCompiler(plan_budget=20.0))
    warm_serve(eng, prompts, lens, scfg.max_new_tokens - 1, "ref-mode")
    run = measured_serve(eng, prompts, lens, scfg.max_new_tokens - 1, dev,
                         "ref-mode", cfg.vocab)
    if sum(run["counts"].values()) <= 0:
        fail("no Triton stitched launch on the ref-mode path")
    pre, dec, dec_in = path_inputs(eng, params, prompts, run, dev)
    kernels = stitched_rows(pre, dec, run["counts"], "ref-mode", checked)
    summary = plan_summary(eng, run, dec_in)
    del pre, dec, dec_in, run

    # first decode step, stitched vs eager, over several weight seeds; then
    # faults planted in the stitched RMSNorm kernels (seed 0) show what the
    # tolerance would catch
    eager = Engine(model, params, ServeConfig(batch=4, max_len=128,
                                              max_new_tokens=16), device=dev)
    readings, ref0 = [], None
    for s in range(LOGIT_SEEDS):
        if s:
            eng.params = eager.params = model.init(SEED + s, dev)
        ps = prompts_for(cfg, lens, SEED + s)
        st = first_step_logits(eng, ps, lens)
        ea = first_step_logits(eager, ps, lens)
        agree = float((st.argmax(-1) == ea.argmax(-1)).float().mean())
        readings.append(rel_diff(st, ea))
        print(f"decode logits stitched vs eager (bf16, {cfg.n_layers}L, seed "
              f"{SEED + s}): rel={readings[-1]:.6g} "
              f"max_ref={float(ea.abs().max()):.4g} argmax_agree={agree}")
        if s == 0:
            ref0 = (ps, ea)
    eng.params = eager.params = params
    faults = fault_readings(eng, ref0, lens, BF16_FAULTS)
    print(f"decode logits bf16: tol={LOGIT_TOL} sound max={max(readings):.6g} "
          f"planted faults {faults}")
    if not all(np.isfinite(r) and r <= LOGIT_TOL for r in readings):
        fail("stitched decode logits disagree with the eager decode")
    return kernels, summary


# ---------------------------------------------------------------------------
# kernel mode: the hand-written kernels
# ---------------------------------------------------------------------------

# per reference kernel body: the port's launch-count name, route, source and
# the TPU kernel's pallas_call
HAND = {
    "_rmsnorm_kernel": ("rmsnorm", "triton", "src/repro_torch/kernels/norms.py",
                        "src/repro/kernels/norms.py:44"),
    "_glu_kernel": ("glu", "triton", "src/repro_torch/kernels/activations.py",
                    "src/repro/kernels/activations.py:32"),
    "_rope_kernel": ("rope", "triton", "src/repro_torch/kernels/rope.py",
                     "src/repro/kernels/rope.py:44"),
    "_decode_attn_kernel": ("decode_attention", "cuda",
                            "src/repro_torch/csrc/decode_attention.cu",
                            "src/repro/kernels/decode_attention.py:95"),
    "_flash_kernel": ("flash_attention", "cuda",
                      "src/repro_torch/csrc/flash_attention.cu",
                      "src/repro/kernels/flash_attention.py:94"),
    "_router_kernel": ("router", "cuda", "src/repro_torch/csrc/router.cu",
                       "src/repro/kernels/router.py:50"),
}
# elementwise operations per output element (the bound's operation count)
HAND_OPS = {"_rmsnorm_kernel": 4, "_glu_kernel": 5, "_rope_kernel": 6}


def expected_launches(cfg, bucket: int) -> tuple[dict, dict]:
    """Hand-written kernel launches per decode step and per prefill call,
    from the config: 2 norms a layer (4 with qk-norm) + the final one, 2
    rotaries and 1 GLU a layer (the experts' GLU in a MoE layer), the router
    once a MoE layer, decode attention once a layer on decode only, flash
    attention once a layer on a prefill whose bucket is a multiple of 128."""
    L = cfg.n_layers
    step = {"rmsnorm": (4 if cfg.qk_norm else 2) * L + 1, "rope": 2 * L,
            "glu": L, "decode_attention": L, "flash_attention": 0,
            "router": L if cfg.family == "moe" else 0}
    return step, dict(step, decode_attention=0,
                      flash_attention=L if bucket % 128 == 0 else 0)


# planted faults in the CUDA sources: (sound text, planted text).  Decode
# attention drops the row's own key (kpos < pos); flash attention leaves acc
# unrescaled when a later kv tile raises the row max; the router does not
# mask the column a round chose, so each row picks its top expert k times
FAULTS = {
    "decode_attention": ("const int hi = min(p, smax - 1);",
                         "const int hi = min(p - 1, smax - 1);"),
    "flash_attention": ("#pragma unroll\n      for (int j = 0; j < DPT; ++j) "
                        "acc[i][j] *= alpha;\n", ""),
    "router": ("if (lane + 32 * j == bi) p[j] = -1.0f;", ""),
}


def fault_dir() -> Path:
    from repro_torch.kernels import build
    return build.build_dir() / "planted_fault"


def build_phase() -> float:
    """Build every CUDA library, and a copy of each with its fault planted,
    from an empty ``build/kernels``: one nvcc each, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    shutil.rmtree(build.build_dir(), ignore_errors=True)
    fault_dir().mkdir(parents=True)
    for stem, (sound, planted) in FAULTS.items():
        src = (build.CSRC / f"{stem}.cu").read_text()
        if src.count(sound) != 1:
            fail(f"the {stem} source lost the text its fault is planted in")
        (fault_dir() / f"{stem}.cu").write_text(src.replace(sound, planted))
    jobs = [(src.stem, build.CSRC, None)
            for src in sorted(build.CSRC.glob("*.cu"))]
    jobs += [(stem, fault_dir(), fault_dir()) for stem in FAULTS]

    def one(job):
        t = time.perf_counter()
        path = build.library(*job)
        return path, time.perf_counter() - t

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        built = list(ex.map(one, jobs))
    secs = time.perf_counter() - t0
    for (stem, src_dir, _), (path, t) in zip(jobs, built):
        info = [ln.split("info    : ")[-1].strip()
                for ln in path.with_suffix(".log").read_text().splitlines()
                if "registers" in ln or "spill" in ln]
        what = "planted fault " if src_dir != build.CSRC else ""
        print(f"cuda build {what}{stem}: {path.name} in {t:.2f}s ptxas {info}")
    print(f"cuda build: {len(jobs)} libraries ({len(FAULTS)} with a planted "
          f"fault) from an empty {build.build_dir().relative_to(ROOT)} in "
          f"{secs:.2f}s, in parallel")
    return secs


def hand_plain(tag):
    from repro_torch.kernels import activations, decode_attention, norms, rope
    from repro_torch.kernels import flash_attention, router
    return {"_rmsnorm_kernel": norms.rmsnorm_plain,
            "_glu_kernel": activations.glu_plain,
            "_rope_kernel": rope.rope_plain,
            "_decode_attn_kernel": decode_attention.decode_attention_plain,
            "_flash_kernel": flash_attention.flash_attention_plain,
            "_router_kernel": router.topk_router_plain}[tag]


def router_compare(name, x, k, out, ref) -> dict:
    """The router kernel's (weights, ids) against the plain version's on
    logits ``x``.  Ids must be equal on every row whose plain probabilities
    among the top k+1 are, pair by pair, equal or more than 4 f32 ulps
    apart; on a row with an exact tie they must also equal a stable
    descending sort's (the lowest index first).  Rows with a closer gap
    are counted, and their sorted weights compared within tolerance.
    Fails on a disagreement; returns the counts and the weights' error."""
    (w, ids), (pw, pids) = out, ref
    xf = x.float()
    e = torch.exp(xf - xf.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    top = torch.sort(p, dim=-1, descending=True, stable=True)
    n = min(k + 1, x.shape[-1])
    v = top.values[:, :n]
    gap = v[:, :-1] - v[:, 1:]
    ulp = torch.nextafter(v[:, :-1], torch.full_like(v[:, :-1], 2.0)) \
        - v[:, :-1]
    close = ((gap > 0) & (gap <= 4 * ulp)).any(-1)
    tie = (gap == 0).any(-1) & ~close
    far = ~close
    if not torch.equal(ids[far], pids[far]):
        bad = int((ids[far] != pids[far]).any(-1).sum())
        fail(f"router {name}: ids differ from the plain version's on {bad} "
             f"rows without a near tie")
    if not torch.equal(ids[tie], top.indices[:, :k][tie].to(torch.int32)):
        fail(f"router {name}: a tie did not go to the lowest index")
    wf, pwf = w.float().clone(), pw.float().clone()
    wf[close] = wf[close].sort(-1).values
    pwf[close] = pwf[close].sort(-1).values
    rtol, atol = TOL[str(w.dtype).replace("torch.", "")]
    if not torch.allclose(wf, pwf, rtol=rtol, atol=atol):
        fail(f"router {name}: weights disagree with the plain version "
             f"(max err {max_err((wf,), (pwf,))})")
    return {"err": max_err((wf,), (pwf,)), "rows": x.shape[0],
            "tie_rows": int(tie.sum()), "close_rows": int(close.sum())}


def router_chain(x, k, renorm=True):
    """The same function as three PyTorch calls (``softmax``, ``topk``, a
    divide): no single call computes it, so this is a yardstick of a chain,
    not a library call.  ``torch.topk`` ranks ties in no fixed order."""
    def run():
        w, i = torch.topk(torch.softmax(x.float(), dim=-1), k)
        if renorm:
            w = w / w.sum(dim=-1, keepdim=True)
        return w.to(x.dtype), i
    return run


# flash-attention samples: (name, B, Hq, Hkv, Lq, Lkv, Dh, causal, window,
# q_offset).  Several kv tiles, one of them fully masked for the first q
# tile; a chunk after 256 cached tokens; a window; MHA at Dh 64; Lq not a
# power of two; rows without a valid key (qpos >= Lkv - 1 + window: 85 of
# the 128 rows), which come out as the mean of V in both versions
FLASH_SAMPLES = [
    ("causal_g2_l256", 2, 16, 8, 256, 256, 128, True, None, 0),
    ("chunk_lq128_lkv384_off256", 2, 16, 8, 128, 384, 128, True, None, 256),
    ("causal_window64", 2, 16, 8, 256, 256, 128, True, 64, 0),
    ("mha_dh64", 2, 8, 8, 256, 256, 64, True, None, 0),
    ("causal_l384", 1, 16, 8, 384, 384, 128, True, None, 0),
    ("rows_without_a_valid_key", 1, 4, 2, 128, 128, 128, True, 16, 100),
]


def hand_samples(dev):
    """Each hand-written kernel against its plain version at sample shapes
    (ragged widths, a GQA group of 4, decode positions at 0, in the middle
    and at Smax-1, with and without a window; the flash cases above), in
    f32 and bf16."""
    from repro_torch.kernels import activations, decode_attention, norms, rope
    from repro_torch.kernels import flash_attention
    gen = torch.Generator().manual_seed(SEED)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen).to(dtype).to(dev)

    cases = []
    for dt in (torch.float32, torch.bfloat16):
        t = str(dt).replace("torch.", "")
        cases.append((f"rmsnorm_{t}_12x200", norms.rmsnorm_op,
                      "_rmsnorm_kernel",
                      (rnd(12, 200, dtype=dt), rnd(200, dtype=dt), 1e-6)))
        for act in ("silu", "gelu"):
            cases.append((f"glu_{act}_{t}_7x333", activations.glu_op,
                          "_glu_kernel", (rnd(7, 333, dtype=dt),
                                          rnd(7, 333, dtype=dt), act)))
        pos = torch.tensor([0, 5, 17, 63, 100, 127], dtype=torch.int32,
                           device=dev)
        cases.append((f"rope_{t}_6x3x64", rope.rope_op, "_rope_kernel",
                      (rnd(6, 192, dtype=dt), pos, 1e4, 64)))
        q, k, v = (rnd(3, 1, 8, 128, dtype=dt), rnd(3, 96, 2, 128, dtype=dt),
                   rnd(3, 96, 2, 128, dtype=dt))
        dpos = torch.tensor([[0], [47], [95]], dtype=torch.int32, device=dev)
        for window in (None, 16):
            cases.append((f"decode_attention_{t}_g4_s96_w{window}",
                          decode_attention.decode_attention_op,
                          "_decode_attn_kernel",
                          (dpos, q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), 128 ** -0.5, window)))
        for name, B, hq, hkv, lq, lkv, dh, causal, window, off in FLASH_SAMPLES:
            q = rnd(B, lq, hq, dh, dtype=dt)
            k, v = rnd(B, lkv, hkv, dh, dtype=dt), rnd(B, lkv, hkv, dh, dtype=dt)
            cases.append((f"flash_{t}_{name}", flash_attention.flash_attention_op,
                          "_flash_kernel",
                          (q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), dh ** -0.5, causal, window, off)))
    errs = {}
    for name, op, tag, args in cases:
        out = op(*args)
        torch.cuda.synchronize()
        ref = hand_plain(tag)(*args)
        errs[name] = max_err((out,), (ref,))
        if not within((out,), (ref,)):
            fail(f"hand-written kernel {name} disagrees with its plain version "
                 f"(max err {errs[name]})")
    print(f"hand-written kernel samples vs plain: "
          + " ".join(f"{k}={v:.3g}" for k, v in errs.items()))
    router_samples(rnd)
    # RoPE in f32 against the rotation computed in f64 from exact angles:
    # how far the kernel and its plain version each are from exact
    x, pos, theta, hd = next(a for n, _, _, a in cases
                             if n.startswith("rope_float32"))
    exact = rope_f64(x, pos, theta, hd)
    dist = {k: float((f(x, pos, theta, hd).double() - exact).abs().max())
            for k, f in (("kernel", rope.rope_op), ("plain", rope.rope_plain))}
    print(f"rope f32 vs f64 at positions up to {int(pos.max())}: "
          + " ".join(f"{k}={v:.3g}" for k, v in dist.items()))


# router samples (T, E, k): a granite decode step and bucket-256 prefill, a
# ragged E past one lane's column, the widest E the kernel takes
ROUTER_SAMPLES = [(4, 32, 8), (1024, 32, 8), (1000, 60, 4), (512, 64, 8)]


def router_samples(rnd):
    """The router kernel against its plain version (``router_compare``) at
    the sample shapes, f32 and bf16, renormalised or not; and on
    bf16-rounded f32 logits, where exact ties are common, with one row of
    equal logits."""
    from repro_torch.kernels import router
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        t = str(dt).replace("torch.", "")
        for T, E, k in ROUTER_SAMPLES:
            x = rnd(T, E, dtype=dt)
            for renorm in (True, False):
                cases.append((f"router_{t}_{T}x{E}_k{k}_renorm{int(renorm)}",
                              x, k, renorm))
    ties = rnd(4096, 32, dtype=torch.bfloat16).float()
    ties[0] = 0.25
    for renorm in (True, False):
        cases.append((f"router_bf16_rounded_f32_4096x32_k8_renorm{int(renorm)}",
                      ties, 8, renorm))
    stats = {}
    for name, x, k, renorm in cases:
        out = router.topk_router_op(x, k, renorm)
        torch.cuda.synchronize()
        stats[name] = router_compare(name, x, k, out,
                                     router.topk_router_plain(x, k, renorm))
    if not stats[cases[-1][0]]["tie_rows"]:
        fail("the bf16-rounded router samples hold no exact tie")
    if out[1][0].tolist() != list(range(8)):
        fail(f"router: a row of equal logits chose {out[1][0].tolist()}")
    print("router kernel samples vs plain (weights max err; rows with an "
          "exact tie; rows with a gap of 4 ulps or less): " + " ".join(
              f"{n}={v['err']:.3g}/{v['tie_rows']}/{v['close_rows']}"
              for n, v in stats.items()))


def rope_f64(x, pos, theta, head_dim):
    """``rope_op``'s rotation in f64 from the exact angles."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float64,
                                   device=x.device) / half)
    ang = pos.double()[:, None, None] * freq            # (rows, 1, half)
    xr = x.double().reshape(x.shape[0], -1, head_dim)
    x1, x2 = xr[..., :half], xr[..., half:]
    c, s = torch.cos(ang), torch.sin(ang)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).reshape(x.shape)


def op_call(node, tensors):
    """(op, args, kwargs) of a hand-written kernel node on ``tensors``."""
    from torch.utils import _pytree as pytree
    from repro_torch.core.trace import _Slot
    kw = node.attrs["eval_fn"].__kwdefaults__
    args, kwargs = pytree.tree_map(
        lambda s: tensors[s.i] if isinstance(s, _Slot) else s, kw["_tmpl"],
        is_leaf=lambda s: isinstance(s, _Slot))
    return kw["_t"], list(args), dict(kwargs)


def hand_library(tag, args):
    """One PyTorch call computing the same function on the same inputs,
    where there is one (a yardstick; the port never calls it)."""
    if tag == "_rmsnorm_kernel":
        x, g, eps = args
        return lambda: F.rms_norm(x, (x.shape[-1],), g, eps)
    if tag == "_decode_attn_kernel":
        pos, qt, kt, vt, scale, *rest = args    # window defaults to None
        window = rest[0] if rest else None
        kpos = torch.arange(kt.shape[2], device=kt.device)[None, :]
        mask = kpos <= pos
        if window is not None:
            mask = mask & (pos - kpos < window)
        mask = mask[:, None, None, :]
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)
    if tag == "_flash_kernel":
        qt, kt, vt, scale, causal, window, q_offset = args
        if not (causal and window is None and q_offset == 0
                and qt.shape[2] == kt.shape[2]):
            return None
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True)
    return None


def hand_bound(tag, args, out) -> tuple[float, str]:
    """Least time for the kernel's work on this run's data: each input read
    once and the output written once over the memory rate, or its
    operations over the rate for their type, whichever is larger.
    Elementwise kernels count f32 operations at the f32 rate; decode
    attention reads only the valid keys of each row; flash attention's
    QK^T and PV products count the valid (query, key) pairs, at the bf16
    tensor-core rate for bf16 inputs and the f32 rate for f32 ones; the
    router counts its softmax (5 operations a logit) and k rounds of a
    compare and a select per logit, at the f32 rate."""
    def nbytes(t):
        return t.numel() * t.element_size()
    rate = F32_PEAK
    if tag == "_router_kernel":
        x, k, _ = args
        b = nbytes(x) + sum(nbytes(o) for o in out)
        ops = x.numel() * (5 + 2 * k)
    elif tag == "_flash_kernel":
        qt, kt, vt, scale, causal, window, q_offset = args
        B, hq, lq, dh = qt.shape
        qpos = q_offset + torch.arange(lq)[:, None]
        kpos = torch.arange(kt.shape[2])[None, :]
        valid = torch.ones(qpos.shape[0], kpos.shape[1], dtype=torch.bool)
        if causal:
            valid &= qpos >= kpos
        if window is not None:
            valid &= qpos - kpos < window
        b = nbytes(qt) + nbytes(kt) + nbytes(vt) + nbytes(out)
        ops = 4 * B * hq * int(valid.sum()) * dh
        if qt.dtype == torch.bfloat16:
            rate = BF16_PEAK
    elif tag == "_decode_attn_kernel":
        pos, qt, kt, vt, scale, *rest = args    # window defaults to None
        window = rest[0] if rest else None
        p = pos.reshape(-1).long()
        hi = p.clamp(max=kt.shape[2] - 1)
        lo = (p - window + 1).clamp(min=0) if window is not None else 0
        keys = int((hi - lo + 1).clamp(min=0).sum())
        _, hkv, _, dh = kt.shape
        b = (2 * keys * hkv * dh * kt.element_size() + nbytes(qt)
             + nbytes(pos) + nbytes(out))
        ops = 4 * qt.shape[1] * dh * keys
    else:
        b = sum(nbytes(a) for a in args if isinstance(a, torch.Tensor)) \
            + nbytes(out)
        ops = HAND_OPS[tag] * out.numel()
    tb, to = b / HBM_BW, ops / rate
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def launch_signature(name, node, tensors) -> tuple:
    """The key the kernel's launcher counts a launch of ``node`` under
    (``build.signature`` of its arguments, defaults filled in)."""
    from repro_torch.kernels import activations, build, decode_attention
    from repro_torch.kernels import flash_attention, norms, rope, router
    launcher = {"rmsnorm": norms, "glu": activations, "rope": rope,
                "decode_attention": decode_attention,
                "flash_attention": flash_attention, "router": router}[name]._launch
    _, args, kwargs = op_call(node, tensors)
    return build.signature(*all_args(launcher, args, kwargs))


def all_args(fn, args, kwargs) -> list:
    """``fn``'s arguments in order, defaults filled in (the dispatcher drops
    an argument left at its default from the traced call)."""
    import inspect
    bound = inspect.signature(fn).bind(*args, **kwargs)
    bound.apply_defaults()
    return list(bound.arguments.values())


def hand_rows(pre, dec, steps, run, path):
    """Every hand-written kernel launch signature of the two plans (shapes,
    dtypes and other arguments), on its main-path operands: held against
    the plain version and timed.  Its launches are the ones its launcher
    counted under that signature in the measured run; they must equal the
    plans' nodes of that signature times the calls of the run, and no
    launch of the run may have a signature outside the plans."""
    plans = {}
    for hand, calls in ((pre[2], 1), (dec[2], steps)):
        for (tag, *_), (node, tensors, n) in hand.items():
            name = HAND[tag][0]
            key = (name, launch_signature(name, node, tensors))
            plans.setdefault(key, [tag, node, tensors, 0])[3] += n * calls
    total, prefill = run["hand_total_sig"], run["hand_prefill_sig"]
    measured = {(name, sig): n for name, c in total.items()
                for sig, n in c.items()}
    if set(measured) != set(plans):
        fail(f"hand-written kernels launched at signatures "
             f"{sorted(map(str, set(measured) - set(plans)))} outside the "
             f"plans, or never at {sorted(map(str, set(plans) - set(measured)))}")
    derived = {key: v[3] for key, v in plans.items()}
    if measured != derived:
        fail(f"hand-written kernel launches by signature {measured} != the "
             f"plans' nodes times their calls {derived}")
    rows = {}
    for key, (tag, node, tensors, _) in sorted(
            plans.items(), key=lambda kv: (kv[0][0], -measured[kv[0]])):
        name, sig = key
        _, route, source, replaces = HAND[tag]
        op, args, kwargs = op_call(node, tensors)
        plain = hand_plain(tag)
        full = all_args(plain, args, kwargs)

        def run_op():
            return op(*args, **kwargs)

        out = run_op()
        torch.cuda.synchronize()
        ref = plain(*args, **kwargs)
        extra = {}
        if tag == "_router_kernel":
            cmp = router_compare(f"{name} at {sig}", full[0], full[1], out, ref)
            err = cmp["err"]
            chain = router_chain(*full)
            extra = {"tie_rows": cmp["tie_rows"],
                     "close_rows": cmp["close_rows"],
                     "chain": "softmax -> topk -> div, three calls",
                     "chain_ms": timed(chain, 50),
                     "chain_device_ms": device_ms(chain)}
        else:
            err = max_err((out,), (ref,))
            if not within((out,), (ref,)):
                fail(f"{name} at {sig} disagrees with its plain version "
                     f"(max err {err})")
        lib = hand_library(tag, full)
        lib_ms = lib_dev_ms = lib_err = None
        if lib is not None:
            lib_out = lib()
            lib_err = max_err((lib_out,), (ref,))
            if not within((lib_out,), (ref,)):
                fail(f"library call of {name} disagrees with the plain "
                     f"version (max err {lib_err})")
            lib_ms = timed(lib, 50)
            lib_dev_ms = device_ms(lib)
        bound_ms, bound_by = hand_bound(tag, full, out)
        tensor_sig = [a for a in sig if isinstance(a, tuple)]
        shapes = ",".join("x".join(map(str, s)) for s, _ in tensor_sig)
        dt = next(d for _, d in tensor_sig if "float" in d).replace("torch.", "")
        n_prefill = prefill[name].get(sig, 0)
        rows[key] = {"name": f"{name}[{shapes},{dt}]", "path": path,
                     "route": route, "source": source, "replaces": replaces,
                     "launches": measured[key],
                     "launches_prefill_call": n_prefill,
                     "launches_per_decode_step": (measured[key] - n_prefill)
                     / steps,
                     "max_abs_err": err,
                     "ms": timed(run_op, 50), "device_ms": device_ms(run_op),
                     "plain_ms": timed(lambda: plain(*args, **kwargs), 20),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                     "library_max_abs_err": lib_err, **extra}
    for name, *_ in HAND.values():
        for what, field in (("decode step", "launches_per_decode_step"),
                            ("prefill call", "launches_prefill_call")):
            mine = [(r, r[field]) for (nm, _), r in rows.items()
                    if nm == name and r[field]]
            agg = {f: sum(n * r[f] for r, n in mine)
                   for f in ("ms", "device_ms", "plain_ms", "bound_ms")}
            for lib in ("library", "chain"):
                if mine and all(r.get(f"{lib}_ms") is not None for r, _ in mine):
                    for f in (f"{lib}_ms", f"{lib}_device_ms"):
                        agg[f] = sum(n * r[f] for r, n in mine)
            print(f"{path} {name} per {what}: "
                  f"launches={sum(n for _, n in mine):g} "
                  + " ".join(f"{k}={v:.4f}" for k, v in agg.items()))
    return list(rows.values())


def serve_kernel_mode(dev, model, params, lens, prompts, max_len, tag,
                      checked):
    """Serve the prompts stitched through the hand-written kernels
    (``kernel_mode("kernels")``), prefill and 15 decode steps; the exact
    launch counts per prefill call and decode step for the prompts' bucket;
    every kernel of the path held against its plain version and timed.
    Returns (engine, ``kernels`` rows, decode plan summary)."""
    from repro_torch.core import StitchCompiler
    from repro_torch.kernels import ops
    from repro_torch.serve import Engine, ServeConfig
    cfg = model.cfg
    steps = 15
    scfg = ServeConfig(batch=4, max_len=max_len, max_new_tokens=steps + 1,
                       stitch_execute=True, paged=False)
    with ops.kernel_mode("kernels"):
        eng = Engine(model, params, scfg, device=dev,
                     compiler=StitchCompiler(plan_budget=20.0))
        warm_serve(eng, prompts, lens, steps, tag)
        run = measured_serve(eng, prompts, lens, steps, dev, tag, cfg.vocab)
    bucket = run["px"].bucket
    per_step, per_prefill = expected_launches(cfg, bucket)
    decode_counts = {k: run["hand_total"][k] - run["hand_prefill"][k]
                     for k in per_step}
    print(f"{tag} launches: prefill call (bucket {bucket}) "
          f"{run['hand_prefill']}, {steps} decode steps {decode_counts}")
    if run["hand_prefill"] != per_prefill:
        fail(f"{tag} prefill launched {run['hand_prefill']}, expected "
             f"{per_prefill}")
    for k, n in per_step.items():
        if decode_counts[k] != n * steps:
            fail(f"{tag} decode launched {k} {decode_counts[k]} times in "
                 f"{steps} steps, expected {n} a step")
    pre, dec, dec_in = path_inputs(eng, params, prompts, run, dev)
    kernels = stitched_rows(pre, dec, run["counts"], tag, checked)
    kernels += hand_rows(pre, dec, steps, run, tag)
    summary = plan_summary(eng, run, dec_in)
    return eng, kernels, summary


def kernel_mode_phase(dev, model, params, lens, prompts, checked):
    """The kernel-mode path at the 64 bucket (``serve_kernel_mode``); then
    its bf16 decode logits against the ref-mode eager decode over several
    weight seeds."""
    from repro_torch.kernels import ops
    from repro_torch.serve import Engine, ServeConfig
    cfg = model.cfg
    eng, kernels, summary = serve_kernel_mode(
        dev, model, params, lens, prompts, 128, "kernel-mode", checked)
    eager = Engine(model, params, ServeConfig(batch=4, max_len=128,
                                              max_new_tokens=2), device=dev)
    readings = []
    for s in range(LOGIT_SEEDS):
        if s:
            eng.params = eager.params = model.init(SEED + s, dev)
        ps = prompts_for(cfg, lens, SEED + s)
        with ops.kernel_mode("kernels"):
            km = first_step_logits(eng, ps, lens)
        ea = first_step_logits(eager, ps, lens)
        agree = float((km.argmax(-1) == ea.argmax(-1)).float().mean())
        readings.append(rel_diff(km, ea))
        print(f"decode logits kernel mode vs ref-mode eager (bf16, "
              f"{cfg.n_layers}L, seed {SEED + s}): rel={readings[-1]:.6g} "
              f"argmax_agree={agree}")
    eng.params = eager.params = params
    print(f"kernel-mode decode logits bf16: tol={KM_LOGIT_TOL} sound "
          f"max={max(readings):.6g}")
    if not all(np.isfinite(r) and r <= KM_LOGIT_TOL for r in readings):
        fail("kernel-mode decode logits disagree with the ref-mode eager decode")
    return kernels, summary


# four prompts in the 256 bucket: a support ticket thread or a RAG query
# with its retrieved passage
LONG_LENS = np.array([256, 200, 160, 131], np.int32)
LONG_MAX_LEN = 512


def long_prompt_phase(dev, model, params, checked):
    """The kernel-mode path at the 256 bucket, where every prefill layer
    runs the flash-attention kernel (``serve_kernel_mode``); then its bf16
    prefill and first-step logits against the ref-mode eager engine over
    several weight seeds."""
    from repro_torch.kernels import ops
    from repro_torch.serve import Engine, ServeConfig
    cfg = model.cfg
    tag = "kernel-mode long"
    prompts = prompts_for(cfg, LONG_LENS, SEED)
    eng, kernels, summary = serve_kernel_mode(
        dev, model, params, LONG_LENS, prompts, LONG_MAX_LEN, tag, checked)
    eager = Engine(model, params, ServeConfig(batch=4, max_len=LONG_MAX_LEN,
                                              max_new_tokens=2), device=dev)
    readings = {"prefill": [], "decode": []}
    for s in range(LOGIT_SEEDS):
        if s:
            eng.params = eager.params = model.init(SEED + s, dev)
        ps = prompts_for(cfg, LONG_LENS, SEED + s)
        with ops.kernel_mode("kernels"):
            km = prefill_and_step_logits(eng, ps, LONG_LENS)
        ea = prefill_and_step_logits(eager, ps, LONG_LENS)
        for what, a, b in zip(("prefill", "decode"), km, ea):
            readings[what].append(rel_diff(a, b))
            agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
            print(f"{tag} {what} logits vs ref-mode eager (bf16, "
                  f"{cfg.n_layers}L, seed {SEED + s}): "
                  f"rel={readings[what][-1]:.6g} argmax_agree={agree}")
    eng.params = eager.params = params
    print(f"{tag} logits bf16: tol={KM_LONG_LOGIT_TOL} sound max prefill="
          f"{max(readings['prefill']):.6g} decode={max(readings['decode']):.6g}")
    if not all(np.isfinite(r) and r <= KM_LONG_LOGIT_TOL
               for rs in readings.values() for r in rs):
        fail(f"{tag} logits disagree with the ref-mode eager engine")
    return kernels, summary


MOE_ARCH = "granite-moe-1b-a400m"
# the MoE phase: kernel mode against the eager ref-mode engine in bf16 at
# the long prompts, prefill (last true position) and first decode step, as
# rel_diff.  Besides the rounding noise of the dense path, the stitched plan
# computes the router's dot in f32 (the widening-convert fold) where the
# eager engine rounds it to bf16, and a token whose 8th and 9th expert
# probabilities differ by less than that rounding changes its experts: a
# flip moves its output far more than rounding does.  Readings over 3 seeds
# on an H100 (24 layers): prefill 0.0181 to 0.0431, first step 0.0249 to
# 0.197 (argmax agreement 0.5 at seed 0); each limit is 1.35x its largest
# reading, rounded up.  The float32 check (moe_f32) is the tight gate.
MOE_LOGIT_TOL = {"prefill": 0.059, "decode": 0.27}


def moe_phase(dev, checked):
    """Full-width granite-moe-1b-a400m served in kernel mode at the long
    prompts (``serve_kernel_mode``: the router kernel in every layer of the
    prefill and of each decode step); then its bf16 prefill and first-step
    logits against the ref-mode eager engine over several weight seeds."""
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig
    cfg = get_config(MOE_ARCH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, dev)
    torch.cuda.synchronize()
    m = cfg.moe
    print(f"init {cfg.name}: {cfg.n_layers}L d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} experts={m.n_experts} "
          f"top_k={m.top_k} d_expert={m.d_expert} vocab={cfg.vocab} "
          f"params={sum(t.numel() for t in tree_leaves(params)) / 1e9:.3f}B in "
          f"{time.perf_counter() - t0:.1f}s")
    tag = "moe kernel-mode long"
    prompts = prompts_for(cfg, LONG_LENS, SEED)
    eng, kernels, summary = serve_kernel_mode(
        dev, model, params, LONG_LENS, prompts, LONG_MAX_LEN, tag, checked)
    eager = Engine(model, params, ServeConfig(batch=4, max_len=LONG_MAX_LEN,
                                              max_new_tokens=2), device=dev)
    readings = {"prefill": [], "decode": []}
    for s in range(LOGIT_SEEDS):
        if s:
            eng.params = eager.params = model.init(SEED + s, dev)
        ps = prompts_for(cfg, LONG_LENS, SEED + s)
        with ops.kernel_mode("kernels"):
            km = prefill_and_step_logits(eng, ps, LONG_LENS)
        ea = prefill_and_step_logits(eager, ps, LONG_LENS)
        for what, a, b in zip(("prefill", "decode"), km, ea):
            readings[what].append(rel_diff(a, b))
            agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
            print(f"{tag} {what} logits vs ref-mode eager (bf16, "
                  f"{cfg.n_layers}L, seed {SEED + s}): "
                  f"rel={readings[what][-1]:.6g} argmax_agree={agree}")
    print(f"{tag} logits bf16: tol={MOE_LOGIT_TOL} sound max prefill="
          f"{max(readings['prefill']):.6g} decode={max(readings['decode']):.6g}")
    if not all(np.isfinite(r) and r <= MOE_LOGIT_TOL[what]
               for what, rs in readings.items() for r in rs):
        fail(f"{tag} logits disagree with the ref-mode eager engine")
    return kernels, summary


def moe_f32(dev):
    """granite-moe-1b-a400m at full width, cut to 4 layers, in float32: the
    kernel-mode prefill at the 256 bucket (flash and the router in every
    layer) and its first decode step against the eager ref-mode engine over
    several weight seeds; then the same with a fault planted in the router
    kernel."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.core import StitchCompiler
    from repro_torch.kernels import ops, router
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig
    cfg = replace(get_config(MOE_ARCH), n_layers=4, dtype="float32")
    model = build_model(cfg)
    params = model.init(SEED, dev)
    long = dict(batch=4, max_len=LONG_MAX_LEN, max_new_tokens=2)
    km = Engine(model, params, ServeConfig(**long, stitch_execute=True),
                device=dev, compiler=StitchCompiler(plan_budget=10.0))
    eager = Engine(model, params, ServeConfig(**long), device=dev)
    readings, ref0 = [], None
    ops.reset_launch_counts()
    for s in range(F32_SEEDS):
        if s:
            km.params = eager.params = model.init(SEED + s, dev)
        ps = prompts_for(cfg, LONG_LENS, SEED + 1 + s)
        ea = prefill_and_step_logits(eager, ps, LONG_LENS)
        with ops.kernel_mode("kernels"):
            kl = prefill_and_step_logits(km, ps, LONG_LENS)
        readings.append([rel_diff(a, b) for a, b in zip(kl, ea)])
        print(f"moe 4-layer f32 kernel-mode bucket 256 vs eager (seed "
              f"{SEED + s}): prefill rel={readings[-1][0]:.6g} decode "
              f"rel={readings[-1][1]:.6g}")
        if s == 0:
            ref0 = (ps, ea)
    # per seed two prefills and one decode step (prefill_and_step_logits)
    n = ops.launch_counts()["router"]
    if n != 3 * F32_SEEDS * cfg.n_layers:
        fail(f"moe 4-layer f32 kernel mode launched the router {n} times, "
             f"expected {3 * F32_SEEDS * cfg.n_layers}")
    km.params = eager.params = params
    router._lib()
    sound_lib, router._LIB = router._LIB, faulted_library(router, "router")
    try:
        with ops.kernel_mode("kernels"):
            planted = [rel_diff(a, b) for a, b in zip(
                prefill_and_step_logits(km, ref0[0], LONG_LENS), ref0[1])]
    finally:
        router._LIB = sound_lib
    print(f"moe 4-layer f32 kernel-mode logits: tol={F32_LOGIT_TOL} sound max "
          f"prefill={max(r[0] for r in readings):.6g} "
          f"decode={max(r[1] for r in readings):.6g}; planted router fault "
          f"(chosen column not masked) prefill={planted[0]:.6g} "
          f"decode={planted[1]:.6g}")
    if not all(r <= F32_LOGIT_TOL for rs in readings for r in rs):
        fail("moe 4-layer f32 kernel-mode logits disagree with eager")
    if not min(planted) > F32_LOGIT_TOL:
        fail("the f32 logit check missed the planted router fault")


def prompts_for(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    prompts = np.zeros((len(lens), int(lens.max())), np.int64)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(0, cfg.vocab, n)
    return prompts


def first_step_logits(e, prompts, lens):
    """Prefill, insert every row, one decode step: its logits (f32)."""
    p = e.prefill(prompts, prompt_lens=lens)
    for row in range(len(lens)):
        e.insert(p, slot=row, row=row)
    _, lg = e.generate_step(steps=1, return_logits=True)
    for row in range(len(lens)):
        e.release(row)
    return lg[0].float()


def prefill_and_step_logits(e, prompts, lens):
    """The prefill's logits at each row's last true position, from one call
    of the engine's bucketed prefill, and the first decode step's after a
    fresh prefill (both f32)."""
    from repro_torch.serve.engine import ADMISSION_BUCKET
    pb = min(ADMISSION_BUCKET.bucket_dim(prompts.shape[1]), e.cfg.max_len)
    padded = np.zeros((len(prompts), pb), np.int64)
    padded[:, :prompts.shape[1]] = prompts
    logits, _ = e._prefill_exec(e.params, torch.as_tensor(padded, device=e.device),
                                torch.as_tensor(lens, device=e.device))
    return logits.float(), first_step_logits(e, prompts, lens)


def rel_diff(a, b) -> float:
    """max |a - b| over max |b|: the logit checks' measure."""
    return float((a - b).abs().max()) / float(b.abs().max())


# planted faults: every stitched RMSNorm kernel of the decode plan swapped
# for the same function with one thing wrong
BF16_FAULTS = {"eps_x10": dict(eps_scale=10.0),
               "norm_out_x(1+2^-7)": dict(out_scale=1 + 2 ** -7),
               "norm_out_x(1+2^-4)": dict(out_scale=1 + 2 ** -4)}
F32_FAULTS = {"eps_x10": dict(eps_scale=10.0),
              "norm_in_bf16": dict(dtype=torch.bfloat16),
              "norm_out_x(1+2^-7)": dict(out_scale=1 + 2 ** -7)}


def fault_readings(eng, ref, lens, faults) -> dict:
    """rel_diff of the stitched first decode step against ``ref`` (prompts,
    eager logits) with each fault planted in the decode plan's RMSNorm
    kernels; the plan is restored after each."""
    prompts, eager_logits = ref
    groups = [grp for grp in eng._exec.compiled.groups
              if grp.kind == "triton"
              and rms_chain(grp.tuned.callable.pattern) is not None]
    if not groups:
        fail("no stitched RMSNorm kernel in the decode plan to plant a fault in")
    out = {}
    for name, kw in faults.items():
        saved = [(grp, grp.tuned.callable) for grp in groups]
        for grp, k in saved:
            grp.tuned.callable = (lambda *a, k=k, kw=kw:
                                  rms_library(k, a, **kw)())
        try:
            out[name] = rel_diff(first_step_logits(eng, prompts, lens),
                                 eager_logits)
        finally:
            for grp, k in saved:
                grp.tuned.callable = k
    out["kernels"] = len(groups)
    return out


def faulted_library(mod, stem):
    """``mod``'s CUDA library with its fault planted (``FAULTS``), built by
    the build phase into ``fault_dir()``."""
    import ctypes
    from repro_torch.kernels import build
    return mod.bind(ctypes.CDLL(str(build.library(stem, src_dir=fault_dir(),
                                                  out_dir=fault_dir()))))


def full_width_f32(dev):
    """qwen3-1.7b at full width, cut to 4 layers, in float32: the stitched
    first decode step, ref mode and kernel mode, against the eager ref-mode
    one over several weight seeds; then faults planted in the stitched
    RMSNorm kernels (ref mode) and in the decode-attention kernel (kernel
    mode).  Then the kernel-mode prefill at the 256 bucket (the flash
    kernel in every layer) and its first decode step against the eager
    ones, and a fault planted in the flash kernel."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.core import StitchCompiler
    from repro_torch.kernels import decode_attention, flash_attention, ops
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig
    cfg = replace(get_config("qwen3-1.7b"), n_layers=4, dtype="float32")
    model = build_model(cfg)
    params = model.init(SEED, dev)
    lens = np.array([30, 25, 20, 32], np.int32)

    def engine(stitch_execute):
        return Engine(model, params, ServeConfig(
            batch=4, max_len=64, max_new_tokens=2,
            stitch_execute=stitch_execute), device=dev,
            compiler=StitchCompiler(plan_budget=10.0))

    stitched, eager, km = engine(True), engine(False), engine(True)
    readings, km_readings, ref0 = [], [], None
    for s in range(F32_SEEDS):
        if s:
            seeded = model.init(SEED + s, dev)
            for e in (stitched, eager, km):
                e.params = seeded
        ps = prompts_for(cfg, lens, SEED + 1 + s)
        ea = first_step_logits(eager, ps, lens)
        readings.append(rel_diff(first_step_logits(stitched, ps, lens), ea))
        with ops.kernel_mode("kernels"):
            km_readings.append(rel_diff(first_step_logits(km, ps, lens), ea))
        print(f"full-width 4-layer f32 decode logits vs eager (seed {SEED + s}): "
              f"stitched rel={readings[-1]:.6g} kernel-mode rel="
              f"{km_readings[-1]:.6g}")
        if s == 0:
            ref0 = (ps, ea)
    for e, tag in ((stitched, "stitched"), (km, "kernel-mode")):
        if e.report()["decode"]["calls"]["stitched"] != F32_SEEDS:
            fail(f"4-layer f32 {tag} decode did not run stitched")
    for e in (stitched, eager, km):
        e.params = params
    faults = fault_readings(stitched, ref0, lens, F32_FAULTS)
    print(f"full-width 4-layer f32 logits: tol={F32_LOGIT_TOL} sound "
          f"max={max(readings):.6g} planted faults {faults}")
    if not all(r <= F32_LOGIT_TOL for r in readings):
        fail("full-width f32 stitched logits disagree with eager")
    decode_attention._lib()
    sound_lib, decode_attention._LIB = (
        decode_attention._LIB,
        faulted_library(decode_attention, "decode_attention"))
    try:
        with ops.kernel_mode("kernels"):
            planted = rel_diff(first_step_logits(km, ref0[0], lens), ref0[1])
    finally:
        decode_attention._LIB = sound_lib
    print(f"full-width 4-layer f32 kernel-mode logits: tol={F32_LOGIT_TOL} "
          f"sound max={max(km_readings):.6g} planted decode-attention fault "
          f"(kpos < pos) {planted:.6g}")
    if not all(r <= F32_LOGIT_TOL for r in km_readings):
        fail("full-width f32 kernel-mode logits disagree with eager")
    if not planted > F32_LOGIT_TOL:
        fail("the f32 logit check missed the planted decode-attention fault")

    long = dict(batch=4, max_len=LONG_MAX_LEN, max_new_tokens=2)
    km_long = Engine(model, params, ServeConfig(**long, stitch_execute=True),
                     device=dev, compiler=StitchCompiler(plan_budget=10.0))
    eager_long = Engine(model, params, ServeConfig(**long), device=dev)
    flash_readings, ref_long = [], None
    ops.reset_launch_counts()
    for s in range(F32_SEEDS):
        if s:
            km_long.params = eager_long.params = model.init(SEED + s, dev)
        ps = prompts_for(cfg, LONG_LENS, SEED + 1 + s)
        ea = prefill_and_step_logits(eager_long, ps, LONG_LENS)
        with ops.kernel_mode("kernels"):
            km_logits = prefill_and_step_logits(km_long, ps, LONG_LENS)
        flash_readings.append([rel_diff(a, b) for a, b in zip(km_logits, ea)])
        print(f"full-width 4-layer f32 kernel-mode bucket 256 vs eager (seed "
              f"{SEED + s}): prefill rel={flash_readings[-1][0]:.6g} decode "
              f"rel={flash_readings[-1][1]:.6g}")
        if s == 0:
            ref_long = (ps, ea)
    # two prefills a seed (prefill_and_step_logits), one flash launch a layer
    flash_n = ops.launch_counts()["flash_attention"]
    if flash_n != 2 * F32_SEEDS * cfg.n_layers:
        fail(f"4-layer f32 kernel-mode prefills launched flash attention "
             f"{flash_n} times, expected {2 * F32_SEEDS * cfg.n_layers}")
    km_long.params = eager_long.params = params
    flash_attention._lib()
    sound_lib, flash_attention._LIB = (
        flash_attention._LIB, faulted_library(flash_attention, "flash_attention"))
    try:
        with ops.kernel_mode("kernels"):
            planted_flash = [rel_diff(a, b) for a, b in zip(
                prefill_and_step_logits(km_long, ref_long[0], LONG_LENS),
                ref_long[1])]
    finally:
        flash_attention._LIB = sound_lib
    print(f"full-width 4-layer f32 kernel-mode bucket 256 logits: "
          f"tol={F32_LOGIT_TOL} sound max prefill="
          f"{max(r[0] for r in flash_readings):.6g} decode="
          f"{max(r[1] for r in flash_readings):.6g}; planted flash fault (acc "
          f"not rescaled) prefill={planted_flash[0]:.6g} "
          f"decode={planted_flash[1]:.6g}")
    if not all(r <= F32_LOGIT_TOL for rs in flash_readings for r in rs):
        fail("full-width f32 kernel-mode bucket-256 logits disagree with eager")
    if not max(planted_flash) > F32_LOGIT_TOL:
        fail("the f32 logit check missed the planted flash-attention fault")


def reduced_reference(dev):
    """Reduced qwen3 in float32: stitched serving, in ref mode and in kernel
    mode (head_dim 16: the decode kernel's narrowest lane layout), equals
    eager ref-mode serving."""
    from dataclasses import replace
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.engine import ADMISSION_BUCKET
    cfg = replace(get_reduced("qwen3-1.7b"), dtype="float32")
    model = build_model(cfg)
    params = model.init(SEED, dev)
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab, (3, 7))
    lens = np.array([7, 5, 6])
    outs = {}
    for mode, stitch_execute in (("ref", True), ("kernels", True),
                                 ("ref", False)):
        ops.reset_launch_counts()
        with ops.kernel_mode(mode):
            eng = Engine(model, params, ServeConfig(
                batch=3, max_len=32, max_new_tokens=6,
                stitch_execute=stitch_execute), device=dev)
            outs[mode, stitch_execute] = eng.generate(prompts, prompt_lens=lens)
        if not stitch_execute:
            continue
        rep = eng.report()["decode"]
        if rep["calls"]["fallback"] or rep["calls"]["stitched"] != 5:
            fail(f"reduced stitched {mode}-mode decode did not run stitched")
        # ref mode runs generated kernels; the reduced kernel-mode plan has
        # none (its kernels' groups run as torch groups), so it must have
        # run every hand-written kernel of its path instead (no flash
        # attention: the prompts' bucket is below 128)
        if mode == "ref" and not rep["plan"]["triton_groups"]:
            fail("reduced stitched decode did not run its Triton groups")
        launched = ops.launch_counts()
        step, prefill = expected_launches(
            cfg, ADMISSION_BUCKET.bucket_dim(prompts.shape[1]))
        path = {k for k in step if step[k] or prefill[k]}
        if mode == "kernels" and not all(launched[k] for k in path):
            fail(f"reduced kernel-mode decode did not run every hand-written "
                 f"kernel: {launched}")
    eager = outs["ref", False]
    same = {f"{m} mode stitched": bool(np.array_equal(o, eager))
            for (m, st), o in outs.items() if st}
    print(f"reduced f32 tokens == eager ref-mode tokens: {same}")
    if not all(same.values()):
        fail("reduced stitched tokens differ from eager tokens")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip())
    import triton
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"triton {triton.__version__} device {torch.cuda.get_device_name(0)}")
    # one rounding per GEMM: f32 accumulation, no TF32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    build_phase()
    samples = sample_kernels(dev)
    print(json.dumps({"sample_kernels": samples}))
    hand_samples(dev)

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("qwen3-1.7b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, dev)
    torch.cuda.synchronize()
    print(f"init {cfg.name}: {cfg.n_layers}L d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab} in {time.perf_counter() - t0:.1f}s")
    lens = np.array([50, 45, 40, 60], np.int32)      # one pow2 bucket: 64
    prompts = prompts_for(cfg, lens, SEED)
    checked: dict = {}
    kernels, summaries = [], {}
    for tag, phase in (("ref-mode", serve_phase),
                       ("kernel-mode", kernel_mode_phase)):
        t0 = time.perf_counter()
        rows, summaries[tag] = phase(dev, model, params, lens, prompts, checked)
        kernels += rows
        print(f"{tag} phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    rows, summaries["kernel-mode long"] = long_prompt_phase(dev, model, params,
                                                            checked)
    kernels += rows
    print(f"kernel-mode long phase: {time.perf_counter() - t0:.1f}s")
    del params
    t0 = time.perf_counter()
    rows, summaries["moe kernel-mode long"] = moe_phase(dev, checked)
    kernels += rows
    print(f"moe phase: {time.perf_counter() - t0:.1f}s")
    for tag, summary in summaries.items():
        print(f"decode plan {tag}: {json.dumps(summary)}")
    t0 = time.perf_counter()
    full_width_f32(dev)
    moe_f32(dev)
    reduced_reference(dev)
    print(f"f32 and reduced checks: {time.perf_counter() - t0:.1f}s")
    print(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
