"""Chip smoke test of the PyTorch port (``repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no
result line):

0. Build: the CUDA C++ libraries (``src/repro_torch/csrc``) and their
   planted-fault copies from an empty ``build/kernels``, one nvcc each, all
   started together, with each one's build seconds and ptxas report; the
   Triton kernels' planted-fault sources.  Then the floor of a launch: an
   empty kernel's device us a launch, back to back and in a CUDA-graph
   replay.
1. Sample kernels: generated Triton stitched kernels for a softmax, an
   RMSNorm chain, a SwiGLU chain and a scaled softmax whose row statistics
   and column scale broadcast implicitly (size-1 dims), and the fourteen
   hand-written kernels
   (RMSNorm, the residual RMSNorm, LayerNorm, SwiGLU/GeGLU, squared ReLU,
   RoPE, the plain and masked softmax, the cross-entropy, decode
   attention, flash attention, the MoE router, the selective scan, the
   RG-LRU) at sample shapes, each held against its plain PyTorch version
   on the card (the router's ids exactly on rows without a near tie, ties
   to the lowest index; NaN rows of the softmax at the same places).
   Flash attention runs its bf16 samples through both kernels (the Hopper
   one, wgmma fed by TMA, and the CUDA-core one it replaced for bf16) and
   its f32 samples through the CUDA-core one; decode attention runs the
   split kernel with positions on its chunk edges; the launches by variant
   are counted exactly.  Three
   bf16 faults are planted (the Hopper flash kernel's acc not rescaled and
   its window ignored, the split decode's combine adding a partial without
   its rescale), and the bf16 sample gate must catch each.  RoPE runs at
   every path's q and k shapes and on the scalar path, at positions up to
   4096, timed; its angle tables equal the spec computed in numpy at
   positions up to 2^17 (one ulp at most); a fault planted in it (each row
   of a block reading its first row's angles) must fail the sample gate.
2. Ref-mode path: full-width qwen3-1.7b cut to 8 of its 28 layers
   (``REF_LAYERS``: the time limit; random weights from a seed) answers 4
   requests through ``Engine(stitch_execute=True)``: the stitched
   prefill and the stitched decode on every step.  Launch counts are zeroed
   just before this run and read just after.  Every generated kernel of the
   decode and prefill plans is then called on the inputs the main path gives
   it and held against its plain version; its time, its bound and its
   launches go into the ``kernels`` line.  A generated kernel that computes
   an RMSNorm chain is also timed against ``F.rms_norm``, one of a single
   elementwise op and views against that op's PyTorch call.  A kernel
   whose members only move data (slices, transposes, reshapes, broadcasts,
   gathers) is held bit for bit against its plain version; a kernel of a
   member class the emitter renders since data movement was ported is also
   timed against its plain version replayed on the card (the fused-torch
   group it replaces).  A layout-only pattern launches nothing: its calls
   are counted apart from the launches (a pattern of the path never called
   fails as a kernel never launched does), its outputs held bit for bit
   against its plain version.  Every path prints a line per generated
   kernel or view pattern (members and shapes, layout, launches or views a
   call, device us beside the bound, layout-only or not), a tally a call
   (launched, views, view copies) and the data-movement kernels' device
   time against their plain versions'.  Per plan, the bytes moved by
   generated kernels, fused-torch groups and single ops, the torch groups
   by the first cause and by every cause of their refusal, and a digest of
   the plan's member sets.
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
   (``F.rms_norm``, ``F.scaled_dot_product_attention``), the GLU beside
   the ``F.silu(g) * u`` chain; the Hopper flash kernel also beside the
   kernel it replaced, on the same operands.  On
   every path the launches by variant are gated: every bf16 flash launch
   the Hopper kernel's, every f32 one the CUDA-core kernel's, every decode
   launch the split kernel's.  Both decode plans
   are printed side by side; the kernel-mode bf16 logits are held against
   the eager ref-mode decode over several weight seeds.
   Plan cache (after the kernel-mode path, the same model and requests in
   kernel mode): an engine over a ``CompilationService`` whose
   ``StitchCache`` writes to an empty directory serves the prompts while
   both stitched plans compile in the background (the fallback plans
   answer; calls by plan, tokens and decode ms during and after the
   compile printed), then ``svc.wait()`` and a second serve: stitched
   plans only, status hit, no service error; both serves' first-step
   logits within ``KM_LOGIT_TOL`` of the offline kernel-mode engine's, and
   bit for bit where the landed plans equal the offline ones (printed with
   both plans' ILP method).  Then a fresh cache over the same directory
   replays both plans: two disk hits, no planner stage or tuner call
   (counted), the landed plans' groups and kinds, an engine over it with
   no fallback call whose prefill and first-step logits are the landed
   plans' bit for bit and whose decode step launches the landed plan's
   kernels by signature (and the offline plan's where the plans are
   equal); warm against cold compile seconds printed.
4. Float32 checks: full width cut to 4 layers, the first decode step of the
   stitched ref-mode and kernel-mode engines against the eager one over
   several weight seeds, with faults planted in the stitched RMSNorm
   kernels, in the decode-attention kernel (``kpos < pos``), in RoPE
   (rows reading their block's first row's angles), in RMSNorm (a
   lane's second repetition of columns written through unnormalised) and
   in SwiGLU (the sigmoid dropped); and
   a reduced model
   served stitched (both modes) vs eager.
5. MoE phase (after the long-prompt phase): full-width granite-moe-1b-a400m
   (24 layers, 32 experts top-8, random weights from a seed) served in
   kernel mode at the long prompts (bucket 256): exact launches per prefill
   call and decode step from the config, every kernel of the path held
   against its plain version, the router beside the ``softmax -> topk ->
   div`` chain; bf16 prefill and first-step logits against the eager
   ref-mode engine over several weight seeds; then (with the float32
   checks) the model cut to 4 layers in float32, with a fault planted in
   the router kernel.
6. ssm phase (after the MoE phase): the scan kernel at sample shapes (with
   phase 1's samples: f32, bf16, and f32 with B and C as strided views);
   full-width falcon-mamba-7b cut from 64 to 32 layers (``SSM_LAYERS``:
   the script's time limit; random weights from a seed) scored in kernel
   mode through ``stitch(train_forward)`` at 4 x 256 tokens: exactly 32
   scan and 33 RMSNorm launches a call and no other
   hand-written kernel, the call's ms, tokens/s, device busy and peak
   memory, every kernel of the path against its plain version (the scan
   beside its bound, whose term is the SFU's exponentials); then
   ``stitch(block_fn)`` on layer 0 (one scan launch a call); bf16 loss and
   block output against the eager ref-mode model over several weight
   seeds; then (with the float32 checks) the model cut to 4 layers in
   float32, with a fault planted in the scan kernel (its lane states
   restart at every chunk of 16 steps).
7. Hybrid phase (after the ssm phase): the RG-LRU kernel, flash attention
   at head width 256 on one kv head and RoPE on that head at sample shapes
   (with phase 1's samples; the RG-LRU's branch-free reciprocal and square
   root at every float of their domains); full-width
   recurrentgemma-9b (38 layers: 26 RG-LRU and 12 local-attention layers,
   random weights from a seed) scored
   in kernel mode through ``stitch(train_forward)`` at 4 x 256 tokens:
   exactly 26 RG-LRU, 12 flash, 24 RoPE, 77 RMSNorm and 38 GLU launches a
   call and no other hand-written kernel, the call's ms, tokens/s, device
   busy and peak memory, every kernel of the path against its plain version
   (flash beside ``F.scaled_dot_product_attention``); then
   ``stitch(block_fn)`` on the first recurrent layer (1 RG-LRU, 2 RMSNorm
   and 1 GLU launch a call); bf16 loss and block output against the eager
   ref-mode model over several weight seeds, and on the same scoring calls
   every hand-written launch against its plain version on its own operands
   (``KernelsVsPlain``: the largest share of outputs off, under
   ``HYBRID_PLAIN_TOL``); then (with the float32 checks)
   the model cut to 4 layers in float32 on one sequence of 2560 tokens, so
   that the 2048-token window masks keys: the loss, the recurrent block's
   and the first attention block's output against eager ref mode, with
   faults planted in the RG-LRU kernel (its chain restarts h at every
   chunk of 32 steps) and in flash attention's window.

8. Dense LayerNorm phase (after the hybrid phase): LayerNorm and squared
   ReLU at nemotron-4-15b's shapes, decode attention and flash at its GQA
   group of 6 (48 / 8 heads), with phase 1's samples; full-width
   nemotron-4-15b (32 layers, d_model 6144, d_ff 24576, vocab 256000, bf16
   parameters: 62.5 GB in f32 would leave the plans no room on one card;
   random weights, every norm's gamma and beta seeded away from 1 and 0)
   served in kernel mode at the long prompts (bucket 256): exactly 65
   LayerNorm, 64 RoPE and 32 squared-ReLU launches a prefill call and a
   decode step, with 32 flash launches a prefill and 32 decode-attention
   launches a step; every kernel of the path against its plain version,
   LayerNorm beside ``F.layer_norm``, squared ReLU beside the ``relu ->
   square`` chain; bf16 prefill and first-step logits against the eager
   ref-mode engine over several weight seeds; then (with the float32
   checks) the model cut to 4 layers in float32, with faults planted in
   LayerNorm (CUDA: beta dropped) and squared ReLU (Triton: squaring
   before the max).
9. Kernel-API phase (after the dense LayerNorm phase): three user
   functions of the kernel API through ``stitch()`` in kernel mode at
   qwen3-1.7b's widths, bf16: the residual seam with the LM-head loss
   (``rmsnorm_residual`` on (4, 256, 2048), the (2048, 151936) LM-head
   GEMM, ``cross_entropy`` over 1024 rows), masked GQA attention over the
   long prompts (``softmax`` with a (4, 1, 256, 256) mask; the query rows
   past a prompt's length are fully masked and must come out 0) and a
   temperature softmax over (4, 151936) vocabulary rows.  Exactly one
   launch of each of the path's kernels a call and no other hand-written
   kernel; every kernel against its plain version on the path's operands,
   timed beside its bound and a PyTorch call (the ``x + res ->
   F.rms_norm`` chain, ``F.cross_entropy``, the ``masked_fill -> softmax``
   and ``mul -> softmax`` chains); the masked softmax's CUDA kernel beside
   both of its bounds (x read whole, and only in the sectors that hold a
   kept lane);
   the outputs against the same functions run eagerly in ref mode over
   several seeds; then in float32 at the same widths, with faults planted
   in three Triton kernels (the residual norm of x alone, the
   cross-entropy's running sum not rescaled, the split softmax's fold
   adding a chunk's sum without its exp(m_c - M) rescale) and in the CUDA
   masked softmax (the mask ignored).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
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
# fault (each row's top expert k times) reads 0.93 and 1.10.  falcon-mamba-7b
# (4 layers, kernel mode, the scan kernel in every layer): loss 0 to 1.7e-7,
# block_fn output 2.8e-7 to 4.5e-7 over 5 seeds; the scan fault (the state
# restarts at every chunk of 16 steps) reads 0.105 in the block check.
# recurrentgemma-9b (4 layers, kernel mode, 2560 tokens: flash masks keys
# outside the 2048 window): loss 0 to 7.4e-8, block_fn output 5.6e-7 to
# 6.6e-7, first attention block 4.8e-7 to 5.6e-7 over 5 seeds; the RG-LRU
# fault (the state restarts at every chunk) reads 0.055 in the block check,
# the flash fault (the window ignored) 0.0150 in the attention block and
# only 5.1e-6 in the loss.
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
# the ILP's wall-clock budget for the full-width plans: each of them took
# the greedy plan when a 20 s budget expired (the plan lines'
# ``ilp=greedy``), and an expired budget always gives the greedy plan, so
# a 5 s budget gives the same plans and saves 15 s on each of 13 plans
PLAN_BUDGET = 5.0
LOGIT_SEEDS = 3           # weight seeds of the full-width bf16 logit check
# the ref-mode qwen3 phase's depth, cut from 28 layers for the time limit:
# its plans took 90 of the phase's 250 s at full depth (a 994 s run)
REF_LAYERS = 8
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


# An f32 value within this many of its ulps of the midpoint between its two
# 16-bit neighbours is a rounding tie for a kernel that computes it in
# another order: Triton's reduction tree against PyTorch's moves a sum by
# an ulp or two, which can carry the value across the midpoint.
TIE_ULPS = 16
LOW = (torch.bfloat16, torch.float16)


def round_other_way(x, r):
    """``r`` (``x`` rounded to 16 bits) with each element whose ``x`` lies
    within ``TIE_ULPS`` f32 ulps of the midpoint to the next 16-bit value
    on ``x``'s side rounded to that value instead; and how many."""
    xd, rd = x.double(), r.double()
    bits = r.view(torch.int16)
    # the neighbour on x's side: one step up in magnitude for a positive
    # r that x exceeds (or a negative r that x undercuts), else down
    up = (xd > rd) == (bits >= 0)
    other = (bits + torch.where(up, 1, -1).to(torch.int16)).view(r.dtype)
    x32 = x.float()
    ulp = (torch.nextafter(x32, torch.full_like(x32, float("inf"))) - x32).double()
    mid = (rd + other.double()) / 2
    near = ((xd - mid).abs() <= TIE_ULPS * ulp) & torch.isfinite(other) \
        & torch.isfinite(xd) & (xd != rd)
    return torch.where(near, other, r), int(near.sum())


def tie_alternative(k, args):
    """The plain version of generated kernel ``k`` with every element of a
    ``convert`` to 16 bits that lies at a rounding tie (``round_other_way``)
    rounded the other way, all at once, and the count of such elements:
    (outputs, ties), or (None, 0) when no such convert has a tie."""
    from repro_torch.core.codegen import eval_node
    p, g = k.pattern, k.pattern.graph
    env = dict(zip(p.external_inputs, args))
    ties = 0
    for node in p.nodes:
        if node.is_source() and node.name in env:
            continue
        ops = [env[o] for o in node.operands]
        val = eval_node(node, ops, g)
        if node.attrs.get("op") == "convert" and val.dtype in LOW \
                and ops[0].dtype.is_floating_point and ops[0].dtype not in LOW:
            val, n = round_other_way(ops[0], val)
            ties += n
        env[node.name] = val
    if not ties:
        return None, 0
    return tuple(env[n] for n in p.external_outputs), ties


def tie_flips(outs, refs, alts):
    """Output elements of a kernel that miss the plain version's gate and
    meet, at the same gate, the plain version with its rounding ties
    rounded the other way (``tie_alternative``): (elements, their max abs
    error against the plain version, the max abs error of every other
    element); None when an element meets neither."""
    flips, err_flip, err_rest = 0, 0.0, 0.0
    for o, r, a in zip(outs, refs, alts):
        if o.dtype == torch.bool or not o.dtype.is_floating_point:
            ok_r, ok_a = o == r, o == a
        else:
            rtol, atol = TOL.get(str(o.dtype).replace("torch.", ""),
                                 TOL["bfloat16"])
            ok_r = torch.isclose(o.float(), r.float(), rtol=rtol, atol=atol)
            ok_a = torch.isclose(o.float(), a.float(), rtol=rtol, atol=atol)
        if not bool((ok_r | ok_a).all()):
            return None
        diff = (o.float() - r.float()).abs()
        flips += int((~ok_r).sum())
        if bool((~ok_r).any()):
            err_flip = max(err_flip, float(diff[~ok_r].max()))
        if bool(ok_r.any()):
            err_rest = max(err_rest, float(diff[ok_r].max()))
    return flips, err_flip, err_rest


def kernel_bound(k) -> tuple[float, str]:
    """Least time for the kernel's work: its inputs read once and outputs
    written once over the memory rate, or its elementwise operations over
    the f32 rate, whichever is larger.  A scratch workspace (a value stored
    and loaded again at other offsets, a few KB a program) is L2 traffic,
    not device-memory traffic, and is not counted."""
    g = k.pattern.graph
    ins, outs = moved(k)
    nbytes = sum(g[n].bytes for n in ins) + sum(g[n].bytes for n in outs)
    ops = sum(n.size for n in k.pattern.compute_members)
    tb, to = nbytes / HBM_BW, ops / F32_PEAK
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def moved(k) -> tuple[list, list]:
    """The external inputs and outputs whose bytes the kernel moves: an
    output returned as a view of an input (``emitted.view_outs``) moves
    nothing, nor does an input only such outputs read."""
    p, g = k.pattern, k.pattern.graph
    views = {o for o, _, _ in getattr(k, "emitted", None).view_outs} \
        if hasattr(k, "emitted") else set()
    outs = [n for n in p.external_outputs if n not in views]
    read, stack = set(), list(outs)
    while stack:
        n = stack.pop()
        if n in read:
            continue
        read.add(n)
        if n in p.members:
            stack.extend(g[n].operands)
    return [n for n in p.external_inputs if n in read], outs


def sweep_bound_ms(k) -> float:
    """The bytes bound of the kernel's design: a wide row's later sweeps
    read their inputs again (``emitted.rereads``), counted once each."""
    g = k.pattern.graph
    extra = sum(g[n].bytes for n in k.emitted.rereads)
    return kernel_bound(k)[0] + extra / HBM_BW * 1e3


MOVE_KINDS = ("reshape", "transpose", "slice", "gather", "broadcast")


def data_movement_only(k) -> bool:
    """Whether every member of the kernel's pattern only moves elements
    (a slice, transpose, reshape, broadcast or gather, or a convert to the
    same dtype): such a kernel rounds nothing, and must give its plain
    version's bits."""
    from repro_torch.kernels.stitched import layout_member
    g = k.pattern.graph
    return all(m.kind.value in MOVE_KINDS or layout_member(m, g)
               for m in k.pattern.compute_members)


def stage1_classes(k) -> list:
    """The member classes of a generated kernel that the emitter renders
    since data movement was ported (each was a ``torch`` group's refusal
    before): slices, gathers, transposes that move an axis, reshapes of
    non-power-of-two dims, wide rows (sweeps), values through scratch."""
    from repro_torch.kernels.stitched import layout_member
    g = k.pattern.graph
    out = set()
    for m in k.pattern.compute_members:
        kind = m.kind.value
        if kind in ("slice", "gather"):
            out.add(kind)
        elif kind == "transpose" and not layout_member(m, g):
            out.add("transpose")
        elif kind == "reshape":
            a = [d for d in g[m.operands[0]].shape if d != 1]
            b = [d for d in m.shape if d != 1]
            if a != b and any(d & (d - 1) for d in a + b):
                out.add("reshape")
    em = getattr(k, "emitted", None)
    if em is not None and em.sweeps:
        out.add("wide")
    if em is not None and em.scratch:
        out.add("scratch")
    return sorted(out)


def rms_chain(p):
    """The RMSNorm chain of a pattern, or None: ``xf = convert(x)`` (or x
    itself; jnp's spelling converts x twice, once for the square and once
    for the product), ``r = rsqrt(mean(square(xf), last axis) + eps)`` (the
    square as ``xf * xf`` or ``square``), ``y = xf * r * gamma`` (r and
    gamma broadcast explicitly or by their size-1 dims, gamma through its
    casts) and an optional
    convert back; the mean is a REDUCTION ``mean`` (a ``GraphBuilder``
    graph) or, as ``torch.mean`` traces, a ``sum``, its broadcast back to
    the kept rank and a division by the width.  Returns (x, gamma input,
    eps, y, the chain's node names); every chain node but ``y`` must be
    used only inside the chain, so the chain can be swapped for one
    ``F.rms_norm``."""
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

    def source(xf):
        """x behind ``xf``: the operand of a member convert, else xf."""
        if (xf in members and g[xf].kind is EW
                and g[xf].attrs.get("op") == "convert"):
            return g[xf].operands[0]
        return xf

    EW = OpKind.ELEMENTWISE
    for red in p.compute_members:
        if red.kind is not OpKind.REDUCTION or \
                red.attrs.get("op") not in ("mean", "sum"):
            continue
        sq = g[red.operands[0]]
        if not (sq.name in members and sq.kind is EW and (
                sq.attrs.get("op") == "square" or (
                    sq.attrs.get("op") == "mul"
                    and sq.operands[0] == sq.operands[1]))):
            continue
        if tuple(red.attrs["axes"]) != (len(sq.shape) - 1,):
            continue
        d, xf = sq.shape[-1], sq.operands[0]
        mean, spelled = red, set()
        if red.attrs["op"] == "sum":
            kept = only_user(red.name, OpKind.BROADCAST)
            div = kept and only_user(kept.name, EW, "div")
            if div is None or div.operands[0] != kept.name:
                continue
            count = g[div.operands[1]]
            if count.kind is not OpKind.CONSTANT or count.shape \
                    or float(count.attrs.get("value", 0)) != d:
                continue
            mean, spelled = div, {kept.name, div.name}
        add = only_user(mean.name, EW, "add")
        if add is None:
            continue
        lit = g[[o for o in add.operands if o != mean.name][0]]
        if lit.kind is not OpKind.CONSTANT or lit.shape or "value" not in lit.attrs:
            continue
        rs = only_user(add.name, EW, "rsqrt")
        if rs is None:
            continue
        r = rs.name
        bc = only_user(rs.name, OpKind.BROADCAST)
        if bc is not None:
            r = bc.name
        m1 = only_user(r, EW, "mul")
        if m1 is None or r not in m1.operands or len(m1.operands) != 2:
            continue
        xf2 = [o for o in m1.operands if o != r]
        xf2 = xf2[0] if xf2 else r
        x = source(xf)
        if source(xf2) != x:
            continue
        m2 = only_user(m1.name, EW, "mul")
        if m2 is None:
            continue
        gam = [o for o in m2.operands if o != m1.name][0]
        chain = {sq.name, red.name, add.name, rs.name, m1.name, *spelled}
        if bc is not None:
            chain.add(bc.name)
        # gamma through its broadcasts and casts (the model casts its f32
        # gamma to the activation dtype and the norm back to f32)
        while gam in members and (g[gam].kind is OpKind.BROADCAST or (
                g[gam].kind is EW and g[gam].attrs.get("op") == "convert")):
            if set(users(gam)) - chain - {m2.name}:
                break
            chain.add(gam)
            gam = g[gam].operands[0]
        if gam not in p.external_inputs or g[gam].shape[-1] != d:
            continue
        if x != xf:
            for c in {xf, xf2}:
                if set(users(c)) <= chain | {m1.name}:
                    chain.add(c)
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
    # an element may miss the gate only where a convert to 16 bits met a
    # rounding tie, and must then meet the plain version rounded the
    # other way there
    alt, ties = tie_alternative(k, args)
    flips = (0, 0.0, err)
    if not within(out, ref):
        flips = tie_flips(out, ref, alt) if alt is not None else None
        if flips is None:
            fail(f"kernel {name} disagrees with its plain version (max err "
                 f"{err}; {ties} rounding ties)")
    moves = data_movement_only(k)
    if moves and not all(bits_equal(o, r) for o, r in zip(out, ref)):
        fail(f"kernel {name} moves data only, yet differs from its plain "
             f"version in some bits")
    ms = timed(lambda: k.launch(*args), 50)
    dev_ms = device_ms(lambda: k.launch(*args))
    plain_ms = timed(lambda: k.plain(*args), 20)
    lib = library if library is not None else (
        rms_library(k, args) or single_op_library(k, args))
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
                "layout": k.emitted.layout, "grid": k.emitted.grid,
                "block_r": k.emitted.block_r, "block": k.emitted.block,
                "num_warps": k.emitted.num_warps,
                "data_movement_only": moves, "bits_equal_plain": moves,
                "rounding_ties": ties, "tie_flips": flips[0],
                "max_abs_err_at_flips": flips[1],
                "max_abs_err_off_flips": flips[2],
                "stage1": stage1_classes(k),
                "scratch_bytes": sum(
                    n * (1 if dt == "bool" else
                         torch.empty(0, dtype=getattr(torch, dt)).element_size())
                    for n, dt in k.emitted.scratch),
                "sweeps": k.emitted.sweeps,
                "sweep_bound_ms": sweep_bound_ms(k)})
    if row["stage1"]:
        # the fused-torch group the kernel replaces runs the plain version
        # member by member: its device time, replayed from a CUDA graph
        row["plain_device_ms"] = device_ms(lambda: k.plain(*args))
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

    def scaled_softmax(x, c):
        # the (rows, 1) max and sum and the (1, cols) scale broadcast
        # implicitly, by their size-1 dims, as jnp traces them
        e = torch.exp(x - x.amax(-1, keepdim=True))
        return e / e.sum(-1, keepdim=True) * c

    x_sm = rnd(64, 256)
    # gamma holds bf16 values in f32, as the model's params do after their
    # cast at use: the library call's bf16 weight is then the same gamma
    x_rms = rnd(4, 1, 2048, dtype=torch.bfloat16)
    g_rms = rnd(2048).to(torch.bfloat16).float()
    a_sw, b_sw = (rnd(4, 1, 6144, dtype=torch.bfloat16),
                  rnd(4, 1, 6144, dtype=torch.bfloat16))
    x_ib, c_ib = rnd(256, 1000), rnd(1, 1000)
    cases = [
        ("softmax_f32_64x256", lambda x: torch.softmax(x, -1), (x_sm,),
         lambda: (torch.softmax(x_sm, -1),)),
        # the library side of the RMSNorm comes from its RMSNorm chain
        ("rmsnorm_bf16_4x1x2048", rms, (x_rms, g_rms), None),
        ("swiglu_bf16_4x1x6144", swiglu, (a_sw, b_sw), None),
        ("implicit_bcast_f32_256x1000", scaled_softmax, (x_ib, c_ib),
         lambda: (torch.softmax(x_ib, -1) * c_ib,)),
    ]
    from repro_torch.kernels.stitched import explicit_broadcasts
    rows = []
    for name, fn, args, lib in cases:
        k, kargs = whole_graph_kernel(fn, args, name)
        if name.startswith("implicit_bcast") and (
                explicit_broadcasts(k.pattern).members == k.pattern.members):
            fail(f"the {name} sample has no implicit broadcast")
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


def every_cause(compiled) -> tuple[list, int, int]:
    """Every cause of every ``torch`` group of a plan (``refusal_causes``,
    node names stripped), counted once a group; and how many torch groups
    there are, and how many of them hold stage-1 causes only."""
    from repro_torch.core.pattern import FusionPattern
    from repro_torch.kernels.stitched import cause_stage, refusal_causes
    g = compiled.graph
    counts, only1, n = Counter(), 0, 0
    for grp in compiled.groups:
        if grp.kind != "torch":
            continue
        n += 1
        causes = refusal_causes(FusionPattern(g, grp.members))
        counts.update({re.sub(r"\b[a-z_]+_\d+(\.bcast\d+)?\b", "*", c)
                       for c in causes})
        only1 += bool(causes) and all(cause_stage(c) == 1 for c in causes)
    return sorted(counts.items(), key=lambda kv: -kv[1]), n, only1


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
    every, n, only1 = every_cause(compiled)
    print(f"plan {tag} torch groups by every cause: {every}")
    print(f"plan {tag} torch groups with stage-1 causes only: {only1} of {n}")
    members = sorted(sorted(grp.members) for grp in compiled.groups)
    print(f"plan {tag} member sets digest: "
          f"{hashlib.sha1(repr(members).encode()).hexdigest()[:16]}")
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
    for grp, members, dead in zip(compiled._order, compiled._members_topo,
                                  compiled._free_after):
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
        # values die after their last use, as in the executor: a 64-layer
        # plan's values would not fit on the card together
        for nm in dead:
            env.pop(nm, None)
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


def variant_gate(tag):
    """The launches by variant since the last reset: every flash launch
    must be the Hopper kernel's (``"sm90"``) in bf16 and the CUDA-core
    kernel's (``"simt"``) in f32, every decode-attention launch the split
    kernel's; counted from the launches' signatures (their dtypes)."""
    from repro_torch.kernels import ops
    sig = ops.launch_counts_by_signature()
    want = {"flash_attention": Counter(), "decode_attention": Counter()}
    for key, n in sig["flash_attention"].items():
        bf16 = key[0][1] == "torch.bfloat16"
        want["flash_attention"]["sm90" if bf16 else "simt"] += n
    for n in sig["decode_attention"].values():
        want["decode_attention"]["split"] += n
    want = {k: dict(c) for k, c in want.items()}
    got = ops.launch_counts_by_variant()
    print(f"{tag} launches by variant: {got}")
    if got != want:
        fail(f"{tag} launched the attention kernels by variant {got}, "
             f"expected {want}")


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
    views, view_copies = stitched.view_counts(), stitched.view_copy_counts()
    hand_total = ops.launch_counts()
    hand_total_sig = ops.launch_counts_by_signature()
    variant_gate(tag)
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
          f"stitched_views={sum(views.values())} "
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
            "counts": counts, "views": views, "view_copies": view_copies,
            "hand_prefill": hand_prefill,
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


def shape_str(node) -> str:
    return "x".join(map(str, node.shape)) + ":" + str(node.dtype)


def layout_line(k, row) -> str:
    """A generated kernel's members and shapes (the first 6 members), its
    layout (``block_r``, ``grid``, ``num_warps``), device us a launch
    beside its bound, and whether every member is layout-only."""
    from repro_torch.kernels.stitched import layout_only
    g = k.pattern.graph
    members = [f"{m.attrs.get('op') or m.kind.value}("
               + ",".join(shape_str(g[o]) for o in m.operands)
               + f")->{shape_str(m)}" for m in k.pattern.compute_members]
    if len(members) > 6:
        members = members[:6] + [f"+{len(members) - 6} more"]
    em = getattr(k, "emitted", None)
    lay = (f"layout={em.layout} block_r={em.block_r} block={em.block} "
           f"grid={em.grid} num_warps={em.num_warps}"
           if em is not None else
           f"layout=view host_us={row['host_us']:.2f} "
           f"outputs_sharing_an_input={row['outputs_sharing_an_input']}")
    plain = row.get("plain_device_ms")
    return (f"members=[{' '.join(members)}] {lay} "
            f"device_us={row['device_ms'] * 1e3:.3f} "
            f"bound_us={row['bound_ms'] * 1e3:.5f} "
            + (f"stage1={','.join(row['stage1'])} sweeps={row['sweeps']} "
               f"scratch_bytes={row['scratch_bytes']} "
               f"plain_device_us={plain * 1e3:.3f} " if plain is not None
               else "")
            + (f"rounding_ties={row['rounding_ties']} "
               f"tie_flips={row['tie_flips']} "
               f"err_off_flips={row['max_abs_err_off_flips']:.3g} "
               if row.get("rounding_ties") else "")
            + f"layout_only={layout_only(k.pattern)}")


# digest -> the (elements, dtype) of each input it was checked at: one
# digest is one kernel over the same bytes (a folded pattern's digest
# carries its folded shapes, so the original shapes may differ)
CHECKED_SIZES: dict[str, list] = {}


def stitched_rows(parts, run, tag, checked):
    """Every generated kernel and view pattern of the path's plans not
    checked yet.  A kernel is held against its plain version and timed
    (``check_kernel``), with its launches in this path's run; a view
    pattern is held against its plain version exactly (``check_view``),
    with its calls in the run.  Fatal when a kernel of the path was never
    launched, or a view pattern never called.  ``parts`` are (what a call
    is, the plan's ``group_inputs``); ``run`` holds the run's launch counts
    (``counts``), view calls (``views``) and view copies (``view_copies``).
    Returns the kernels' rows (the ``kernels`` line's)."""
    from repro_torch.kernels.stitched import StitchedView
    rows = []
    seen = {}
    for _, res in parts:
        for digest, (k, args) in res[0].items():
            sizes = [(a.numel(), a.dtype) for a in args]
            if CHECKED_SIZES.setdefault(digest, sizes) != sizes:
                fail(f"{tag}: generated callable {digest} met at two input "
                     f"sizes: {CHECKED_SIZES[digest]} and {sizes}")
            seen[digest] = (k, args)
    for digest, (k, args) in seen.items():
        view = isinstance(k, StitchedView)
        n = (run["views"] if view else run["counts"]).get(digest, 0)
        if n <= 0:
            fail(f"{tag}: " + (f"view pattern {digest} of the path was never "
                               f"called" if view else
                               f"kernel {digest} of the path was never "
                               f"launched"))
        if digest in checked:
            checked[digest]["views" if view else "launches"] += n
            continue
        members = sorted({m.attrs.get("op") or m.kind.value
                          for m in k.pattern.compute_members})
        name = f"stitched_{digest}[{','.join(members)}]"
        if view:
            checked[digest] = check_view(name, k, args, n)
        else:
            checked[digest] = check_kernel(name, k, args, launches=n)
            rows.append(checked[digest])
    print(f"{tag} path kernels: {len(seen)} distinct generated kernels and "
          f"view patterns, {len(rows)} new kernels")
    for what, (kernels, per_call, _) in parts:
        for digest, n in per_call.items():
            print(f"{tag} stitched kernel per {what}: {digest} "
                  f"{'views' if checked[digest].get('view') else 'launches'}"
                  f"={n} " + layout_line(kernels[digest][0], checked[digest]))
        kern = {d: n for d, n in per_call.items()
                if not checked[d].get("view")}
        views = {d: n for d, n in per_call.items() if checked[d].get("view")}
        copies = sum(run["view_copies"].get(d, 0) for d in views)
        print(f"{tag} stitched per {what}: launched {sum(kern.values())}, "
              f"views {sum(views.values())}, view copies {copies} (in the "
              f"whole run)")
        agg = {key: sum(n * checked[d][key] for d, n in kern.items())
               for key in ("ms", "device_ms", "plain_ms", "bound_ms")}
        print(f"{tag} stitched kernels per {what}: kernels={len(kern)} "
              f"launches={sum(kern.values())} "
              + " ".join(f"{k}={v:.4f}" for k, v in agg.items()))
        # the kernels of groups that ran member by member before data
        # movement was emitted, against those eager groups (plain version)
        new = {d: n for d, n in kern.items() if checked[d].get("stage1")}
        agg = {key: sum(n * checked[d][key] for d, n in new.items())
               for key in ("device_ms", "plain_device_ms", "bound_ms",
                           "sweep_bound_ms")}
        print(f"{tag} stitched data-movement kernels per {what}: "
              f"kernels={len(new)} launches={sum(new.values())} "
              + " ".join(f"{k}={v:.5f}" for k, v in agg.items()))
    return rows


def bits_equal(a, b) -> bool:
    """Same dtype, shape and bits (NaNs included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bool:
        return torch.equal(a, b)
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def check_view(name, k, args, calls):
    """A view pattern on the path's operands: its outputs the plain
    version's bit for bit and contiguous; the view's host us a call."""
    out = k(*args)
    ref = k.plain(*args)
    for o, r in zip(out, ref):
        if not (bits_equal(o, r) and o.is_contiguous()):
            fail(f"view pattern {name} differs from its plain version")
    shared = sum(o.untyped_storage().data_ptr() == a.untyped_storage().data_ptr()
                 for o in out for a in args)
    reps = 1000
    t0 = time.perf_counter()
    for _ in range(reps):
        k(*args)
    host_us = (time.perf_counter() - t0) * 1e6 / reps
    bound_ms, bound_by = kernel_bound(k)
    return {"name": name, "view": True, "views": calls,
            "outputs_sharing_an_input": shared, "host_us": host_us,
            "device_ms": 0.0, "bound_ms": bound_ms, "bound_by": bound_by}


def single_op_library(k, args):
    """The one PyTorch call that computes a pattern whose compute members
    are one elementwise op and layout members (an ``[add, reshape]``: the
    ``torch.add``, then a view): the plain version is that call; else
    None."""
    from repro_torch.core.ir import OpKind
    from repro_torch.kernels.stitched import layout_member
    g = k.pattern.graph
    ops = [m for m in k.pattern.compute_members if not layout_member(m, g)]
    if len(ops) != 1 or ops[0].kind is not OpKind.ELEMENTWISE:
        return None
    return lambda: k.plain(*args)


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
                 compiler=StitchCompiler(plan_budget=PLAN_BUDGET))
    warm_serve(eng, prompts, lens, scfg.max_new_tokens - 1, "ref-mode")
    run = measured_serve(eng, prompts, lens, scfg.max_new_tokens - 1, dev,
                         "ref-mode", cfg.vocab)
    if sum(run["counts"].values()) <= 0:
        fail("no Triton stitched launch on the ref-mode path")
    pre, dec, dec_in = path_inputs(eng, params, prompts, run, dev)
    kernels = stitched_rows([("prefill call", pre), ("decode step", dec)],
                            run, "ref-mode", checked)
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
    "_rmsnorm_kernel": ("rmsnorm", "cuda", "src/repro_torch/csrc/norms.cu",
                        "src/repro/kernels/norms.py:44"),
    "_glu_kernel": ("glu", "cuda", "src/repro_torch/csrc/activations.cu",
                    "src/repro/kernels/activations.py:32"),
    "_rope_kernel": ("rope", "cuda", "src/repro_torch/csrc/rope.cu",
                     "src/repro/kernels/rope.py:44"),
    "_decode_attn_kernel": ("decode_attention", "cuda",
                            "src/repro_torch/csrc/decode_attention.cu",
                            "src/repro/kernels/decode_attention.py:95"),
    "_flash_kernel": ("flash_attention", "cuda",
                      "src/repro_torch/csrc/flash_attention_sm90.cu",
                      "src/repro/kernels/flash_attention.py:94"),
    "_router_kernel": ("router", "cuda", "src/repro_torch/csrc/router.cu",
                       "src/repro/kernels/router.py:50"),
    "_mamba_kernel": ("mamba_scan", "cuda", "src/repro_torch/csrc/mamba_scan.cu",
                      "src/repro/kernels/mamba_scan.py:52"),
    "_rglru_kernel": ("rg_lru", "cuda", "src/repro_torch/csrc/rg_lru.cu",
                      "src/repro/kernels/rg_lru.py:44"),
    "_layernorm_kernel": ("layernorm", "cuda", "src/repro_torch/csrc/norms.cu",
                          "src/repro/kernels/norms.py:105"),
    "_sqrelu_kernel": ("squared_relu", "triton",
                       "src/repro_torch/kernels/activations.py",
                       "src/repro/kernels/activations.py:65"),
    "_rmsnorm_residual_kernel": ("rmsnorm_residual", "triton",
                                 "src/repro_torch/kernels/norms.py",
                                 "src/repro/kernels/norms.py:71"),
    "_softmax_kernel": ("softmax", "triton",
                        "src/repro_torch/kernels/softmax.py",
                        "src/repro/kernels/softmax.py:43"),
    "_softmax_masked_kernel": ("softmax_masked", "cuda",
                               "src/repro_torch/csrc/softmax.cu",
                               "src/repro/kernels/softmax.py:53"),
    "_xent_kernel": ("cross_entropy", "triton",
                     "src/repro_torch/kernels/cross_entropy.py",
                     "src/repro/kernels/cross_entropy.py:62"),
}
# elementwise operations per output element (the bound's operation count):
# LayerNorm's two sums, x - mu, its square, the products by rsqrt and gamma
# and the sum with beta; squared ReLU's max and product; the residual
# RMSNorm's add, square and sum, the products by rsqrt and gamma.  Per
# input element: a softmax's scale, max, subtraction, sum and division (its
# exponential counted at the SFU's rate); the cross-entropy's max,
# subtraction, sum and the gold logit's compare, select and sum (its
# exponential likewise)
HAND_OPS = {"_rmsnorm_kernel": 4, "_glu_kernel": 5, "_rope_kernel": 6,
            "_layernorm_kernel": 7, "_sqrelu_kernel": 2,
            "_rmsnorm_residual_kernel": 5, "_softmax_kernel": 5,
            "_softmax_masked_kernel": 5, "_xent_kernel": 6}


def expected_launches(cfg, bucket: int | None = None) -> tuple[dict, dict]:
    """Hand-written kernel launches per decode step and per prefill call,
    from the config: 2 norms a layer + the final one (LayerNorm where
    ``cfg.norm`` is ``ln``, else RMSNorm), 2 more RMSNorms a layer with
    qk-norm, 2 rotaries and 1 activation a layer (squared ReLU where
    ``cfg.act`` is ``sqrelu``, else the GLU; the experts' GLU in a MoE
    layer), the router
    once a MoE layer, decode attention once a layer on decode only, flash
    attention once a layer on a prefill whose bucket is a multiple of 128.
    The ssm and hybrid families score and do not serve: both are then one
    scoring call's (``train_forward``) at a sequence length of ``bucket``.
    ssm: a norm and a scan a layer and the final norm.  hybrid: 2 norms and
    a GLU a layer and the final norm, an RG-LRU a recurrent layer, 2
    rotaries and flash attention (at a length that is a multiple of 128)
    an attention layer.  Every other kernel 0."""
    L = cfg.n_layers
    zero = {name: 0 for name, *_ in HAND.values()}
    if cfg.family == "ssm":
        call = dict(zero, rmsnorm=L + 1, mamba_scan=L)
        return call, call
    if cfg.family == "hybrid":
        pat = cfg.hybrid.pattern
        n_attn = sum(pat[i % len(pat)] == "attn" for i in range(L))
        call = dict(zero, rmsnorm=2 * L + 1, glu=L, rg_lru=L - n_attn,
                    rope=2 * n_attn,
                    flash_attention=n_attn if bucket % 128 == 0 else 0)
        return call, call
    step = dict(zero, rope=2 * L, decode_attention=L,
                router=L if cfg.family == "moe" else 0)
    step["layernorm" if cfg.norm == "ln" else "rmsnorm"] += 2 * L + 1
    step["rmsnorm"] += 2 * L if cfg.qk_norm else 0
    step["squared_relu" if cfg.act == "sqrelu" else "glu"] += L
    return step, dict(step, decode_attention=0,
                      flash_attention=L if bucket % 128 == 0 else 0)


# planted faults in the CUDA sources: (sound text, planted text).  Decode
# attention drops the row's own key (kpos < pos); flash attention leaves acc
# unrescaled when a later kv tile raises the row max; the router's top
# column fills every slot, so each row picks its top expert k times;
# the selective scan's lane states restart at every chunk of time steps;
# the RG-LRU's chain restarts h at every chunk of steps the kernel
# walks;
# flash attention ignores the window (every key up to the diagonal is
# walked and valid); the same two in the Hopper flash kernel; the split
# decode's combine adds a chunk's partial without its exp(m_c - M) rescale;
# every row of a RoPE block reads the angle table of the block's first row;
# RMSNorm writes a lane's second repetition of columns through unnormalised
# (x itself); LayerNorm drops beta; SwiGLU drops the sigmoid (a = g); the
# masked softmax's 16-byte path keeps every lane (its mask ignored).
# Keyed by fault: (CUDA source stem, sound text, planted text)
FAULTS = {
    "decode_attention": ("decode_attention",
                         "const int hi = min(p, smax - 1);",
                         "const int hi = min(p - 1, smax - 1);"),
    "flash_attention": ("flash_attention",
                        "#pragma unroll\n      for (int j = 0; j < DPT; ++j) "
                        "acc[i][j] *= alpha;\n", ""),
    "flash_window": ("flash_attention",
                     "  const int q0 = blockIdx.x * kBlockQ;\n",
                     "  window = 0;\n  const int q0 = blockIdx.x * kBlockQ;\n"),
    "router": ("router",
               "if (c < e && r < k) {\n      ws[warp][r] = p[j];\n"
               "      is[warp][r] = c;\n    }",
               "if (c < e && r == 0) {\n      for (int s = 0; s < k; ++s) "
               "{\n        ws[warp][s] = p[j];\n        is[warp][s] = c;\n"
               "      }\n    }"),
    "mamba_scan": ("mamba_scan", "const bool more = t0 + kChunk < L;",
                   "const bool more = t0 + kChunk < L;\n"
                   "    for (int i = 0; i < kPer; ++i) h[i] = 0.f;"),
    "rg_lru": ("rg_lru",
               "for (int j0 = 0; j0 < steps; j0 += kChainBatch) {",
               "h = 0.f;\n      "
               "for (int j0 = 0; j0 < steps; j0 += kChainBatch) {"),
    "flash_sm90_no_rescale": (
        "flash_attention_sm90",
        "o[c][i] *= (i / 2) % 2 ? alpha_b : alpha_a;", "o[c][i] *= 1.f;"),
    "flash_sm90_window": (
        "flash_attention_sm90", "  const int q0 = blockIdx.x * kBlockM;\n",
        "  window = 0;\n  const int q0 = blockIdx.x * kBlockM;\n"),
    "decode_combine_no_rescale": (
        "decode_attention", "wa += a[j] * w;", "wa += a[j];"),
    "rope_row_table": ("rope", "const float2* t = cs + r * a.half + lane * V;",
                       "const float2* t = cs + lane * V;"),
    "rmsnorm_second_rep_raw": ("norms", "return __fmul_rn(t, gs[e]);",
                               "return e / V == 1 ? v[e] "
                               ": __fmul_rn(t, gs[e]);"),
    "layernorm_no_beta": ("norms", "return __fmaf_rn(t, gs[e], bs[e]);",
                          "return __fmul_rn(t, gs[e]);"),
    "glu_no_sigmoid": ("activations", "a = silu(g);", "a = g;"),
    "softmax_mask_ignored": ("softmax",
                             "kb |= keep_bits(m.w[j]) << (4 * j);",
                             "kb |= 0xFu << (4 * j);"),
}


# planted faults in the Triton kernels, the same plan as ``FAULTS``: keyed by
# fault, (kernel module, kernel function, sound text, planted text).
# Squared ReLU squares before the max, so negative
# inputs come out as their squares; the residual RMSNorm normalises x
# instead of x + res; the cross-entropy drops the exp(m_old - m_new)
# rescale of its running sum; the split softmax's fold adds each chunk's
# sum without its exp(m_c - M) rescale
TRITON_FAULTS = {
    "sqrelu_square_first": (
        "activations", "_sqrelu_kernel",
        "r = tl.maximum(x, 0.0, propagate_nan=tl.PropagateNan.ALL)\n"
        "    tl.store(o_ptr + off, (r * r)",
        "r = tl.maximum(x * x, 0.0, propagate_nan=tl.PropagateNan.ALL)\n"
        "    tl.store(o_ptr + off, (r)"),
    "residual_normalises_x": (
        "norms", "_rmsnorm_residual_kernel",
        "var = tl.div_rn(tl.sum(s * s, axis=1)[:, None], 1.0 * d)",
        "s = tl.load(x_ptr + r64 * stride_x + c, mask=mask, other=0.0)"
        ".to(tl.float32)\n"
        "    var = tl.div_rn(tl.sum(s * s, axis=1)[:, None], 1.0 * d)"),
    "xent_no_rescale": (
        "cross_entropy", "_xent_kernel",
        "l = l * tl.exp(m - m_new) + ", "l = l + "),
    "softmax_split_no_rescale": (
        "softmax", "_softmax_split_kernel",
        "lc * tl.exp(mc - M)", "lc"),
}
# the module global each Triton kernel's jitted function is kept in
TRITON_JIT = {"_sqrelu_kernel": "_SQ_JIT",
              "_rmsnorm_residual_kernel": "_RES_JIT",
              "_softmax_split_kernel": "_SPLIT_JIT", "_xent_kernel": "_JIT"}


def fault_dir(fault: str) -> Path:
    """The directory of one planted fault's source and library."""
    from repro_torch.kernels import build
    return build.build_dir() / "planted_fault" / fault


def fault_source(fault: str) -> tuple[str, str, str]:
    """(the source a fault is planted in, its sound text, its planted
    text): the CUDA source's text for a ``FAULTS`` entry, the Triton kernel
    function's (``inspect.getsource``) for a ``TRITON_FAULTS`` one."""
    import importlib
    import inspect
    from repro_torch.kernels import build
    if fault in FAULTS:
        stem, sound, planted = FAULTS[fault]
        return (build.CSRC / f"{stem}.cu").read_text(), sound, planted
    stem, fn, sound, planted = TRITON_FAULTS[fault]
    return (inspect.getsource(getattr(importlib.import_module(
        f"repro_torch.kernels.{stem}"), fn)), sound, planted)


def build_phase() -> float:
    """Build every CUDA library, and a copy of each with its fault planted,
    from an empty ``build/kernels``: one nvcc each, all started together.
    Also write each Triton kernel's source with its fault planted
    (``TRITON_FAULTS``), jitted when the f32 check plants it."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    shutil.rmtree(build.build_dir(), ignore_errors=True)
    for fault, (stem, *_) in FAULTS.items():
        src, sound, planted = fault_source(fault)
        if src.count(sound) != 1:
            fail(f"the {stem} source lost the text fault {fault} is planted in")
        fault_dir(fault).mkdir(parents=True)
        (fault_dir(fault) / f"{stem}.cu").write_text(src.replace(sound, planted))
    for fault, (stem, fn, *_) in TRITON_FAULTS.items():
        src, sound, planted = fault_source(fault)
        if src.count(sound) != 1:
            fail(f"the {fn} source lost the text fault {fault} is planted in")
        fault_dir(fault).mkdir(parents=True)
        (fault_dir(fault) / f"{fn}.py").write_text(
            f'"""{fn} with the fault {fault} planted."""\n'
            "from __future__ import annotations\n\ntl = libdevice = None\n\n\n"
            + src.replace(sound, planted))
    jobs = [(src.stem, build.CSRC, None)
            for src in sorted(build.CSRC.glob("*.cu"))]
    jobs += [(stem, fault_dir(f), fault_dir(f))
             for f, (stem, *_) in FAULTS.items()]

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
        what = (f"planted fault {src_dir.name} " if src_dir != build.CSRC
                else "")
        print(f"cuda build {what}{stem}: {path.name} in {t:.2f}s ptxas {info}")
    print(f"cuda build: {len(jobs)} libraries ({len(FAULTS)} with a planted "
          f"fault) from an empty {build.build_dir().relative_to(ROOT)} in "
          f"{secs:.2f}s, in parallel")
    return secs


def hand_plain(tag):
    from repro_torch.kernels import activations, decode_attention, norms, rope
    from repro_torch.kernels import flash_attention, mamba_scan, rg_lru, router
    from repro_torch.kernels import cross_entropy, softmax
    return {"_rmsnorm_kernel": norms.rmsnorm_plain,
            "_rmsnorm_residual_kernel": norms.rmsnorm_residual_plain,
            "_softmax_kernel": softmax.softmax_plain,
            "_softmax_masked_kernel": softmax.softmax_masked_plain,
            "_xent_kernel": cross_entropy.cross_entropy_plain,
            "_layernorm_kernel": norms.layernorm_plain,
            "_glu_kernel": activations.glu_plain,
            "_sqrelu_kernel": activations.squared_relu_plain,
            "_rope_kernel": rope.rope_plain,
            "_decode_attn_kernel": decode_attention.decode_attention_plain,
            "_flash_kernel": flash_attention.flash_attention_plain,
            "_router_kernel": router.topk_router_plain,
            "_mamba_kernel": mamba_scan.mamba_scan_plain,
            "_rglru_kernel": rg_lru.rg_lru_plain}[tag]


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
    # recurrentgemma's head width 256 on one kv head: its scoring shape (the
    # 2048 window does not bite), a window of 256 over 1024 keys, and 8 q
    # heads on 2 kv heads for a 200-row chunk after 56 cached tokens
    ("dh256_g16_l256", 4, 16, 1, 256, 256, 256, True, 2048, 0),
    ("dh256_g16_l1024_window256", 1, 16, 1, 1024, 1024, 256, True, 256, 0),
    ("dh256_g4_lq200_lkv256_off56", 1, 8, 2, 200, 256, 256, True, None, 56),
    # nemotron-4-15b's prefill at bucket 256: 48 q heads on 8 kv heads
    ("nemotron_g6_l256", 4, 48, 8, 256, 256, 128, True, None, 0),
]


def hand_samples(dev):
    """Each hand-written kernel against its plain version at sample shapes
    (ragged widths, GQA groups of 4 and 6, decode positions at 0, in the
    middle and at Smax-1, with and without a window; the flash cases above;
    LayerNorm and squared ReLU at nemotron-4-15b's rows and a ragged width),
    in f32 and bf16."""
    from repro_torch.kernels import activations, decode_attention, norms
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
        q, k, v = (rnd(3, 1, 8, 128, dtype=dt), rnd(3, 96, 2, 128, dtype=dt),
                   rnd(3, 96, 2, 128, dtype=dt))
        dpos = torch.tensor([[0], [47], [95]], dtype=torch.int32, device=dev)
        for window in (None, 16):
            cases.append((f"decode_attention_{t}_g4_s96_w{window}",
                          decode_attention.decode_attention_op,
                          "_decode_attn_kernel",
                          (dpos, q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), 128 ** -0.5, window)))
        # nemotron-4-15b's decode step: a GQA group of 6 over 512 keys; and
        # the split kernel's chunk edges: positions 0, C - 1, C and Smax - 1,
        # a window across two chunks, a group of 16
        q, k, v = (rnd(4, 1, 48, 128, dtype=dt), rnd(4, 512, 8, 128, dtype=dt),
                   rnd(4, 512, 8, 128, dtype=dt))
        C = decode_attention.CHUNK
        for dname, dp, window in (
                ("g6_s512", [0, 255, 511, 300], None),
                ("g6_s512_chunk_edges", [0, C - 1, C, 511], None),
                ("g6_s512_window_two_chunks", [C + 8, 2 * C, 300, 511], C)):
            dpos = torch.tensor(dp, dtype=torch.int32, device=dev)[:, None]
            cases.append((f"decode_attention_{t}_{dname}",
                          decode_attention.decode_attention_op,
                          "_decode_attn_kernel",
                          (dpos, q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), 128 ** -0.5, window)))
        q16 = rnd(2, 1, 16, 256, dtype=dt)
        k16, v16 = rnd(2, 96, 1, 256, dtype=dt), rnd(2, 96, 1, 256, dtype=dt)
        cases.append((f"decode_attention_{t}_g16_dh256_s96",
                      decode_attention.decode_attention_op,
                      "_decode_attn_kernel",
                      (torch.tensor([[C], [95]], dtype=torch.int32,
                                    device=dev), q16.transpose(1, 2),
                       k16.transpose(1, 2), v16.transpose(1, 2),
                       256 ** -0.5, None)))
        # nemotron-4-15b's prefill and decode rows and a ragged width;
        # seeded gamma and beta, squared ReLU's inputs with exact zeros
        for rows, d in ((1024, 6144), (4, 6144), (37, 96)):
            g = (1 + 0.1 * rnd(d, dtype=torch.float32)).to(dt)
            b = (0.1 * rnd(d, dtype=torch.float32)).to(dt)
            cases.append((f"layernorm_{t}_{rows}x{d}", norms.layernorm_op,
                          "_layernorm_kernel",
                          (2.0 * rnd(rows, d, dtype=dt) + 0.5, g, b, 1e-5)))
        for rows, d in ((1024, 24576), (4, 24576), (37, 96)):
            x = rnd(rows, d, dtype=dt)
            x.view(-1)[::5] = 0.0
            cases.append((f"squared_relu_{t}_{rows}x{d}",
                          activations.squared_relu_op, "_sqrelu_kernel", (x,)))
        for name, B, hq, hkv, lq, lkv, dh, causal, window, off in FLASH_SAMPLES:
            q = rnd(B, lq, hq, dh, dtype=dt)
            k, v = rnd(B, lkv, hkv, dh, dtype=dt), rnd(B, lkv, hkv, dh, dtype=dt)
            cases.append((f"flash_{t}_{name}", flash_attention.flash_attention_op,
                          "_flash_kernel",
                          (q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), dh ** -0.5, causal, window, off)))
    # the replaced kernel on the same inputs: flash on the CUDA cores in
    # bf16
    for name, op, tag, args in list(cases):
        if tag == "_flash_kernel" and args[0].dtype == torch.bfloat16:
            cases.append((name.replace("flash_", "flash_simt_"),
                          functools.partial(flash_attention._launch_variant,
                                            "simt"), tag, args))
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
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
    n_flash = len(FLASH_SAMPLES)
    want = {"flash_attention": {"sm90": n_flash, "simt": 2 * n_flash},
            "decode_attention": {
                "split": sum(n.startswith("decode_attention_")
                             for n, *_ in cases)}}
    if ops.launch_counts_by_variant() != want:
        fail(f"attention samples ran by variant "
             f"{ops.launch_counts_by_variant()}, expected {want}")
    attention_faults(cases)
    rope_samples(rnd)
    router_samples(rnd)
    scan_samples(rnd)
    rglru_samples(rnd)
    api_samples(rnd)


# bf16 faults planted in the Hopper flash kernel and the split decode's
# combine, each with the samples that must catch it: (fault, module name,
# sample names)
ATTENTION_FAULTS = [
    ("flash_sm90_no_rescale", "flash_attention",
     ["flash_bfloat16_causal_g2_l256", "flash_bfloat16_nemotron_g6_l256",
      "flash_bfloat16_dh256_g16_l256"]),
    ("flash_sm90_window", "flash_attention",
     ["flash_bfloat16_causal_window64",
      "flash_bfloat16_dh256_g16_l1024_window256"]),
    ("decode_combine_no_rescale", "decode_attention",
     ["decode_attention_bfloat16_g6_s512",
      "decode_attention_bfloat16_g6_s512_chunk_edges"]),
]


def attention_faults(cases):
    """Each ``ATTENTION_FAULTS`` fault's library swapped in, its samples run
    and held against the plain version: the bf16 gate (1.6e-2) must fail on
    at least one of them; the readings are printed."""
    from repro_torch.kernels import decode_attention, flash_attention
    by_name = {n: (op, tag, args) for n, op, tag, args in cases}
    mods = {"flash_attention": (flash_attention, "_LIB_SM90", "_lib_sm90"),
            "decode_attention": (decode_attention, "_LIB", "_lib")}
    for fault, mod_name, names in ATTENTION_FAULTS:
        mod, attr, loader = mods[mod_name]
        getattr(mod, loader)()
        sound = getattr(mod, attr)
        setattr(mod, attr, faulted_library(mod, fault))
        readings, caught = {}, False
        try:
            for n in names:
                op, tag, args = by_name[n]
                out = op(*args)
                torch.cuda.synchronize()
                ref = hand_plain(tag)(*args)
                readings[n] = max_err((out,), (ref,))
                caught |= not within((out,), (ref,))
        finally:
            setattr(mod, attr, sound)
        print(f"planted fault {fault} (bf16 gate {TOL['bfloat16'][0]}): "
              + " ".join(f"{k}={v:.4g}" for k, v in readings.items()))
        if not caught:
            fail(f"the bf16 sample gate missed the planted fault {fault}")


# RoPE samples (name, rows, heads, head_dim, theta, row stride past the
# row): 3 heads of 64 at ragged positions; every path's q and k: qwen3's
# decode step (4 rows at positions past the prompts), nemotron's prefill
# (48 q heads and 8 kv heads of 128, 4 x 256 rows), recurrentgemma's
# scoring call (16 q heads and one kv head of 256), granite-moe's head
# width 64; and head_dim 8 in rows 2 elements wider than the row, which
# no 16-byte load fits (the kernel's scalar path)
ROPE_SAMPLES = [
    ("3x64", 6, 3, 64, 1e4, 0),
    ("qwen3_decode_q", 4, 16, 128, 1e6, 0),
    ("qwen3_decode_k", 4, 8, 128, 1e6, 0),
    ("nemotron_prefill_q", 1024, 48, 128, 1e4, 0),
    ("nemotron_prefill_k", 1024, 8, 128, 1e4, 0),
    ("recurrentgemma_q", 1024, 16, 256, 1e4, 0),
    ("recurrentgemma_k", 1024, 1, 256, 1e4, 0),
    ("granite_moe_prefill_q", 1024, 16, 64, 1e4, 0),
    ("granite_moe_decode_k", 4, 8, 64, 1e4, 0),
    ("scalar_4x8_stride34", 7, 4, 8, 1e4, 2),
]


def rope_samples(rnd):
    """The RoPE kernel at ``ROPE_SAMPLES``, f32 and bf16, at positions up
    to 4096: against its plain version within ``TOL``, device us a launch;
    then the planted fault ``rope_row_table``, which the samples' gate
    must catch; the kernel's angle tables alone against the spec computed
    in numpy (f64 power and trig functions, each rounded once to f32) at
    positions 0 to 2^17 - 1; the f32 kernel and the plain version against
    the rotation computed in f64 from exact angles."""
    from repro_torch.kernels import rope
    gen = torch.Generator().manual_seed(SEED + 3)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for name, rows, heads, hd, theta, pad in ROPE_SAMPLES:
            x = rnd(rows, heads * hd + pad, dtype=dt)[:, :heads * hd]
            pos = torch.randint(0, 4097, (rows,), generator=gen)
            pos[0] = 4096
            cases.append((f"rope_{str(dt).replace('torch.', '')}_{name}", x,
                          pos.to(torch.int32).to(x.device), theta, hd))
    errs, us = {}, {}
    for name, *args in cases:
        out = rope.rope_op(*args)
        torch.cuda.synchronize()
        ref = rope.rope_plain(*args)
        errs[name] = max_err((out,), (ref,))
        if not within((out,), (ref,)):
            fail(f"RoPE kernel {name} disagrees with its plain version "
                 f"(max err {errs[name]})")
        us[name] = 1e3 * device_ms(functools.partial(rope._launch_kernel,
                                                     *args))
    print("rope kernel samples vs plain at positions to 4096 (f32 2e-5, "
          "bf16 1.6e-2): " + " ".join(f"{k}={v:.3g}" for k, v in errs.items()))
    print("rope samples, device us a launch: "
          + " ".join(f"{k}={v:.2f}" for k, v in us.items()))
    rope._lib()
    sound = rope._LIB
    rope._LIB = faulted_library(rope, "rope_row_table")
    readings = {}
    try:
        for name, *args in cases:
            out = rope.rope_op(*args)
            torch.cuda.synchronize()
            ref = rope.rope_plain(*args)
            readings[name] = (max_err((out,), (ref,)), within((out,), (ref,)))
    finally:
        rope._LIB = sound
    print("planted fault rope_row_table (f32 2e-5, bf16 1.6e-2): "
          + " ".join(f"{k}={v:.4g}" for k, (v, _) in readings.items()))
    if all(ok for _, ok in readings.values()):
        fail("the RoPE sample gate missed the planted fault rope_row_table")
    # the angle tables alone: x1 = 1 and x2 = 0 make the outputs c and s,
    # at positions 0 to 2^17 - 1, for each (theta, head_dim) of the samples,
    # against the spec in numpy: freq = f32(theta^-e) and c, s = f32 of the
    # f64 cos and sin of the f32 angle
    dev = cases[0][1].device
    n = 1 << 17
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    off = {}
    for theta, hd in sorted({(t, h) for _, _, _, h, t, _ in ROPE_SAMPLES}):
        half = hd // 2
        ones = torch.zeros(n, hd, device=dev)
        ones[:, :half] = 1.0
        got = rope.rope_op(ones, pos, theta, hd).cpu().numpy()
        e = np.arange(half, dtype=np.float32) / np.float32(half)
        freq = np.power(np.float64(theta), -e.astype(np.float64)).astype(
            np.float32)
        ang = np.arange(n, dtype=np.float32)[:, None] * freq[None, :]
        want = np.concatenate([np.cos(ang.astype(np.float64)),
                               np.sin(ang.astype(np.float64))],
                              axis=1).astype(np.float32)
        ulps = np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64))
        off[f"theta={theta:g},head_dim={hd}"] = int((ulps > 0).sum())
        if ulps.max() > 1:
            fail(f"the RoPE kernel's angle table departs from the spec by "
                 f"{int(ulps.max())} ulps at theta {theta:g}, head_dim {hd}")
    print(f"rope angle tables (cos, sin) against the spec in numpy at "
          f"positions 0 to {n - 1}: values one ulp off (none more) " + " ".join(
              f"{k}:{v}" for k, v in off.items()))
    # f32 against the rotation in f64 from exact angles: how far each is
    # from exact
    x, pos, theta, hd = next(a for n, *a in cases
                             if n.startswith("rope_float32"))
    exact = rope_f64(x, pos, theta, hd)
    dist = {k: float((f(x, pos, theta, hd).double() - exact).abs().max())
            for k, f in (("cuda", rope.rope_op), ("plain", rope.rope_plain))}
    print(f"rope f32 vs f64 at positions up to {int(pos.max())}: "
          + " ".join(f"{k}={v:.3g}" for k, v in dist.items()))


def launch_floor():
    """The floor of a launch: an empty kernel of one warp a block, at one
    block and at 2 blocks an SM, in device us a launch, back to back
    (CUDA events around 1000 launches) and in a CUDA-graph replay."""
    from repro_torch.kernels import rope
    lib = rope._lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    floor = {}
    for blocks in (1, 2 * sms):
        def empty():
            err = lib.repro_empty_kernel(blocks,
                                         torch.cuda.current_stream().cuda_stream)
            if err:
                fail(f"empty kernel launch failed: "
                     f"{lib.repro_cuda_error_string(err).decode()}")
        floor[blocks] = {"back_to_back_us": 1e3 * timed(empty, 1000),
                         "graph_us": 1e3 * device_ms(empty, 1000)}
    print("launch floor, an empty kernel, device us a launch (back to back "
          "/ CUDA-graph replay): " + " ".join(
              f"{b}_blocks={v['back_to_back_us']:.3f}/{v['graph_us']:.3f}"
              for b, v in floor.items()))


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


# selective-scan samples (Bb, L, Dm, N): falcon-mamba-7b's scoring shape, one
# step, a ragged L, the reduced config's N, several staged chunks of 16 steps
SCAN_SAMPLES = [(4, 256, 8192, 16), (1, 1, 8192, 16), (2, 33, 128, 16),
                (2, 48, 64, 8), (1, 700, 512, 16)]


def scan_samples(rnd):
    """The selective-scan kernel against its plain version at the sample
    shapes, x and delta in f32 and in bf16, and in f32 with B and C as
    strided column views of one projection, as the model hands them (a
    row stride of dt_rank + 2N)."""
    from repro_torch.kernels import mamba_scan
    errs = {}
    for Bb, L, Dm, N in SCAN_SAMPLES:
        for dt, strided in ((torch.float32, False), (torch.bfloat16, False),
                            (torch.float32, True)):
            x = rnd(Bb, L, Dm, dtype=dt)
            delta = F.softplus(rnd(Bb, L, Dm, dtype=torch.float32) - 1.0).to(dt)
            A = -torch.arange(1, N + 1, dtype=torch.float32,
                              device=x.device).repeat(Dm, 1)
            dbc = 0.5 * rnd(Bb, L, 256 + 2 * N, dtype=torch.float32)
            B, C = dbc[..., 256:256 + N], dbc[..., 256 + N:]
            if not strided:
                B, C = B.contiguous(), C.contiguous()
            D = rnd(Dm, dtype=torch.float32)
            name = (f"scan_{str(dt).replace('torch.', '')}_{Bb}x{L}x{Dm}x{N}"
                    + ("_strided_bc" if strided else ""))
            out = mamba_scan.mamba_scan_op(x, delta, A, B, C, D)
            torch.cuda.synchronize()
            ref = mamba_scan.mamba_scan_plain(x, delta, A, B, C, D)
            errs[name] = max_err((out,), (ref,))
            if not within((out,), (ref,)):
                fail(f"scan kernel {name} disagrees with its plain version "
                     f"(max err {errs[name]})")
    print("scan kernel samples vs plain (f32 2e-5, bf16 1.6e-2): "
          + " ".join(f"{k}={v:.3g}" for k, v in errs.items()))


# RG-LRU samples (B, L, D): recurrentgemma-9b's scoring shape, one step, a
# ragged L, many chunks of 32 steps, the f32 check's (1, 2560, 4096)
RGLRU_SAMPLES = [(4, 256, 4096), (1, 1, 4096), (2, 37, 256), (1, 2560, 512),
                 (1, 2560, 4096)]


def rglru_samples(rnd):
    """The RG-LRU kernel against its plain version at the sample shapes, x
    and the gates in f32 and in bf16; Lambda around the model's 0.5.  Then
    the kernel's branch-free reciprocal and square root against the IEEE
    ones at every float of their domains."""
    from repro_torch.kernels import rg_lru
    errs = {}
    for B, L, D in RGLRU_SAMPLES:
        for dt in (torch.float32, torch.bfloat16):
            x, ig, rg = (rnd(B, L, D, dtype=dt) for _ in range(3))
            lam = 0.5 + 0.5 * rnd(D, dtype=torch.float32)
            name = f"rg_lru_{str(dt).replace('torch.', '')}_{B}x{L}x{D}"
            out = rg_lru.rg_lru_op(x, ig, rg, lam, 8.0)
            torch.cuda.synchronize()
            ref = rg_lru.rg_lru_plain(x, ig, rg, lam, 8.0)
            errs[name] = max_err((out,), (ref,))
            if not within((out,), (ref,)):
                fail(f"RG-LRU kernel {name} disagrees with its plain version "
                     f"(max err {errs[name]})")
    print("rg_lru kernel samples vs plain (f32 2e-5, bf16 1.6e-2): "
          + " ".join(f"{k}={v:.3g}" for k, v in errs.items()))
    # the kernel's branch-free reciprocal and square root against the IEEE
    # operations they stand for, at every float they meet
    mismatches = rg_lru.newton_mismatches("cuda")
    if mismatches != (0, 0):
        fail(f"the RG-LRU kernel's reciprocal and square root differ from "
             f"the IEEE ones at {mismatches} floats")
    print("rg_lru kernel's branch-free reciprocal and square root: equal to "
          "the IEEE ones at every float of their domains")


def api_samples(rnd):
    """The kernel API's four kernels against their plain versions, f32 and
    bf16: the residual RMSNorm at a ragged width and at qwen3-1.7b's
    (1024, 2048); the softmax at a ragged width, at the reference
    benchmark's (2048, 1024) with scale 0.125, and past the one-pass block
    (a row of 10001), each with a row of -inf (NaN in both, as in the
    reference) and a row holding a NaN; the masked softmax with fully
    masked rows (exactly 0) and rows masked in their first half, one-pass
    (the CUDA kernel; a ragged width takes its one-element path) and wide;
    the cross-entropy
    at a vocabulary of 50001 (no multiple of a power-of-two block) and at
    a ragged width.  NaN must sit at the same
    places in both; the rest within ``TOL``."""
    from repro_torch.kernels import cross_entropy, norms, softmax
    gen = torch.Generator().manual_seed(SEED + 9)
    dev = rnd(1, dtype=torch.float32).device
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        t = str(dt).replace("torch.", "")
        for rows, d in ((7, 333), (1024, 2048)):
            cases.append((f"rmsnorm_residual_{t}_{rows}x{d}",
                          norms.rmsnorm_residual_op,
                          "_rmsnorm_residual_kernel",
                          (rnd(rows, d, dtype=dt), rnd(rows, d, dtype=dt),
                           (1 + 0.1 * rnd(d, dtype=torch.float32)).to(dt),
                           1e-6)))
        for rows, d, scale in ((7, 333, 1.0), (2048, 1024, 0.125),
                               (3, 10001, 1 / 0.7)):
            x = 3.0 * rnd(rows, d, dtype=dt)
            x[1] = -float("inf")
            x[2, d // 3] = float("nan")
            cases.append((f"softmax_{t}_{rows}x{d}", softmax.softmax_op,
                          "_softmax_kernel", (x, scale)))
        for rows, d in ((64, 256), (6, 333), (4, 10001)):
            mask = (torch.rand((rows, d), generator=gen) < 0.6).to(dev)
            mask[0] = False
            mask[1, : d // 2] = False
            cases.append((f"softmax_masked_{t}_{rows}x{d}",
                          softmax.softmax_masked_op, "_softmax_masked_kernel",
                          (3.0 * rnd(rows, d, dtype=dt), mask, 128 ** -0.5)))
        for rows, V in ((16, 50001), (7, 333)):
            lab = torch.randint(0, V, (rows,), generator=gen,
                                dtype=torch.int32)
            lab[0], lab[1] = 0, V - 1
            cases.append((f"cross_entropy_{t}_{rows}x{V}",
                          cross_entropy.cross_entropy_op, "_xent_kernel",
                          (4.0 * rnd(rows, V, dtype=dt),
                           lab.to(dev))))
    errs = {}
    for name, op, tag, args in cases:
        out = op(*args)
        torch.cuda.synchronize()
        ref = hand_plain(tag)(*args)
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        for o, r in zip(outs, refs):
            if not torch.equal(torch.isnan(o), torch.isnan(r)):
                fail(f"{name}: NaN at other places than in the plain version")
        if tag == "_softmax_kernel" and not torch.isnan(outs[0][1:3]).all():
            fail(f"{name}: a row of -inf or with a NaN is not NaN")
        if tag == "_softmax_masked_kernel" and not (
                (outs[0][0] == 0).all() and (outs[0][~args[1]] == 0).all()):
            fail(f"{name}: masked lanes or a fully masked row are not 0")
        ok = [torch.nan_to_num(o.float(), nan=0.0) for o in outs]
        ok_ref = [torch.nan_to_num(r.float(), nan=0.0) for r in refs]
        errs[name] = max_err(ok, ok_ref)
        if not within([o.to(x.dtype) for o, x in zip(ok, outs)],
                      [r.to(x.dtype) for r, x in zip(ok_ref, refs)]):
            fail(f"hand-written kernel {name} disagrees with its plain version "
                 f"(max err {errs[name]})")
    print(f"kernel API samples vs plain: "
          + " ".join(f"{k}={v:.3g}" for k, v in errs.items()))


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
    if tag == "_layernorm_kernel":
        x, g, b, eps = args
        return lambda: F.layer_norm(x, (x.shape[-1],), g, b, eps)
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
        # the same function when no causal pair falls outside the window
        if not (causal and q_offset == 0 and qt.shape[2] == kt.shape[2]
                and (window is None or qt.shape[2] - 1 < window)):
            return None
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True)
    if tag == "_rmsnorm_residual_kernel":
        x, res, g, eps = args

        def residual_chain():
            s = x + res
            return F.rms_norm(s, (s.shape[-1],), g, eps), s
        return residual_chain
    if tag == "_softmax_kernel":
        x, scale = args
        return lambda: torch.softmax(x * scale, dim=-1)
    if tag == "_softmax_masked_kernel":
        x, mask, scale = args
        drop = ~mask
        return lambda: torch.softmax(x.masked_fill(drop, -torch.inf) * scale,
                                     dim=-1)
    if tag == "_xent_kernel":
        logits, labels = args
        labels64 = labels.long()
        return lambda: F.cross_entropy(logits, labels64, reduction="none")
    return None


# library calls that compute the kernel's function with another rounding or
# another edge case, so only their time is used
LIBRARY_TIME_ONLY = {
    "_softmax_masked_kernel": "NaN on a fully masked row",
    "_xent_kernel": "bf16 losses from bf16 logits",
}


@functools.lru_cache(maxsize=None)
def sfu_rate() -> tuple[float, str]:
    """Exponentials a second on this card: the SFU's 16 results a clock per
    SM (the arithmetic-instruction throughput table of NVIDIA's CUDA C++
    documentation, compute capability 9.0) x the SMs x the card's maximum
    SM clock from nvidia-smi; and the sentence saying so."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = 16 * sms * mhz * 1e6
    return rate, (f"SFU: 16 exp a clock per SM x {sms} SMs x {mhz:.0f} MHz "
                  f"(clocks.max.sm) = {rate:.4g} exp/s")


def hand_bound(tag, args, out) -> tuple[float, str, str]:
    """Least time for the kernel's work on this run's data: each input read
    once and the output written once over the memory rate, or its
    operations over the rate for their type, whichever is larger.
    Elementwise kernels count f32 operations at the f32 rate; decode
    attention reads only the valid keys of each row; flash attention's
    QK^T and PV products count the valid (query, key) pairs, at the bf16
    tensor-core rate for bf16 inputs and the f32 rate for f32 ones; the
    router counts its softmax (5 operations a logit) and k rounds of a
    compare and a select per logit, at the f32 rate; the selective scan
    counts one exponential a state element a step at the SFU's rate
    (:func:`sfu_rate`) and 5 other f32 operations (two products, a fused
    multiply-add for the update, one for the sum over n) at the f32 rate;
    the RG-LRU counts 6 SFU results an element (3 exponentials, 2
    reciprocals of the sigmoids' divisions, a square root) at the SFU's
    rate and 14 other f32 operations an element at the f32 rate; the
    softmaxes and the cross-entropy count one exponential an input element
    at the SFU's rate and ``HAND_OPS`` f32 operations an input element; the
    masked softmax counts them at its kept lanes and reads x only in the
    32-byte sectors that hold one (:func:`masked_bytes`; all of x is
    :func:`masked_full_bound`).
    Returns (ms, "bytes" or "operations", the bounding term)."""
    def nbytes(t):
        return t.numel() * t.element_size()
    rate, kind = F32_PEAK, "f32"
    extra = 0.0
    outs = out if isinstance(out, tuple) else (out,)
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
            rate, kind = BF16_PEAK, "bf16 tensor cores"
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
    elif tag == "_mamba_kernel":
        x, delta, A, B, C, D = args
        elems = x.numel() * A.shape[1]          # state elements x steps
        b = sum(nbytes(a) for a in args) + nbytes(out)
        ops = 5 * elems
        extra = elems / sfu_rate()[0]
    elif tag == "_rglru_kernel":
        x, ig, rg, lam, c = args
        b = sum(nbytes(a) for a in (x, ig, rg, lam)) + nbytes(out)
        ops = 14 * x.numel()
        extra = 6 * x.numel() / sfu_rate()[0]
    elif tag == "_softmax_masked_kernel":
        x, mask, _ = args
        b = masked_bytes(x, mask)[1]
        kept = int(mask.sum())
        ops = HAND_OPS[tag] * kept
        extra = kept / sfu_rate()[0]
    else:
        b = sum(nbytes(a) for a in args if isinstance(a, torch.Tensor)) \
            + sum(nbytes(o) for o in outs)
        ops = HAND_OPS[tag] * outs[0].numel()
        if tag in ("_softmax_kernel", "_softmax_masked_kernel", "_xent_kernel"):
            ops = HAND_OPS[tag] * args[0].numel()
            extra = args[0].numel() / sfu_rate()[0]
    terms = {"bytes": b / HBM_BW, kind: ops / rate, "SFU": extra}
    term = max(terms, key=terms.get)
    return (terms[term] * 1e3, "bytes" if term == "bytes" else "operations",
            term)


def masked_bytes(x, mask) -> tuple[int, int]:
    """The masked softmax's bytes on (x, mask): all of x, the bool mask and
    the output; and the same with x counted only in its 32-byte sectors
    that hold a kept lane."""
    rows, d = x.shape
    per = 32 // x.element_size()
    sectors = F.pad(mask, (0, (-d) % per)).reshape(rows, -1, per).any(-1)
    rest = mask.numel() + x.numel() * x.element_size()
    return (rest + x.numel() * x.element_size(),
            rest + 32 * int(sectors.sum()))


def masked_full_bound(args) -> float:
    """The masked softmax's bound (ms) with all of x read: its bytes over
    the memory rate, or its exponentials over the SFU's rate."""
    x, mask, _ = args
    return 1e3 * max(masked_bytes(x, mask)[0] / HBM_BW,
                     x.numel() / sfu_rate()[0])


def flash_variant(args) -> str:
    """The flash kernel a call with these arguments runs."""
    from repro_torch.kernels import flash_attention
    qt, kt, vt = args[:3]
    return flash_attention._variant(
        qt.dtype, qt.shape[-1], [t.data_ptr() for t in (qt, kt, vt)],
        [st for t in (qt, kt, vt) for st in t.stride()[:3]])


def source_of(tag, args, source):
    """The CUDA source a flash call runs: the Hopper kernel's or the
    CUDA-core kernel's; ``source`` for every other kernel."""
    if tag == "_flash_kernel" and flash_variant(args) == "simt":
        return "src/repro_torch/csrc/flash_attention.cu"
    return source


def replaced_kernel(tag, args, refs) -> dict:
    """The kernel a rebuild replaced, on the same inputs, timed beside the
    new one: the CUDA-core flash kernel for a bf16 call that runs the
    Hopper one, held against the plain version."""
    from repro_torch.kernels import flash_attention
    if tag != "_flash_kernel":
        return {}
    variant = flash_variant(args)
    if variant != "sm90":
        return {"variant": variant}
    old = functools.partial(flash_attention._launch_variant, "simt", *args)
    out = old()
    torch.cuda.synchronize()
    olds = out if isinstance(out, tuple) else (out,)
    err = max_err(olds, refs)
    if not within(olds, refs):
        fail(f"the replaced simt kernel disagrees with the plain version "
             f"(max err {err})")
    return {"variant": variant, "old_variant": "simt", "old_max_abs_err": err,
            "old_ms": timed(old, 50), "old_device_ms": device_ms(old)}


def paired_device_times(*fns, rounds: int = 5, reps: int = 100) -> list:
    """Device ms a call of each of ``fns`` in each of ``rounds``
    alternations (in order, then reversed: new, old, old, new, ... for two)
    of a CUDA-graph replay of ``reps`` calls: a comparison of kernels on
    one card with the drift of its clocks shared between them.  One list
    of ``rounds`` times a function."""
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for r in range(rounds):
        for i in (order if r % 2 == 0 else order[::-1]):
            times[i].append(device_ms(fns[i], reps))
    return times


def launch_signature(name, node, tensors) -> tuple:
    """The key the kernel's launcher counts a launch of ``node`` under
    (``build.signature`` of its arguments, defaults filled in)."""
    from repro_torch.kernels import activations, build, decode_attention
    from repro_torch.kernels import flash_attention, mamba_scan, norms, rope
    from repro_torch.kernels import cross_entropy, rg_lru, router, softmax
    launcher = {"rmsnorm": norms._launch,
                "rmsnorm_residual": norms._launch_residual,
                "softmax": softmax._launch,
                "softmax_masked": softmax._launch_masked,
                "cross_entropy": cross_entropy._launch,
                "layernorm": norms._launch_layernorm,
                "glu": activations._launch,
                "squared_relu": activations._launch_sqrelu,
                "rope": rope._launch, "decode_attention": decode_attention._launch,
                "flash_attention": flash_attention._launch,
                "router": router._launch, "mamba_scan": mamba_scan._launch,
                "rg_lru": rg_lru._launch}[name]
    _, args, kwargs = op_call(node, tensors)
    return build.signature(*all_args(launcher, args, kwargs))


def all_args(fn, args, kwargs) -> list:
    """``fn``'s arguments in order, defaults filled in (the dispatcher drops
    an argument left at its default from the traced call)."""
    import inspect
    bound = inspect.signature(fn).bind(*args, **kwargs)
    bound.apply_defaults()
    return list(bound.arguments.values())


def hand_chain(tag, args):
    """The PyTorch calls that compute squared ReLU or a GLU, a yardstick of
    a chain where no single call computes the kernel's function, and what
    the chain is."""
    if tag == "_sqrelu_kernel":
        x = args[0]
        return (lambda: torch.relu(x).square()), "relu -> square, two calls"
    g, u, act = args
    if act == "silu":
        return (lambda: F.silu(g) * u), "F.silu(g) * u, two calls"
    return ((lambda: F.gelu(g, approximate="tanh") * u),
            "F.gelu(g, approximate='tanh') * u, two calls")


def hand_rows(parts, path):
    """Every hand-written kernel launch signature of the path's plans
    (shapes, dtypes and other arguments), on its main-path operands: held
    against the plain version and timed.  ``parts`` are (what a call is,
    the plan's ``group_inputs``, its calls in the measured run, the
    launches by kernel and signature the run counted in those calls).  A
    signature's launches must equal the plans' nodes of that signature
    times their calls, and no launch of the run may have a signature
    outside the plans."""
    plans = {}
    for _, res, calls, _ in parts:
        for (tag, *_), (node, tensors, n) in res[2].items():
            name = HAND[tag][0]
            key = (name, launch_signature(name, node, tensors))
            plans.setdefault(key, [tag, node, tensors, 0])[3] += n * calls
    measured, per_part = {}, {}
    for what, _, calls, sig in parts:
        for name, c in sig.items():
            for s, n in c.items():
                measured[name, s] = measured.get((name, s), 0) + n
                per_part[what, name, s] = n / calls
    if set(measured) != set(plans):
        fail(f"hand-written kernels launched at signatures "
             f"{sorted(map(str, set(measured) - set(plans)))} outside the "
             f"plans, or never at {sorted(map(str, set(plans) - set(measured)))}")
    derived = {key: v[3] for key, v in plans.items()}
    if measured != derived:
        fail(f"hand-written kernel launches by signature {measured} != the "
             f"plans' nodes times their calls {derived}")

    def field(what):
        return "launches_per_" + what.replace(" ", "_")

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
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
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
            err = max_err(outs, refs)
            if not within(outs, refs):
                fail(f"{name} at {sig} disagrees with its plain version "
                     f"(max err {err})")
        if tag in ("_sqrelu_kernel", "_glu_kernel"):
            # no single call computes it: a chain of calls is the yardstick
            chain, what = hand_chain(tag, full)
            if not within((chain(),), (ref,)):
                fail(f"the {what} chain disagrees with {name}'s plain version")
            extra = {"chain": what, "chain_ms": timed(chain, 50),
                     "chain_device_ms": device_ms(chain)}
        source = source_of(tag, full, source)
        extra.update(replaced_kernel(tag, full, refs))
        lib = hand_library(tag, full)
        lib_ms = lib_dev_ms = lib_err = None
        if lib is not None:
            lib_out = lib()
            lib_outs = lib_out if isinstance(lib_out, tuple) else (lib_out,)
            if tag in LIBRARY_TIME_ONLY:
                extra["library_time_only"] = LIBRARY_TIME_ONLY[tag]
            else:
                lib_err = max_err(lib_outs, refs)
                if not within(lib_outs, refs):
                    fail(f"library call of {name} disagrees with the plain "
                         f"version (max err {lib_err})")
            lib_ms = timed(lib, 50)
            lib_dev_ms = device_ms(lib)
        bound_ms, bound_by, term = hand_bound(tag, full, out)
        if tag == "_softmax_masked_kernel":
            extra["bound_all_bytes_ms"] = masked_full_bound(full)
        tensor_sig = [a for a in sig if isinstance(a, tuple)]
        shapes = ",".join("x".join(map(str, s)) for s, _ in tensor_sig)
        dt = next(d for _, d in tensor_sig if "float" in d).replace("torch.", "")
        row = {"name": f"{name}[{shapes},{dt}]", "path": path,
               "route": route, "source": source, "replaces": replaces,
               "launches": measured[key]}
        for what, *_ in parts:
            row[field(what)] = per_part.get((what, *key), 0)
        rows[key] = dict(row, **{
            "max_abs_err": err,
            "ms": timed(run_op, 50), "device_ms": device_ms(run_op),
            "plain_ms": timed(lambda: plain(*args, **kwargs), 20),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_term": term,
            "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
            "library_max_abs_err": lib_err, **extra})
    for name, *_ in HAND.values():
        for what, *_ in parts:
            mine = [(r, r[field(what)]) for (nm, _), r in rows.items()
                    if nm == name and r[field(what)]]
            agg = {f: sum(n * r[f] for r, n in mine)
                   for f in ("ms", "device_ms", "plain_ms", "bound_ms")}
            if mine and all(r.get("old_ms") is not None for r, _ in mine):
                for f in ("old_ms", "old_device_ms"):
                    agg[f] = sum(n * r[f] for r, n in mine)
            for lib in ("library", "chain"):
                if mine and all(r.get(f"{lib}_ms") is not None for r, _ in mine):
                    for f in (f"{lib}_ms", f"{lib}_device_ms"):
                        agg[f] = sum(n * r[f] for r, n in mine)
            if not mine and not any(nm == name for nm, _ in rows):
                continue
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
                     compiler=StitchCompiler(plan_budget=PLAN_BUDGET))
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
    parts = [("prefill call", pre), ("decode step", dec)]
    kernels = stitched_rows(parts, run, tag, checked)
    prefill_sig = run["hand_prefill_sig"]
    decode_sig = {k: dict(Counter(c) - Counter(prefill_sig[k]))
                  for k, c in run["hand_total_sig"].items()}
    kernels += hand_rows([("prefill call", pre, 1, prefill_sig),
                          ("decode step", dec, steps, decode_sig)], tag)
    summary = plan_summary(eng, run, dec_in)
    return eng, kernels, summary


def kernel_mode_phase(dev, model, params, lens, prompts, checked):
    """The kernel-mode path at the 64 bucket (``serve_kernel_mode``); then
    its bf16 decode logits against the ref-mode eager decode over several
    weight seeds.  Returns the rows, the plan summary and the engine (the
    plan-cache phase's offline yardstick)."""
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
    return kernels, summary, eng


# ---------------------------------------------------------------------------
# the plan cache: miss-then-upgrade serving and replay from disk
# ---------------------------------------------------------------------------

CACHE_STEPS = 15          # decode steps a serve of the plan-cache phase


def cache_serve(e, prompts, lens, svc=None):
    """One serve of the prompts in kernel mode: a prefill, then
    ``CACHE_STEPS`` decode steps from each row's first prompt token (as
    ``first_step_logits``), each timed alone and marked by whether
    ``svc`` still had a background compile in flight when it began.
    Returns the tokens, the first step's logits (f32), the steps' ms
    during and after the compile (the first step apart: it traces and
    compiles on a first serve), and the prefill call's seconds."""
    from repro_torch.kernels import ops
    with ops.kernel_mode("kernels"):
        t0 = time.perf_counter()
        px = e.prefill(prompts, prompt_lens=lens)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        for row in range(len(lens)):
            e.insert(px, slot=row, row=row)
        e._tok[:len(lens), 0] = np.asarray(prompts)[:, 0]
        toks, first, during, after = [px.first_tokens[:, None]], None, [], []
        for i in range(CACHE_STEPS):
            busy = svc is not None and svc.pending() > 0
            t0 = time.perf_counter()
            tok, lg = e.generate_step(steps=1, return_logits=True)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            toks.append(tok[:len(lens)])
            if i == 0:
                first, first_ms = lg[0].float(), ms
            else:
                (during if busy else after).append(ms)
        for row in range(len(lens)):
            e.release(row)
    return (np.concatenate(toks, axis=1), first, during, after,
            (prefill_s, first_ms))


def step_counts(e):
    """One decode step's launches: generated kernels by digest and view
    patterns by digest (nonzero only), hand-written kernels by signature."""
    from repro_torch.kernels import ops, stitched
    cache = {k: v.clone() for k, v in e.kv.decode_cache().items()}
    tok = torch.as_tensor(e._tok.copy(), device=e.device)
    stitched.reset_launch_counts()
    ops.reset_launch_counts()
    e._exec(e.params, cache, tok)
    torch.cuda.synchronize()
    gen = {k: v for k, v in stitched.launch_counts().items() if v}
    views = {k: v for k, v in stitched.view_counts().items() if v}
    return gen, views, ops.launch_counts_by_signature()


def plan_record(svc, sf):
    """The active plan of a stitched function in canonical coordinates:
    its graph's key and its groups (members, kind, row block, scratch,
    pack), in a fixed order."""
    from repro_torch.cache import extract_record
    g, compiled = sf.graph, sf.compiled
    sig = svc.cache.signature_of(g)
    rec = extract_record(g, sig, compiled, "", "")
    return rec.graph_key, sorted(rec.groups, key=repr)


def counted(stages: Counter):
    """Wrap pattern generation, the ILP and the tuner so each call is
    counted in ``stages``; returns a function that unwraps them."""
    from repro_torch.core import compiler as comp_mod
    from repro_torch.core.tuner import TemplateTuner
    saved = [(comp_mod, "generate_patterns"), (comp_mod, "solve_fusion_plan"),
             (TemplateTuner, "tune")]
    originals = [getattr(o, n) for o, n in saved]

    def wrap(name, fn):
        def run(*a, **k):
            stages[name] += 1
            return fn(*a, **k)
        return run

    for (owner, name), fn in zip(saved, originals):
        setattr(owner, name, wrap(name, fn))

    def restore():
        for (owner, name), fn in zip(saved, originals):
            setattr(owner, name, fn)
    return restore


def plan_cache_phase(dev, model, params, lens, prompts, offline):
    """The plan cache at full width in kernel mode (bucket 64).

    1. Cold serve: an engine over a ``CompilationService`` with a
       ``DiskStore`` in an empty directory serves the prompts; the fallback
       plans answer while both stitched plans compile in the background;
       ``svc.wait()``; a second serve must run the stitched plans only
       (status hit, no fallback call, no service error).  Both serves'
       first decode step within ``KM_LOGIT_TOL`` of the offline kernel-mode
       engine's (``offline``); the second serve's tokens and logits equal
       to the offline engine's bit for bit where the landed plans are the
       offline plans.
    2. Warm replay: a fresh cache and service over the same directory
       compile both graphs: each a hit from disk, no planner stage or tuner
       call; the replayed plans equal the landed ones (groups, kinds,
       row blocks, packs) and the offline ones where those equal; an
       engine over that service serves with no fallback call, its prefill
       and first-step logits bit for bit the landed plans', one decode
       step's launches by kernel and signature the landed plan's (and the
       offline plan's where the plans are equal).  Prints warm against
       cold compile seconds."""
    import tempfile
    from repro_torch.cache import CompilationService, StitchCache
    from repro_torch.kernels import ops
    from repro_torch.serve import Engine, ServeConfig
    scfg = ServeConfig(batch=4, max_len=128, max_new_tokens=CACHE_STEPS + 1,
                       stitch_execute=True, paged=False)
    off_toks, off_first, _, off_ms, _ = cache_serve(offline, prompts, lens)
    with ops.kernel_mode("kernels"):
        off_pre, _ = prefill_and_step_logits(offline, prompts, lens)
    root = Path(tempfile.mkdtemp(prefix="plan_cache_"))
    try:
        svc = CompilationService(StitchCache(directory=str(root)),
                                 plan_budget=PLAN_BUDGET)
        eng = Engine(model, params, scfg, device=dev, stitch_service=svc)
        t0 = time.perf_counter()
        toks1, first1, during1, after1, call1 = cache_serve(eng, prompts, lens,
                                                            svc)
        serve1 = time.perf_counter() - t0
        calls1 = {k: dict(eng.report()[k]["plan_calls"])
                  for k in ("prefill", "decode")}
        t0 = time.perf_counter()
        svc.wait()
        waited = time.perf_counter() - t0
        toks2, first2, during2, after2, call2 = cache_serve(eng, prompts, lens,
                                                            svc)
        rep = eng.report()
        calls2 = {k: {m: n - calls1[k].get(m, 0)
                      for m, n in rep[k]["plan_calls"].items()}
                  for k in ("prefill", "decode")}
        print(f"plan cache cold serve: {serve1:.1f}s (prefill call "
              f"{call1[0]:.1f}s, first decode step {call1[1] / 1e3:.1f}s: "
              f"trace and fallback plan; second serve {call2[0]:.3f}s / "
              f"{call2[1]:.1f}ms), plan calls {calls1}, "
              f"tokens {toks1.tolist()}; waited {waited:.1f}s for the "
              f"background compiles; second serve plan calls {calls2}, "
              f"status {eng.stitch_status}")
        print(f"plan cache decode ms a step (the first of each serve "
              f"apart): during the background compile {len(during1)} steps, "
              f"median {np.median(during1) if during1 else float('nan'):.2f}; "
              f"after it {len(after1) + len(after2)} steps, median "
              f"{np.median(after1 + after2):.2f} (first serve after it "
              f"{len(after1)}); offline engine median {np.median(off_ms):.2f}")
        errs = svc.error_report()
        if svc.last_error is not None or errs or any(
                rep[k]["service_error"] for k in ("prefill", "decode")):
            fail(f"plan cache: background compile failed: {svc.last_error} "
                 f"{errs}")
        if eng.stitch_status != "hit" or eng._prefill_exec.status != "hit":
            fail(f"plan cache: after svc.wait() the plans are "
                 f"{eng._prefill_exec.status} / {eng.stitch_status}, not hit")
        if any(c.get("xla") for c in calls2.values()) or any(
                rep[k]["calls"]["fallback"] for k in ("prefill", "decode")):
            fail(f"plan cache: a fallback call after the plans landed: "
                 f"{calls2}, {[rep[k]['calls'] for k in ('prefill', 'decode')]}")
        records = {p.name: json.loads(p.read_text())
                   for p in sorted(root.glob("plan_*.json"))}
        if len(records) != 2:
            fail(f"plan cache: {len(records)} plan files, expected 2")
        cold_s = {("prefill" if r["placement"] else "decode"): r["solve_seconds"]
                  for r in records.values()}
        off_plans = {k: offline.report()[k]["plan"] for k in ("prefill", "decode")}
        landed = {k: rep[k]["plan"] for k in ("prefill", "decode")}
        execs = {"prefill": ("_prefill_exec",), "decode": ("_exec",)}
        same = {}
        for k, (attr,) in execs.items():
            same[k] = (plan_record(svc, getattr(eng, attr))
                       == plan_record(svc, getattr(offline, attr)))
            print(f"plan cache {k}: landed plan equals the offline plan: "
                  f"{same[k]} (ilp landed {landed[k]['ilp_method']}, offline "
                  f"{off_plans[k]['ilp_method']}); cold compile "
                  f"{cold_s[k]:.2f}s in the background, "
                  f"{off_plans[k]['compile_seconds']:.2f}s offline")
        readings = [rel_diff(first1, off_first), rel_diff(first2, off_first)]
        print(f"plan cache first-step logits vs the offline kernel mode: "
              f"cold serve rel={readings[0]:.6g}, second serve "
              f"rel={readings[1]:.6g} (tol {KM_LOGIT_TOL})")
        if not all(np.isfinite(r) and r <= KM_LOGIT_TOL for r in readings):
            fail("plan cache: a serve's first-step logits disagree with the "
                 "offline kernel mode")
        with ops.kernel_mode("kernels"):
            pre2, step2 = prefill_and_step_logits(eng, prompts, lens)
        if same["prefill"] and not bits_equal(pre2, off_pre):
            fail("plan cache: the landed prefill plan is the offline one but "
                 "its logits differ in some bits")
        if all(same.values()) and not (
                bits_equal(first2, off_first) and np.array_equal(toks2, off_toks)):
            fail("plan cache: the landed plans are the offline ones but the "
                 "second serve's tokens or logits differ in some bits")

        # 2. warm replay: a fresh cache over the same directory
        stages: Counter = Counter()
        restore = counted(stages)
        try:
            warm = CompilationService(StitchCache(directory=str(root)),
                                      plan_budget=PLAN_BUDGET)
            if len(warm.cache.store.memory):
                fail("plan cache: the fresh cache's memory tier is not empty")
            warm_s = {}
            for k, (attr,) in execs.items():
                sf = getattr(eng, attr)
                t0 = time.perf_counter()
                cg = warm.compiler("stitch", sf.placement).compile(sf.graph)
                warm_s[k] = time.perf_counter() - t0
                if cg.stats.cache_status != "hit":
                    fail(f"plan cache: the warm {k} compile was a "
                         f"{cg.stats.cache_status}")
            wrep = warm.cache.report()
            weng = Engine(model, params, scfg, device=dev, stitch_service=warm)
            with ops.kernel_mode("kernels"):
                pre_w, step_w = prefill_and_step_logits(weng, prompts, lens)
            wr = weng.report()
        finally:
            restore()
        print(f"plan cache warm replay: {wrep['total_hits']} hits, "
              f"{wrep['total_misses']} misses from {wrep['disk_entries']} "
              f"disk entries (memory tier {wrep['memory_entries']} after); "
              f"planner and tuner calls {dict(stages)}; engine plan calls "
              f"{ {k: wr[k]['plan_calls'] for k in ('prefill', 'decode')} }")
        for k in execs:
            print(f"plan cache {k} compile: warm {warm_s[k]:.3f}s against cold "
                  f"{cold_s[k]:.2f}s (background) and "
                  f"{off_plans[k]['compile_seconds']:.2f}s (offline): "
                  f"{cold_s[k] / warm_s[k]:.1f}x")
        if wrep["total_hits"] != 2 or wrep["total_misses"] or sum(stages.values()):
            fail(f"plan cache: the warm compiles were not two disk hits with "
                 f"no planner or tuner call ({wrep}, {dict(stages)})")
        if any(wr[k]["plan_calls"].get("xla") or wr[k]["calls"]["fallback"]
               for k in execs):
            fail("plan cache: the warm engine served a fallback call")
        for k, (attr,) in execs.items():
            if plan_record(warm, getattr(weng, attr)) != plan_record(
                    svc, getattr(eng, attr)):
                fail(f"plan cache: the replayed {k} plan is not the landed one")
        if not (bits_equal(pre_w, pre2) and bits_equal(step_w, step2)):
            fail("plan cache: the replayed plans' logits differ in some bits "
                 "from the plans they replay")
        counts = {"landed": step_counts(eng), "warm": step_counts(weng),
                  "offline": step_counts(offline)}
        print("plan cache launches a decode step (generated, views, "
              "hand-written by kernel): " + " ".join(
                  f"{k}={sum(g.values())}/{sum(v.values())}/"
                  f"{ {n: sum(c.values()) for n, c in h.items() if c} }"
                  for k, (g, v, h) in counts.items()))
        if counts["warm"] != counts["landed"]:
            fail("plan cache: the replayed decode plan launches other kernels "
                 "than the plan it replays")
        if counts["warm"][2] != counts["offline"][2]:
            fail("plan cache: hand-written launches a step differ from the "
                 "offline kernel mode's")
        if same["decode"] and counts["warm"] != counts["offline"]:
            fail("plan cache: the decode plan is the offline one but launches "
                 "other kernels")
        print(f"plan cache: prefill and first-step logits of the replayed "
              f"plans bit for bit the landed plans'; equal to the offline "
              f"engine's where the plans are ({same})")
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
        record_logits(tag, cfg, SEED + s, km, ea, readings,
                      KM_LONG_LOGIT_TOL)
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
        record_logits(tag, cfg, SEED + s, km, ea, readings,
                      MOE_LOGIT_TOL["prefill"])
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
          f"(each row's top expert k times) prefill={planted[0]:.6g} "
          f"decode={planted[1]:.6g}")
    if not all(r <= F32_LOGIT_TOL for rs in readings for r in rs):
        fail("moe 4-layer f32 kernel-mode logits disagree with eager")
    if not min(planted) > F32_LOGIT_TOL:
        fail("the f32 logit check missed the planted router fault")


SSM_ARCH = "falcon-mamba-7b"
HYBRID_ARCH = "recurrentgemma-9b"
# the scoring batch: 4 windows of 256 tokens, as a log-likelihood task's
# candidates, a reranker's passages or a perplexity filter's crawled text
SCORE_BATCH = (4, 256)
SCORE_CALLS = 5           # measured scoring calls after the first
BLOCK_CALLS = 3           # measured block_fn calls after the first
# falcon-mamba-7b's depth in the ssm phase, cut from its 64 layers at full
# width: the whole script took 1286.1 s on the card, over its 1200 s
# limit, when the host was slow (the ssm phase 197.3 s of it, its plan's
# pattern generation 121.9 s); the phase is the largest earlier one
SSM_LAYERS = 32
# the ssm phase in bf16: the stitched kernel-mode loss against the eager
# ref-mode model's (the oracle loop) as |diff| / |eager loss|, and
# the layer-0 block_fn output as rel_diff.  The stitched plan computes the
# dots in f32 where eager rounds them to bf16 (the widening-convert fold),
# and the layers carry that noise to the loss.  Readings over 3 seeds on an
# H100 at 64 layers, before the cut: loss 2.64e-4 to 4.06e-4, block 2.24e-3
# to 2.76e-3; each limit is 1.35x its largest reading, rounded up, and is
# kept at 32 layers.  A loss over 1024 tokens moves
# little under a wrong scan, so the block check, per element, and the f32
# check below (where the planted scan fault reads 0.105) are the gates.
SSM_TOL = {"loss": 5.5e-4, "block": 3.8e-3}
# the hybrid phase in bf16 (38 layers), measured as the ssm phase's: the
# same rounding noise (the flash kernel and the eager oracle both keep the
# probabilities in f32).  Readings over 3 seeds on an H100: loss 1.8e-6 to
# 5.0e-5, block 0, 0 and 2.8e-3 (0 where the kernel's f32 recurrence
# rounds to the oracle's bf16 values everywhere, 2.8e-3 where one element
# takes the neighbouring bf16 value); each limit is 1.35x its largest
# reading, rounded up.  The loss reading is noise at about 1e-4, past its
# limit, for sound kernels: over seeds 0-4 the CUDA-core flash kernel reads
# up to 1.32e-4 and the Hopper one with expf up to 1.28e-4, while
# lower-precision copies (p in one bf16 part, the RG-LRU's state or decay
# in bf16) read at most 1.17e-4 (examples/torch_hybrid_loss_noise.py).  No
# such copy fails a limit over the sound readings, so the limit stays; the
# kernels are held by scoring_phase's per-launch f64 check of flash, and
# the block and f32 checks.
HYBRID_TOL = {"loss": 6.8e-5, "block": 3.8e-3}
# the hybrid phase's reading of the hand-written kernels alone, on the
# scoring call of its bf16 check: every hand-written launch's output
# against its plain version on the same operands (``KernelsVsPlain``), as
# the largest share of outputs whose bits differ, over the call's
# launches.  Over seeds 0-4 on an H100 (examples/torch_hybrid_loss_noise.py,
# PERF.md section 2) the sound kernels read at most 3.26e-4 (the Hopper
# flash kernel's launches; the CUDA-core one 7.5e-5, the Hopper one with
# expf 3.28e-4; RMSNorm 1.7e-5 to 2.6e-5, RoPE 1.9e-5 to 4.2e-5, the
# RG-LRU and GLU 0), and the lower-precision copies 0.356 to 0.362 (p in
# one bf16 part), 0.0459 to 0.0460 (the RG-LRU's state in bf16) and 0.0451
# to 0.0452 (its decay in bf16), at every seed.  The limit is 1.35x the
# largest sound reading.  The loss of the same plan run with every
# hand-written op computed plainly did not see the kernels: sound kernels
# up to 8.0e-5, the copies 1.2e-5 to 1.8e-4, and the expf probe past
# 1.35x the sound kernels' largest at two seeds.
HYBRID_PLAIN_TOL = 4.4e-4
# the hybrid f32 check: one sequence of 2560 tokens, so that the 2048-token
# window masks keys in the flash kernel (the eager side takes the chunked
# attention, 512 query rows a chunk)
HYBRID_F32_BATCH = (1, 2560)


def score_batch(cfg, seed, dev, shape=SCORE_BATCH):
    """Tokens and labels ``shape`` (B, S) from ``seed``."""
    rng = np.random.default_rng(seed)
    return {k: torch.as_tensor(rng.integers(0, cfg.vocab, shape),
                               device=dev) for k in ("tokens", "labels")}


def block_input(cfg, seed, dev, shape=SCORE_BATCH):
    """A block's input (B, S, d_model) in the compute dtype: unit normal, the
    scale of a normed hidden state."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((*shape, cfg.d_model), generator=gen, device=dev)
    return x.to(getattr(torch, cfg.dtype))


def block_params(model, params):
    """The ``block_fn`` operand: layer 0 (ssm), or the first recurrent layer
    ``params["supers"][0]["l0"]`` (hybrid, which keeps no ``layers``)."""
    if model.cfg.family == "hybrid":
        return params["supers"][0]["l0"]
    return model.layer_params(params, 0)


def block_launches(cfg) -> dict:
    """Hand-written kernel launches of one ``block_fn`` call: the scan
    (ssm); the RG-LRU, 2 RMSNorms and the GeGLU (hybrid)."""
    zero = {name: 0 for name, *_ in HAND.values()}
    if cfg.family == "hybrid":
        return dict(zero, rg_lru=1, rmsnorm=2, glu=1)
    return dict(zero, mamba_scan=1)


def measured_calls(sf, args, calls):
    """The main-path run of a stitched function: every launch count is
    zeroed just before ``calls`` calls and read just after; each call is
    timed on the host around a synchronize."""
    from repro_torch.kernels import ops, stitched
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stitched.reset_launch_counts()
    ops.reset_launch_counts()
    times, out = [], None
    for _ in range(calls):
        t0 = time.perf_counter()
        out = sf(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    variant_gate("measured calls")
    return {"out": out, "ms": times, "counts": stitched.launch_counts(),
            "views": stitched.view_counts(),
            "view_copies": stitched.view_copy_counts(),
            "hand": ops.launch_counts(),
            "hand_sig": ops.launch_counts_by_signature(),
            "peak": torch.cuda.max_memory_allocated()}


def stitched_call(tag, fn, args, dev):
    """``stitch(fn)`` in kernel mode, its first call (trace, plan, kernel
    builds) timed, and its plan line."""
    from repro_torch.core import StitchCompiler
    from repro_torch.exec import stitch
    from repro_torch.kernels import ops
    with ops.kernel_mode("kernels"):
        sf = stitch(fn, mode="offline", device=dev,
                    compiler=StitchCompiler(plan_budget=PLAN_BUDGET),
                    name=tag.replace(" ", "_"))
        t0 = time.perf_counter()
        sf(*args)
        torch.cuda.synchronize()
    print(f"{tag} first call: {time.perf_counter() - t0:.1f}s (trace + plan "
          f"+ kernel builds)")
    plan_line(tag, sf.report(), sf.compiled)
    return sf


def init_line(cfg, params, secs):
    """The config and the measured parameter count (``ModelConfig.
    param_count``, a verbatim copy of the reference's, leaves out the ssm
    conv bias and undercounts a hybrid recurrent layer's projections)."""
    from torch.utils._pytree import tree_leaves
    n = sum(t.numel() for t in tree_leaves(params))
    if cfg.family == "ssm":
        from repro_torch.models.mamba import _dims
        s, dm, dtr = _dims(cfg)
        shape = (f"d_inner={dm} d_state={s.d_state} d_conv={s.d_conv} "
                 f"dt_rank={dtr}")
    else:
        h = cfg.hybrid
        shape = (f"pattern={'/'.join(h.pattern)} heads={cfg.n_heads}/"
                 f"{cfg.n_kv_heads} head_dim={cfg.dh} window={h.window} "
                 f"d_ff={cfg.d_ff}")
    print(f"init {cfg.name}: {cfg.n_layers}L d_model={cfg.d_model} {shape} "
          f"vocab={cfg.vocab} params={n / 1e9:.4f}B measured "
          f"({n * 4 / 1e9:.2f} GB f32; ModelConfig.param_count "
          f"{cfg.param_count() / 1e9:.4f}B, {n - cfg.param_count()} short) "
          f"in {secs:.1f}s")


def plain_ops() -> dict:
    """Each hand-written kernel's custom op (an ``OpOverload`` of
    ``torch.ops.repro_torch``) -> (its launch counter's name, its plain
    version)."""
    out = {}
    for tag, (name, *_) in HAND.items():
        fn = hand_plain(tag)
        op = getattr(torch.ops.repro_torch,
                     "topk_router" if name == "router" else name)
        out[op.default] = (name, fn)
    return out


class KernelsVsPlain(torch.utils._python_dispatch.TorchDispatchMode):
    """While active, each hand-written kernel's op runs its kernel as it is
    and also its plain version on the same arguments: ``calls`` counts the
    launches by name, ``share`` keeps per name the largest share, over its
    launches, of output elements whose bits differ from the plain
    version's.  The call's result is the kernels', and every launch sees
    the kernel path's own inputs, so a share is one kernel's rounding
    alone, with nothing carried from an earlier layer; every other op runs
    as it is."""

    def __init__(self):
        super().__init__()
        self.plain, self.calls, self.share = plain_ops(), Counter(), {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in self.plain:
            name, fn = self.plain[func]
            ref = fn(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            share = max(float((o != r).double().mean())
                        for o, r in zip(outs, refs))
            self.calls[name] += 1
            self.share[name] = max(self.share.get(name, 0.0), share)
        return out


def plain_share(mode, want) -> float:
    """The reading of a call run under ``KernelsVsPlain``: the largest
    share of outputs off the plain version over its hand-written launches,
    failing unless it saw exactly ``want`` launches (the call's)."""
    got = {k: v for k, v in mode.calls.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        fail(f"kernels vs plain versions saw launches {got}, expected the "
             f"call's {want}")
    return max(mode.share.values())


def scoring_phase(dev, checked, arch, name, tol, n_layers=None):
    """Full-width ``arch`` (random weights from a seed; ``n_layers`` of
    them when given) scored in kernel
    mode through ``stitch(train_forward)`` at 4 x 256 tokens: exactly the
    config's launches a call (``expected_launches``); every kernel of the
    path against its plain version and timed.  Then ``stitch(block_fn)``
    on the first block (``block_launches`` a call).  Then, over
    ``LOGIT_SEEDS`` weight seeds, the bf16 loss and the block output
    against the eager ref-mode model, each under ``tol``; and every bf16
    flash launch of those scoring calls run again on the Hopper and the
    CUDA-core kernel and held against an f64 attention: the Hopper kernel
    may be off the f64 value in bf16 on no larger a share of outputs than
    the CUDA-core kernel at any launch."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = replace(cfg, n_layers=n_layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, dev)
    torch.cuda.synchronize()
    init_line(cfg, params, time.perf_counter() - t0)
    tag = f"{name} score"
    batch = score_batch(cfg, SEED, dev)
    sf = stitched_call(tag, model.train_forward, (params, batch), dev)
    run = measured_calls(sf, (params, batch), SCORE_CALLS)
    loss = run["out"][0]
    ms = float(np.median(run["ms"]))
    t1 = time.perf_counter()
    busy = device_busy_ms(lambda: sf(params, batch))
    wall = (time.perf_counter() - t1) * 1e3
    tokens = SCORE_BATCH[0] * SCORE_BATCH[1]
    print(f"{tag}: loss={float(loss):.6f} call_ms={ms:.2f} (median of "
          f"{[round(t, 2) for t in run['ms']]}) tokens_per_s={tokens / ms * 1e3:.1f} "
          f"peak_mem_gb={run['peak'] / 2**30:.2f} "
          f"stitched_launches={sum(run['counts'].values())} "
          f"hand_launches={run['hand']}")
    print(f"{tag} call device busy: {busy} ms of {wall:.2f} ms wall (profiled)")
    if loss.shape != () or not bool(torch.isfinite(loss)) or float(loss) <= 0:
        fail(f"{tag} loss malformed: {loss}")
    if sf.report()["calls"]["fallback"]:
        fail(f"{tag} fell back to eager")
    per_call, _ = expected_launches(cfg, SCORE_BATCH[1])
    want = {k: v * SCORE_CALLS for k, v in per_call.items()}
    if run["hand"] != want:
        fail(f"{tag}: {SCORE_CALLS} calls launched {run['hand']}, expected {want}")
    res = group_inputs(sf.compiled, spec_inputs(sf, (params, batch)))
    kernels = stitched_rows([("scoring call", res)], run, tag, checked)
    hand = hand_rows([("scoring call", res, SCORE_CALLS, run["hand_sig"])],
                     tag)
    kernels += hand
    del res
    for r in hand:
        print(f"{tag} {r['name']} per launch: " + " ".join(
            f"{k}={r[k] * 1e3:.2f}us" for k in ("ms", "device_ms", "plain_ms",
                                               "bound_ms", "library_ms",
                                               "library_device_ms")
            if r[k] is not None) + f" bound_term={r['bound_term']}")
    plan = sf.report()["plan"]
    print(f"score plan {tag}: " + json.dumps({
        "n_ops": plan["n_ops"], "n_kernels": plan["n_kernels"],
        "triton_groups": plan["triton_groups"],
        "torch_groups": plan["torch_groups"], "op_groups": plan["op_groups"],
        "ilp": plan["ilp_method"],
        "compile_s": round(plan["compile_seconds"] + plan["trace_seconds"], 2),
        "call_ms": round(ms, 2), "tokens_per_s": round(tokens / ms * 1e3, 1),
        "device_busy_ms": busy, "peak_mem_gb": round(run["peak"] / 2**30, 2)}))

    btag = f"{name} block"
    lp, x = block_params(model, params), block_input(cfg, SEED, dev)
    bf = stitched_call(btag, model.block_fn, (lp, x), dev)
    brun = measured_calls(bf, (lp, x), BLOCK_CALLS)
    print(f"{btag}: call_ms={float(np.median(brun['ms'])):.2f} (median of "
          f"{[round(t, 2) for t in brun['ms']]}) hand_launches={brun['hand']}")
    want = {k: v * BLOCK_CALLS for k, v in block_launches(cfg).items()}
    if brun["hand"] != want:
        fail(f"{btag}: {BLOCK_CALLS} calls launched {brun['hand']}, expected "
             f"{want}")
    bres = group_inputs(bf.compiled, spec_inputs(bf, (lp, x)))
    kernels += stitched_rows([("block call", bres)], brun, btag,
                             checked)
    kernels += hand_rows([("block call", bres, BLOCK_CALLS, brun["hand_sig"])],
                         btag)
    del bres, brun, run

    from repro_torch.kernels import flash_attention
    readings = {"loss": [], "block": []}
    flash_rows, plain_rows = [], []
    plain_tol = HYBRID_PLAIN_TOL if name == "hybrid" else None
    for s in range(LOGIT_SEEDS):
        if s:
            # the old weights go first: two full-width f32 copies do not
            # fit beside the activations
            params = lp = None
            torch.cuda.empty_cache()
            params = model.init(SEED + s, dev)
            lp = block_params(model, params)
        b, xs = score_batch(cfg, SEED + s, dev), block_input(cfg, SEED + s, dev)
        launches = []
        with recorded_flash(launches), KernelsVsPlain() as vs_plain:
            st = float(sf(params, b)[0])
        ea = float(model.train_forward(params, b)[0])
        readings["loss"].append(abs(st - ea) / abs(ea))
        readings["block"].append(rel_diff(bf(lp, xs).float(),
                                          model.block_fn(lp, xs).float()))
        print(f"{tag} bf16 vs ref-mode eager ({cfg.n_layers}L, seed "
              f"{SEED + s}): loss {st:.6f} vs {ea:.6f} rel={readings['loss'][-1]:.6g} "
              f"block_fn rel={readings['block'][-1]:.6g}")
        if plain_tol is not None:
            plain_rows.append(plain_share(vs_plain, per_call))
            print(f"{tag} bf16 hand kernels vs their plain versions on the "
                  f"call's operands (seed {SEED + s}): largest share of "
                  f"outputs off a launch {plain_rows[-1]:.6g}, by kernel "
                  + " ".join(f"{k}={v:.4g}"
                             for k, v in sorted(vs_plain.share.items())))
        if launches:
            rows = flash_against_f64(launches, {
                v: functools.partial(flash_attention._launch_variant, v)
                for v in ("sm90", "simt")})
            del launches
            flash_rows += rows
            print(f"{tag} bf16 flash vs f64 (seed {SEED + s}, {len(rows)} "
                  f"launches): worst max err / max |f64|, share off f64 in "
                  f"bf16: " + " ".join(
                      f"{v}={max(r[v][0] for r in rows):.4g}/"
                      f"{max(r[v][1] for r in rows):.4g}"
                      for v in ("sm90", "simt"))
                  + "; launches where sm90's share exceeds simt's: "
                  + str(sum(r["sm90"][1] > r["simt"][1] for r in rows)))
    print(f"{tag} bf16: tol={tol} sound max loss="
          f"{max(readings['loss']):.6g} block={max(readings['block']):.6g}")
    if not all(np.isfinite(r) and r <= tol[what]
               for what, rs in readings.items() for r in rs):
        fail(f"{tag} bf16 readings disagree with the ref-mode eager model")
    if plain_tol is not None:
        print(f"{tag} bf16 hand kernels vs plain versions: tol={plain_tol} "
              f"max={max(plain_rows):.6g}")
        if not all(r <= plain_tol for r in plain_rows):
            fail(f"{tag} bf16: the hand-written kernels disagree with their "
                 f"plain versions on the same plan")
    worse = sum(r["sm90"][1] > r["simt"][1] for r in flash_rows)
    if worse:
        fail(f"{tag}: the Hopper flash kernel is off the f64 attention on more "
             f"outputs than the CUDA-core kernel at {worse} of "
             f"{len(flash_rows)} launches")
    return kernels


def attn_block(model, params, x):
    """A hybrid model's first attention block (``params["supers"][0]
    ["l2"]``) on ``x``, eagerly in the current kernel mode: the flash
    kernel's output per element."""
    from repro_torch.models import griffin
    B, S, _ = x.shape
    pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    return griffin._attn_block(params["supers"][0]["l2"], x, model.cfg, pos)


def attention_f64(qt, kt, vt, scale, causal=True, window=None, q_offset=0):
    """The flash kernels' function in f64 (masked scores -1e30)."""
    B, Hq, Lq, Dh = qt.shape
    Hkv, Lkv = kt.shape[1], kt.shape[2]
    g = Hq // Hkv
    q = qt.double().reshape(B, Hkv, g, Lq, Dh)
    s = torch.einsum("bhgqd,bhkd->bhgqk", q, kt.double()) * scale
    qpos = q_offset + torch.arange(Lq, device=qt.device)[:, None]
    kpos = torch.arange(Lkv, device=qt.device)[None, :]
    valid = torch.ones(Lq, Lkv, dtype=torch.bool, device=qt.device)
    if causal:
        valid &= qpos >= kpos
    if window is not None:
        valid &= qpos - kpos < window
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    o = torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(s, -1), vt.double())
    return o.reshape(B, Hq, Lq, Dh)


@contextlib.contextmanager
def recorded_flash(into: list):
    """Append every flash launch's operands (copies, their strides kept)
    and arguments to ``into`` while the block runs."""
    from repro_torch.kernels import flash_attention
    launch = flash_attention._launch_variant

    def record(variant, qt, kt, vt, *rest):
        into.append((qt.clone(), kt.clone(), vt.clone(), *rest))
        return launch(variant, qt, kt, vt, *rest)

    flash_attention._launch_variant = record
    try:
        yield into
    finally:
        flash_attention._launch_variant = launch


def flash_against_f64(launches, kernels: dict) -> list:
    """Each recorded flash launch run on each of ``kernels`` (name: a
    function of the launch's operands and arguments) and held against
    ``attention_f64``: per launch ``{name: (max |out - f64| / max |f64|,
    the share of outputs that are not the f64 value rounded to bf16)}``."""
    rows = []
    for qt, kt, vt, *rest in launches:
        ref = attention_f64(qt, kt, vt, *rest)
        ref_bf16, top = ref.to(torch.bfloat16), float(ref.abs().max())
        rows.append({})
        for name, fn in kernels.items():
            o = fn(qt, kt, vt, *rest)
            rows[-1][name] = (float((o.double() - ref).abs().max()) / top,
                              float((o != ref_bf16).double().mean()))
    return rows


def attn_block_launches(cfg) -> dict:
    """Hand-written kernel launches of ``attn_block`` in kernel mode at a
    length that is a multiple of 128."""
    zero = {name: 0 for name, *_ in HAND.values()}
    if cfg.family != "hybrid":
        return zero
    return dict(zero, rmsnorm=2, rope=2, flash_attention=1, glu=1)


def scoring_f32(dev, arch, name, shape, faults):
    """``arch`` at full width, cut to 4 layers, in float32, on ``shape``
    tokens, against the eager ref-mode model over several weight seeds: the
    kernel-mode scoring loss and first block's output (stitched), and, for
    a hybrid, its first attention block's output (kernel mode, eagerly: the
    loss is a mean over every token, and a fault in a few rows' attention
    moves it little); then the same with each fault of ``faults`` planted,
    ``(kernel module, FAULTS key, the reading that must see it, what the
    fault is)``."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    cfg = replace(get_config(arch), n_layers=4, dtype="float32")
    model = build_model(cfg)
    params = model.init(SEED, dev)
    sf = bf = None
    tag = f"{name} 4-layer f32"
    readings, measure0 = [], None
    for s in range(F32_SEEDS):
        if s:
            params = model.init(SEED + s, dev)
        b = score_batch(cfg, SEED + 1 + s, dev, shape)
        x = block_input(cfg, SEED + 1 + s, dev, shape)
        lp = block_params(model, params)
        if sf is None:
            sf = stitched_call(f"{tag} score", model.train_forward,
                               (params, b), dev)
            bf = stitched_call(f"{tag} block", model.block_fn, (lp, x), dev)
            ops.reset_launch_counts()
        ea, ey = float(model.train_forward(params, b)[0]), model.block_fn(lp, x)
        hybrid = cfg.family == "hybrid"
        eat = attn_block(model, params, x) if hybrid else None

        def measure(params=params, b=b, x=x, ea=ea, ey=ey, eat=eat):
            out = {"loss": abs(float(sf(params, b)[0]) - ea) / abs(ea),
                   "block": rel_diff(bf(block_params(model, params), x), ey)}
            if eat is not None:
                with ops.kernel_mode("kernels"):
                    out["attn"] = rel_diff(attn_block(model, params, x), eat)
            return out

        readings.append(measure())
        print(f"{tag} kernel mode vs eager (seed {SEED + s}, {shape[0]} x "
              f"{shape[1]} tokens): " + " ".join(
                  f"{k} rel={v:.6g}" for k, v in readings[-1].items()))
        if s == 0:
            measure0 = measure
    # one scoring call, one block call and one attention block a seed
    per_call, _ = expected_launches(cfg, shape[1])
    want = {k: F32_SEEDS * (v + block_launches(cfg)[k]
                            + attn_block_launches(cfg)[k])
            for k, v in per_call.items()}
    if ops.launch_counts() != want:
        fail(f"{tag} launched {ops.launch_counts()}, expected {want}")
    variant_gate(tag)
    planted = {}
    for mod, fault, _, _ in faults:
        mod._lib()
        sound_lib, mod._LIB = mod._LIB, faulted_library(mod, fault)
        try:
            planted[fault] = measure0()
        finally:
            mod._LIB = sound_lib
    sound = {k: max(r[k] for r in readings) for k in readings[0]}
    print(f"{tag}: tol={F32_LOGIT_TOL} sound max " + " ".join(
        f"{k}={v:.6g}" for k, v in sound.items()) + "; " + "; ".join(
        f"planted {fault} ({what}) " + " ".join(
            f"{k}={v:.6g}" for k, v in planted[fault].items())
        for _, fault, _, what in faults))
    if not all(v <= F32_LOGIT_TOL for v in sound.values()):
        fail(f"{tag} kernel-mode readings disagree with eager")
    for _, fault, reading, _ in faults:
        if not planted[fault][reading] > F32_LOGIT_TOL:
            fail(f"the f32 {reading} check missed the planted {fault} fault")


NEMOTRON_ARCH = "nemotron-4-15b"
# the dense LayerNorm phase (32 layers, bf16 params and compute): kernel mode
# against the eager ref-mode engine at the long prompts, prefill (last true
# position) and first decode step, as rel_diff; the same rounding noise as
# the qwen3 long phase (the stitched plan computes the dots in f32 where
# eager rounds them to bf16), over 32 layers.  Readings over 3 seeds on an
# H100: prefill 0.0164 to 0.0195, first step 0.0192 to 0.0219 (argmax
# agreement 1.0); each limit is 1.35x its largest reading, rounded up.  The
# float32 check (nemotron_f32) is the tight gate.
NEMOTRON_LOGIT_TOL = {"prefill": 0.027, "decode": 0.030}


def seed_norms(params, seed: int) -> None:
    """Every norm's g to ``1 + 0.1 N(0, 1)`` and b to ``0.1 N(0, 1)``, from
    ``seed``, in place: random init makes them 1 and 0, where a LayerNorm
    that dropped either would still be right."""
    norms = [lp[k] for lp in params["layers"] for k in ("norm1", "norm2")]
    gen = torch.Generator(device=params["final_norm"]["g"].device)
    gen.manual_seed(seed)
    for p in norms + [params["final_norm"]]:
        for k, mean in (("g", 1.0), ("b", 0.0)):
            t = p[k]
            p[k] = (mean + 0.1 * torch.randn(t.shape, generator=gen,
                                             device=t.device)).to(t.dtype)


def nemotron_phase(dev, checked):
    """Full-width nemotron-4-15b (32 layers, bf16 parameters: 62.5 GB in
    f32 would not leave the plans room on one card; random weights and
    seeded norms) served in kernel mode at the long prompts
    (``serve_kernel_mode``: LayerNorm twice a layer and at the end, squared
    ReLU once a layer, beside RoPE, flash and decode attention at a GQA
    group of 6); then its bf16 prefill and first-step logits against the
    eager ref-mode engine over several weight seeds, the old weights freed
    before the next seed's are made."""
    from dataclasses import replace
    from torch.utils._pytree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig
    cfg = replace(get_config(NEMOTRON_ARCH), param_dtype="bfloat16")
    model = build_model(cfg)
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(SEED, dev)
    seed_norms(params, SEED)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"init {cfg.name}: {cfg.n_layers}L d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} head_dim={cfg.dh} "
          f"d_ff={cfg.d_ff} act={cfg.act} norm={cfg.norm} vocab={cfg.vocab} "
          f"params={n / 1e9:.4f}B ({n * 2 / 1e9:.2f} GB bf16, "
          f"{n * 4 / 1e9:.2f} GB in f32; ModelConfig.param_count "
          f"{cfg.param_count() / 1e9:.4f}B) in {time.perf_counter() - t0:.1f}s; "
          f"device memory allocated before init {before / 2**30:.2f} GB, "
          f"after {torch.cuda.memory_allocated() / 2**30:.2f} GB")
    tag = "nemotron kernel-mode long"
    prompts = prompts_for(cfg, LONG_LENS, SEED)
    eng, kernels, summary = serve_kernel_mode(
        dev, model, params, LONG_LENS, prompts, LONG_MAX_LEN, tag, checked)
    eager = Engine(model, params, ServeConfig(batch=4, max_len=LONG_MAX_LEN,
                                              max_new_tokens=2), device=dev)
    readings = {"prefill": [], "decode": []}
    for s in range(LOGIT_SEEDS):
        if s:
            # the old weights go first: two bf16 copies are 62.6 GB
            eng.params = eager.params = params = None
            gc.collect()
            torch.cuda.empty_cache()
            params = model.init(SEED + s, dev)
            seed_norms(params, SEED + s)
            eng.params = eager.params = params
        ps = prompts_for(cfg, LONG_LENS, SEED + s)
        with ops.kernel_mode("kernels"):
            km = prefill_and_step_logits(eng, ps, LONG_LENS)
        ea = prefill_and_step_logits(eager, ps, LONG_LENS)
        record_logits(tag, cfg, SEED + s, km, ea, readings,
                      NEMOTRON_LOGIT_TOL["prefill"])
    print(f"{tag} logits bf16: tol={NEMOTRON_LOGIT_TOL} sound max prefill="
          f"{max(readings['prefill']):.6g} decode={max(readings['decode']):.6g}")
    if not all(np.isfinite(r) and r <= NEMOTRON_LOGIT_TOL[what]
               for what, rs in readings.items() for r in rs):
        fail(f"{tag} logits disagree with the ref-mode eager engine")
    return kernels, summary


def faulted_triton(fault):
    """The Triton kernel with ``fault`` planted (``TRITON_FAULTS``), from
    the source the build phase wrote into ``fault_dir(fault)``, jitted."""
    import importlib.util
    from repro_torch.kernels import build
    fn = TRITON_FAULTS[fault][1]
    spec = importlib.util.spec_from_file_location(
        f"planted_{fault}", fault_dir(fault) / f"{fn}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return build.triton_jit(getattr(mod, fn))


@contextlib.contextmanager
def planted_triton(fault):
    """The Triton kernel of ``fault`` swapped for its planted copy
    (``faulted_triton``) in its module, the sound one restored after."""
    import importlib
    stem, fn, _, _ = TRITON_FAULTS[fault]
    mod = importlib.import_module(f"repro_torch.kernels.{stem}")
    attr = TRITON_JIT[fn]
    sound = getattr(mod, attr)
    setattr(mod, attr, faulted_triton(fault))
    try:
        yield
    finally:
        setattr(mod, attr, sound)


@contextlib.contextmanager
def planted_fault(fault):
    """``fault`` planted while the block runs: a ``FAULTS`` one by its
    CUDA library (``faulted_library``) in place of the sound one of the
    kernel module of the same name, a ``TRITON_FAULTS`` one by
    ``planted_triton``."""
    if fault not in FAULTS:
        with planted_triton(fault):
            yield
        return
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{FAULTS[fault][0]}")
    mod._lib()
    sound = mod._LIB
    mod._LIB = faulted_library(mod, fault)
    try:
        yield
    finally:
        mod._LIB = sound


# the faults the nemotron f32 check plants: LayerNorm's (CUDA) and squared
# ReLU's (Triton)
NEMOTRON_FAULTS = ("layernorm_no_beta", "sqrelu_square_first")


def nemotron_f32(dev):
    """nemotron-4-15b at full width, cut to 4 layers, in float32 (params
    too), norms seeded: the kernel-mode prefill at the 256 bucket and its
    first decode step against the eager ref-mode engine over several weight
    seeds; at the first seed, the same with each of its faults
    (``NEMOTRON_FAULTS``) planted."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.core import StitchCompiler
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig
    cfg = replace(get_config(NEMOTRON_ARCH), n_layers=4, dtype="float32")
    model = build_model(cfg)
    long = dict(batch=4, max_len=LONG_MAX_LEN, max_new_tokens=2)
    km = eager = None
    tag = "nemotron 4-layer f32 kernel-mode bucket 256"
    readings, planted = [], {}
    ops.reset_launch_counts()
    for s in range(F32_SEEDS):
        if km is not None:
            km.params = eager.params = None
            gc.collect()
            torch.cuda.empty_cache()
        params = model.init(SEED + s, dev)
        seed_norms(params, SEED + s)
        if km is None:
            km = Engine(model, params, ServeConfig(**long, stitch_execute=True),
                        device=dev, compiler=StitchCompiler(plan_budget=10.0))
            eager = Engine(model, params, ServeConfig(**long), device=dev)
        km.params = eager.params = params
        ps = prompts_for(cfg, LONG_LENS, SEED + 1 + s)
        ea = prefill_and_step_logits(eager, ps, LONG_LENS)
        with ops.kernel_mode("kernels"):
            kl = prefill_and_step_logits(km, ps, LONG_LENS)
        readings.append([rel_diff(a, b) for a, b in zip(kl, ea)])
        print(f"{tag} vs eager (seed {SEED + s}): prefill "
              f"rel={readings[-1][0]:.6g} decode rel={readings[-1][1]:.6g}")
        if s:
            continue
        # per seed two prefills and one decode step (prefill_and_step_logits)
        step, prefill = expected_launches(cfg, 256)
        want = {k: 2 * prefill[k] + step[k] for k in step}
        if ops.launch_counts() != want:
            fail(f"{tag} launched {ops.launch_counts()}, expected {want}")
        variant_gate(tag)
        for fault in NEMOTRON_FAULTS:
            with planted_fault(fault), ops.kernel_mode("kernels"):
                planted[fault] = [rel_diff(a, b) for a, b in zip(
                    prefill_and_step_logits(km, ps, LONG_LENS), ea)]
    print(f"{tag} logits: tol={F32_LOGIT_TOL} sound max prefill="
          f"{max(r[0] for r in readings):.6g} decode="
          f"{max(r[1] for r in readings):.6g}; " + "; ".join(
              f"planted {fault} prefill={v[0]:.6g} decode={v[1]:.6g}"
              for fault, v in planted.items()))
    if not all(r <= F32_LOGIT_TOL for rs in readings for r in rs):
        fail(f"{tag} logits disagree with eager")
    for fault, v in planted.items():
        if not min(v) > F32_LOGIT_TOL:
            fail(f"the f32 logit check missed the planted {fault} fault")


# ---------------------------------------------------------------------------
# phase 9: the kernel API through stitch() at qwen3-1.7b's widths
# ---------------------------------------------------------------------------

def seam_loss(x, res, gamma, w_out, labels):
    """The residual seam and the LM-head loss of a scoring harness:
    ``rmsnorm_residual`` on x, res (B, S, d), the LM-head GEMM (a plain
    ``torch.matmul``) and ``cross_entropy`` over the (B * S, V) logits.
    Returns (the mean NLL, the new residual)."""
    from repro_torch.kernels import ops
    h, new_res = ops.rmsnorm_residual(x, res, gamma, 1e-6)
    logits = h.reshape(-1, h.shape[-1]) @ w_out
    return ops.cross_entropy(logits, labels), new_res


def masked_attention(q, k, v, mask):
    """GQA attention through the kernel API's masked softmax (the paper's
    Fig. 5(c) pattern): the scores of q (B, L, Hq, Dh) against k repeated
    to Hq heads, ``softmax(s * Dh**-0.5)`` where ``mask`` (B, 1, L, L) is
    True, then the product with v; the reference oracle's einsum chain."""
    from repro_torch.kernels import ops
    group = q.shape[2] // k.shape[2]
    kr = torch.repeat_interleave(k, group, dim=2)
    vr = torch.repeat_interleave(v, group, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kr)
    p = ops.softmax(s, q.shape[-1] ** -0.5, mask)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr)


def padding_mask(lens, L, device=None):
    """(B, 1, L, L) bool: causal, key < len[b] and query < len[b]; the
    query rows past a prompt's length are fully masked."""
    lens = torch.as_tensor(lens, device=device)[:, None, None, None]
    qp = torch.arange(L, device=device)[:, None]
    kp = torch.arange(L, device=device)[None, :]
    return (qp >= kp) & (kp < lens) & (qp < lens)


def vocab_probs(logits):
    """A temperature-0.7 distribution over full vocabulary rows."""
    from repro_torch.kernels import ops
    return ops.softmax(logits, 1 / 0.7)


API_ARCH = "qwen3-1.7b"
API_CALLS = 5             # measured calls of each path function
# each path function and its hand-written kernel launches a call
API_PATHS = {
    "seam": (seam_loss, {"rmsnorm_residual": 1, "cross_entropy": 1}),
    "attention": (masked_attention, {"softmax_masked": 1}),
    "vocab": (vocab_probs, {"softmax": 1}),
}
# the phase in bf16: the stitched kernel-mode outputs against the same
# functions run eagerly in ref mode, as rel_diff (the loss as |diff| /
# |eager loss|; the attention on the query rows that are not fully masked,
# whose eager rows are NaN by the reference's definition).  The new
# residual (x + res rounded once) must be equal.  Both sides run the same
# GEMMs on the same bf16 operands; the kernels differ from the oracles only
# in the order of f32 sums and in bf16 roundings of a few outputs.
# Readings over 3 seeds on an H100: seam loss 0, 0 and 3.07e-7 (4 f32 ulps
# of a loss of 12.4), attention 5.1e-4 to 8.5e-4, vocabulary rows 0 to
# 9.8e-5; each limit is about 1.35x the largest, rounded up.
API_TOL = {"seam loss": 4.2e-7, "attention": 1.2e-3, "vocab": 1.4e-4}
# planted faults of the f32 check: the path and reading each must move
API_FAULTS = {"residual_normalises_x": "seam loss",
              "xent_no_rescale": "seam loss",
              "softmax_mask_ignored": "attention",
              "softmax_split_no_rescale": "vocab"}


def api_inputs(cfg, dtype, seed, dev) -> dict:
    """Each path function's operands at ``cfg``'s widths, from ``seed``:
    x, res (4, 256, d) and a seeded gamma; the LM head (d, V) at a scale
    that makes unit logits; int32 labels; q (4, 256, Hq, Dh), k and v
    (4, 256, Hkv, Dh) and the long prompts' padding mask; (4, V) logits."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    B, L = len(LONG_LENS), int(LONG_LENS.max())
    d, V = cfg.d_model, cfg.vocab

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=dev)).to(dtype)

    return {
        "seam": (rnd(B, L, d), rnd(B, L, d), 1.0 + rnd(d, scale=0.1),
                 rnd(d, V, scale=d ** -0.5),
                 torch.randint(0, V, (B * L,), generator=gen, device=dev,
                               dtype=torch.int32)),
        "attention": (rnd(B, L, cfg.n_heads, cfg.dh),
                      rnd(B, L, cfg.n_kv_heads, cfg.dh),
                      rnd(B, L, cfg.n_kv_heads, cfg.dh),
                      padding_mask(LONG_LENS, L, dev)),
        "vocab": (rnd(B, V, scale=2.0),),
    }


def api_readings(path, args, st, ea) -> dict:
    """The stitched kernel-mode outputs ``st`` against the eager ref-mode
    ``ea`` of one path; fails on a malformed output, a new residual that
    differs, or a fully masked query row that is not exactly 0."""
    if path == "seam":
        (loss, res), (eloss, eres) = st, ea
        if loss.shape != () or not bool(torch.isfinite(loss)) or float(loss) <= 0:
            fail(f"kernel-api seam loss malformed: {loss}")
        if not torch.equal(res, eres):
            fail("kernel-api seam: the new residual differs from x + res")
        return {"seam loss": abs(float(loss) - float(eloss)) / abs(float(eloss))}
    if path == "attention":
        q, mask = args[0], args[3]
        rows = mask[:, 0].any(-1)                   # (B, L) query rows kept
        if st.shape != q.shape or not bool(torch.isfinite(st).all()):
            fail("kernel-api attention output malformed")
        if not bool((st[~rows] == 0).all()):
            fail("kernel-api attention: a fully masked query row is not 0")
        return {"attention": rel_diff(st[rows].float(), ea[rows].float())}
    if st.shape != args[0].shape or not bool(torch.isfinite(st).all()):
        fail("kernel-api vocab probabilities malformed")
    return {"vocab": rel_diff(st.float(), ea.float())}


def api_stitched(dtype, dev) -> dict:
    """Each path function through ``stitch()`` in kernel mode, traced and
    planned at qwen3-1.7b's widths in ``dtype`` (first call timed)."""
    from repro_torch.configs import get_config
    inputs = api_inputs(get_config(API_ARCH), dtype, SEED, dev)
    t = str(dtype).replace("torch.", "")
    return {path: stitched_call(f"kernel-api {path} {t}", fn, inputs[path], dev)
            for path, (fn, _) in API_PATHS.items()}


def kernel_api_phase(dev, checked):
    """The kernel API through ``stitch()`` in kernel mode at qwen3-1.7b's
    widths, bf16: the residual seam with the LM-head loss (x, res (4, 256,
    2048), LM head (2048, 151936)), masked GQA attention over the long
    prompts (scores (4, 16, 256, 256)) and a softmax over (4, 151936)
    vocabulary rows.  Per path: exactly its kernels' launches a call (and
    no other hand-written kernel), every kernel of the path against its
    plain version on the path's operands and timed, the plan; then its
    outputs against the eager ref-mode function over several seeds."""
    from repro_torch.configs import get_config
    cfg = get_config(API_ARCH)
    inputs = api_inputs(cfg, torch.bfloat16, SEED, dev)
    fns = api_stitched(torch.bfloat16, dev)
    rows = []
    for path, (fn, per_call) in API_PATHS.items():
        tag, sf, args = f"kernel-api {path}", fns[path], inputs[path]
        run = measured_calls(sf, args, API_CALLS)
        want = {name: per_call.get(name, 0) * API_CALLS
                for name, *_ in HAND.values()}
        ms = float(np.median(run["ms"]))
        print(f"{tag}: call_ms={ms:.3f} (median of "
              f"{[round(t, 3) for t in run['ms']]}) "
              f"peak_mem_gb={run['peak'] / 2**30:.2f} "
              f"stitched_launches={sum(run['counts'].values())} "
              f"hand_launches={ {k: v for k, v in run['hand'].items() if v} }")
        if run["hand"] != want:
            fail(f"{tag}: {API_CALLS} calls launched {run['hand']}, expected "
                 f"{want}")
        if sf.report()["calls"]["fallback"]:
            fail(f"{tag} fell back to eager")
        api_readings(path, args, run["out"], fn(*args))
        res = group_inputs(sf.compiled, spec_inputs(sf, args))
        rows += stitched_rows([("call", res)], run, tag, checked)
        hand = hand_rows([("call", res, API_CALLS, run["hand_sig"])], tag)
        rows += hand
        del res
        for r in hand:
            print(f"{tag} {r['name']} per launch: " + " ".join(
                f"{k}={r[k] * 1e3:.2f}us" for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms",
                    "bound_all_bytes_ms", "library_ms", "library_device_ms",
                    "old_ms", "old_device_ms") if r.get(k) is not None)
                + f" bound_term={r['bound_term']}")
        plan = sf.report()["plan"]
        print(f"plan {tag}: " + json.dumps({
            "n_ops": plan["n_ops"], "n_kernels": plan["n_kernels"],
            "triton_groups": plan["triton_groups"],
            "torch_groups": plan["torch_groups"], "op_groups": plan["op_groups"],
            "groups": sorted(len(g.members) for g in sf.compiled.groups),
            "compile_s": round(plan["compile_seconds"] + plan["trace_seconds"], 2),
            "call_ms": round(ms, 3)}))
    readings = {k: [] for k in API_TOL}
    for s in range(LOGIT_SEEDS):
        if s:
            inputs = api_inputs(cfg, torch.bfloat16, SEED + s, dev)
        for path, (fn, _) in API_PATHS.items():
            args = inputs[path]
            for k, v in api_readings(path, args, fns[path](*args),
                                     fn(*args)).items():
                readings[k].append(v)
        print(f"kernel-api bf16 vs ref-mode eager (seed {SEED + s}): " + " ".join(
            f"{k}={v[-1]:.6g}" for k, v in readings.items()))
    print(f"kernel-api bf16: tol={API_TOL} sound max " + " ".join(
        f"{k}={max(v):.6g}" for k, v in readings.items()))
    if not all(np.isfinite(r) and r <= API_TOL[k]
               for k, rs in readings.items() for r in rs):
        fail("kernel-api bf16 outputs disagree with the ref-mode eager ones")
    del fns, inputs
    kernel_api_f32(dev)
    return rows


def kernel_api_f32(dev):
    """The three path functions in float32 at the same full widths (they
    are shallow: nothing to cut), stitched in kernel mode against eager ref
    mode over several seeds, limit ``F32_LOGIT_TOL``; at the first seed,
    the same with each of ``API_FAULTS`` planted, which must read above
    it."""
    from repro_torch.configs import get_config
    cfg = get_config(API_ARCH)
    fns = api_stitched(torch.float32, dev)
    readings, planted = {k: [] for k in API_TOL}, {}
    for s in range(F32_SEEDS):
        inputs = api_inputs(cfg, torch.float32, SEED + s, dev)
        eager = {path: fn(*inputs[path]) for path, (fn, _) in API_PATHS.items()}
        for path in API_PATHS:
            for k, v in api_readings(path, inputs[path],
                                     fns[path](*inputs[path]),
                                     eager[path]).items():
                readings[k].append(v)
        if s:
            continue
        for fault, what in API_FAULTS.items():
            path = what.split(" ")[0]
            with planted_fault(fault):
                out = fns[path](*inputs[path])
            if path == "seam":
                # the planted residual fault leaves the residual sound
                planted[fault] = abs(float(out[0]) - float(eager[path][0])) \
                    / abs(float(eager[path][0]))
            elif path == "attention":
                keep = inputs[path][3][:, 0].any(-1)
                planted[fault] = rel_diff(out[keep].float(),
                                          eager[path][keep].float())
            else:
                planted[fault] = rel_diff(out.float(), eager[path].float())
    print(f"kernel-api f32 vs ref-mode eager: tol={F32_LOGIT_TOL} sound max "
          + " ".join(f"{k}={max(v):.6g}" for k, v in readings.items()) + "; "
          + " ".join(f"planted {f} {API_FAULTS[f]}={v:.6g}"
                     for f, v in planted.items()))
    if not all(r <= F32_LOGIT_TOL for rs in readings.values() for r in rs):
        fail("kernel-api f32 outputs disagree with the ref-mode eager ones")
    for fault, v in planted.items():
        if not v > F32_LOGIT_TOL:
            fail(f"the kernel-api f32 check missed the planted {fault} fault")


def prompts_for(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    prompts = np.zeros((len(lens), int(lens.max())), np.int64)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(0, cfg.vocab, n)
    return prompts


def first_step_logits(e, prompts, lens):
    """Prefill, insert every row, one decode step: its logits (f32).  The
    step decodes each row's first prompt token, not the engine's own greedy
    token, so two engines' steps are compared on one input: where the top
    two prefill logits of a row are a near tie, rounding noise flips the
    greedy token, and the two steps would then decode different tokens."""
    p = e.prefill(prompts, prompt_lens=lens)
    for row in range(len(lens)):
        e.insert(p, slot=row, row=row)
    e._tok[:len(lens), 0] = np.asarray(prompts)[:, 0]
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


def argmax_ties(tag, a, b, tol) -> int:
    """The rows whose argmax differs between logits ``a`` and ``b``; each
    must be a near tie of ``b``'s top two, their gap within 2 tol max|b|
    (the noise the limit allows can move each of the two by tol max|b|).
    Fails on a flip that is no near tie; returns the number of flips."""
    flip = a.argmax(-1) != b.argmax(-1)
    top2 = b.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    bad = flip & (gap > 2 * tol * b.abs().max())
    if bool(bad.any()):
        fail(f"{tag}: the argmax differs on {int(bad.sum())} rows whose top "
             f"two logits are no near tie (gaps {gap[bad].tolist()})")
    return int(flip.sum())


def record_logits(tag, cfg, seed, km, ea, readings, prefill_tol):
    """One seed's prefill and first-step logits (``prefill_and_step_logits``)
    against the eager engine's: their rel_diff into ``readings``, the argmax
    agreement printed; a prefill argmax may differ only on a near tie
    (``argmax_ties``)."""
    argmax_ties(f"{tag} prefill, seed {seed}", km[0], ea[0], prefill_tol)
    for what, a, b in zip(("prefill", "decode"), km, ea):
        readings[what].append(rel_diff(a, b))
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        print(f"{tag} {what} logits vs ref-mode eager (bf16, "
              f"{cfg.n_layers}L, seed {seed}): "
              f"rel={readings[what][-1]:.6g} argmax_agree={agree}")


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


def faulted_library(mod, fault):
    """``mod``'s CUDA library with ``fault`` planted (``FAULTS``), built by
    the build phase into ``fault_dir(fault)``."""
    import ctypes
    from repro_torch.kernels import build
    stem = FAULTS[fault][0]
    return mod.bind(ctypes.CDLL(str(build.library(
        stem, src_dir=fault_dir(fault), out_dir=fault_dir(fault)))))


def full_width_f32(dev):
    """qwen3-1.7b at full width, cut to 4 layers, in float32: the stitched
    first decode step, ref mode and kernel mode, against the eager ref-mode
    one over several weight seeds; then faults planted in the stitched
    RMSNorm kernels (ref mode) and in the decode-attention, RoPE, RMSNorm
    and GLU kernels (kernel mode), each of which must read over 100x the
    limit.  Then the kernel-mode prefill at the 256 bucket (the flash
    kernel in every layer) and its first decode step against the eager
    ones, and a fault planted in the flash kernel."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.core import StitchCompiler
    from repro_torch.kernels import activations, decode_attention, norms
    from repro_torch.kernels import flash_attention, ops, rope
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
    planted = {}
    for mod, fault in ((decode_attention, "decode_attention"),
                       (rope, "rope_row_table"),
                       (norms, "rmsnorm_second_rep_raw"),
                       (activations, "glu_no_sigmoid")):
        mod._lib()
        sound_lib, mod._LIB = mod._LIB, faulted_library(mod, fault)
        try:
            with ops.kernel_mode("kernels"):
                planted[fault] = rel_diff(first_step_logits(km, ref0[0], lens),
                                          ref0[1])
        finally:
            mod._LIB = sound_lib
    print(f"full-width 4-layer f32 kernel-mode logits: tol={F32_LOGIT_TOL} "
          f"sound max={max(km_readings):.6g} planted faults (decode attention "
          f"kpos < pos; RoPE rows reading their block's first row's angles; "
          f"RMSNorm's second repetition of columns unnormalised; SwiGLU "
          f"without its sigmoid) "
          + " ".join(f"{k}={v:.6g}" for k, v in planted.items()))
    if not all(r <= F32_LOGIT_TOL for r in km_readings):
        fail("full-width f32 kernel-mode logits disagree with eager")
    for fault, reading in planted.items():
        if not reading > 100 * F32_LOGIT_TOL:
            fail(f"the f32 logit check missed the planted {fault} fault by "
                 f"100x its limit ({reading:.6g})")

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
    variant_gate("4-layer f32 kernel-mode bucket 256")
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
    print(f"bound rates: {HBM_BW:.4g} B/s, f32 {F32_PEAK:.4g} FLOP/s, bf16 "
          f"tensor cores {BF16_PEAK:.4g} FLOP/s, {sfu_rate()[1]}")
    # one rounding per GEMM: f32 accumulation, no TF32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    build_phase()
    launch_floor()
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
    t0 = time.perf_counter()
    ref_model = build_model(dataclasses.replace(cfg, n_layers=REF_LAYERS))
    rows, summaries["ref-mode"] = serve_phase(
        dev, ref_model, ref_model.init(SEED, dev), lens, prompts, checked)
    kernels += rows
    del ref_model
    print(f"ref-mode phase ({REF_LAYERS} of {cfg.n_layers} layers): "
          f"{time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    rows, summaries["kernel-mode"], offline = kernel_mode_phase(
        dev, model, params, lens, prompts, checked)
    kernels += rows
    print(f"kernel-mode phase: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    plan_cache_phase(dev, model, params, lens, prompts, offline)
    del offline
    print(f"plan cache phase: {time.perf_counter() - t0:.1f}s")
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
    torch.cuda.empty_cache()
    for name, arch, tol, layers in (("ssm", SSM_ARCH, SSM_TOL, SSM_LAYERS),
                                    ("hybrid", HYBRID_ARCH, HYBRID_TOL, None)):
        t0 = time.perf_counter()
        kernels += scoring_phase(dev, checked, arch, name, tol, layers)
        # the phase's weights go before the next one's are made
        gc.collect()
        torch.cuda.empty_cache()
        print(f"{name} phase: {time.perf_counter() - t0:.1f}s (device memory "
              f"still allocated {torch.cuda.memory_allocated() / 2**30:.2f} GB)")
    t0 = time.perf_counter()
    rows, summaries["nemotron kernel-mode long"] = nemotron_phase(dev, checked)
    kernels += rows
    gc.collect()
    torch.cuda.empty_cache()
    print(f"nemotron phase: {time.perf_counter() - t0:.1f}s (device memory "
          f"still allocated {torch.cuda.memory_allocated() / 2**30:.2f} GB)")
    t0 = time.perf_counter()
    kernels += kernel_api_phase(dev, checked)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"kernel-api phase: {time.perf_counter() - t0:.1f}s")
    for tag, summary in summaries.items():
        print(f"decode plan {tag}: {json.dumps(summary)}")
    t0 = time.perf_counter()
    full_width_f32(dev)
    moe_f32(dev)
    from repro_torch.kernels import flash_attention, mamba_scan, rg_lru
    scoring_f32(dev, SSM_ARCH, "ssm", SCORE_BATCH, [
        (mamba_scan, "mamba_scan", "block",
         "the scan's state restarts at each chunk")])
    scoring_f32(dev, HYBRID_ARCH, "hybrid", HYBRID_F32_BATCH, [
        (rg_lru, "rg_lru", "block",
         "the RG-LRU's chain restarts h at each chunk"),
        (flash_attention, "flash_window", "attn",
         "flash ignores the window")])
    nemotron_f32(dev)
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
