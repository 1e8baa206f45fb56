"""Kernel generation & tuning — the paper's Alg. 3.

For a fusion pattern: enumerate implementation templates (different
parallelization / scratch / launch trade-offs), run RegisterPlanning and
SharedPlanning (volume + layout constraints; Alg. 4 reuse), generate the
kernel per schedule kind, evaluate, keep the best.

Evaluation is model-based by default (fast, the paper's JIT story) and
execution-based on request: each candidate's generated kernel is timed on
sample inputs on their device (the "optimize once, run many times" offline
path).  :meth:`TemplateTuner.instantiate` rebuilds one recorded choice
without search — the warm path of :mod:`repro_torch.cache`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

from .cost import CostModel, HardwareModel, TPU_V5E
from .ir import Graph, OpKind
from .pattern import FusionPattern
from .scratch import ScratchAllocator, ScratchPlan
from .templates import Attr, Schedule, SubAttr, Template

__all__ = ["TunedKernel", "TemplateTuner", "generate_templates", "grid_row_block"]


def grid_row_block(template: Template) -> int | None:
    """The GRID tiling factor a template was tuned with (None if unfactored)."""
    rb = None
    for s in template:
        for a in s.attrs:
            for lvl in a.levels:
                if lvl.kind == "GRID" and lvl.factor:
                    rb = lvl.factor
    return rb


@dataclass
class TunedKernel:
    pattern: FusionPattern
    template: Template
    scratch_plan: ScratchPlan
    modeled_time: float
    measured_time: float | None = None   # seconds a call, execution-based only
    callable: Callable | None = field(default=None, repr=False)


def _attrs_for_node(node, row_block: int, seq_small_reduce: bool) -> tuple[Attr, ...]:
    """Default per-dimension tiling spec: rows -> GRID_<rb>, then trailing
    dims map minor-most to LANE, second-minor to SUBLANE, others SEQ."""
    rank = max(len(node.shape), 1)
    attrs: list[Attr] = []
    for d in range(rank):
        if d == 0:
            attrs.append(Attr((SubAttr("GRID", row_block),)))
        elif d == rank - 1:
            if (
                seq_small_reduce
                and node.kind is OpKind.REDUCTION
                and node.shape
                and node.shape[-1] < 128
            ):
                attrs.append(Attr((SubAttr("SEQ"),)))
            else:
                attrs.append(Attr((SubAttr("LANE"),)))
        elif d == rank - 2:
            attrs.append(Attr((SubAttr("SUBLANE"),)))
        else:
            attrs.append(Attr((SubAttr("SEQ"),)))
    return tuple(attrs)


def _diagnostic(p: FusionPattern, stage: str, err: Exception) -> dict:
    """Structured record of one StitchInfeasible: which pattern, at which
    tuning stage, and the human-readable reason — surfaced through
    ``FusionStats.diagnostics`` / ``report()["diagnostics"]`` instead of
    being silently swallowed into a fused-torch fallback."""
    members = sorted(n.name for n in p.compute_members)
    return {
        "stage": stage,                  # "analyze" | "build"
        "pattern_class": p.pattern_class,
        "members": members[:8],
        "n_members": len(members),
        "reason": str(err),
    }


def _note_diagnostic(diagnostics: list | None, p: FusionPattern, stage: str,
                     err: Exception, bound: int = 256) -> None:
    from repro_torch import obs

    d = _diagnostic(p, stage, err)
    obs.event("tune.infeasible", cat="compile", **d)
    if diagnostics is None:
        return
    diagnostics.append(d)
    if len(diagnostics) > bound:
        del diagnostics[: len(diagnostics) - bound]


def generate_templates(
    p: FusionPattern, cost: CostModel, max_templates: int = 12,
    diagnostics: list | None = None,
) -> list[Template]:
    """TemplatesGeneration: row-block sweep x scratch-storage choice.

    Scratch choice: heavy-crossing intermediates (the cost model's
    scratch_request set) either all go to on-chip scratch (block composition)
    or stay in registers (thread composition) when small enough; both variants are emitted so
    KernelEvalUpdate can pick.  An infeasible pattern yields no templates;
    when ``diagnostics`` is given the reason is appended to it.
    """
    from repro_torch.kernels.stitched import StitchInfeasible, emission_plan

    try:
        _, ana = emission_plan(p)
    except StitchInfeasible as err:
        _note_diagnostic(diagnostics, p, "analyze", err)
        return []
    req = cost.scratch_request(p)
    templates: list[Template] = []
    scratch_variants = [tuple(sorted(req))] if req else [()]
    if req:
        scratch_variants.append(())  # register-only variant
    for rb in ana.feasible_blocks:
        for scratch in scratch_variants:
            scheds = []
            for node in p.compute_members:
                scheds.append(
                    Schedule(
                        node.name,
                        _attrs_for_node(node, rb, seq_small_reduce=False),
                        scratch=node.name in scratch,
                    )
                )
            templates.append(Template(tuple(scheds)))
            if len(templates) >= max_templates:
                return templates
    return templates


class TemplateTuner:
    """Alg. 3 driver."""

    # keep the diagnostics log bounded: a long-lived serving process tunes
    # many graphs and only the recent tail is useful for debugging
    MAX_DIAGNOSTICS = 256

    def __init__(self, hw: HardwareModel = TPU_V5E, execution_based: bool = False):
        self.hw = hw
        self.cost = CostModel(hw)
        self.execution_based = execution_based
        # structured StitchInfeasible records (see _diagnostic); the compiler
        # snapshots the slice produced by each graph's tuning run into
        # FusionStats.diagnostics
        self.diagnostics: list[dict] = []
        # ScratchAllocator builds a whole-graph post-dominator tree; reuse it
        # across the many (pattern, template) pairs of one graph's tuning run.
        # Keyed by graph identity, invalidated when the graph grows OR its
        # outputs change (mark_output moves the virtual post-dominance sink).
        self._allocators: dict[int, tuple[ScratchAllocator, int, tuple]] = {}

    def _note_infeasible(self, p: FusionPattern, stage: str, err: Exception) -> None:
        _note_diagnostic(self.diagnostics, p, stage, err,
                         bound=self.MAX_DIAGNOSTICS)

    def _allocator(self, g) -> ScratchAllocator:
        hit = self._allocators.get(id(g))
        if (hit is not None and hit[0].g is g and hit[1] == len(g.nodes)
                and hit[2] == tuple(g.outputs)):
            return hit[0]
        if len(self._allocators) > 8:
            self._allocators.clear()
        alloc = ScratchAllocator(g)
        self._allocators[id(g)] = (alloc, len(g.nodes), tuple(g.outputs))
        return alloc

    # -- SharedPlanning -------------------------------------------------------
    def shared_planning(self, p: FusionPattern, template: Template) -> ScratchPlan | None:
        req_all = self.cost.scratch_request(p)
        req = {k: v for k, v in req_all.items() if k in set(template.scratch_ops)}
        plan = self._allocator(p.graph).allocate(req)
        # registered custom-kernel bodies allocate their own scratch inside
        # the composed kernel; it shares the same on-chip volume
        if plan.allocated + self.cost.custom_scratch(p) > self.hw.onchip_budget:
            return None
        return plan

    # -- static validation ----------------------------------------------------
    def validate(self, p: FusionPattern, fn: Callable) -> bool:
        """Static shape check on the emitted kernel: the shapes and dtypes
        the emitter allocates for its outputs must be the graph's.  A
        failing candidate is discarded (callers fall back to a fused-torch
        group, numerics unaffected)."""
        g = p.graph
        shapes = getattr(fn, "out_shapes", None)
        dtypes = getattr(fn, "out_dtypes", None)
        if shapes is None or dtypes is None:
            return False
        want = [(tuple(g[n].shape), str(g[n].dtype)) for n in p.external_outputs]
        return [(tuple(s), str(d)) for s, d in zip(shapes, dtypes)] == want

    # -- KernelEvalUpdate -----------------------------------------------------
    def _modeled(self, p: FusionPattern, rb: int | None) -> float:
        modeled = self.cost.fused_time(p)
        # tiny grid-utilization nudge: prefer sublane-aligned row blocks
        if rb and rb % 8:
            modeled *= 1.05
        return modeled

    def _measure(self, fn: Callable, args: list, repeats: int = 3,
                 inner: int = 10) -> float:
        """Least seconds a call over ``repeats`` rounds of ``inner`` calls,
        after one warm-up call (the kernel's build).  On the card the rounds
        are bracketed by CUDA events on the inputs' device; on the CPU by
        the host clock (the plain version runs there).  ``fn`` is called
        with ``count=False``: these launches are left out of the launch
        counts, so a synchronous compile's tuning does not move what a
        caller counts on its own path."""
        import torch

        dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
                   None)
        fn(*args, count=False)
        best = float("inf")
        if dev is not None and dev.type == "cuda":
            with torch.cuda.device(dev):
                torch.cuda.synchronize(dev)
                for _ in range(repeats):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(inner):
                        fn(*args, count=False)
                    end.record()
                    end.synchronize()
                    best = min(best, start.elapsed_time(end) / 1e3 / inner)
            return best
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(inner):
                fn(*args, count=False)
            best = min(best, (time.perf_counter() - t0) / inner)
        return best

    def tune(self, p: FusionPattern, sample_inputs: list | None = None
             ) -> TunedKernel | None:
        """The best validated candidate: by modeled time, or, with
        ``execution_based`` and ``sample_inputs`` (one tensor per
        ``p.external_inputs``), by measured time."""
        from repro_torch.kernels.stitched import StitchInfeasible, build_stitched_callable

        templates = generate_templates(p, self.cost,
                                       diagnostics=self.diagnostics)
        candidates: list[tuple[float, int, TunedKernel]] = []
        for i, template in enumerate(templates):
            plan = self.shared_planning(p, template)
            if plan is None:
                continue  # infeasible template (paper: skip)
            rb = grid_row_block(template)
            try:
                fn = build_stitched_callable(p, row_block=rb)
            except StitchInfeasible as err:
                self._note_infeasible(p, "build", err)
                continue
            modeled = self._modeled(p, rb)
            measured = None
            if self.execution_based and sample_inputs is not None:
                try:
                    measured = self._measure(fn, sample_inputs)
                except StitchInfeasible as err:
                    # the emitter's refusal skips the candidate; a kernel
                    # that fails to build or launch raises to the caller
                    self._note_infeasible(p, "measure", err)
                    continue
            cand = TunedKernel(p, template, plan, modeled, measured, fn)
            candidates.append((measured if measured is not None else modeled,
                               i, cand))
        # best candidate first; abstract validation runs once per pattern in
        # the common case and only walks down on analysis soundness gaps
        for _key, _i, cand in sorted(candidates, key=lambda t: (t[0], t[1])):
            if self.validate(p, cand.callable):
                return cand
        return None

    # -- plan replay (cache hits) --------------------------------------------
    def instantiate(
        self,
        p: FusionPattern,
        row_block: int | None = None,
        scratch_names=(),
    ) -> TunedKernel | None:
        """Build ONE kernel from a previously tuned ``(row_block, scratch)``
        choice, skipping template enumeration and candidate evaluation.

        This is the warm path of :mod:`repro_torch.cache`: the stored choice
        is re-validated against this pattern's concrete shapes (row blocks
        are clamped to the feasible set; scratch must fit the on-chip
        budget), so a plan recorded at a nearby bucketed shape still
        instantiates soundly or falls back to a fused-torch group (return
        None).  At the recorded shapes it emits the kernel :meth:`tune`
        chose, source for source.
        """
        from repro_torch.kernels.stitched import (
            StitchInfeasible, build_stitched_callable, emission_plan)

        try:
            _, ana = emission_plan(p)
        except StitchInfeasible as err:
            self._note_infeasible(p, "analyze", err)
            return None
        rb = row_block or ana.feasible_blocks[0]
        if rb not in ana.feasible_blocks:
            rb = max((b for b in ana.feasible_blocks if b <= rb),
                     default=ana.feasible_blocks[0])
        member_names = {n.name for n in p.compute_members}
        scratch = {n for n in scratch_names if n in member_names}
        template = Template(tuple(
            Schedule(
                node.name,
                _attrs_for_node(node, rb, seq_small_reduce=False),
                scratch=node.name in scratch,
            )
            for node in p.compute_members
        ))
        plan = self.shared_planning(p, template)
        if plan is None:
            return None
        try:
            fn = build_stitched_callable(p, row_block=rb)
        except StitchInfeasible as err:
            self._note_infeasible(p, "build", err)
            return None
        if not self.validate(p, fn):
            return None
        return TunedKernel(p, template, plan, self._modeled(p, rb), None, fn)
