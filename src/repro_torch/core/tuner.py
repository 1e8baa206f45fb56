"""Kernel generation & tuning — the paper's Alg. 3.

For a fusion pattern: enumerate implementation templates (different
parallelization / scratch / launch trade-offs), run RegisterPlanning and
SharedPlanning (volume + layout constraints; Alg. 4 reuse), generate the
kernel per schedule kind, evaluate, keep the best.

Evaluation is model-based (the paper's JIT story); timing candidates on
sample inputs comes with the plan-cache slice.
"""

from __future__ import annotations

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

    def __init__(self, hw: HardwareModel = TPU_V5E):
        self.hw = hw
        self.cost = CostModel(hw)
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
    def tune(self, p: FusionPattern) -> TunedKernel | None:
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
            modeled = self.cost.fused_time(p)
            # tiny grid-utilization nudge: prefer sublane-aligned row blocks
            if rb and rb % 8:
                modeled *= 1.05
            candidates.append((modeled, i, TunedKernel(p, template, plan,
                                                       modeled, fn)))
        # best candidate first; abstract validation runs once per pattern in
        # the common case and only walks down on analysis soundness gaps
        for _key, _i, cand in sorted(candidates, key=lambda t: (t[0], t[1])):
            if self.validate(p, cand.callable):
                return cand
        return None
