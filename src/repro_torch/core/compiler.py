"""StitchCompiler — the public optimize-and-execute API (paper Fig. 2).

Pipeline:   graph -> pattern generation (§4.2) -> cost scoring (§4.3)
          -> ILP + cycle cuts (§4.1) -> per-group kernel tuning (Alg. 3)
          -> executable.

Three execution modes reproduce the paper's comparison axes:

* ``mode="off"``    — one kernel per op ("TensorFlow" baseline),
* ``mode="xla"``    — XLA-style fusion: connected elementwise/row-reduction
                      chains only, no packing, no gemm stitching,
* ``mode="stitch"`` — full FusionStitching.

The compiled object reports the statistics the paper's tables are built
from: kernel counts per mode (Table 3's compression ratios), modeled step
times (Table 3 speedups), pattern-class composition (Fig. 6), and scratch
allocation statistics (Table 4).
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Mapping

from repro_torch import obs

from .codegen import eval_node, source_value
from .cost import H100, CostModel, HardwareModel
from .fusiongen import GenConfig, generate_patterns
from .ilp import PlanResult, solve_fusion_plan
from .ir import Graph, OpKind
from .pattern import FusionPattern
from .tuner import TemplateTuner, TunedKernel

__all__ = ["StitchCompiler", "CompiledGraph", "FusionStats", "xla_like_groups"]


# ---------------------------------------------------------------------------
# XLA-baseline grouping (thread composition only)
# ---------------------------------------------------------------------------

_XLA_FUSIBLE = {
    OpKind.ELEMENTWISE,
    OpKind.BROADCAST,
    OpKind.RESHAPE,
    OpKind.TRANSPOSE,
    OpKind.SLICE,
}


def xla_like_groups(g: Graph) -> list[frozenset[str]]:
    """Greedy XLA-ish loop fusion: a producer is fused into its consumer when
    the producer is elementwise glue and *all* of its users land in the same
    group (duplication-free single-output fusion); row reductions may root a
    group (input fusion).  No packing of independent ops, no gemm members —
    exactly the capability gap the paper exploits (§1, §7)."""
    group_of: dict[str, int] = {}
    groups: dict[int, set[str]] = {}
    opaque: dict[int, bool] = {}   # group rooted at a non-loop op (gemm etc.)
    nxt = 0
    # walk reverse-topo: consumers first
    for name in reversed(g.topo_order()):
        node = g[name]
        if node.is_source() or node.kind is OpKind.TUPLE:
            continue
        fusible = node.kind in _XLA_FUSIBLE or (
            node.kind is OpKind.REDUCTION and node.reduce_kind.value == "row"
        )
        placed = False
        if fusible and name not in g.outputs:
            users = [u for u in g.users(name) if not g[u].is_source()]
            ugroups = {group_of.get(u) for u in users}
            if len(ugroups) == 1 and None not in ugroups and users:
                gid = ugroups.pop()
                # loop fusion only merges into loop-fusion groups — never
                # into a GEMM/custom kernel — and reductions stay roots.
                if node.kind is not OpKind.REDUCTION and not opaque[gid]:
                    groups[gid].add(name)
                    group_of[name] = gid
                    placed = True
        if not placed:
            groups[nxt] = {name}
            group_of[name] = nxt
            opaque[nxt] = not fusible and node.kind is not OpKind.REDUCTION
            nxt += 1
    return [frozenset(v) for v in groups.values()]


# ---------------------------------------------------------------------------
# compiled artifact
# ---------------------------------------------------------------------------

@dataclass
class FusionStats:
    mode: str
    n_ops: int                       # compute ops in the graph ("TF kernels")
    n_kernels: int                   # kernels after this mode's fusion
    pattern_classes: dict[str, int] = field(default_factory=dict)
    modeled_time: float = 0.0        # cost-model step time, seconds
    scratch_requested: int = 0
    scratch_allocated: int = 0
    patterns_with_scratch: int = 0
    triton_groups: int = 0           # groups executed as generated Triton
    torch_groups: int = 0            # chosen patterns run as fused torch
    packs: int = 0                   # horizontal PackPatterns in the plan
    packed_subgraphs: int = 0        # independent subgraphs absorbed by packs
    cache_status: str = "off"        # "off" | "miss" | "hit"
    ilp: PlanResult | None = None
    compile_seconds: float = 0.0     # wall time spent producing this artifact
    # wall seconds per compile stage: pattern_gen, ilp, verify, tune
    stage_seconds: dict = field(default_factory=dict)
    # static verification summary ({"errors", "warnings", "codes"}) when the
    # compiler ran with verify != "off"; None when verification was skipped
    verify: dict | None = None
    verify_seconds: float = 0.0      # wall time of the verification passes
    # structured StitchInfeasible diagnostics from tuning: why a chosen
    # pattern degraded to a fused-torch group instead of a Triton kernel
    diagnostics: list = field(default_factory=list)

    @property
    def compression(self) -> float:
        return self.n_ops / self.n_kernels if self.n_kernels else float("nan")

    @property
    def alloc_over_req(self) -> float:
        if not self.scratch_requested:
            return 1.0
        return self.scratch_allocated / self.scratch_requested


@dataclass
class _Group:
    members: frozenset[str]
    kind: str                        # "triton" | "torch" | "op"
    tuned: TunedKernel | None = None
    # horizontal-pack provenance: the independent member subgraphs this
    # group packs (None for ordinary dependence-connected groups)
    pack: tuple[frozenset[str], ...] | None = None


class CompiledGraph:
    """Executable produced by :class:`StitchCompiler`.

    Calling it runs the graph group-by-group (each group = one kernel):
    stitched groups through their generated Triton kernel, the rest through
    eager PyTorch.  A value is dropped as soon as its last consuming group
    has run, so peak memory stays near the live working set.
    """

    def __init__(self, g: Graph, groups: list[_Group], stats: FusionStats):
        self.graph = g
        self.groups = groups
        self.stats = stats
        self._order = self._schedule()
        self._free_after = self._liveness()
        # members of each scheduled group in topo order, computed once: the
        # executor walks them on every call
        topo = {n: i for i, n in enumerate(g.topo_order())}
        self._members_topo = [sorted(grp.members, key=topo.__getitem__)
                              for grp in self._order]

    def _schedule(self) -> list[_Group]:
        g = self.graph
        owner: dict[str, int] = {}
        for i, grp in enumerate(self.groups):
            for m in grp.members:
                owner[m] = i
        indeg = [0] * len(self.groups)
        succs: list[set[int]] = [set() for _ in self.groups]
        for name, node in g.nodes.items():
            if name not in owner:
                continue
            for o in node.operands:
                if o in owner and owner[o] != owner[name]:
                    if owner[name] not in succs[owner[o]]:
                        succs[owner[o]].add(owner[name])
                        indeg[owner[name]] += 1
        ready = [i for i in range(len(self.groups)) if indeg[i] == 0]
        order: list[int] = []
        while ready:
            cur = ready.pop(0)
            order.append(cur)
            for s in sorted(succs[cur]):
                indeg[s] -= 1
                if indeg[s] == 0:
                    ready.append(s)
        assert len(order) == len(self.groups), "cyclic group schedule"
        return [self.groups[i] for i in order]

    def _liveness(self) -> list[list[str]]:
        """Per scheduled group, the values whose last consumer it is."""
        g = self.graph
        last: dict[str, int] = {}
        for i, grp in enumerate(self._order):
            for m in grp.members:
                for o in g[m].operands:
                    if o not in grp.members:
                        last[o] = i
        free: list[list[str]] = [[] for _ in self._order]
        keep = set(g.outputs)
        for name, i in last.items():
            if name not in keep:
                free[i].append(name)
        return free

    def __call__(self, inputs: Mapping) -> dict:
        g = self.graph
        device = None
        for v in inputs.values():
            if hasattr(v, "device"):
                device = v.device
                break
        env: dict = {}
        for name, node in g.nodes.items():
            if node.is_source():
                env[name] = source_value(node, inputs, device)
        for grp, members, dead in zip(self._order, self._members_topo,
                                      self._free_after):
            if grp.kind == "triton" and grp.tuned and grp.tuned.callable:
                p = grp.tuned.pattern
                args = [env[i] for i in p.external_inputs]
                outs = grp.tuned.callable(*args)
                for nm, val in zip(p.external_outputs, outs):
                    env[nm] = val
            else:
                # fused-torch group: evaluate members in topo order
                for nm in members:
                    node = g[nm]
                    env[nm] = eval_node(node, [env[o] for o in node.operands], g)
            for nm in dead:
                env.pop(nm, None)
        return {o: env[o] for o in g.outputs}


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------

class StitchCompiler:
    def __init__(
        self,
        hw: HardwareModel = H100,
        mode: str = "stitch",
        gen_cfg: GenConfig | None = None,
        plan_budget: float | None = None,
        verify: str = "plans",
        execution_based_eval: bool = False,
        cache=None,
        placement: str = "",
    ):
        assert mode in ("off", "xla", "stitch")
        assert verify in ("off", "plans", "full")
        self.hw = hw
        self.mode = mode
        self.gen_cfg = gen_cfg or GenConfig()
        # anytime ILP: wall-clock seconds before the fusion-plan solve
        # degrades to the greedy heuristic (None = solve to optimality)
        self.plan_budget = plan_budget
        self.cost = CostModel(hw, reg_budget=self.gen_cfg.reg_budget)
        # execution-based tuning times each candidate kernel on the sample
        # inputs given to compile(); without them it tunes by the model
        self.tuner = TemplateTuner(hw, execution_based=execution_based_eval)
        # Optional repro_torch.cache.StitchCache (duck-typed: lookup/insert)
        # — when set, stitch-mode compiles replay cached plans and populate
        # the cache on a miss; pattern generation, ILP and tuning run only
        # cold.
        self.cache = cache
        # The specialization this compile targets, part of the cache key
        # ("" = a plain single-device compile; see exec.function).
        self.placement = placement
        # Static verification level (repro_torch.analysis): "plans" runs the
        # plan verifier post-ILP/pre-tune and refuses ERROR plans; "full"
        # also runs the IR verifier on the graph; "off" skips both.  The
        # same knob gates cache-replay verification (StitchCache.lookup).
        self.verify = verify

    # -- planning -------------------------------------------------------------
    def plan(self, g: Graph, stage: dict | None = None
             ) -> tuple[list[FusionPattern], PlanResult | None]:
        stage = {} if stage is None else stage
        if self.mode == "off":
            return [], None
        if self.mode == "xla":
            pats = [
                FusionPattern(g, grp, "xla")
                for grp in xla_like_groups(g)
                if len(grp) >= 2
            ]
            return pats, None
        t0 = _time.perf_counter()
        with obs.span("compile.pattern_gen", cat="compile", graph=g.name) as s:
            patterns = generate_patterns(g, self.gen_cfg, self.hw)
            s.set(patterns=len(patterns),
                  packs=sum(1 for p in patterns
                            if getattr(p, "member_groups", None)))
        pscores = [self.cost.score(p) for p in patterns]
        stage["pattern_gen"] = _time.perf_counter() - t0
        t1 = _time.perf_counter()
        scratch_budget = self.gen_cfg.scratch_budget
        if scratch_budget is None:
            scratch_budget = self.hw.onchip_budget
        with obs.span("compile.ilp", cat="compile", graph=g.name,
                      patterns=len(patterns)) as s:
            result = solve_fusion_plan(
                g, patterns, [ps.score for ps in pscores],
                budget_seconds=self.plan_budget,
                scratch_requests=[ps.scratch_request for ps in pscores],
                scratch_budget=scratch_budget)
            s.set(method=result.method, chosen=len(result.chosen))
        stage["ilp"] = _time.perf_counter() - t1
        return result.chosen, result

    # -- static verification (repro_torch.analysis passes 1-2) -----------------------
    def verify_chosen(self, g: Graph, chosen: list[FusionPattern]) -> dict:
        """Run the static verifier on a proposed plan (post-ILP, pre-tune).

        ``verify="plans"`` checks the plan invariants (disjointness, induced
        acyclicity, scratch budget, registry membership); ``verify="full"``
        additionally runs the IR verifier on the graph.  ERROR findings
        raise :class:`repro_torch.analysis.VerificationError` — the compiler
        refuses to tune or execute an illegal plan.  Returns the findings
        summary recorded into :class:`FusionStats`.
        """
        from repro_torch.analysis import (VerificationError, errors, summarize,
                                    verify_graph, verify_plan)

        findings = []
        if self.verify == "full":
            findings += verify_graph(g)
        budget = None
        if self.mode == "stitch":
            budget = self.gen_cfg.scratch_budget
            if budget is None:
                budget = self.hw.onchip_budget
        reg_budget = self.cost.reg_budget if self.mode == "stitch" else None
        findings += verify_plan(g, chosen, require_cover=False,
                                scratch_budget=budget, cost=self.cost,
                                reg_budget=reg_budget)
        if errors(findings):
            obs.event("compile.verify_reject", cat="compile", graph=g.name,
                      codes=sorted({f.code for f in errors(findings)}))
            raise VerificationError(
                f"fusion plan for graph {g.name!r} rejected", findings)
        return summarize(findings)

    # -- modeled whole-graph time (Table 3's perf metric) ----------------------
    def modeled_time(self, g: Graph, groups: list[frozenset[str]]) -> float:
        total = 0.0
        for members in groups:
            if len(members) == 1:
                (m,) = members
                total += self.cost.kernel_time(g, m) + self.hw.launch_latency
            else:
                p = FusionPattern(g, members)
                total += self.cost.fused_time(p) + self.hw.launch_latency
        return total

    def compile(self, g: Graph, *, bypass_cache_lookup: bool = False,
                sample_inputs: Mapping | None = None) -> CompiledGraph:
        """Plan, verify and tune ``g``.  With a cache, a hit replays the
        cached plan (unless ``bypass_cache_lookup``) and a miss inserts the
        new one.  ``sample_inputs`` (graph inputs by name, on the device to
        tune for) feed execution-based tuning."""
        with obs.span("compile.graph", cat="compile", graph=g.name,
                      mode=self.mode, placement=self.placement) as osp:
            return self._compile(g, bypass_cache_lookup, sample_inputs, osp)

    def _pattern_inputs(self, g: Graph, chosen: list[FusionPattern],
                        inputs: Mapping) -> list[list]:
        """Each chosen pattern's external inputs, from one eager run of
        ``g`` on ``inputs`` (values dropped after their last use)."""
        need = {i for p in chosen for i in p.external_inputs}
        order = g.topo_order()
        last = {o: i for i, n in enumerate(order) for o in g[n].operands}
        device = next((v.device for v in inputs.values()
                       if hasattr(v, "device")), None)
        env, kept = {}, {}
        for i, name in enumerate(order):
            node = g[name]
            if node.is_source():
                env[name] = source_value(node, inputs, device)
            else:
                env[name] = eval_node(node, [env[o] for o in node.operands], g)
            if name in need:
                kept[name] = env[name]
            for o in set(node.operands):
                if last[o] == i:
                    env.pop(o, None)
        return [[kept[i] for i in p.external_inputs] for p in chosen]

    def _compile(self, g: Graph, bypass_cache_lookup, sample_inputs,
                 osp) -> CompiledGraph:
        t0 = _time.perf_counter()
        g.validate()
        cached = self.cache is not None and self.mode == "stitch"
        sig = None
        if cached:
            sig = self.cache.signature_of(g)   # computed once, reused by insert
            if not bypass_cache_lookup:
                hit = self.cache.lookup(g, self, sig=sig)
                if hit is not None:
                    hit.stats.compile_seconds = _time.perf_counter() - t0
                    osp.set(cache="hit", n_kernels=hit.stats.n_kernels)
                    return hit
        stage: dict[str, float] = {}
        chosen, ilp = self.plan(g, stage)
        verify_summary = None
        verify_seconds = 0.0
        if self.verify != "off":
            tv = _time.perf_counter()
            verify_summary = self.verify_chosen(g, chosen)
            verify_seconds = _time.perf_counter() - tv
        stage["verify"] = verify_seconds
        covered: set[str] = set()
        for p in chosen:
            covered |= p.members

        groups: list[_Group] = []
        stats = FusionStats(
            mode=self.mode, n_ops=len(g.compute_nodes()), n_kernels=0, ilp=ilp,
            verify=verify_summary, verify_seconds=verify_seconds,
        )

        diag_start = len(self.tuner.diagnostics)
        tt = _time.perf_counter()
        samples = [None] * len(chosen)
        if (self.tuner.execution_based and sample_inputs is not None
                and self.mode == "stitch"):
            samples = self._pattern_inputs(g, chosen, sample_inputs)
        with obs.span("compile.tune", cat="compile", graph=g.name,
                      patterns=len(chosen)):
            for p, sample in zip(chosen, samples):
                stats.pattern_classes[p.pattern_class] = (
                    stats.pattern_classes.get(p.pattern_class, 0) + 1
                )
                pack = tuple(getattr(p, "member_groups", ())) or None
                if pack:
                    stats.packs += 1
                    stats.packed_subgraphs += len(pack)
                tuned = None
                if self.mode == "stitch":
                    tuned = self.tuner.tune(p, sample)
                if tuned is not None:
                    groups.append(_Group(p.members, "triton", tuned, pack))
                    stats.triton_groups += 1
                    stats.scratch_requested += sum(
                        self.cost.scratch_request(p).values()
                    )
                    stats.scratch_allocated += tuned.scratch_plan.allocated
                    if tuned.scratch_plan.allocated:
                        stats.patterns_with_scratch += 1
                else:
                    groups.append(_Group(p.members, "torch", None, pack))
                    stats.torch_groups += 1
        stage["tune"] = _time.perf_counter() - tt

        # why patterns degraded to fused-torch during this tuning run
        stats.diagnostics = list(self.tuner.diagnostics[diag_start:])

        # singleton groups for uncovered compute ops
        for node in g.compute_nodes():
            if node.name not in covered:
                groups.append(_Group(frozenset([node.name]), "op"))

        stats.n_kernels = len(groups)
        stats.modeled_time = self.modeled_time(g, [grp.members for grp in groups])
        stats.compile_seconds = _time.perf_counter() - t0
        stats.stage_seconds = stage
        compiled = CompiledGraph(g, groups, stats)
        osp.set(cache=stats.cache_status, n_kernels=stats.n_kernels,
                modeled_time_s=stats.modeled_time)
        if cached:
            stats.cache_status = "miss"
            self.cache.insert(
                g, compiled, sig=sig, solve_seconds=stats.compile_seconds,
                compiler=self,
            )
            # the plan is now available for replay: every poller's next
            # lookup upgrades — this is the moment a compile "lands"
            obs.event("compile.land", cat="compile", graph=g.name,
                      placement=self.placement,
                      n_kernels=stats.n_kernels,
                      modeled_time_s=stats.modeled_time,
                      compile_seconds=stats.compile_seconds)
        return compiled
