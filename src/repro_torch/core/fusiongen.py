"""Fusion-pattern generation — the paper's §4.2.

Two domain-specific searches produce the candidate set the ILP chooses from:

* :func:`substitution_fusion` (Alg. 1) — topo-sort the graph, collapse every
  run of ops between adjacent *partition ops* into one pattern.  Driven by
  :func:`multi_step_substitution`, which widens the partition-op set in the
  paper's order (large GEMMs -> batched-GEMMs -> column reductions -> scalar
  reductions), collecting patterns at every step.

* :func:`exploratory_fusion` (Alg. 2) — recursive producer/consumer expansion
  from seed patterns, gated by the two fusibility conditions: member kinds
  restricted to elementwise / reduction / batched-gemm (+ shape glue), and no
  cyclic data dependence after contraction.

* :func:`packing_fusion` — §4.2's *independent-op packing*: find
  structurally-similar independent subgraphs (per-expert MoE FFN chains,
  per-head attention tails), grow exclusive producer cones around each twin,
  and bin the cones with capacity-bounded first-fit-decreasing over the
  register/scratch budgets.  Each bin becomes one :class:`PackPattern` — a
  horizontal kernel whose member subgraphs share a grid but exchange no data.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .ir import Graph, OpKind, OpNode, ReduceKind
from .pattern import FusionPattern, PackPattern, contraction_creates_cycle

__all__ = [
    "GenConfig",
    "substitution_fusion",
    "multi_step_substitution",
    "exploratory_fusion",
    "packing_fusion",
    "generate_patterns",
]

# kinds that may always live inside a fused kernel
_FUSIBLE_GLUE = {
    OpKind.ELEMENTWISE,
    OpKind.BROADCAST,
    OpKind.RESHAPE,
    OpKind.TRANSPOSE,
    OpKind.SLICE,
}
_FUSIBLE_EXPLORE = _FUSIBLE_GLUE | {OpKind.REDUCTION, OpKind.BATCHED_GEMM}


@dataclass
class GenConfig:
    # §4.2.1 — a GEMM is "large" (left to the native library / MXU pipeline)
    # when its FLOPs exceed this; small ones are stitched. cuBLAS rule -> MXU rule.
    large_gemm_flops: float = 2.0e9
    # §4.2.2 seed heuristics
    max_operands: int = 10           # ops with more operands are never seeds
    seed_min_bytes: int = 1 << 20    # "large input/output tensors"
    # exploration budget ("if it still takes long, give up")
    max_patterns: int = 4000
    max_pattern_size: int = 64
    max_depth: int = 12
    # registered Pallas custom kernels (kernels/registry.py) stop partitioning
    # from `custom_fuse_step` on, so attention/router bodies can live inside a
    # stitched kernel alongside their surrounding projections
    stitch_custom: bool = True
    custom_fuse_step: int = 1
    # on-chip scratch ceiling for candidate partitions; None = hardware budget
    scratch_budget: int | None = None
    # §4.2 independent-op packing: propose horizontal PackPatterns over
    # structurally-similar independent subgraphs, binned first-fit-decreasing
    # under the register/scratch budgets
    pack_patterns: bool = True
    pack_min_group: int = 2        # twin-class multiplicity needed to seed packs
    pack_max_members: int = 16     # max packed subgraphs per bin
    # live-register ceiling for one kernel (cost.register_pressure); None =
    # hardware reg_budget.  Also the FFD bin capacity.
    reg_budget: int | None = None


def _gemm_flops(g: Graph, node: OpNode) -> float:
    import math

    lhs = g[node.operands[0]]
    k = math.prod(lhs.shape[d] for d in node.attrs["contract"][0])
    return 2.0 * node.size * k


def _is_partition_op(g: Graph, node: OpNode, step: int, cfg: GenConfig) -> bool:
    """Paper's multi-step widening: step 0 partitions on large GEMMs only;
    each later step *removes* a class from the partition set (i.e. allows it
    to fuse).  Order: large gemm | batched-gemm | column reductions | scalar
    reductions.  GATHER/SCATTER always partition (opaque); CUSTOM partitions
    unless the kernel is registered stitchable and the step has widened past
    ``cfg.custom_fuse_step``."""
    if node.kind is OpKind.CUSTOM:
        if cfg.stitch_custom and step >= cfg.custom_fuse_step:
            from repro_torch.kernels.registry import lookup
            if lookup(node) is not None:
                return False
        return True
    if node.kind in (OpKind.GATHER, OpKind.SCATTER):
        return True
    if node.kind is OpKind.SLICE:
        return False
    if node.kind is OpKind.GEMM:
        return _gemm_flops(g, node) >= cfg.large_gemm_flops or step < 1
    if node.kind is OpKind.BATCHED_GEMM:
        return step < 1
    if node.kind is OpKind.REDUCTION:
        rk = node.reduce_kind
        if rk is ReduceKind.COLUMN:
            return step < 2
        if rk is ReduceKind.SCALAR:
            return step < 3
        return False  # row reductions always fusible
    return False


def substitution_fusion(
    g: Graph, partition: set[str], origin: str = "substitution",
) -> list[FusionPattern]:
    """Alg. 1: collapse all ops between adjacent partition ops (in topo order)
    into a single pattern each."""
    topo = g.topo_order()
    patterns: list[FusionPattern] = []
    run: list[str] = []

    def flush():
        nonlocal run
        members = [
            m for m in run
            if not g[m].is_source() and g[m].kind is not OpKind.TUPLE
        ]
        if len(members) >= 2:
            patterns.append(FusionPattern(g, frozenset(members), origin))
        run = []

    for name in topo:
        if name in partition:
            flush()
        else:
            run.append(name)
    flush()
    return patterns


def multi_step_substitution(g: Graph, cfg: GenConfig) -> list[FusionPattern]:
    """§4.2.1 multi-step procedure: run Alg. 1 once per widening step."""
    out: list[FusionPattern] = []
    seen: set[frozenset[str]] = set()
    for step in range(4):
        partition = {
            n.name for n in g.nodes.values() if _is_partition_op(g, n, step, cfg)
        }
        for p in substitution_fusion(g, partition):
            if p.members not in seen and not p.creates_cycle():
                seen.add(p.members)
                out.append(p)
    return out


def _explore_fusible(g: Graph, name: str, cfg: GenConfig | None = None) -> bool:
    node = g[name]
    if node.kind in _FUSIBLE_EXPLORE:
        return True
    if cfg is None:
        return False
    # exploration may also pull in small GEMMs and registered custom kernels —
    # the same classes the widened substitution steps stop partitioning on
    if node.kind is OpKind.GEMM:
        return _gemm_flops(g, node) < cfg.large_gemm_flops
    if node.kind is OpKind.CUSTOM and cfg.stitch_custom:
        from repro_torch.kernels.registry import lookup
        return lookup(node) is not None
    return False


def exploratory_fusion(
    g: Graph, seeds: list[frozenset[str]] | None = None, cfg: GenConfig | None = None,
) -> list[FusionPattern]:
    """Alg. 2 with the paper's seed heuristics and a search budget."""
    cfg = cfg or GenConfig()
    if seeds is None:
        seeds = []
        for node in g.nodes.values():
            if node.kind not in (OpKind.ELEMENTWISE, OpKind.REDUCTION, OpKind.BATCHED_GEMM):
                continue
            if len(node.operands) > cfg.max_operands:
                continue
            io = node.bytes + sum(g[o].bytes for o in node.operands)
            if io < cfg.seed_min_bytes:
                continue
            seeds.append(frozenset([node.name]))

    patterns: list[FusionPattern] = []
    seen: set[frozenset[str]] = set()

    def expand_candidates(members: frozenset[str]) -> list[str]:
        cands: set[str] = set()
        for m in members:
            # ProducerExpansion
            for o in g[m].operands:
                if o not in members and _explore_fusible(g, o, cfg):
                    cands.add(o)
            # ConsumerExpansion
            for u in g.users(m):
                if u not in members and _explore_fusible(g, u, cfg):
                    cands.add(u)
        return sorted(cands)

    def explore(members: frozenset[str], depth: int):
        if len(patterns) >= cfg.max_patterns or depth > cfg.max_depth:
            return
        for cand in expand_candidates(members):
            fused = members | {cand}
            if fused in seen or len(fused) > cfg.max_pattern_size:
                continue
            seen.add(fused)
            if contraction_creates_cycle(g, fused):
                continue
            if len(fused) >= 2:
                patterns.append(FusionPattern(g, fused, "exploratory"))
            if len(patterns) >= cfg.max_patterns:
                return
            explore(fused, depth + 1)

    for s in seeds:
        explore(s, 0)
    return patterns


# ---------------------------------------------------------------------------
# §4.2 independent-op packing — horizontal FFD packs
# ---------------------------------------------------------------------------

def _node_sig(g: Graph, n: OpNode) -> tuple:
    """Structural twin signature: two nodes with equal signatures compute the
    same op at the same shapes over same-shaped operands — per-expert chain
    ops hash equal across experts, per-head tails across heads."""
    extra: tuple = ()
    if n.kind is OpKind.REDUCTION:
        extra = (tuple(n.attrs.get("axes", ())), n.attrs.get("op"))
    elif n.kind in (OpKind.GEMM, OpKind.BATCHED_GEMM):
        extra = (tuple(map(tuple, n.attrs.get("contract", ((), ())))),
                 tuple(map(tuple, n.attrs.get("batch", ((), ())))))
    elif n.kind is OpKind.BROADCAST:
        extra = (tuple(n.attrs.get("bcast_dims", ())),)
    elif n.kind is OpKind.TRANSPOSE:
        extra = (tuple(n.attrs.get("perm", ())),)
    elif n.kind is OpKind.SLICE:
        extra = (tuple(n.attrs.get("starts", ())), tuple(n.attrs.get("limits", ())))
    elif n.kind is OpKind.CUSTOM:
        extra = (n.attrs.get("kernel"), n.attrs.get("project"))
    return (n.kind.value, n.attrs.get("op"), n.shape, n.dtype, extra,
            tuple(g[o].shape for o in n.operands),
            tuple(g[o].dtype for o in n.operands))


def _grow_cone(g: Graph, sink: str, cfg: GenConfig,
               taken: set[str]) -> frozenset[str]:
    """Exclusive producer cone of ``sink``: pull in an operand iff it is
    fusible, unclaimed, and *all* of its users already live in the cone —
    shared producers (the block input feeding every expert, router gates)
    stay external, which is what keeps sibling cones independent."""
    members: set[str] = {sink}
    changed = True
    while changed and len(members) < cfg.max_pattern_size:
        changed = False
        frontier: set[str] = set()
        for m in members:
            frontier.update(g[m].operands)
        for o in sorted(frontier - members):
            node = g[o]
            if node.is_source() or node.kind is OpKind.TUPLE or o in taken:
                continue
            if not _explore_fusible(g, o, cfg):
                continue
            if not all(u in members for u in g.users(o)):
                continue
            members.add(o)
            changed = True
            if len(members) >= cfg.max_pattern_size:
                break
    return frozenset(members)


def packing_fusion(g: Graph, cfg: GenConfig | None = None,
                   hw=None) -> list[PackPattern]:
    """Propose horizontal packs of independent subgraphs (paper §4.2).

    1. Hash every fusible compute node into structural twin classes; keep
       classes with multiplicity >= ``cfg.pack_min_group``.
    2. Walking classes sink-first (latest topo position first), grow an
       exclusive producer cone from each unclaimed twin.  A class whose
       cones collapse into fewer than ``pack_min_group`` disjoint cones
       (e.g. the combine-add chain joining the experts — its "twins" depend
       on each other) is discarded.
    3. First-fit-decreasing: cones sorted by register-pressure weight are
       binned under the register and scratch budgets (capacity-bounded, max
       ``pack_max_members`` subgraphs per bin); only mutually independent
       cones with a common row dimension share a bin.  Register capacity is
       a *max* over the bin's cones (independent subgraphs serialise inside
       a block, so the widest one sets the working set — the §4.2 occupancy
       argument); scratch is summed (one allocation serves the kernel).

    Each bin with >= 2 cones becomes a :class:`PackPattern` whose
    ``member_groups`` are the cones (pack provenance for the verifier).
    """
    cfg = cfg or GenConfig()
    if not cfg.pack_patterns:
        return []
    from .cost import CostModel, TPU_V5E
    hw = hw or TPU_V5E
    cost = CostModel(hw, reg_budget=cfg.reg_budget)
    reg_cap = cost.reg_budget
    scratch_cap = (cfg.scratch_budget if cfg.scratch_budget is not None
                   else hw.onchip_budget)

    topo_pos = {name: i for i, name in enumerate(g.topo_order())}
    classes: dict[tuple, list[str]] = {}
    for name, node in g.nodes.items():
        if node.is_source() or node.kind is OpKind.TUPLE:
            continue
        if not _explore_fusible(g, name, cfg):
            continue
        classes.setdefault(_node_sig(g, node), []).append(name)
    twin_classes = [sorted(v, key=lambda n: -topo_pos[n])
                    for v in classes.values() if len(v) >= cfg.pack_min_group]
    # sink classes first: their cones swallow whole chains, later (earlier-
    # topo) classes only pick over the uncovered remainder
    twin_classes.sort(key=lambda ns: -topo_pos[ns[0]])

    taken: set[str] = set()
    cones: list[frozenset[str]] = []
    for names in twin_classes:
        cand: list[frozenset[str]] = []
        claimed: set[str] = set(taken)
        for name in names:
            if name in claimed:
                continue
            cone = _grow_cone(g, name, cfg, claimed)
            claimed |= cone
            cand.append(cone)
        if len(cand) < cfg.pack_min_group:
            continue  # twins were dependent (combiner chains) or claimed
        # pipeline stages masquerade as twins (the two residual adds of one
        # block): their cones feed one another.  A true packing family is
        # mutually independent — any cross-cone edge disqualifies the class.
        owner = {m: i for i, c in enumerate(cand) for m in c}
        if any(owner.get(o) is not None and owner[o] != owner[m]
               for m in owner for o in g[m].operands):
            continue
        cones.extend(cand)
        taken = claimed

    if len(cones) < 2:
        return []

    def cone_rows(cone: frozenset[str]) -> int | None:
        # leading non-1 dim of the first sized output — the row grid the
        # emitter parallelises over (leading 1s are batch padding)
        for o in g.external_outputs(cone):
            for d in g[o].shape:
                if d > 1:
                    return d
        return None

    def cone_weight(cone: frozenset[str]) -> tuple[int, int]:
        p = FusionPattern(g, cone, "pack")
        reg = cost.register_pressure(p)
        if reg == 0:  # singleton cone: one live row tile
            reg = sum(cost._tile_bytes(g[m]) for m in cone)
        scr = sum(cost.scratch_request(p).values()) + cost.custom_scratch(p)
        return reg, scr

    weighted = []
    for cone in cones:
        rows = cone_rows(cone)
        if rows is None:
            continue
        reg, scr = cone_weight(cone)
        if reg > reg_cap or scr > scratch_cap:
            continue  # a cone that can't fuse alone can't join a bin
        weighted.append((reg, scr, rows, cone))
    # first-fit-decreasing over register weight (the binding budget)
    weighted.sort(key=lambda t: (-t[0], -t[1], sorted(t[3])[0]))

    def independent(cone: frozenset[str], others: list[frozenset[str]]) -> bool:
        pool = set().union(*others) if others else set()
        for m in cone:
            if any(o in pool for o in g[m].operands):
                return False
        for grp in others:
            for m in grp:
                if any(o in cone for o in g[m].operands):
                    return False
        # transitive dependence through external nodes (attention cone ->
        # residual add -> expert cone) would make the merged bin cyclic
        return not contraction_creates_cycle(g, frozenset(cone | pool))

    bins: list[dict] = []
    for reg, scr, rows, cone in weighted:
        placed = False
        for b in bins:
            if (b["rows"] == rows
                    and len(b["cones"]) < cfg.pack_max_members
                    and max(b["reg"], reg) <= reg_cap
                    and b["scr"] + scr <= scratch_cap
                    and independent(cone, b["cones"])):
                b["cones"].append(cone)
                b["reg"] = max(b["reg"], reg)
                b["scr"] += scr
                placed = True
                break
        if not placed:
            bins.append({"rows": rows, "cones": [cone], "reg": reg, "scr": scr})

    packs: list[PackPattern] = []
    for b in bins:
        if len(b["cones"]) < 2:
            continue
        union = frozenset().union(*b["cones"])
        if contraction_creates_cycle(g, union):
            continue
        try:
            packs.append(PackPattern(
                g, union, "pack",
                member_groups=tuple(sorted(b["cones"], key=sorted))))
        except ValueError:
            continue
        if len(packs) >= cfg.max_patterns:
            break
    return packs


def generate_patterns(g: Graph, cfg: GenConfig | None = None,
                      hw=None) -> list[FusionPattern]:
    """§4.2 composition rule: substitution fusion is the base strategy,
    exploratory fusion is supplementary, and independent-op packing adds
    horizontal candidates the first two (dependence-connected by
    construction) can never propose."""
    cfg = cfg or GenConfig()
    out = multi_step_substitution(g, cfg)
    seen = {p.members for p in out}
    for p in exploratory_fusion(g, None, cfg):
        if p.members not in seen:
            seen.add(p.members)
            out.append(p)
    for p in packing_fusion(g, cfg, hw):
        if p.members not in seen:
            seen.add(p.members)
            out.append(p)
    return out
