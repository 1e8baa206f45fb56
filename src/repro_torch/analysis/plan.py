"""Pass 2 — plan verifier: is a fusion plan legal for a given graph?

A *plan* here is any grouping of graph nodes into kernels: the patterns
the ILP chose (pre-tuning), the ``_Group`` list of a compiled artifact,
or a ``PlanRecord`` replayed from disk.  ``verify_plan`` checks the §4
invariants statically:

* every member exists and is a compute node (RA020 / RA027),
* groups are disjoint (RA021) and — when asked — cover every compute
  node (RA022),
* the induced group DAG is acyclic (RA023) — the global form of the
  ``induced_reaches`` cycle rule, checked over the *whole* plan rather
  than one contraction at a time,
* multi-member groups fit the on-chip scratch budget (RA024),
* fused groups only contain CUSTOM kernels the registry knows (RA025),
* recorded pattern-class stats match a recount (RA026, WARN),
* horizontal packs are well-formed: member subgraphs disjoint and covering
  (RA060), no data dependence crosses two packed subgraphs (RA061), and
  the pack fits the register/live-value budget (RA062).

``verify_record`` adapts a disk ``PlanRecord`` (canonical indices) onto
the live graph and runs the same checks — the cache-replay gate.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from repro_torch.core.cost import CostModel
from repro_torch.core.ir import Graph, OpKind
from repro_torch.core.pattern import FusionPattern
from repro_torch.kernels.registry import lookup as _registry_lookup

from .findings import Finding

__all__ = ["GroupView", "verify_plan", "verify_record", "verify_compiled"]

_RECORD_KINDS = ("triton", "torch", "op")


class GroupView:
    """Minimal adapter one plan group: a member set, an execution kind
    (``triton``/``torch``/``op`` from artifacts and records, ``pattern`` for
    not-yet-tuned ILP choices), and — for horizontal packs — the packed
    member subgraphs (``pack``, None for ordinary groups)."""

    __slots__ = ("members", "kind", "index", "pack")

    def __init__(self, members: Iterable[str], kind: str = "pattern",
                 index: int = 0,
                 pack: "tuple[frozenset[str], ...] | None" = None):
        self.members = frozenset(members)
        self.kind = kind
        self.index = index
        self.pack = pack


def _as_views(groups: Sequence) -> list[GroupView]:
    views = []
    for i, grp in enumerate(groups):
        if isinstance(grp, GroupView):
            grp.index = i
            views.append(grp)
        elif isinstance(grp, (frozenset, set, list, tuple)):
            views.append(GroupView(grp, "pattern", i))
        else:  # duck-typed _Group / FusionPattern / PackPattern
            kind = getattr(grp, "kind", "pattern")
            pack = (getattr(grp, "pack", None)
                    or getattr(grp, "member_groups", None))
            if pack:
                pack = tuple(frozenset(gset) for gset in pack)
            views.append(GroupView(grp.members, kind, i, pack or None))
    return views


def verify_plan(
    g: Graph,
    groups: Sequence,
    *,
    require_cover: bool = False,
    scratch_budget: int | None = None,
    cost: CostModel | None = None,
    reg_budget: int | None = None,
    pattern_classes: dict[str, int] | None = None,
) -> list[Finding]:
    """Check plan legality; ``groups`` accepts member sets, patterns,
    ``_Group``-likes or :class:`GroupView` s.  ``scratch_budget`` (with a
    ``cost`` model) enables the RA024 budget check for fusable groups;
    ``reg_budget`` (with ``cost``) enables the RA062 register-pressure
    check for packed groups; ``require_cover`` additionally demands a full
    disjoint cover of the graph's compute nodes (records / compiled
    artifacts — the compiler's pre-tune call leaves uncovered nodes to
    implicit singletons)."""
    findings: list[Finding] = []
    views = _as_views(groups)
    compute = {n.name for n in g.compute_nodes()}

    # -- membership + disjointness ----------------------------------------
    owner: dict[str, int] = {}
    sane: list[GroupView] = []
    for v in views:
        ok = True
        for m in sorted(v.members):
            if m not in g.nodes:
                findings.append(Finding(
                    "RA020", f"member {m!r} not in graph", node=m,
                    group=v.index))
                ok = False
                continue
            if m not in compute:
                findings.append(Finding(
                    "RA027", f"member {m!r} is {g[m].kind.value}, not a "
                             f"compute node", node=m, group=v.index))
                ok = False
            if m in owner:
                findings.append(Finding(
                    "RA021", f"node {m!r} owned by groups {owner[m]} and "
                             f"{v.index}", node=m, group=v.index))
                ok = False
            else:
                owner[m] = v.index
        if ok:
            sane.append(v)

    uncovered = compute - set(owner)
    if require_cover:
        for m in sorted(uncovered):
            findings.append(Finding(
                "RA022", f"compute node {m!r} not covered by any group",
                node=m))

    # -- induced group DAG must schedule (global cycle rule) ---------------
    # Uncovered compute nodes execute as implicit singleton kernels, so they
    # participate in the schedule exactly as CompiledGraph._schedule treats
    # them — a cycle routed through one is just as unschedulable.
    full_owner = dict(owner)
    n_groups = len(views)
    for m in sorted(uncovered):
        full_owner[m] = n_groups
        n_groups += 1
    indeg = [0] * n_groups
    succs: list[set[int]] = [set() for _ in range(n_groups)]
    for name, gid in full_owner.items():
        for o in g.nodes[name].operands:
            src = full_owner.get(o)
            if src is not None and src != gid and gid not in succs[src]:
                succs[src].add(gid)
                indeg[gid] += 1
    ready = [i for i in range(n_groups) if indeg[i] == 0]
    seen = 0
    while ready:
        cur = ready.pop()
        seen += 1
        for s in succs[cur]:
            indeg[s] -= 1
            if indeg[s] == 0:
                ready.append(s)
    if seen != n_groups:
        stuck = sorted(i for i in range(n_groups) if indeg[i] > 0)
        real = [i for i in stuck if i < len(views)]
        findings.append(Finding(
            "RA023", f"induced group DAG has a cycle through groups "
                     f"{real[:6] if real else stuck[:6]}",
            group=real[0] if real else None))

    # -- per-group kernel legality (fused groups only) ---------------------
    for v in sane:
        if len(v.members) < 2 or v.kind == "op":
            continue
        if any(m not in g.nodes for m in v.members):
            continue
        # registered-custom membership: an unregistered CUSTOM cannot live
        # inside a fused kernel — there is no body to stitch (registry rule;
        # kernels/stitched.py would only discover this mid-tuning)
        for m in sorted(v.members):
            node = g[m]
            if node.kind is OpKind.CUSTOM and _registry_lookup(node) is None:
                findings.append(Finding(
                    "RA025", f"custom kernel "
                             f"{node.attrs.get('kernel', '?')!r} not in "
                             f"registry", node=m, group=v.index))
        if scratch_budget is not None and cost is not None \
                and v.kind in ("pattern", "triton"):
            p = FusionPattern(g, v.members)
            req = sum(cost.scratch_request(p).values()) + cost.custom_scratch(p)
            if req > scratch_budget:
                findings.append(Finding(
                    "RA024", f"scratch request {req} B exceeds budget "
                             f"{scratch_budget} B", group=v.index))

    # -- horizontal packs: provenance well-formed + truly independent ------
    for v in sane:
        if not v.pack:
            continue
        seen_pack: set[str] = set()
        union: set[str] = set()
        bad_pack = False
        for grp in v.pack:
            if grp & seen_pack:
                findings.append(Finding(
                    "RA060", f"pack member subgraphs overlap on "
                             f"{sorted(grp & seen_pack)[:4]}", group=v.index))
                bad_pack = True
            seen_pack |= grp
            union |= grp
        if union != v.members:
            findings.append(Finding(
                "RA060", "pack member subgraphs do not cover the group "
                         f"({len(union)} packed vs {len(v.members)} members)",
                group=v.index))
            bad_pack = True
        if bad_pack:
            continue
        owner_grp: dict[str, int] = {}
        for gi, grp in enumerate(v.pack):
            for m in grp:
                owner_grp[m] = gi
        for m in sorted(v.members):
            if m not in g.nodes:
                continue
            for o in g.nodes[m].operands:
                if o in owner_grp and owner_grp[o] != owner_grp[m]:
                    findings.append(Finding(
                        "RA061", f"pack dependence crosses member subgraphs: "
                                 f"{o!r} (subgraph {owner_grp[o]}) feeds "
                                 f"{m!r} (subgraph {owner_grp[m]})",
                        node=m, group=v.index))
        if reg_budget is not None and cost is not None \
                and all(m in g.nodes for m in v.members):
            # pack-aware pressure: independent subgraphs serialise inside a
            # block, so the widest member subgraph sets the working set
            # (mirrors CostModel.register_pressure on a PackPattern)
            reg = max(cost.register_pressure(FusionPattern(g, grp))
                      for grp in v.pack)
            if reg > reg_budget:
                findings.append(Finding(
                    "RA062", f"pack register pressure {reg} B exceeds "
                             f"budget {reg_budget} B", group=v.index))

    # -- recorded pattern-class stats vs a recount (WARN) ------------------
    if pattern_classes is not None:
        recount: dict[str, int] = {}
        for v in sane:
            if len(v.members) < 2 or v.kind == "op" \
                    or any(m not in g.nodes for m in v.members):
                continue
            cls = FusionPattern(g, v.members).pattern_class
            recount[cls] = recount.get(cls, 0) + 1
        recorded = {k: c for k, c in pattern_classes.items() if c}
        if recount != recorded:
            findings.append(Finding(
                "RA026", f"recorded pattern classes {recorded} != recount "
                         f"{recount}"))

    return findings


def verify_record(
    g: Graph,
    canon_order: Sequence[str],
    rec,
    *,
    scratch_budget: int | None = None,
    cost: CostModel | None = None,
    reg_budget: int | None = None,
) -> list[Finding]:
    """Verify a disk ``PlanRecord`` against the *live* graph it is about
    to replay onto.  ``canon_order`` maps the record's canonical node
    indices back to this graph's node names (``sig.canon_order``)."""
    findings: list[Finding] = []
    n = len(canon_order)
    if getattr(rec, "n_nodes", n) != n:
        findings.append(Finding(
            "RA050", f"record describes {rec.n_nodes} nodes, live graph has "
                     f"{n}"))
        return findings
    views: list[GroupView] = []
    for i, gr in enumerate(rec.groups):
        if gr.kind not in _RECORD_KINDS:
            findings.append(Finding(
                "RA028", f"group kind {gr.kind!r} not one of "
                         f"{_RECORD_KINDS}", group=i))
            continue
        pack_idx = [list(gset) for gset in (getattr(gr, "pack", ()) or ())]
        flat_pack = [j for gset in pack_idx for j in gset]
        bad = [j for j in list(gr.members) + list(gr.scratch or []) + flat_pack
               if not isinstance(j, int) or not 0 <= j < n]
        if bad:
            findings.append(Finding(
                "RA020", f"canonical indices {bad[:6]} out of range "
                         f"[0, {n})", group=i))
            continue
        pack = (tuple(frozenset(canon_order[j] for j in gset)
                      for gset in pack_idx) or None)
        views.append(GroupView((canon_order[j] for j in gr.members),
                               gr.kind, i, pack))
    if not any(f.severity == "error" for f in findings):
        findings += verify_plan(g, views, require_cover=True,
                                scratch_budget=scratch_budget, cost=cost,
                                reg_budget=reg_budget)
    return findings


def verify_compiled(cg, *, scratch_budget: int | None = None,
                    cost: CostModel | None = None,
                    reg_budget: int | None = None) -> list[Finding]:
    """Full audit of a compiled artifact: IR pass + plan pass + recorded
    pattern-class consistency.  Offline/CLI entry point."""
    from .verify import verify_graph

    findings = verify_graph(cg.graph)
    findings += verify_plan(
        cg.graph, cg.groups, require_cover=True,
        scratch_budget=scratch_budget, cost=cost, reg_budget=reg_budget,
        pattern_classes=getattr(cg.stats, "pattern_classes", None))
    return findings
