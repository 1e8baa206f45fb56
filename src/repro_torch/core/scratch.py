"""Scratch-space (VMEM) optimization — the paper's Alg. 4.

Goal (paper §5.4): bound *worst-case* on-chip usage of a fused kernel by
letting later ops reuse scratch buffers whose values are provably dead.  The
paper diverts the classic dominance-tree algorithm (Cooper-Harvey-Kennedy)
from control-flow graphs to the dataflow DAG.

Soundness note (also recorded in DESIGN.md): on a dataflow DAG rooted at a
virtual sink collecting all outputs, *post-dominance* is the relation that
makes reuse sound — if ``inst`` post-dominates ``prev_inst``, every path from
``prev_inst``'s value to any kernel output passes through ``inst``, so by the
time ``inst`` executes (topo order) no future op can still need
``prev_inst``'s buffer, and ``inst`` may take it over.  We therefore build
the dominance tree of the *reversed* DAG (sink-rooted); the paper's
``dom.Dominates(inst, prev_inst)`` test maps to ``postdom(inst, prev_inst)``.

The allocator walks ops in topo order, propagates "which allocations flow
here" along data edges (the paper's PropagateAllocInfo/CollectAllocInfo), and
on each scratch request either reuses a dominated predecessor's buffer
(Share) — reclaiming further dominated duplicates (Reclaim) — or allocates
fresh space (Alloc).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .ir import Graph

__all__ = ["dominator_tree", "post_dominates", "ScratchAllocator", "ScratchPlan"]


# ---------------------------------------------------------------------------
# Cooper-Harvey-Kennedy "engineered" dominance on an arbitrary rooted DAG
# ---------------------------------------------------------------------------

def dominator_tree(
    nodes: list[str], preds: dict[str, list[str]], root: str
) -> dict[str, str | None]:
    """idom map via Cooper-Harvey-Kennedy iteration.

    `nodes` must be reverse-post-order reachable-from-root; `preds[v]` are
    predecessors in the rooted graph.
    """
    rpo_index = {n: i for i, n in enumerate(nodes)}
    idom: dict[str, str | None] = {n: None for n in nodes}
    idom[root] = root

    def intersect(a: str, b: str) -> str:
        while a != b:
            while rpo_index[a] > rpo_index[b]:
                a = idom[a]  # type: ignore[assignment]
            while rpo_index[b] > rpo_index[a]:
                b = idom[b]  # type: ignore[assignment]
        return a

    changed = True
    while changed:
        changed = False
        for v in nodes:
            if v == root:
                continue
            cands = [p for p in preds.get(v, []) if idom.get(p) is not None]
            if not cands:
                continue
            new = cands[0]
            for p in cands[1:]:
                new = intersect(new, p)
            if idom[v] != new:
                idom[v] = new
                changed = True
    idom[root] = None
    return idom


_SINK = "__sink__"


def _postdom_idom(g: Graph) -> dict[str, str | None]:
    """Immediate post-dominators of the dataflow DAG (virtual sink over the
    graph outputs and any otherwise-unused values)."""
    # reversed graph: edges user -> operand ; root = sink -> outputs
    succ_rev: dict[str, list[str]] = {n: list(dict.fromkeys(g.nodes[n].operands)) for n in g.nodes}
    sinks = set(g.outputs) | {n for n in g.nodes if not g.users(n)}
    succ_rev[_SINK] = sorted(sinks)
    preds_rev: dict[str, list[str]] = {n: [] for n in list(g.nodes) + [_SINK]}
    for src, dsts in succ_rev.items():
        for d in dsts:
            preds_rev[d].append(src)

    # RPO of the reversed graph from sink
    order: list[str] = []
    seen: set[str] = set()

    def dfs(v: str):
        stack = [(v, iter(succ_rev.get(v, [])))]
        seen.add(v)
        while stack:
            cur, it = stack[-1]
            advanced = False
            for w in it:
                if w not in seen:
                    seen.add(w)
                    stack.append((w, iter(succ_rev.get(w, []))))
                    advanced = True
                    break
            if not advanced:
                order.append(cur)
                stack.pop()

    dfs(_SINK)
    rpo = list(reversed(order))
    return dominator_tree(rpo, preds_rev, _SINK)


def post_dominates(idom: dict[str, str | None], a: str, b: str) -> bool:
    """Does `a` post-dominate `b` (a on every path b -> outputs)?"""
    cur: str | None = b
    while cur is not None:
        if cur == a:
            return True
        cur = idom.get(cur)
    return False


# ---------------------------------------------------------------------------
# Alg. 4 — scratch allocation with dominance-based reuse
# ---------------------------------------------------------------------------

@dataclass
class ScratchPlan:
    # buffer id -> size in bytes
    buffers: dict[int, int] = field(default_factory=dict)
    # op name -> buffer id it writes
    assignment: dict[str, int] = field(default_factory=dict)
    requested: int = 0

    @property
    def allocated(self) -> int:
        return sum(self.buffers.values())

    @property
    def alloc_over_req(self) -> float:
        """The paper's Table-4 ``alloc/req`` ratio (lower = more reuse)."""
        return self.allocated / self.requested if self.requested else 1.0


class ScratchAllocator:
    """Alg. 4 on a fusion pattern's subgraph."""

    def __init__(self, g: Graph):
        self.g = g
        self.ipdom = _postdom_idom(g)

    def allocate(self, req_map: dict[str, int]) -> ScratchPlan:
        g = self.g
        plan = ScratchPlan(requested=sum(req_map.values()))
        next_buf = 0
        # alloc-info flowing to each op: set of (op, buffer) live allocations
        flow: dict[str, set[tuple[str, int]]] = {}

        for inst in g.topo_order():
            incoming: set[tuple[str, int]] = set()
            for operand in g.nodes[inst].operands:          # CollectAllocInfo
                incoming |= flow.get(operand, set())
            if inst not in req_map:
                flow[inst] = incoming                        # PropagateAllocInfo
                continue

            shared = False
            taken: tuple[str, int] | None = None
            dead: set[tuple[str, int]] = set()
            for prev in sorted(incoming, key=lambda t: (-req_map.get(t[0], 0), t[0])):
                prev_inst, buf = prev
                if post_dominates(self.ipdom, inst, prev_inst):
                    if not shared and plan.buffers[buf] >= req_map[inst]:
                        taken = prev                          # Share
                        shared = True
                        dead.add(prev)
                        continue
                    dead.add(prev)                            # Reclaim
            if shared and taken is not None:
                plan.assignment[inst] = taken[1]
            else:
                plan.buffers[next_buf] = req_map[inst]        # Alloc
                plan.assignment[inst] = next_buf
                next_buf += 1
            # this op's allocation flows onward; dominated dead ones do not
            flow[inst] = (incoming - dead) | {(inst, plan.assignment[inst])}

        return plan
