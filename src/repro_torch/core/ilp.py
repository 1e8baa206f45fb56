"""Fusion-plan ILP (paper §4.1) with iterative cycle-cut constraints (Fig. 3).

The problem:   maximize  sum_j X_j * f(P_j)
               s.t.      X_u + X_v <= 1   whenever P_u and P_v overlap
                         X_j in {0, 1}
plus lazily-added constraints forbidding plans whose contracted graph is
cyclic.  This is weighted set packing.  Instance sizes after the paper's
heuristics are modest (tens to a few thousand patterns), so we solve exactly
with a best-first branch-and-bound whose bound is the LP-ish greedy residual;
``pulp`` (the package the paper itself uses) is used as an optional
cross-check in tests, never as a runtime dependency.

Cycle handling mirrors Fig. 3(d): solve -> contract chosen patterns ->
detect a cycle among contracted supernodes -> add a "not all of these
together" cut -> re-solve, until acyclic.
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field

from .ir import Graph
from .pattern import FusionPattern

__all__ = ["ILPSolver", "solve_fusion_plan", "greedy_fusion_plan", "PlanResult"]


@dataclass
class PlanResult:
    chosen: list[FusionPattern]
    objective: float
    iterations: int          # number of solve rounds (1 + cycle-cut rounds)
    cuts_added: int
    nodes_explored: int
    method: str = "ilp"      # "ilp" | "greedy" (anytime budget expired)
    budget_expired: bool = False


class ILPSolver:
    """Exact best-first branch & bound for weighted set packing with
    arbitrary 'at most k-1 of this set' cut constraints.

    ``deadline`` (a ``time.monotonic`` instant) makes the solve *anytime*:
    on expiry it returns the best feasible selection found so far and sets
    ``budget_expired`` — a huge backward graph can never hang the caller.
    """

    def __init__(self, weights: list[float], overlaps: list[set[int]],
                 node_budget: int = 200_000, deadline: float | None = None):
        self.w = weights
        self.overlaps = overlaps          # overlaps[i] = set of j conflicting with i
        self.cuts: list[frozenset[int]] = []
        self.node_budget = node_budget
        self.deadline = deadline
        self.budget_expired = False
        self.nodes_explored = 0

    def add_cut(self, idxs: frozenset[int]) -> None:
        """Forbid selecting ALL of `idxs` simultaneously."""
        self.cuts.append(idxs)

    # -------------------------------------------------------------- solve --
    def solve(self) -> tuple[list[int], float]:
        n = len(self.w)
        order = sorted(range(n), key=lambda i: -self.w[i])
        # suffix upper bound: sum of remaining positive weights (ignores
        # conflicts -> valid optimistic bound)
        suffix = [0.0] * (n + 1)
        for pos in range(n - 1, -1, -1):
            suffix[pos] = suffix[pos + 1] + max(self.w[order[pos]], 0.0)

        best_val = 0.0
        best_sel: list[int] = []
        self.nodes_explored = 0

        # DFS with bounding (explicit stack; states: (pos, chosen, blocked, val))
        stack = [(0, frozenset(), frozenset(), 0.0)]
        while stack:
            pos, chosen, blocked, val = stack.pop()
            self.nodes_explored += 1
            if self.nodes_explored > self.node_budget:
                break  # return best found so far (budget guard; tested small)
            if (self.deadline is not None and self.nodes_explored % 256 == 0
                    and time.monotonic() > self.deadline):
                self.budget_expired = True
                break  # anytime: best-so-far under the wall-clock budget
            if val > best_val:
                best_val, best_sel = val, sorted(chosen)
            if pos >= n or val + suffix[pos] <= best_val:
                continue
            i = order[pos]
            # branch 1: skip i
            stack.append((pos + 1, chosen, blocked, val))
            # branch 2: take i (if feasible)
            if i not in blocked and self.w[i] > 0:
                new_chosen = chosen | {i}
                if not self._violates_cut(new_chosen):
                    new_blocked = blocked | self.overlaps[i]
                    stack.append((pos + 1, new_chosen, new_blocked, val + self.w[i]))
        return best_sel, best_val

    def _violates_cut(self, chosen: frozenset[int]) -> bool:
        return any(cut.issubset(chosen) for cut in self.cuts)


# ---------------------------------------------------------------------------
# plan-level driver: ILP + cycle detection loop
# ---------------------------------------------------------------------------

def _find_cycle_patterns(g: Graph, chosen: list[FusionPattern]) -> frozenset[int] | None:
    """Detect a cycle in the graph contracted by `chosen`; return the indices
    of the patterns participating in one cycle, or None if acyclic.

    Contracted-graph nodes: one supernode per chosen pattern + one node per
    remaining op.  Edge u->v iff some member/op of u feeds some member/op
    of v."""
    owner: dict[str, int] = {}
    for idx, p in enumerate(chosen):
        for m in p.members:
            owner[m] = idx

    def rep(name: str) -> tuple[str, int] | str:
        return ("P", owner[name]) if name in owner else name

    adj: dict[object, set[object]] = {}
    for name, node in g.nodes.items():
        dst = rep(name)
        for o in node.operands:
            src = rep(o)
            if src != dst:
                adj.setdefault(src, set()).add(dst)
        adj.setdefault(dst, set())

    # iterative DFS cycle detection, tracking the stack to extract the cycle
    WHITE, GRAY, BLACK = 0, 1, 2
    color = {v: WHITE for v in adj}
    parent: dict[object, object] = {}
    for root in list(adj):
        if color[root] != WHITE:
            continue
        stack = [(root, iter(sorted(adj[root], key=repr)))]
        color[root] = GRAY
        while stack:
            v, it = stack[-1]
            advanced = False
            for w in it:
                if color[w] == WHITE:
                    color[w] = GRAY
                    parent[w] = v
                    stack.append((w, iter(sorted(adj[w], key=repr))))
                    advanced = True
                    break
                if color[w] == GRAY:
                    # found cycle w -> ... -> v -> w ; collect pattern ids
                    ids: set[int] = set()
                    cur = v
                    while True:
                        if isinstance(cur, tuple) and cur[0] == "P":
                            ids.add(cur[1])
                        if cur == w:
                            break
                        cur = parent.get(cur)
                        if cur is None:
                            break
                    if isinstance(w, tuple) and w[0] == "P":
                        ids.add(w[1])
                    if ids:
                        return frozenset(ids)
            if not advanced:
                color[v] = BLACK
                stack.pop()
        # continue to next root
    return None


def greedy_fusion_plan(
    g: Graph,
    pats: list[FusionPattern],
    w: list[float],
    overlaps: list[set[int]],
) -> tuple[list[FusionPattern], float]:
    """The paper's §4 greedy heuristic: take patterns in descending score
    order, skipping overlaps, then repair cycles by dropping the cheapest
    pattern of each detected cycle.  Used as the anytime fallback when the
    ILP's wall-clock budget expires — always valid, usually near-optimal."""
    chosen_idx: list[int] = []
    blocked: set[int] = set()
    for i in sorted(range(len(w)), key=lambda i: -w[i]):
        if w[i] <= 0 or i in blocked:
            continue
        chosen_idx.append(i)
        blocked |= overlaps[i]
    while True:
        cyc = _find_cycle_patterns(g, [pats[i] for i in chosen_idx])
        if cyc is None:
            break
        drop = min(cyc, key=lambda k: w[chosen_idx[k]])
        chosen_idx.pop(drop)
    return [pats[i] for i in chosen_idx], sum(w[i] for i in chosen_idx)


def solve_fusion_plan(
    g: Graph,
    patterns: list[FusionPattern],
    scores: list[float],
    max_cycle_rounds: int = 50,
    budget_seconds: float | None = None,
    scratch_requests: list[int] | None = None,
    scratch_budget: int | None = None,
) -> PlanResult:
    """The paper's full loop: ILP -> cycle check -> add cut -> re-solve.

    ``budget_seconds`` makes the whole loop *anytime*: when the wall-clock
    budget expires (inside a branch-and-bound solve or between cycle-cut
    rounds), the greedy §4 heuristic produces the plan instead, recorded in
    the returned :class:`PlanResult` (``method="greedy"``,
    ``budget_expired=True``) so callers and cache records can tell an
    optimal plan from a budgeted one.

    ``scratch_requests``/``scratch_budget`` add the on-chip feasibility
    constraint: any pattern whose requested scratch exceeds the budget is
    excluded from the solve outright (infeasible, not merely unattractive).
    """
    assert len(patterns) == len(scores)
    deadline = (None if budget_seconds is None
                else time.monotonic() + budget_seconds)
    if scratch_requests is not None and scratch_budget is not None:
        assert len(scratch_requests) == len(patterns)
        scores = [
            -1.0 if scratch_requests[i] > scratch_budget else s
            for i, s in enumerate(scores)
        ]
    keep = [i for i, s in enumerate(scores) if s > 0]
    pats = [patterns[i] for i in keep]
    w = [scores[i] for i in keep]

    overlaps: list[set[int]] = [set() for _ in pats]
    for i, j in itertools.combinations(range(len(pats)), 2):
        if pats[i].overlaps(pats[j]):
            overlaps[i].add(j)
            overlaps[j].add(i)

    # Horizontal packs span distant regions of the graph, so a pack and a
    # vertical pattern that are each acyclic alone routinely close a cycle
    # *pairwise* once both are contracted — and a two-pattern cycle holds no
    # matter what else is selected, so it is a hard mutual exclusion, not a
    # lazy cut.  Folding these into the overlap constraints up front keeps
    # the cycle-cut loop for the rare >= 3-pattern cycles only; without
    # this, pack-heavy graphs (stacked RNN steps) burn one solve round per
    # pair and blow through ``max_cycle_rounds``.
    pack_idx = {i for i, p in enumerate(pats)
                if getattr(p, "member_groups", None)}
    for i in sorted(pack_idx):
        for j in range(len(pats)):
            if j == i or j in overlaps[i] or (j in pack_idx and j < i):
                continue
            if deadline is not None and time.monotonic() > deadline:
                break
            if _find_cycle_patterns(g, [pats[i], pats[j]]) is not None:
                overlaps[i].add(j)
                overlaps[j].add(i)

    def greedy(rounds: int, cuts: int, nodes: int) -> PlanResult:
        chosen, val = greedy_fusion_plan(g, pats, w, overlaps)
        return PlanResult(chosen, val, rounds, cuts, nodes,
                          method="greedy", budget_expired=True)

    solver = ILPSolver(w, overlaps, deadline=deadline)
    cuts = 0
    for rounds in range(1, max_cycle_rounds + 1):
        if deadline is not None and time.monotonic() > deadline:
            return greedy(rounds, cuts, solver.nodes_explored)
        sel, val = solver.solve()
        if solver.budget_expired:
            return greedy(rounds, cuts, solver.nodes_explored)
        chosen = [pats[i] for i in sel]
        cyc = _find_cycle_patterns(g, chosen)
        if cyc is None:
            return PlanResult(chosen, val, rounds, cuts, solver.nodes_explored)
        # map pattern positions in `chosen` back to solver indices
        cut_idx = frozenset(sel[k] for k in range(len(sel)) if k in cyc)
        if len(cut_idx) == 1:
            # a single pattern whose contraction self-cycles can never be
            # chosen (shouldn't happen: generators pre-filter, but be safe)
            only = next(iter(cut_idx))
            solver.w[only] = -1.0
        else:
            solver.add_cut(cut_idx)
        cuts += 1
    raise RuntimeError("cycle-cut loop did not converge")
