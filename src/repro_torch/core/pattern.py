"""Fusion patterns — candidate subgraphs the ILP chooses among (paper §4.1).

A :class:`FusionPattern` is an immutable set of node names of one graph plus
cached facts the cost model and ILP need: external I/O tensors, internal
(saved) bytes, the paper's three-way classification (elemwise / reduction /
gemm, §6.4), and whether contracting it keeps the graph acyclic.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Iterable

from .ir import Graph, OpKind, OpNode, ReduceKind

__all__ = ["FusionPattern", "PackPattern", "PatternClass",
           "contraction_creates_cycle"]


class PatternClass:
    ELEMWISE = "elemwise"
    REDUCTION = "reduction"
    GEMM = "gemm"


@dataclass(frozen=True)
class FusionPattern:
    graph: Graph = field(compare=False, repr=False)
    members: frozenset[str] = field(compare=True)
    origin: str = "manual"  # "substitution" | "exploratory" | "manual"

    def __post_init__(self):
        if not self.members:
            raise ValueError("empty fusion pattern")
        for m in self.members:
            if m not in self.graph:
                raise ValueError(f"pattern member {m!r} not in graph")

    # -- cached structural facts --------------------------------------------
    @cached_property
    def nodes(self) -> list[OpNode]:
        order = [n for n in self.graph.topo_order() if n in self.members]
        return [self.graph[n] for n in order]

    @cached_property
    def compute_members(self) -> list[OpNode]:
        return [n for n in self.nodes if not n.is_source() and n.kind is not OpKind.TUPLE]

    @cached_property
    def external_inputs(self) -> list[str]:
        return self.graph.external_inputs(self.members)

    @cached_property
    def external_outputs(self) -> list[str]:
        return self.graph.external_outputs(self.members)

    @cached_property
    def input_bytes(self) -> int:
        return sum(self.graph[n].bytes for n in self.external_inputs)

    @cached_property
    def output_bytes(self) -> int:
        return sum(self.graph[n].bytes for n in self.external_outputs)

    @cached_property
    def saved_bytes(self) -> int:
        """Off-chip traffic eliminated by this fusion: every internal
        intermediate is a write+read (2x bytes) that no longer touches HBM."""
        return 2 * self.graph.internal_edges_bytes(self.members)

    @cached_property
    def pattern_class(self) -> str:
        """Paper §6.4: gemm > reduction > elemwise precedence.  Stitchable
        CUSTOM kernels (flash attention etc.) are compute-bearing, so they
        classify with the GEMMs."""
        kinds = {n.kind for n in self.nodes}
        if kinds & {OpKind.GEMM, OpKind.BATCHED_GEMM, OpKind.CUSTOM}:
            return PatternClass.GEMM
        if OpKind.REDUCTION in kinds:
            return PatternClass.REDUCTION
        return PatternClass.ELEMWISE

    @cached_property
    def custom_members(self) -> tuple[str, ...]:
        """CUSTOM member names (registered or not), projections included."""
        return tuple(
            n.name for n in self.nodes if n.kind is OpKind.CUSTOM
        )

    @cached_property
    def reduce_kinds(self) -> set[ReduceKind]:
        return {n.reduce_kind for n in self.nodes if n.kind is OpKind.REDUCTION}

    @cached_property
    def has_data_dependences(self) -> bool:
        """False for pure packing patterns (no member feeds another member)."""
        return any(
            any(o in self.members for o in n.operands) for n in self.nodes
        )

    def overlaps(self, other: "FusionPattern") -> bool:
        return bool(self.members & other.members)

    def creates_cycle(self) -> bool:
        return contraction_creates_cycle(self.graph, self.members)

    def key(self) -> frozenset[str]:
        return self.members

    def __len__(self) -> int:
        return len(self.members)

    def __repr__(self) -> str:  # compact, deterministic
        names = ",".join(sorted(self.members)[:6])
        more = f",+{len(self.members)-6}" if len(self.members) > 6 else ""
        return f"FusionPattern[{self.pattern_class}]({names}{more})"


@dataclass(frozen=True)
class PackPattern(FusionPattern):
    """A *horizontal* pattern: the union of several mutually independent
    member subgraphs packed into one kernel (paper §4.2's independent-op
    packing).  ``member_groups`` records the provenance — which nodes came
    from which packed subgraph — so the plan verifier can re-check pack
    legality (disjoint groups, no cross-group dependence) and ``report()``
    can surface pack statistics.  Everything else (cost, ILP exclusivity,
    emission) treats the pack as an ordinary pattern over ``members``."""

    member_groups: tuple[frozenset[str], ...] = field(
        default=(), compare=False)

    def __post_init__(self):
        super().__post_init__()
        if len(self.member_groups) < 2:
            raise ValueError("pack needs >= 2 member subgraphs")
        seen: set[str] = set()
        union: set[str] = set()
        for grp in self.member_groups:
            if not grp:
                raise ValueError("empty pack member subgraph")
            if grp & seen:
                raise ValueError(
                    f"pack member subgraphs overlap on {sorted(grp & seen)[:4]}")
            seen |= grp
            union |= grp
        if union != set(self.members):
            raise ValueError("pack member subgraphs do not cover the pattern")

    @cached_property
    def cross_group_edges(self) -> list[tuple[str, str]]:
        """(producer, consumer) pairs crossing two member subgraphs — must be
        empty for a legal pack (the subgraphs are independent by
        construction; the verifier re-checks via this property)."""
        owner: dict[str, int] = {}
        for i, grp in enumerate(self.member_groups):
            for m in grp:
                owner[m] = i
        bad: list[tuple[str, str]] = []
        for n in self.nodes:
            for o in n.operands:
                if o in owner and owner[o] != owner[n.name]:
                    bad.append((o, n.name))
        return bad

    def __repr__(self) -> str:
        return (f"PackPattern[{self.pattern_class}]"
                f"({len(self.member_groups)}x{len(self.members)//max(len(self.member_groups),1)})")


def contraction_creates_cycle(graph: Graph, members: Iterable[str]) -> bool:
    """True iff contracting `members` to a single node creates a cycle, i.e.
    there is a path  member -> (outside nodes) -> member.

    We BFS forward from the out-frontier of the member set through non-member
    nodes only; reaching any member again means a cycle (Fig. 3 in the paper).
    """
    mset = set(members)
    frontier: list[str] = []
    for m in mset:
        for u in graph.users(m):
            if u not in mset:
                frontier.append(u)
    seen = set(frontier)
    while frontier:
        cur = frontier.pop()
        if cur in mset:
            return True
        for u in graph.users(cur):
            if u in mset:
                return True
            if u not in seen:
                seen.add(u)
                frontier.append(u)
    return False
