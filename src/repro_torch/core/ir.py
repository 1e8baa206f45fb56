"""StitchIR — the computation-graph IR FusionStitching plans over.

The paper operates on XLA-HLO-like dataflow graphs whose vertices are tensor
ops classified into the categories the fusion planner reasons about
(elementwise / reduction / gemm / batched-gemm / data-movement).  StitchIR is
that graph: a small, explicit DAG of :class:`OpNode` with static shapes and
dtypes, cheap to build by hand (benchmarks, tests) or from a traced jaxpr
(:mod:`repro_torch.core.trace`).

Design notes
------------
* Nodes are identified by unique string names; the graph owns a dict
  ``name -> OpNode`` plus explicit use/def edges derived from operand lists.
* Shapes are plain tuples of ints; dtype is a numpy dtype string.  We never
  carry tracer state here — the IR is a value-level description, which is what
  makes plan optimization (a pure combinatorial problem) fast and hermetic.
* ``OpKind`` mirrors the paper's vocabulary (§4.2): ELEMENTWISE, REDUCTION
  (with row/column/scalar sub-kinds derived from the reduced axes), GEMM,
  BATCHED_GEMM, plus the glue kinds every real graph has (PARAMETER, CONSTANT,
  BROADCAST, RESHAPE, TRANSPOSE, TUPLE).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field, replace
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

__all__ = [
    "OpKind",
    "ReduceKind",
    "OpNode",
    "Graph",
    "GraphBuilder",
    "itemsize",
    "tensor_bytes",
]


class OpKind(enum.Enum):
    PARAMETER = "parameter"
    CONSTANT = "constant"
    ELEMENTWISE = "elementwise"
    BROADCAST = "broadcast"
    RESHAPE = "reshape"
    TRANSPOSE = "transpose"
    REDUCTION = "reduction"
    GEMM = "gemm"
    BATCHED_GEMM = "batched_gemm"
    SLICE = "slice"
    GATHER = "gather"
    SCATTER = "scatter"
    TUPLE = "tuple"
    CUSTOM = "custom"  # opaque (e.g. an op we never fuse across)


class ReduceKind(enum.Enum):
    """Sub-classification of reductions, following the paper's partition-op
    widening order (§4.2.1): row reductions are the friendliest (fusible with
    warp/sublane composition), column and scalar reductions have dedicated
    parallelization needs and start life as partition ops."""

    ROW = "row"        # innermost (minor-most) dims reduced
    COLUMN = "column"  # non-innermost dims reduced
    SCALAR = "scalar"  # all dims reduced
    NONE = "none"


# dtypes numpy does not spell natively (numpy has no bfloat16)
_EXTRA_ITEMSIZE = {"bfloat16": 2}


def itemsize(dtype: str) -> int:
    size = _EXTRA_ITEMSIZE.get(str(dtype))
    return size if size is not None else np.dtype(dtype).itemsize


def tensor_bytes(shape: Sequence[int], dtype: str) -> int:
    return int(math.prod(shape)) * itemsize(dtype) if shape else itemsize(dtype)


@dataclass
class OpNode:
    """One vertex of the dataflow DAG."""

    name: str
    kind: OpKind
    shape: tuple[int, ...]
    dtype: str
    operands: tuple[str, ...] = ()
    # Op-specific payload:
    #   ELEMENTWISE: {"op": "add"|"mul"|...}  (primitive spelling)
    #   REDUCTION:   {"axes": (..,), "op": "sum"|"max"|...}
    #   GEMM/BATCHED_GEMM: {"contract": ((lhs_dims),(rhs_dims)), "batch": ((..),(..))}
    #   BROADCAST:   {"bcast_dims": (..,)}
    #   TRANSPOSE:   {"perm": (..,)}
    attrs: dict = field(default_factory=dict)

    # -- derived helpers ----------------------------------------------------
    @property
    def size(self) -> int:
        return int(math.prod(self.shape)) if self.shape else 1

    @property
    def bytes(self) -> int:
        return tensor_bytes(self.shape, self.dtype)

    @property
    def reduce_kind(self) -> ReduceKind:
        if self.kind is not OpKind.REDUCTION:
            return ReduceKind.NONE
        axes = tuple(self.attrs.get("axes", ()))
        if not axes:
            return ReduceKind.NONE
        in_rank = self.attrs.get("in_rank")
        if in_rank is None:
            in_rank = len(self.shape) + len(axes)
        if len(axes) == in_rank:
            return ReduceKind.SCALAR
        if (in_rank - 1) in axes:
            return ReduceKind.ROW
        return ReduceKind.COLUMN

    def is_compute_intensive(self) -> bool:
        return self.kind in (OpKind.GEMM, OpKind.BATCHED_GEMM)

    def is_memory_intensive(self) -> bool:
        return self.kind in (
            OpKind.ELEMENTWISE,
            OpKind.BROADCAST,
            OpKind.RESHAPE,
            OpKind.TRANSPOSE,
            OpKind.REDUCTION,
            OpKind.SLICE,
        )

    def is_source(self) -> bool:
        return self.kind in (OpKind.PARAMETER, OpKind.CONSTANT)

    def __hash__(self) -> int:  # nodes are interned by name within a graph
        return hash(self.name)


class Graph:
    """A static-shape dataflow DAG.

    Invariants (checked by :meth:`validate`):
      * every operand of every node exists in the graph,
      * the graph is acyclic,
      * outputs reference existing nodes.
    """

    def __init__(self, name: str = "graph") -> None:
        self.name = name
        self.nodes: dict[str, OpNode] = {}
        self.outputs: list[str] = []
        self._users: dict[str, set[str]] | None = None  # lazy cache
        self._topo: list[str] | None = None             # lazy cache

    # -- construction -------------------------------------------------------
    def add(self, node: OpNode) -> OpNode:
        if node.name in self.nodes:
            raise ValueError(f"duplicate node name {node.name!r}")
        for o in node.operands:
            if o not in self.nodes:
                raise ValueError(f"{node.name}: unknown operand {o!r}")
        self.nodes[node.name] = node
        self._users = None
        self._topo = None
        return node

    def mark_output(self, *names: str) -> None:
        for n in names:
            if n not in self.nodes:
                raise ValueError(f"unknown output {n!r}")
            if n not in self.outputs:
                self.outputs.append(n)
        self._users = None

    # -- queries --------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.nodes)

    def __contains__(self, name: str) -> bool:
        return name in self.nodes

    def __getitem__(self, name: str) -> OpNode:
        return self.nodes[name]

    def users(self, name: str) -> set[str]:
        if self._users is None:
            users: dict[str, set[str]] = {n: set() for n in self.nodes}
            for node in self.nodes.values():
                for o in node.operands:
                    users[o].add(node.name)
            self._users = users
        return self._users[name]

    def producers(self, name: str) -> tuple[str, ...]:
        return self.nodes[name].operands

    def compute_nodes(self) -> list[OpNode]:
        """Nodes that correspond to executed kernels (excludes params/consts/
        tuples) — the denominator for kernel-count statistics."""
        return [
            n
            for n in self.nodes.values()
            if n.kind not in (OpKind.PARAMETER, OpKind.CONSTANT, OpKind.TUPLE)
        ]

    def topo_order(self) -> list[str]:
        """Deterministic Kahn topological order (insertion-order tiebreak).

        Cached until the next :meth:`add`; a fresh copy is returned so
        callers may mutate their list freely."""
        if self._topo is not None:
            return list(self._topo)
        # count operand edges (duplicates count once per unique producer)
        indeg = {n: len(set(self.nodes[n].operands)) for n in self.nodes}
        order: list[str] = []
        ready = [n for n in self.nodes if indeg[n] == 0]
        users = {n: sorted(self.users(n)) for n in self.nodes}
        seen_ready = set(ready)
        while ready:
            cur = ready.pop(0)
            order.append(cur)
            for u in users[cur]:
                indeg[u] -= 1
                if indeg[u] == 0 and u not in seen_ready:
                    ready.append(u)
                    seen_ready.add(u)
        if len(order) != len(self.nodes):
            raise ValueError(f"cycle detected in graph {self.name!r}")
        self._topo = order
        return list(order)

    def validate(self) -> None:
        self.topo_order()  # raises on cycles / dangling operands
        for out in self.outputs:
            if out not in self.nodes:
                raise ValueError(f"output {out!r} missing")

    # -- subgraph / pattern helpers ------------------------------------------
    def external_inputs(self, members: Iterable[str]) -> list[str]:
        """Tensors read by `members` but produced outside the set."""
        mset = set(members)
        ext: list[str] = []
        seen = set()
        for m in mset:
            for o in self.nodes[m].operands:
                if o not in mset and o not in seen:
                    ext.append(o)
                    seen.add(o)
        return ext

    def external_outputs(self, members: Iterable[str]) -> list[str]:
        """Tensors produced by `members` and read outside the set (or graph
        outputs)."""
        mset = set(members)
        outs: list[str] = []
        for m in sorted(mset):
            used_outside = any(u not in mset for u in self.users(m))
            if used_outside or m in self.outputs:
                outs.append(m)
        return outs

    def internal_edges_bytes(self, members: Iterable[str]) -> int:
        """Bytes of intermediates that fusion keeps on-chip: tensors produced
        AND consumed entirely inside the member set."""
        mset = set(members)
        total = 0
        for m in mset:
            node = self.nodes[m]
            if node.is_source():
                continue
            users = self.users(m)
            if users and users.issubset(mset) and m not in self.outputs:
                total += node.bytes
        return total

    def induced_reaches(self, src: str, dst: str, forbidden: set[str]) -> bool:
        """Is there a path src -> dst that leaves `forbidden` (used for cycle
        checks when contracting a candidate pattern)?"""
        stack = [src]
        seen = {src}
        while stack:
            cur = stack.pop()
            if cur == dst:
                return True
            for u in self.users(cur):
                if u in seen:
                    continue
                seen.add(u)
                stack.append(u)
        return False

    # -- pretty ---------------------------------------------------------------
    def dump(self) -> str:
        lines = [f"Graph {self.name} ({len(self.nodes)} nodes)"]
        for n in self.topo_order():
            node = self.nodes[n]
            ops = ", ".join(node.operands)
            extra = ""
            if node.kind is OpKind.REDUCTION:
                extra = f" axes={node.attrs.get('axes')}"
            elif node.kind is OpKind.ELEMENTWISE:
                extra = f" op={node.attrs.get('op')}"
            lines.append(
                f"  {n} = {node.kind.value}{extra} {node.dtype}{list(node.shape)}"
                + (f" ({ops})" if ops else "")
            )
        lines.append(f"  outputs: {self.outputs}")
        return "\n".join(lines)


class GraphBuilder:
    """Ergonomic construction API used by benchmarks/tests.

    >>> b = GraphBuilder("softmax")
    >>> x = b.param("x", (256, 1024))
    >>> m = b.reduce("max", x, axes=(1,))
    >>> e = b.ew("exp", b.ew("sub", x, b.bcast(m, (256, 1024), (0,))))
    >>> s = b.reduce("sum", e, axes=(1,))
    >>> y = b.ew("div", e, b.bcast(s, (256, 1024), (0,)))
    >>> g = b.build(outputs=[y])
    """

    def __init__(self, name: str = "graph") -> None:
        self.graph = Graph(name)
        self._ctr: dict[str, int] = {}

    def _fresh(self, stem: str) -> str:
        i = self._ctr.get(stem, 0)
        self._ctr[stem] = i + 1
        return f"{stem}_{i}" if i or stem in self.graph.nodes else stem

    def _node(self, stem, kind, shape, dtype, operands=(), **attrs) -> str:
        name = self._fresh(stem)
        self.graph.add(
            OpNode(name, kind, tuple(int(s) for s in shape), dtype, tuple(operands), attrs)
        )
        return name

    # sources
    def param(self, name: str, shape, dtype: str = "float32") -> str:
        return self._node(name, OpKind.PARAMETER, shape, dtype)

    def const(self, name: str, shape=(), dtype: str = "float32") -> str:
        return self._node(name, OpKind.CONSTANT, shape, dtype)

    # elementwise (shape = first operand's shape unless given)
    def ew(self, op: str, *operands: str, shape=None, dtype=None) -> str:
        first = self.graph[operands[0]]
        shape = tuple(shape) if shape is not None else first.shape
        dtype = dtype or first.dtype
        return self._node(op, OpKind.ELEMENTWISE, shape, dtype, operands, op=op)

    def bcast(self, operand: str, shape, dims: tuple[int, ...]) -> str:
        src = self.graph[operand]
        return self._node(
            "bcast", OpKind.BROADCAST, shape, src.dtype, (operand,), bcast_dims=tuple(dims)
        )

    def reshape(self, operand: str, shape) -> str:
        src = self.graph[operand]
        return self._node("reshape", OpKind.RESHAPE, shape, src.dtype, (operand,))

    def transpose(self, operand: str, perm: tuple[int, ...]) -> str:
        src = self.graph[operand]
        shape = tuple(src.shape[p] for p in perm)
        return self._node("transpose", OpKind.TRANSPOSE, shape, src.dtype, (operand,), perm=tuple(perm))

    def reduce(self, op: str, operand: str, axes: tuple[int, ...], keepdims: bool = False) -> str:
        src = self.graph[operand]
        axes = tuple(sorted(a % len(src.shape) for a in axes))
        if keepdims:
            shape = tuple(1 if i in axes else s for i, s in enumerate(src.shape))
        else:
            shape = tuple(s for i, s in enumerate(src.shape) if i not in axes)
        return self._node(
            f"reduce_{op}", OpKind.REDUCTION, shape, src.dtype, (operand,),
            op=op, axes=axes, in_rank=len(src.shape), keepdims=keepdims,
        )

    def dot(self, lhs: str, rhs: str, name: str = "dot") -> str:
        """Plain 2-D matmul (m,k) @ (k,n)."""
        a, b = self.graph[lhs], self.graph[rhs]
        m, k = a.shape
        k2, n = b.shape
        assert k == k2, f"dot shape mismatch {a.shape} @ {b.shape}"
        return self._node(
            name, OpKind.GEMM, (m, n), a.dtype, (lhs, rhs),
            contract=((1,), (0,)), batch=((), ()),
        )

    def batched_dot(self, lhs: str, rhs: str, name: str = "bdot") -> str:
        """(b,m,k) @ (b,k,n)."""
        a, b = self.graph[lhs], self.graph[rhs]
        bb, m, k = a.shape
        bb2, k2, n = b.shape
        assert bb == bb2 and k == k2, f"bdot mismatch {a.shape} @ {b.shape}"
        return self._node(
            name, OpKind.BATCHED_GEMM, (bb, m, n), a.dtype, (lhs, rhs),
            contract=((2,), (1,)), batch=((0,), (0,)),
        )

    def slice_(self, operand: str, starts, limits, name: str = "slice") -> str:
        src_node = self.graph[operand]
        shape = tuple(l - s for s, l in zip(starts, limits))
        return self._node(name, OpKind.SLICE, shape, src_node.dtype, (operand,),
                          starts=tuple(starts), limits=tuple(limits))

    def gather(self, table: str, indices: str, name: str = "gather") -> str:
        t, ix = self.graph[table], self.graph[indices]
        shape = ix.shape + t.shape[1:]
        return self._node(name, OpKind.GATHER, shape, t.dtype, (table, indices))

    def custom(self, name: str, shape, dtype: str, operands=(), **attrs) -> str:
        return self._node(name, OpKind.CUSTOM, shape, dtype, operands, **attrs)

    def tuple_(self, *operands: str) -> str:
        return self._node("tuple", OpKind.TUPLE, (), "float32", operands)

    def build(self, outputs: Sequence[str]) -> Graph:
        self.graph.mark_output(*outputs)
        self.graph.validate()
        return self.graph
