"""Pass 1 — IR verifier: structural + per-OpKind shape/dtype legality.

``verify_graph`` statically checks a :class:`repro_torch.core.Graph` without
executing it and without importing jax: every operand resolves (RA001),
the def-use relation is acyclic (RA002), declared outputs exist (RA003),
dtypes parse (RA004), and each node's shape is consistent with what the
executors (:mod:`repro_torch.core.codegen` / the Pallas emitters) would
actually produce — dot contraction dims, broadcast dims, reduce axes,
reshape element counts, transpose perms, slice bounds, gather shapes.
Dead compute nodes are reported as warnings (RA005).

This is the real replacement for the thin ``Graph.validate()``:
``GraphBuilder``/``Graph.add`` enforce some of this at construction
time, but graphs arriving from disk records, hand mutation, or future
frontends do not get that protection.
"""

from __future__ import annotations

import math

from repro_torch.core.ir import Graph, OpKind, OpNode, itemsize

from .findings import Finding

__all__ = ["verify_graph"]


def _broadcast_shapes(shapes: list[tuple[int, ...]]) -> tuple[int, ...] | None:
    """numpy-style broadcast result, or None when incompatible."""
    rank = max((len(s) for s in shapes), default=0)
    out = []
    for i in range(1, rank + 1):
        dim = 1
        for s in shapes:
            if i <= len(s):
                d = s[-i]
                if d == 1:
                    continue
                if dim not in (1, d):
                    return None
                dim = d
        out.append(dim)
    return tuple(reversed(out))


def _check_elementwise(g: Graph, n: OpNode) -> Finding | None:
    shapes = [g[o].shape for o in n.operands]
    if n.attrs.get("op") == "iota":
        return None                       # generator: no operand constraint
    bc = _broadcast_shapes(shapes)
    if bc is None:
        return Finding("RA010", f"operand shapes {shapes} do not broadcast",
                       node=n.name)
    if bc != n.shape:
        return Finding("RA010", f"operands {shapes} broadcast to {bc}, "
                                f"node declares {n.shape}", node=n.name)
    return None


def _check_broadcast(g: Graph, n: OpNode) -> Finding | None:
    src = g[n.operands[0]].shape
    dims = n.attrs.get("bcast_dims")
    if dims is None:
        return Finding("RA011", "missing bcast_dims attr", node=n.name)
    dims = tuple(dims)
    if len(dims) != len(src):
        return Finding("RA011", f"bcast_dims {dims} must have one entry per "
                                f"operand dim (operand shape {src})",
                       node=n.name)
    if any(not 0 <= d < len(n.shape) for d in dims) or \
            any(a >= b for a, b in zip(dims, dims[1:])):
        return Finding("RA011", f"bcast_dims {dims} not strictly increasing "
                                f"within output rank {len(n.shape)}",
                       node=n.name)
    for i, d in enumerate(dims):
        if src[i] not in (1, n.shape[d]):
            return Finding("RA011", f"operand dim {i} (={src[i]}) cannot map "
                                    f"to output dim {d} (={n.shape[d]})",
                           node=n.name)
    return None


def _check_reshape(g: Graph, n: OpNode) -> Finding | None:
    src = g[n.operands[0]].shape
    if math.prod(src) != math.prod(n.shape):
        return Finding("RA012", f"reshape {src} -> {n.shape} changes element "
                                f"count {math.prod(src)} -> "
                                f"{math.prod(n.shape)}", node=n.name)
    return None


def _check_transpose(g: Graph, n: OpNode) -> Finding | None:
    src = g[n.operands[0]].shape
    perm = n.attrs.get("perm")
    if perm is None or sorted(perm) != list(range(len(src))):
        return Finding("RA013", f"perm {perm} is not a permutation of "
                                f"rank-{len(src)} axes", node=n.name)
    want = tuple(src[p] for p in perm)
    if want != n.shape:
        return Finding("RA013", f"transpose of {src} by {tuple(perm)} gives "
                                f"{want}, node declares {n.shape}",
                       node=n.name)
    return None


def _check_reduction(g: Graph, n: OpNode) -> Finding | None:
    src = g[n.operands[0]].shape
    axes = n.attrs.get("axes")
    if axes is None:
        return Finding("RA014", "missing axes attr", node=n.name)
    axes = tuple(axes)
    if len(set(axes)) != len(axes) or \
            any(not 0 <= a < len(src) for a in axes):
        return Finding("RA014", f"axes {axes} invalid for operand rank "
                                f"{len(src)}", node=n.name)
    if n.attrs.get("keepdims", False):
        want = tuple(1 if i in axes else d for i, d in enumerate(src))
    else:
        want = tuple(d for i, d in enumerate(src) if i not in axes)
    if want != n.shape:
        return Finding("RA014", f"reduce of {src} over {axes} gives {want}, "
                                f"node declares {n.shape}", node=n.name)
    return None


def _check_dot(g: Graph, n: OpNode) -> Finding | None:
    if len(n.operands) != 2:
        return Finding("RA015", f"dot takes 2 operands, got "
                                f"{len(n.operands)}", node=n.name)
    lhs, rhs = g[n.operands[0]].shape, g[n.operands[1]].shape
    try:
        lc, rc = (tuple(d) for d in n.attrs["contract"])
        lb, rb = (tuple(d) for d in n.attrs.get("batch", ((), ())))
    except (KeyError, TypeError, ValueError):
        return Finding("RA015", f"malformed contract/batch attrs "
                                f"{n.attrs.get('contract')!r}", node=n.name)
    for dims, shape, side in ((lc, lhs, "lhs"), (rc, rhs, "rhs"),
                              (lb, lhs, "lhs"), (rb, rhs, "rhs")):
        if any(not 0 <= d < len(shape) for d in dims):
            return Finding("RA015", f"{side} dims {dims} out of range for "
                                    f"shape {shape}", node=n.name)
    if len(lc) != len(rc) or any(lhs[a] != rhs[b] for a, b in zip(lc, rc)):
        return Finding("RA015", f"contracted extents differ: lhs{lhs}@{lc} "
                                f"vs rhs{rhs}@{rc}", node=n.name)
    if len(lb) != len(rb) or any(lhs[a] != rhs[b] for a, b in zip(lb, rb)):
        return Finding("RA015", f"batch extents differ: lhs{lhs}@{lb} vs "
                                f"rhs{rhs}@{rb}", node=n.name)
    want = tuple(lhs[d] for d in lb) \
        + tuple(d for i, d in enumerate(lhs) if i not in lc and i not in lb) \
        + tuple(d for i, d in enumerate(rhs) if i not in rc and i not in rb)
    if want != n.shape:
        return Finding("RA015", f"dot_general({lhs}, {rhs}) gives {want}, "
                                f"node declares {n.shape}", node=n.name)
    return None


def _check_slice(g: Graph, n: OpNode) -> Finding | None:
    src = g[n.operands[0]].shape
    starts = n.attrs.get("starts")
    limits = n.attrs.get("limits")
    strides = n.attrs.get("strides") or (1,) * len(src)
    if starts is None or limits is None or \
            not len(starts) == len(limits) == len(strides) == len(src):
        return Finding("RA016", f"starts/limits {starts}/{limits} do not "
                                f"match operand rank {len(src)}", node=n.name)
    for s, l, d in zip(starts, limits, src):
        if not 0 <= s <= l <= d:
            return Finding("RA016", f"slice [{starts}:{limits}] out of "
                                    f"bounds for shape {src}", node=n.name)
    want = tuple(-(-(l - s) // st)
                 for s, l, st in zip(starts, limits, strides))
    if want != n.shape:
        return Finding("RA016", f"slice of {src} gives {want}, node "
                                f"declares {n.shape}", node=n.name)
    return None


def _check_gather(g: Graph, n: OpNode) -> Finding | None:
    if len(n.operands) != 2:
        return Finding("RA017", f"gather takes 2 operands, got "
                                f"{len(n.operands)}", node=n.name)
    table, idx = g[n.operands[0]].shape, g[n.operands[1]].shape
    want = idx + table[1:]
    if want != n.shape:
        return Finding("RA017", f"take(table{table}, idx{idx}) gives {want}, "
                                f"node declares {n.shape}", node=n.name)
    return None


_KIND_CHECKS = {
    OpKind.ELEMENTWISE: _check_elementwise,
    OpKind.BROADCAST: _check_broadcast,
    OpKind.RESHAPE: _check_reshape,
    OpKind.TRANSPOSE: _check_transpose,
    OpKind.REDUCTION: _check_reduction,
    OpKind.GEMM: _check_dot,
    OpKind.BATCHED_GEMM: _check_dot,
    OpKind.SLICE: _check_slice,
    OpKind.GATHER: _check_gather,
    # CUSTOM / SCATTER / TUPLE: opaque or shape-free carriers — only the
    # structural checks (operands, cycles, dtype) apply
}


def verify_graph(g: Graph) -> list[Finding]:
    """Run every IR check; returns all findings (empty = clean)."""
    findings: list[Finding] = []

    # -- structural: operands resolve, outputs exist -----------------------
    resolved: set[str] = set()
    for n in g.nodes.values():
        missing = [o for o in n.operands if o not in g.nodes]
        if missing:
            findings.append(Finding(
                "RA001", f"operand(s) {missing} undefined", node=n.name))
        else:
            resolved.add(n.name)
    for out in g.outputs:
        if out not in g.nodes:
            findings.append(Finding(
                "RA003", f"declared output {out!r} not in graph", node=out))

    # -- cycles (Kahn over edges whose endpoints both exist) ---------------
    indeg = {name: 0 for name in g.nodes}
    users: dict[str, list[str]] = {name: [] for name in g.nodes}
    for n in g.nodes.values():
        for o in n.operands:
            if o in g.nodes:
                indeg[n.name] += 1
                users[o].append(n.name)
    ready = [name for name, d in indeg.items() if d == 0]
    seen = 0
    while ready:
        cur = ready.pop()
        seen += 1
        for u in users[cur]:
            indeg[u] -= 1
            if indeg[u] == 0:
                ready.append(u)
    if seen != len(g.nodes):
        stuck = sorted(name for name, d in indeg.items() if d > 0)
        findings.append(Finding(
            "RA002", f"def-use cycle through {stuck[:6]}"
                     + ("..." if len(stuck) > 6 else ""),
            node=stuck[0] if stuck else None))

    # -- dtypes ------------------------------------------------------------
    for n in g.nodes.values():
        try:
            itemsize(n.dtype)
        except (TypeError, ValueError):
            findings.append(Finding(
                "RA004", f"dtype {n.dtype!r} is not a numpy dtype",
                node=n.name))

    # -- per-kind shape rules (only on nodes whose operands resolve, so a
    #    single missing node does not cascade into shape noise) ------------
    for n in g.nodes.values():
        if n.name not in resolved:
            continue
        check = _KIND_CHECKS.get(n.kind)
        if check is None:
            continue
        if n.kind is not OpKind.ELEMENTWISE and not n.operands:
            continue                        # structurally hopeless; RA001-ish
        f = check(g, n)
        if f is not None:
            findings.append(f)

    # -- dead compute nodes (reverse reachability from outputs) ------------
    live: set[str] = set()
    stack = [o for o in g.outputs if o in g.nodes]
    while stack:
        cur = stack.pop()
        if cur in live:
            continue
        live.add(cur)
        stack.extend(o for o in g.nodes[cur].operands if o in g.nodes)
    for n in g.nodes.values():
        if n.kind in (OpKind.PARAMETER, OpKind.CONSTANT):
            continue
        if n.name not in live:
            # an unused projection of a live multi-output custom base is
            # structural, not dead compute: the kernel produces it whether
            # or not anyone reads it (e.g. a scan's final-state output)
            if ("project" in n.attrs and n.operands
                    and n.operands[0] in live):
                continue
            findings.append(Finding(
                "RA005", "compute node feeds no graph output", node=n.name))

    return findings
