"""Canonical graph signatures — the cache key half of StitchCache.

A fusion plan is a function of graph *structure* (topology, op kinds, attrs,
dtypes), not of node names, trace order, or — up to feasibility — exact
shapes.  This module computes:

* ``graph_key``  — a hex digest of the structure with shapes factored out.
  Invariant to node renaming and to the order nodes were inserted/traced.
  Two graphs with equal ``graph_key`` are isomorphic as op DAGs (same node
  count, same edges under the canonical numbering), so a fusion plan stored
  in canonical coordinates for one replays on the other.
* ``canon_order`` — the canonical node numbering itself: position ``i`` in
  one graph corresponds structurally to position ``i`` in any other graph
  with the same ``graph_key``.  Plans are persisted as sets of canonical
  indices and mapped back through this list on replay.
* ``shape_key`` — digest of every node's concrete shape in canonical order.
  The bucketing policy (:mod:`repro_torch.cache.policy`) coarsens shapes
  before digesting so nearby sequence lengths share one cache entry.

Safety note: a cache collision (two distinct graphs hashing alike) can only
ever produce a *suboptimal* plan, never a wrong answer — replay always
evaluates the actual new graph's nodes; the record only dictates grouping.

Algorithm
---------
1. Bottom-up structural hash per node: ``h(n) = H(kind, dtype, rank,
   normalized attrs, (h(operand_0), h(operand_1), ...))``.  Operand order is
   preserved (sub is not commutative); names never enter the hash.
2. Canonical order: deterministic pre-order DFS from the outputs (in output
   order, operands in positional order) — purely structural.  Nodes
   unreachable from any output (rare dead code) are appended sorted by
   structural hash.
3. ``graph_key`` hashes the canonical sequence of per-node descriptors with
   operand edges rewritten to canonical indices — this captures sharing
   (a diamond and a duplicated subtree hash differently).

Attr normalization: runtime-only attrs (closures such as ``eval_fn``,
declared in :data:`RUNTIME_ONLY_ATTRS`) are excluded; shape-dependent attrs
(slice ``starts``/``limits``) contribute only their arity so shape bucketing
still works; constant payloads (``torch.Tensor`` or numpy) contribute their
value when scalar and their dtype/rank otherwise (exact shapes are the shape
key's job), never their device.  Every spelling is stable across processes:
digests are ``hashlib``'s, never Python's salted ``hash()``, and an object
whose ``repr`` holds a memory address is spelled by its type.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.ir import Graph

__all__ = [
    "GraphSignature",
    "compute_signature",
    "config_key",
    "node_struct_hashes",
    "placement_key",
    "RUNTIME_ONLY_ATTRS",
    "SHAPE_DEPENDENT_ATTRS",
]

# Attrs that exist only to make a node executable (closures, projections of
# multi-output customs) — never part of the identity of the computation.
RUNTIME_ONLY_ATTRS = frozenset({"eval_fn"})

# Attrs whose *values* scale with tensor shapes; they contribute arity only,
# so a length-100 and a length-120 slice of the same program share a
# graph_key and can share a shape bucket.
SHAPE_DEPENDENT_ATTRS = frozenset({"starts", "limits"})


def _digest(payload: str) -> str:
    return hashlib.sha256(payload.encode()).hexdigest()


def _array_sig(dtype, ndim: int, item) -> str:
    if ndim == 0:
        return f"scalar:{dtype}:{item()!r}"
    return f"array:{dtype}:rank{ndim}"


def _stable_value(value) -> str:
    """A tensor, array, dtype or device spelled without its payload's
    addresses: a tensor is reduced as an array is (its device left out)."""
    if isinstance(value, torch.Tensor):
        dtype = str(value.dtype).removeprefix("torch.")
        return _array_sig(dtype, value.dim(), value.item)
    if isinstance(value, (np.ndarray, np.generic)):
        arr = np.asarray(value)
        return _array_sig(arr.dtype, arr.ndim, arr.item)
    if isinstance(value, torch.dtype):
        return str(value)
    if isinstance(value, torch.device):
        return f"device:{value.type}"
    if isinstance(value, dict):
        return "{" + ",".join(f"{k}={_stable_value(value[k])}"
                              for k in sorted(value)) + "}"
    if isinstance(value, (list, tuple)):
        return "(" + ",".join(_stable_value(v) for v in value) + ")"
    if callable(value):
        return f"callable:{getattr(value, '__name__', '?')}"
    text = repr(value)
    return f"object:{type(value).__name__}" if " at 0x" in text else text


def _stable_attr_value(key: str, value) -> str:
    if key in SHAPE_DEPENDENT_ATTRS:
        try:
            return f"len={len(value)}" if value is not None else "none"
        except TypeError:
            return "scalar"
    return _stable_value(value)


def _attr_sig(node) -> str:
    items = []
    for k in sorted(node.attrs):
        if k in RUNTIME_ONLY_ATTRS:
            continue
        items.append(f"{k}={_stable_attr_value(k, node.attrs[k])}")
    return ";".join(items)


def node_struct_hashes(g: Graph) -> dict[str, str]:
    """Bottom-up, name-free structural hash for every node."""
    h: dict[str, str] = {}
    for name in g.topo_order():
        node = g.nodes[name]
        payload = "|".join(
            (
                node.kind.value,
                node.dtype,
                str(len(node.shape)),
                _attr_sig(node),
                ",".join(h[o] for o in node.operands),
            )
        )
        h[name] = _digest(payload)
    return h


def _canonical_order(g: Graph, struct: dict[str, str]) -> list[str]:
    order: list[str] = []
    seen: set[str] = set()
    # Pre-order DFS from outputs; operands visited in positional order.
    for out in g.outputs:
        stack = [out]
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            order.append(cur)
            # push reversed so operand 0 is visited first
            stack.extend(reversed(g.nodes[cur].operands))
    # Dead code (unreachable from outputs): identical-hash stragglers are
    # structurally interchangeable below their frontier, so hash order plus
    # a stable secondary key is sufficient for a valid (if arbitrary)
    # correspondence; replay validity is re-checked against the new graph.
    rest = sorted((n for n in g.nodes if n not in seen), key=lambda n: (struct[n], n))
    order.extend(rest)
    return order


@dataclass(frozen=True)
class GraphSignature:
    graph_key: str
    shape_key: str                       # digest of exact shapes, canon order
    canon_order: tuple[str, ...] = field(repr=False)
    shapes: tuple[tuple[int, ...], ...] = field(repr=False)

    @property
    def node_to_index(self) -> dict[str, int]:
        return {n: i for i, n in enumerate(self.canon_order)}

    def bucket_key(self, policy) -> str:
        """Digest of shapes after the policy's coarsening."""
        bucketed = tuple(policy.bucket_shape(s) for s in self.shapes)
        return _digest(repr(bucketed))


def config_key(gen_cfg=None) -> str:
    """Stable digest of the pattern-generation knobs a plan was solved under.

    Two compiles of the same graph under different :class:`GenConfig`
    settings (``large_gemm_flops``, ``stitch_custom``, scratch budget, ...)
    legitimately choose different plans; without this component a plan cached
    under one config replays for all of them.  ``None`` hashes identically to
    a default ``GenConfig()``, so callers that never touch the knobs keep
    hitting the same entries.
    """
    import dataclasses

    from repro_torch.core.fusiongen import GenConfig

    cfg = gen_cfg if gen_cfg is not None else GenConfig()
    fields = sorted(dataclasses.asdict(cfg).items())
    return _digest(repr(fields))[:12]


def placement_key(mesh=None, specs=None) -> str:
    """The placement half of the cache key: ``""`` for the single-device
    placement, the only one the port has (mesh dispatch is not ported)."""
    if mesh is not None or specs is not None:
        raise NotImplementedError("mesh placement is not ported yet; the "
                                  "port stitches on one device")
    return ""


def compute_signature(g: Graph) -> GraphSignature:
    struct = node_struct_hashes(g)
    order = _canonical_order(g, struct)
    index = {n: i for i, n in enumerate(order)}
    desc = []
    for name in order:
        node = g.nodes[name]
        desc.append(
            (
                node.kind.value,
                node.dtype,
                len(node.shape),
                _attr_sig(node),
                tuple(index[o] for o in node.operands),
            )
        )
    outputs = tuple(index[o] for o in g.outputs)
    graph_key = _digest(repr((desc, outputs)))
    shapes = tuple(tuple(int(d) for d in g.nodes[n].shape) for n in order)
    shape_key = _digest(repr(shapes))
    return GraphSignature(graph_key, shape_key, tuple(order), shapes)
