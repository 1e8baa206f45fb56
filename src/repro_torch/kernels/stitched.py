"""Generic stitched-kernel emitter — paper §5 mapped to Triton on Hopper.

Replaces the reference's ``repro/kernels/stitched.py:build_stitched_callable``
(its ``pl.pallas_call`` at line 450).  Given a :class:`FusionPattern`, emit
ONE Triton kernel computing the whole pattern: the generated source holds
one statement per member node, evaluated value-to-value in registers
(thread composition), with row reductions computed on the register tile and
feeding dependent elementwise members in the same body (warp composition).

Design.  Each program owns ``BLOCK_R`` rows of the pattern's row dimension
R (see :func:`analyze_pattern`, whose role decisions are the reference's).
A value keeps its row axis (ROW role) plus every trailing dim of extent > 1,
each padded to a power of two and masked; INV values are fully resident in
every program.  Masked lanes take the neutral value before a reduction (0
for sum, -inf for max).  Float members compute in f32 and round to their
declared IR dtype after every member, as eager PyTorch does; converts are
explicit nodes.  Shapes are baked into the source, so one kernel is
generated per (pattern, shapes).

Bound.  Every member is memory-bound: the least time is the bytes of the
external inputs read once plus the outputs written once, over 3.35 TB/s;
the design keeps every intermediate out of device memory.

Emitted in this stage: ELEMENTWISE (the whole ``EW_OPS`` vocabulary, an
operand with size-1 dims broadcast implicitly as jnp does, lowered as an
explicit BROADCAST), BROADCAST, RESHAPE of trailing power-of-two dims and
REDUCTION over trailing axes, with every input ROW or INV.  A pattern the
reference's analysis rejects, or whose rows are too wide for one block, is
retried with its leading (B, S) dims folded into one row axis
(:func:`fold_rows`): one row per token, as a prefill's norms and
activations need.  Everything else raises
:class:`StitchInfeasible` from the static check, naming the ROADMAP stage
that will emit it; the compiler then runs the group as a ``"torch"`` group.

The wrapper runs the plain version (the members evaluated eagerly with
:func:`repro_torch.core.codegen.eval_node`) only for CPU tensors; for CUDA
tensors it launches the generated kernel, counting each launch.
"""

from __future__ import annotations

import hashlib
import importlib.util
import math
import os
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.core.codegen import canonical_dtype, eval_node
from repro_torch.core.ir import Graph, OpKind, OpNode
from repro_torch.core.pattern import FusionPattern, PackPattern

__all__ = ["StitchAnalysis", "analyze_pattern", "build_stitched_callable",
           "StitchInfeasible", "StitchedKernel", "check_emittable",
           "emission_plan", "explicit_broadcasts", "fold_rows",
           "reset_launch_counts",
           "launch_counts", "MAX_BLOCK_ELEMS"]


class StitchInfeasible(Exception):
    """Pattern not in the emitter's supported class (the compiler runs the
    group as a fused ``"torch"`` group instead)."""


ROW = "row"          # leading dim == R, sliced per block
INV = "invariant"    # no row dim; fully resident per block
ACC = "accumulator"  # produced by cross-row accumulation over grid steps


@dataclass
class StitchAnalysis:
    rows: int                               # R
    roles: dict[str, str]                   # node -> ROW | INV | ACC
    acc_init: dict[str, tuple[str, float]]  # acc node -> (combine, init value)
    feasible_blocks: list[int]              # row-block sizes that divide R
    single_block: bool = False              # an ACC feeds members (grid must be 1)


def _role_of_input(node: OpNode, rows: int) -> str:
    return ROW if node.shape and node.shape[0] == rows else INV


def analyze_pattern(p: FusionPattern) -> StitchAnalysis:
    """Try candidate row dimensions in priority order (output leading dims
    first — outputs define the kernel's write parallelism — then input
    leading dims); the first candidate under which every member op is
    row-local or an accumulator wins."""
    g = p.graph
    outs = p.external_outputs
    if not outs:
        raise StitchInfeasible("pattern has no outputs")

    cands: dict[int, float] = {}
    for n in outs:
        shp = g[n].shape
        if shp and shp[0] > 1:  # rows=1 is degenerate (everything aliases)
            cands[shp[0]] = cands.get(shp[0], 0) + 1000.0
    for n in p.external_inputs:
        shp = g[n].shape
        if shp and shp[0] > 1:
            cands[shp[0]] = cands.get(shp[0], 0) + 1.0
    if not cands:
        raise StitchInfeasible("no shaped tensors")
    order = sorted(cands, key=lambda k: (-cands[k], -k))
    # inputs consumed ONLY as gemm rhs / gather tables are weights: even when
    # their leading dim coincides with R (square matrices), they are
    # row-invariant.  Tried as a fallback classification.
    def _is_weight_use(user: str, name: str) -> bool:
        node = g[user]
        if node.kind in (OpKind.GEMM, OpKind.BATCHED_GEMM):
            return len(node.operands) > 1 and node.operands[1] == name
        if node.kind is OpKind.GATHER:
            return node.operands[0] == name
        if node.kind is OpKind.BROADCAST:
            # operand axis 0 maps to a non-leading target axis -> per-channel
            # weight broadcast (gamma etc.), not a per-row tensor
            dims = tuple(node.attrs.get("bcast_dims", ()))
            return bool(dims) and dims[0] != 0
        return False

    rhs_only: set[str] = set()
    for name in p.external_inputs:
        users = [u for u in g.users(name) if u in p.members]
        if users and all(_is_weight_use(u, name) for u in users):
            rhs_only.add(name)
    last_err: StitchInfeasible | None = None
    for rows in order:
        for force_inv in ((frozenset(), frozenset(rhs_only))
                          if rhs_only else (frozenset(),)):
            try:
                return _analyze_with_rows(p, rows, force_inv)
            except StitchInfeasible as e:
                last_err = e
    raise last_err if last_err is not None else StitchInfeasible("no viable rows")


def _analyze_with_rows(p: FusionPattern, rows: int,
                       force_inv: frozenset[str] = frozenset()) -> StitchAnalysis:
    g = p.graph

    roles: dict[str, str] = {}
    acc_init: dict[str, tuple[str, float]] = {}
    for name in p.external_inputs:
        roles[name] = INV if name in force_inv else _role_of_input(g[name], rows)

    topo_members = [n.name for n in p.nodes if not n.is_source()]
    single_block = False
    for name in topo_members:
        node = g[name]
        ops = node.operands
        op_roles = [roles.get(o) for o in ops]
        if any(r is None for r in op_roles):
            # operand outside pattern and not an external input -> impossible
            raise StitchInfeasible(f"unrooted operand of {name}")
        if any(r == ACC for r in op_roles):
            # §5.3 layout constraint: an accumulator's value only exists once
            # the whole row space has been visited, so a member may consume it
            # only when the entire row space is one block (grid == 1)
            single_block = True
            op_roles = [INV if r == ACC else r for r in op_roles]

        k = node.kind
        if k is OpKind.ELEMENTWISE:
            # a ROW operand arrives as an (rb, ...) block; any other operand
            # spanning the full row space cannot be combined with it
            # value-to-value (it would need per-block slicing)
            if ROW in op_roles:
                for o, r in zip(ops, op_roles):
                    oshape = g[o].shape
                    if (r == INV and oshape and oshape[0] == rows
                            and roles.get(o) != ACC):
                        raise StitchInfeasible(
                            f"{name} mixes a row block with full-rows operand {o}")
            roles[name] = ROW if ROW in op_roles else INV
        elif k is OpKind.BROADCAST:
            dims = tuple(node.attrs.get("bcast_dims", ()))
            src_shape = g[ops[0]].shape
            if op_roles[0] == ROW:
                # the operand's row axis (its dim 0) must land on the target's
                # leading axis, and the target must keep the row extent
                if (dims and dims[0] == 0 and node.shape
                        and node.shape[0] == rows):
                    roles[name] = ROW
                else:
                    raise StitchInfeasible(
                        f"broadcast {name} moves a row-blocked operand off the row axis")
            elif node.shape and node.shape[0] == rows:
                # target spans rows; sound only if no operand dim carrying
                # real extent maps onto the row axis (pure replication)
                if dims and dims[0] == 0 and src_shape and src_shape[0] != 1:
                    raise StitchInfeasible(
                        f"broadcast {name} needs per-block rows of invariant {ops[0]}")
                roles[name] = ROW
            else:
                roles[name] = INV
        elif k is OpKind.RESHAPE:
            src = g[ops[0]]
            if roles[ops[0]] == ROW:
                if node.shape and node.shape[0] == rows and src.shape and src.shape[0] == rows:
                    roles[name] = ROW      # row-local reshape of trailing dims
                else:
                    raise StitchInfeasible(f"reshape {name} mixes rows")
            else:
                roles[name] = INV
        elif k is OpKind.SLICE:
            starts = node.attrs["starts"]
            src_shape = g[ops[0]].shape
            if roles[ops[0]] == ROW:
                if starts[0] == 0 and node.shape[0] == src_shape[0]:
                    roles[name] = ROW     # trailing-dim slice, row-local
                else:
                    raise StitchInfeasible(f"slice {name} cuts the row axis")
            else:
                roles[name] = INV
        elif k is OpKind.TRANSPOSE:
            perm = tuple(node.attrs["perm"])
            if roles[ops[0]] == ROW:
                if perm and perm[0] == 0:
                    roles[name] = ROW
                else:
                    raise StitchInfeasible(f"transpose {name} moves row axis")
            else:
                roles[name] = INV
        elif k is OpKind.REDUCTION:
            axes = tuple(node.attrs["axes"])
            if roles[ops[0]] == ROW and 0 in axes:
                red = node.attrs.get("op", "sum")
                if red not in ("sum", "max", "min"):
                    raise StitchInfeasible(f"cross-row reduce op {red}")
                roles[name] = ACC
                acc_init[name] = {
                    "sum": ("add", 0.0),
                    "max": ("max", -math.inf),
                    "min": ("min", math.inf),
                }[red]
            elif roles[ops[0]] == ROW:
                roles[name] = ROW
            else:
                roles[name] = INV
        elif k in (OpKind.GEMM, OpKind.BATCHED_GEMM):
            (lc, rc) = node.attrs["contract"]
            (lb, rb_) = node.attrs.get("batch", ((), ()))
            lrole, rrole = roles[ops[0]], roles[ops[1]]
            if lrole == ROW and rrole == ROW and 0 in lb and 0 in rb_:
                roles[name] = ROW          # batched over rows
            elif lrole == ROW and rrole == INV and 0 not in lc:
                roles[name] = ROW          # (R, k) @ (k, n)
            elif lrole == ROW and rrole == ROW and 0 in lc and 0 in rc:
                roles[name] = ACC          # contract over rows -> accumulate
                acc_init[name] = ("add", 0.0)
            elif lrole == INV and rrole == INV:
                roles[name] = INV
            else:
                raise StitchInfeasible(f"gemm {name} row structure unsupported")
        elif k is OpKind.GATHER:
            trole, irole = roles[ops[0]], roles[ops[1]]
            if trole == INV:
                roles[name] = irole
            else:
                raise StitchInfeasible(f"gather {name} from row-varying table")
        elif k is OpKind.TUPLE:
            roles[name] = INV
        elif k is OpKind.CUSTOM:
            if "project" in node.attrs:
                # projection of a multi-output custom base: its own shape
                # decides the role; the base is a shapeless tuple carrier
                roles[name] = (ROW if node.shape and node.shape[0] == rows
                               else INV)
                continue
            from .registry import lookup
            if lookup(node) is None:
                raise StitchInfeasible(f"unregistered custom kernel {name}")
            if node.attrs.get("multi") and name in p.external_outputs:
                raise StitchInfeasible(
                    f"multi-output custom base {name} escapes the pattern")
            # replayed at its full traced shapes: one grid step over the
            # whole row space makes every blocked shape equal its full shape
            single_block = True
            roles[name] = (ROW if node.shape and node.shape[0] == rows
                           else INV)
        else:
            raise StitchInfeasible(f"unsupported kind {k} in stitched kernel")

    blocks = [b for b in (8, 16, 32, 64, 128, 256, 512, rows) if b <= rows and rows % b == 0]
    if single_block:
        blocks = [rows]
    if not blocks:
        blocks = [rows]
    return StitchAnalysis(rows, roles, acc_init, sorted(set(blocks)), single_block)


# ---------------------------------------------------------------------------
# the Triton emitter
# ---------------------------------------------------------------------------

# padded elements one program holds per value: a row (times the program's
# rows) must fit the register tile
MAX_BLOCK_ELEMS = 16384

_TL_DTYPES = {
    "float32": "tl.float32", "float64": "tl.float64", "float16": "tl.float16",
    "bfloat16": "tl.bfloat16", "int8": "tl.int8", "int16": "tl.int16",
    "int32": "tl.int32", "int64": "tl.int64", "uint8": "tl.uint8",
    "bool": "tl.int1",
}

_FLOAT_EW = {
    "add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})",
    "div": "({0} / {1})", "max": "tl.maximum({0}, {1})",
    "min": "tl.minimum({0}, {1})", "pow": "libdevice.pow({0}, {1})",
    "neg": "(-{0})", "exp": "tl.exp({0})", "log": "tl.log({0})",
    "log1p": "libdevice.log1p({0})", "tanh": "libdevice.tanh({0})",
    "sqrt": "tl.sqrt({0})", "rsqrt": "tl.rsqrt({0})", "abs": "tl.abs({0})",
    "sign": "tl.where({0} > 0, 1.0, tl.where({0} < 0, -1.0, 0.0))",
    "erf": "libdevice.erf({0})", "square": "({0} * {0})",
    "sigmoid": "tl.sigmoid({0})", "silu": "({0} * tl.sigmoid({0}))",
    "gelu": ("(0.5 * {0} * (1.0 + libdevice.tanh(0.7978845608028654 * "
             "({0} + 0.044715 * {0} * {0} * {0}))))"),
    "relu": "tl.maximum({0}, 0.0)",
    "softplus": "(tl.maximum({0}, 0.0) + libdevice.log1p(tl.exp(-tl.abs({0}))))",
    "cos": "tl.cos({0})", "sin": "tl.sin({0})",
}

_INT_EW = {
    "add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})",
    "div": "({0} // {1})", "max": "tl.maximum({0}, {1})",
    "min": "tl.minimum({0}, {1})", "neg": "(-{0})", "abs": "tl.abs({0})",
    "square": "({0} * {0})", "and": "({0} & {1})", "or": "({0} | {1})",
    "xor": "({0} ^ {1})", "not": "(~{0})",
}

_BOOL_EW = {"and": "({0} & {1})", "or": "({0} | {1})", "xor": "({0} ^ {1})",
            "not": "({0} == 0)"}

_CMP = {"ge": ">=", "gt": ">", "le": "<=", "lt": "<", "eq": "=="}

_NEUTRAL = {"sum": "0.0", "mean": "0.0", "max": "float('-inf')",
            "min": "float('inf')"}


def _pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length() if n > 1 else 1


def _is_float(dtype: str) -> bool:
    return canonical_dtype(dtype).is_floating_point


@dataclass
class _Val:
    """A value inside the kernel: its logical trailing dims that are kernel
    axes (extent > 1), and whether axis 0 is the program's row block."""
    var: str
    row: bool
    dims: tuple[int, ...]          # logical extents of the non-row kernel axes
    dtype: str

    @property
    def pads(self) -> tuple[int, ...]:
        return tuple(_pow2(d) for d in self.dims)

    def kshape(self, block_r: int) -> tuple[int, ...]:
        return ((block_r,) if self.row else ()) + self.pads


def _kernel_dims(shape: tuple[int, ...], row: bool) -> tuple[int, ...]:
    trailing = shape[1:] if row else shape
    return tuple(d for d in trailing if d != 1)


def check_emittable(p: FusionPattern, ana: StitchAnalysis) -> None:
    """The emitter's static feasibility check (made at tune time).  Raises
    :class:`StitchInfeasible` naming the ROADMAP stage that will emit what
    this stage cannot."""
    g = p.graph
    for name in p.external_inputs:
        if ana.roles.get(name) not in (ROW, INV):
            raise StitchInfeasible(f"input {name} is not ROW/INV")
        _check_dtype(g[name])
    for node in p.compute_members:
        role = ana.roles.get(node.name)
        k = node.kind
        if role == ACC or ana.single_block:
            raise StitchInfeasible(
                f"{node.name}: accumulator roles are not emitted yet "
                f"(ROADMAP Queue 2 stage 3, ACC roles)")
        if k in (OpKind.GEMM, OpKind.BATCHED_GEMM):
            raise StitchInfeasible(
                f"{node.name}: GEMM members are not emitted yet "
                f"(ROADMAP Queue 2 stage 2, in-kernel GEMM)")
        if k in (OpKind.CUSTOM, OpKind.SCATTER):
            raise StitchInfeasible(
                f"{node.name}: custom members are not emitted yet "
                f"(ROADMAP Queue 2 stage 5, registered customs)")
        if k in (OpKind.SLICE, OpKind.GATHER, OpKind.TUPLE):
            raise StitchInfeasible(
                f"{node.name}: {k.value} members are not emitted yet "
                f"(ROADMAP Queue 2 stage 1, data movement)")
        _check_dtype(node)
        row = role == ROW
        if k is OpKind.ELEMENTWISE:
            op = node.attrs["op"]
            if op not in ("convert", "integer_pow", "select") \
                    and op not in _FLOAT_EW and op not in _INT_EW \
                    and op not in _BOOL_EW and op not in _CMP:
                raise StitchInfeasible(f"{node.name}: elementwise op {op!r}")
            for o in node.operands:
                if g[o].shape and g[o].shape != node.shape:
                    # size-1 broadcasts are explicit by now
                    # (explicit_broadcasts); any other mismatch is refused
                    raise StitchInfeasible(
                        f"{node.name}: operand {o} of shape {g[o].shape} does "
                        f"not broadcast to {node.shape} by size-1 dims")
        elif k is OpKind.RESHAPE:
            src = g[node.operands[0]]
            a = _kernel_dims(src.shape, row)
            b = _kernel_dims(node.shape, row)
            if a != b and any(_pow2(d) != d for d in a + b):
                raise StitchInfeasible(
                    f"{node.name}: reshape of non-power-of-two trailing dims "
                    f"(ROADMAP Queue 2 stage 1)")
        elif k is OpKind.TRANSPOSE:
            src = g[node.operands[0]]
            moved = [a for a in node.attrs["perm"] if src.shape[a] != 1]
            if moved != sorted(moved):
                raise StitchInfeasible(
                    f"{node.name}: transpose moves an axis "
                    f"(ROADMAP Queue 2 stage 1)")
        elif k is OpKind.REDUCTION:
            if node.attrs.get("op", "sum") not in _NEUTRAL:
                raise StitchInfeasible(
                    f"{node.name}: reduce op {node.attrs.get('op')!r}")
    for name in set(p.external_inputs) | {n.name for n in p.compute_members}:
        node = g[name]
        row = ana.roles[name] == ROW
        elems = math.prod(_pow2(d) for d in _kernel_dims(node.shape, row))
        if elems > MAX_BLOCK_ELEMS:
            raise StitchInfeasible(
                f"{name}: a row of {elems} padded elements exceeds one block "
                f"({MAX_BLOCK_ELEMS}); wide rows are not tiled yet")


def _check_dtype(node: OpNode) -> None:
    if str(node.dtype) not in _TL_DTYPES:
        raise StitchInfeasible(f"{node.name}: dtype {node.dtype} not emitted")


# ---------------------------------------------------------------------------
# row folding: (B, S, ...) values as (B*S, ...) rows
# ---------------------------------------------------------------------------

def _fold_prefix(shape: tuple[int, ...], rows: int) -> int | None:
    """The longest k with prod(shape[:k]) == rows (None if there is none):
    those leading dims become the folded row axis."""
    prod, best = 1, None
    for k, d in enumerate(shape, 1):
        prod *= d
        if prod == rows:
            best = k
        elif prod > rows:
            break
    return best


def _folded_shape(shape, rows: int, k: int | None) -> tuple[int, ...]:
    return ((rows,) + tuple(shape[k:])) if k else tuple(shape)


def _prefix_extents(shape, k: int) -> list[int]:
    return [d for d in shape[:k] if d != 1]


def _fold_node(node: OpNode, g, rows: int, pre: dict) -> OpNode:
    """``node`` with its row prefix folded (``pre``: name -> k or None) and
    its axis attributes remapped; raises StitchInfeasible when a member
    moves, slices or reduces the folded axes."""
    k = pre[node.name]
    shape = _folded_shape(node.shape, rows, k)
    attrs = dict(node.attrs)
    kind = node.kind
    if node.is_source() or kind is OpKind.ELEMENTWISE:
        return OpNode(node.name, kind, shape, node.dtype, node.operands, attrs)
    src = g[node.operands[0]]
    ks = pre[src.name]
    fold_err = StitchInfeasible(f"{node.name}: {kind.value} crosses the folded rows")
    if kind is OpKind.BROADCAST:
        dims = tuple(attrs["bcast_dims"])
        if not k:
            if ks:
                raise fold_err
        elif ks:
            # the row prefix maps onto the row prefix; extent-1 axes carry
            # no data and may land anywhere
            moved = [j for j in range(len(dims)) if src.shape[j] != 1
                     and (j < ks) != (dims[j] < k)]
            if moved or (_prefix_extents(src.shape, ks)
                         != _prefix_extents(node.shape, k)):
                raise fold_err
            attrs["bcast_dims"] = (0,) + tuple(max(d - k + 1, 0)
                                               for d in dims[ks:])
        else:
            # an invariant replicated over the rows: only its extent-1 axes
            # may land on the row prefix
            if any(dims[j] < k and src.shape[j] != 1 for j in range(len(dims))):
                raise fold_err
            attrs["bcast_dims"] = tuple(max(d - k + 1, 0) for d in dims)
    elif kind is OpKind.RESHAPE:
        if bool(k) != bool(ks):
            raise fold_err
    elif kind is OpKind.REDUCTION:
        axes = tuple(attrs["axes"])
        if bool(k) != bool(ks):
            raise fold_err
        if ks:
            if any(a < ks and src.shape[a] != 1 for a in axes):
                raise fold_err
            attrs["axes"] = tuple(a - ks + 1 for a in axes if a >= ks)
            attrs["in_rank"] = 1 + len(src.shape) - ks
    elif kind is OpKind.TRANSPOSE:
        perm = tuple(attrs["perm"])
        if bool(k) != bool(ks):
            raise fold_err
        if ks:
            new = (0,) + tuple(a - ks + 1 for a in perm[k:])
            kept = [a for a in perm[:k] if src.shape[a] != 1]
            if (any(a >= ks for a in perm[:k]) or kept != sorted(kept)
                    or sorted(new) != list(range(1 + len(src.shape) - ks))
                    or _prefix_extents(src.shape, ks) != _prefix_extents(node.shape, k)):
                raise fold_err
            attrs["perm"] = new
    else:
        raise StitchInfeasible(f"{node.name}: {kind.value} is not folded")
    return OpNode(node.name, kind, shape, node.dtype, node.operands, attrs)


def fold_rows(p: FusionPattern) -> tuple[FusionPattern, StitchAnalysis]:
    """Wide-row fold.  The reference's analysis takes a value's leading dim
    as its rows, so a prefill value (B, S, D) is B rows of S*D elements —
    wider than one block — and a GEMM output (B*S, D) reshaped to (B, S, D)
    looks like a different row space.  Here every value whose leading dims
    multiply to R is re-read as (R, rest): one row per token.  The folded
    pattern is a graph of the pattern's own nodes with remapped shapes and
    axes, analysed under the reference's role rules at rows R and checked
    for emission; the data layout is unchanged (contiguous leading dims),
    so the kernel runs on the original tensors viewed as folded.  A pack
    folds when all its subgraphs share the folded row space."""
    g = p.graph
    names = list(p.external_inputs) + [n.name for n in p.nodes]
    cands: list[int] = []
    for n in list(p.external_outputs) + list(p.external_inputs):
        shp = g[n].shape
        prod = shp[0] if shp else 1
        for d in shp[1:-1]:
            prod *= d
            if d != 1 and prod not in cands:
                cands.append(prod)
    last: StitchInfeasible | None = None
    for rows in cands:
        try:
            pre = {n: _fold_prefix(g[n].shape, rows) for n in names}
            fg = Graph(f"{g.name}/rows{rows}")
            for n in p.external_inputs:
                node = g[n]
                fg.add(OpNode(n, node.kind if node.is_source() else OpKind.PARAMETER,
                              _folded_shape(node.shape, rows, pre[n]),
                              node.dtype, (), dict(node.attrs)))
            for node in p.nodes:
                if node.name not in fg:
                    fg.add(_fold_node(node, g, rows, pre))
            fg.mark_output(*p.external_outputs)
            groups = getattr(p, "member_groups", None)
            fp = (PackPattern(fg, p.members, p.origin, member_groups=groups)
                  if groups else FusionPattern(fg, p.members, p.origin))
            ana = _analyze_with_rows(fp, rows)
            check_emittable(fp, ana)
            return fp, ana
        except StitchInfeasible as err:
            last = err
    raise last if last is not None else StitchInfeasible("no rows to fold")


def _implicit_dims(shape, out) -> bool:
    """A same-rank operand whose every dim is 1 or the node's: jnp's
    implicit size-1 broadcast."""
    return len(shape) == len(out) and tuple(shape) != tuple(out) and all(
        a in (1, b) for a, b in zip(shape, out))


def explicit_broadcasts(p: FusionPattern) -> FusionPattern:
    """``p`` with every implicit size-1 broadcast of an elementwise member
    spelled as the BROADCAST the tracer used to write (identity
    ``bcast_dims`` to the member's shape, a member named
    ``<member>.bcast<i>``), so it is analysed and lowered as an explicit
    BROADCAST of that operand is; ``p`` itself when it has none.  Any other
    shape mismatch is left for :func:`check_emittable` to refuse."""
    g = p.graph
    adds: dict[str, list] = {}
    for node in p.compute_members:
        if node.kind is not OpKind.ELEMENTWISE:
            continue
        for i, o in enumerate(node.operands):
            if _implicit_dims(g[o].shape, node.shape):
                adds.setdefault(node.name, []).append(i)
    if not adds:
        return p
    fg = Graph(f"{g.name}/bcast")
    for n in p.external_inputs:
        node = g[n]
        fg.add(OpNode(n, node.kind if node.is_source() else OpKind.PARAMETER,
                      node.shape, node.dtype, (), dict(node.attrs)))
    members = set(p.members)
    for node in p.nodes:
        if node.name in fg:
            continue
        ops = list(node.operands)
        for i in adds.get(node.name, ()):
            src = g[ops[i]]
            b = f"{node.name}.bcast{i}"
            fg.add(OpNode(b, OpKind.BROADCAST, node.shape, src.dtype,
                          (ops[i],),
                          {"bcast_dims": tuple(range(len(node.shape)))}))
            members.add(b)
            ops[i] = b
        fg.add(OpNode(node.name, node.kind, node.shape, node.dtype,
                      tuple(ops), dict(node.attrs)))
    fg.mark_output(*p.external_outputs)
    groups = getattr(p, "member_groups", None)
    if groups:
        groups = tuple(frozenset(grp) | {f"{m}.bcast{i}" for m in grp
                                         for i in adds.get(m, ())}
                       for grp in groups)
        return PackPattern(fg, frozenset(members), p.origin,
                           member_groups=groups)
    return FusionPattern(fg, frozenset(members), p.origin)


def emission_plan(p: FusionPattern) -> tuple[FusionPattern, StitchAnalysis]:
    """The pattern the emitter renders and its analysis: ``p`` itself (its
    implicit size-1 broadcasts spelled out, :func:`explicit_broadcasts`)
    when the reference's analysis admits it, else its row-folded form.
    When neither is emitted, the StitchInfeasible names both reasons."""
    p = explicit_broadcasts(p)
    try:
        ana = analyze_pattern(p)
        check_emittable(p, ana)
        return p, ana
    except StitchInfeasible as err:
        try:
            return fold_rows(p)
        except StitchInfeasible as fold_err:
            raise StitchInfeasible(f"{err}; folded rows: {fold_err}") from None


@dataclass
class _Emitted:
    source: str
    digest: str
    block_r: int
    grid: int
    num_warps: int
    in_names: list[str]        # kernel arg i <- this external input
    out_names: list[str]       # kernel out j -> this external output
    out_dtypes: list[str]


class _Emitter:
    def __init__(self, p: FusionPattern, ana: StitchAnalysis, rb: int):
        self.p = p
        self.g = p.graph
        self.ana = ana
        self.rows = ana.rows
        self.lines: list[str] = []
        self.vals: dict[str, _Val] = {}
        self.nvar = 0
        self.indent = 1
        widest = 1
        for name in set(p.external_inputs) | {n.name for n in p.compute_members}:
            if ana.roles[name] == ROW:
                widest = max(widest, math.prod(
                    _pow2(d) for d in _kernel_dims(self.g[name].shape, True)))
        cap = max(1, MAX_BLOCK_ELEMS // widest)
        self.block_r = min(_pow2(min(rb, self.rows)), 1 << (cap.bit_length() - 1))
        # a horizontal pack's independent subgraphs take consecutive ranges
        # of programs, so a program holds one subgraph's block, never the
        # whole pack's (the cost model's register gate assumes exactly this)
        members = [n for n in p.nodes if not n.is_source()]
        groups = getattr(p, "member_groups", None)
        if groups:
            self.subgraphs = [[n for n in members if n.name in grp]
                              for grp in groups]
            self.subgraphs.sort(key=lambda sub: members.index(sub[0]))
        else:
            self.subgraphs = [members]
        self.blocks = -(-self.rows // self.block_r)
        self.grid = self.blocks * len(self.subgraphs)
        tile = self.block_r * widest
        self.num_warps = (1 if tile <= 256 else 2 if tile <= 1024
                          else 4 if tile <= 4096 else 8)

    # -- small helpers ---------------------------------------------------------
    def var(self) -> str:
        self.nvar += 1
        return f"v{self.nvar}"

    def emit(self, line: str) -> None:
        self.lines.append("    " * self.indent + line)

    def arange(self, n_axes: int, axis: int, size: int) -> str:
        idx = ", ".join(":" if i == axis else "None" for i in range(n_axes))
        return f"tl.arange(0, {size})" + (f"[{idx}]" if n_axes > 1 else "")

    def index_and_mask(self, shape: tuple[int, ...], row: bool):
        """Offsets and mask of a contiguous tensor of logical ``shape``
        laid over this value's kernel axes."""
        strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
        start = 1 if row else 0
        axes = [(i, d) for i, d in enumerate(shape) if i >= start and d != 1]
        n = start + len(axes)
        terms, masks = [], []
        if row:
            r = "rows" + ("" if n == 1 else
                          "[" + ", ".join([":"] + ["None"] * (n - 1)) + "]")
            terms.append(f"{r} * {strides[0]}")
            masks.append(f"({r} < {self.rows})")
        for k, (i, d) in enumerate(axes):
            a = self.arange(n, k + start, _pow2(d))
            terms.append(f"{a} * {strides[i]}" if strides[i] != 1 else a)
            if _pow2(d) != d:
                masks.append(f"({a} < {d})")
        return " + ".join(terms) or "0", " & ".join(masks) or None

    def axis_masks(self, v: _Val, axes: list[int]) -> str | None:
        """Mask of the padded lanes on the given kernel axes of ``v``."""
        n = len(v.kshape(self.block_r))
        off = 1 if v.row else 0
        masks = []
        for ax in axes:
            d = v.dims[ax - off]
            if _pow2(d) != d:
                masks.append(f"({self.arange(n, ax, _pow2(d))} < {d})")
        return " & ".join(masks) or None

    def new_val(self, name: str) -> _Val:
        node = self.g[name]
        row = self.ana.roles[name] == ROW
        return _Val(self.var(), row, _kernel_dims(node.shape, row),
                    str(node.dtype))

    # -- body ------------------------------------------------------------------
    def run(self) -> _Emitted:
        p, g = self.p, self.g
        members = [n for n in p.nodes if not n.is_source()]
        ext_in = list(p.external_inputs)
        # kernel arguments in order of first use: isomorphic patterns (the
        # same block in every layer) render to the same source
        order: list[str] = []
        for node in members:
            for o in node.operands:
                if o in ext_in and o not in order:
                    order.append(o)
        ext_out = list(p.external_outputs)
        outs = [n.name for n in members if n.name in ext_out]
        params = ([f"in{i}" for i in range(len(order))]
                  + [f"out{j}" for j in range(len(outs))])
        in_arg = {name: f"in{i}" for i, name in enumerate(order)}
        out_arg = {name: f"out{j}" for j, name in enumerate(outs)}
        self.lines = []
        self.emit("prog = tl.program_id(0)")
        for s, sub in enumerate(self.subgraphs):
            self.vals = {}
            if len(self.subgraphs) > 1:
                self.emit(f"if prog // {self.blocks} == {s}:")
                self.indent = 2
                self.emit(f"pid = prog - {s * self.blocks}")
            else:
                self.emit("pid = prog")
            self.emit(f"rows = pid * {self.block_r} + tl.arange(0, {self.block_r})")
            names = {n.name for n in sub}
            loaded = []
            for node in sub:
                for o in node.operands:
                    if o in in_arg and o not in loaded:
                        loaded.append(o)
            for name in loaded:
                self.load(name, in_arg[name])
            for node in sub:
                self.member(node)
            for name in outs:
                if name in names:
                    self.store(name, out_arg[name])
            self.indent = 1
        body = "\n".join(self.lines)
        src = (f"@triton.jit\ndef stitched_kernel({', '.join(params)}):\n"
               f"{body}\n")
        digest = hashlib.sha1(src.encode()).hexdigest()[:16]
        header = (f"# generated stitched kernel {digest}: "
                  f"{len(p.compute_members)} ops, rows={self.rows}, "
                  f"block_r={self.block_r}, grid={self.grid}, "
                  f"subgraphs={len(self.subgraphs)}\n")
        return _Emitted(
            source=_HEADER + header + src, digest=digest,
            block_r=self.block_r, grid=self.grid, num_warps=self.num_warps,
            in_names=order, out_names=outs,
            out_dtypes=[str(g[n].dtype) for n in outs])

    def load(self, name: str, ptr: str) -> None:
        node = self.g[name]
        v = self.new_val(name)
        self.vals[name] = v
        if not v.row and not v.dims:
            val = f"tl.load({ptr})"
        else:
            offs, mask = self.index_and_mask(node.shape, v.row)
            m = f", mask={mask}, other=0" if mask else ""
            val = f"tl.load({ptr} + ({offs}){m})"
        if v.dtype == "bool":
            val = f"({val} != 0)"
        self.emit(f"{v.var} = {val}")

    def store(self, name: str, ptr: str) -> None:
        node = self.g[name]
        v = self.vals[name]
        val = v.var
        if v.dtype == "bool":
            val = f"{val}.to(tl.int8)"
        if not v.row and not v.dims:
            self.emit(f"tl.store({ptr}, {val}, mask=pid == 0)")
            return
        offs, mask = self.index_and_mask(node.shape, v.row)
        if not v.row:
            # every program holds the invariant value; program 0 writes it
            mask = f"({mask}) & (pid == 0)" if mask else "pid == 0"
        m = f", mask={mask}" if mask else ""
        self.emit(f"tl.store({ptr} + ({offs}), {val}{m})")

    def member(self, node: OpNode) -> None:
        k = node.kind
        ops = [self.vals[o] for o in node.operands]
        v = self.new_val(node.name)
        if k is OpKind.ELEMENTWISE:
            expr = self.elementwise(node, ops)
        elif k is OpKind.BROADCAST:
            expr = self.broadcast(node, ops[0], v)
        elif k is OpKind.RESHAPE:
            expr = self.reshape(ops[0], v)
        elif k is OpKind.TRANSPOSE:
            expr = ops[0].var            # only size-1 axes move (checked)
        elif k is OpKind.REDUCTION:
            expr = self.reduction(node, ops[0], v)
        else:  # pragma: no cover - check_emittable rejects the rest
            raise StitchInfeasible(f"cannot emit {k}")
        self.emit(f"{v.var} = {expr}")
        self.vals[node.name] = v

    def elementwise(self, node: OpNode, ops: list[_Val]) -> str:
        op = node.attrs["op"]
        dt = str(node.dtype)
        tl_dt = _TL_DTYPES[dt]
        if op == "convert":
            src = ops[0]
            if dt == "bool":
                return f"({src.var} != 0)"
            return f"{src.var}.to({tl_dt})"
        in_dt = ops[-1].dtype if op == "select" else ops[0].dtype
        fl = _is_float(in_dt)
        # float members compute in f32 (f64 stays f64) and round once
        cdt = "tl.float64" if in_dt == "float64" else "tl.float32"

        def arg(v: _Val) -> str:
            if fl and v.dtype not in ("float32", "float64") and v.dtype != "bool":
                return f"{v.var}.to({cdt})"
            return v.var

        if op == "select":
            expr = f"tl.where({ops[0].var}, {arg(ops[1])}, {arg(ops[2])})"
        elif op in _CMP:
            expr = f"({arg(ops[0])} {_CMP[op]} {arg(ops[1])})"
            return expr if dt == "bool" else f"{expr}.to({tl_dt})"
        elif op == "integer_pow":
            y = int(node.attrs["y"])
            a = arg(ops[0])
            expr = " * ".join([a] * abs(y)) if y else "1.0"
            if y < 0:
                expr = f"(1.0 / ({expr}))"
            else:
                expr = f"({expr})"
        elif in_dt == "bool":
            expr = _BOOL_EW[op].format(*[o.var for o in ops])
        elif fl:
            expr = _FLOAT_EW[op].format(*[arg(o) for o in ops])
        else:
            if op not in _INT_EW:
                raise StitchInfeasible(f"{node.name}: integer op {op!r}")
            expr = _INT_EW[op].format(*[o.var for o in ops])
        if dt == "bool":
            return f"({expr} != 0)" if in_dt != "bool" else expr
        if _is_float(dt) and dt not in ("float32", "float64") or not fl:
            return f"({expr}).to({tl_dt})"
        return expr

    def broadcast(self, node: OpNode, src: _Val, out: _Val) -> str:
        shape = out.kshape(self.block_r)
        shape_s = "(" + ", ".join(str(s) for s in shape) + ("," if len(shape) == 1 else "") + ")"
        if not src.row and not src.dims:                  # scalar
            if not shape:
                return src.var
            if src.dtype == "bool":
                return (f"(tl.full({shape_s}, 0, tl.int8) + "
                        f"{src.var}.to(tl.int8)) != 0")
            return f"tl.full({shape_s}, 0, {_TL_DTYPES[src.dtype]}) + {src.var}"
        dims = tuple(node.attrs["bcast_dims"])
        src_shape = self.g[node.operands[0]].shape
        # target kernel axes: row axis (if any) + target dims of extent > 1
        tgt_axes = ([0] if out.row else []) + [
            i for i, d in enumerate(node.shape) if d != 1 and not (out.row and i == 0)]
        src_axes = ([0] if src.row else []) + [
            dims[i] for i, d in enumerate(src_shape)
            if d != 1 and not (src.row and i == 0)]
        idx = ", ".join(":" if a in src_axes else "None" for a in tgt_axes)
        if src_axes == tgt_axes:
            return src.var
        return f"tl.broadcast_to({src.var}[{idx}], {shape_s})"

    def reshape(self, src: _Val, out: _Val) -> str:
        if src.dims == out.dims:
            return src.var
        shape = out.kshape(self.block_r)
        return f"tl.reshape({src.var}, ({', '.join(str(s) for s in shape)},))"

    def reduction(self, node: OpNode, src: _Val, out: _Val) -> str:
        op = node.attrs.get("op", "sum")
        src_shape = self.g[node.operands[0]].shape
        row_off = 1 if src.row else 0
        # logical axis -> kernel axis of the operand
        kax, k = {}, row_off
        for i, d in enumerate(src_shape):
            if src.row and i == 0:
                continue
            if d != 1:
                kax[i] = k
                k += 1
        axes = sorted(kax[a] for a in node.attrs["axes"] if a in kax)
        x = src.var
        fl = _is_float(src.dtype)
        if fl and src.dtype not in ("float32", "float64"):
            x = f"{x}.to(tl.float32)"
        if not axes:
            expr = x
        else:
            mask = self.axis_masks(src, axes)
            if mask:
                neutral = _NEUTRAL[op]
                if not fl:
                    neutral = {"max": f"{_int_min(src.dtype)}",
                               "min": f"{_int_max(src.dtype)}"}.get(op, "0")
                t = self.var()
                self.emit(f"{t} = tl.where({mask}, {x}, {neutral})")
                x = t
            fn = {"sum": "tl.sum", "mean": "tl.sum", "max": "tl.max",
                  "min": "tl.min"}[op]
            expr = x
            for ax in reversed(axes):
                expr = f"{fn}({expr}, axis={ax})"
            if op == "mean":
                count = math.prod(src_shape[a] for a in node.attrs["axes"])
                expr = f"({expr} / {float(count)})"
        dt = str(node.dtype)
        if dt not in ("float32", "float64") or not fl:
            expr = f"({expr}).to({_TL_DTYPES[dt]})"
        return expr


def _int_min(dtype: str) -> int:
    return int(torch.iinfo(canonical_dtype(dtype)).min)


def _int_max(dtype: str) -> int:
    return int(torch.iinfo(canonical_dtype(dtype)).max)


_HEADER = '''import triton
import triton.language as tl
try:
    from triton.language.extra import libdevice
except ImportError:  # older Triton releases
    from triton.language.extra.cuda import libdevice

'''


# ---------------------------------------------------------------------------
# launch counts and the build directory
# ---------------------------------------------------------------------------

_LAUNCHES: dict[str, int] = {}       # kernel digest -> launches
_MODULES: dict[str, object] = {}     # kernel digest -> imported module


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    """Launches per generated kernel (by source digest) since the last
    :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def build_dir() -> Path:
    """Where generated kernels are written: ``build/stitched`` at the
    repository root."""
    return Path(__file__).resolve().parents[3] / "build" / "stitched"


def _load_module(em: _Emitted):
    mod = _MODULES.get(em.digest)
    if mod is None:
        d = build_dir()
        d.mkdir(parents=True, exist_ok=True)
        path = d / f"k_{em.digest}.py"
        if not path.exists() or path.read_text() != em.source:
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_text(em.source)
            tmp.replace(path)
        spec = importlib.util.spec_from_file_location(f"stitched_{em.digest}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[em.digest] = mod
    return mod


class StitchedKernel:
    """Callable wrapper of one generated kernel: ``f(*external_inputs) ->
    tuple(outputs)`` in ``p.external_inputs`` / ``p.external_outputs``
    order.  CPU tensors take the plain version; CUDA tensors launch the
    Triton kernel."""

    def __init__(self, p: FusionPattern, ana: StitchAnalysis, em: _Emitted):
        self.pattern = p
        self.analysis = ana
        self.emitted = em
        self.launches = 0
        self.build_seconds: float | None = None   # first launch, JIT included
        self.out_shapes = [tuple(p.graph[n].shape) for n in p.external_outputs]
        self.out_dtypes = [str(p.graph[n].dtype) for n in p.external_outputs]
        # kernel argument i <- external input _in_idx[i]; kernel output j ->
        # external output _out_idx[j] (a folded kernel indexes the same
        # contiguous tensors under its own shapes)
        self._in_idx = [p.external_inputs.index(n) for n in em.in_names]
        self._out_idx = [p.external_outputs.index(n) for n in em.out_names]
        _LAUNCHES.setdefault(em.digest, 0)

    @property
    def digest(self) -> str:
        return self.emitted.digest

    @property
    def source(self) -> str:
        return self.emitted.source

    def plain(self, *inputs) -> tuple:
        """The plain PyTorch version: the members evaluated eagerly."""
        g = self.pattern.graph
        env = dict(zip(self.pattern.external_inputs, inputs))
        for node in self.pattern.nodes:
            if node.is_source() and node.name in env:
                continue
            env[node.name] = eval_node(node, [env[o] for o in node.operands], g)
        return tuple(env[n] for n in self.pattern.external_outputs)

    def __call__(self, *inputs) -> tuple:
        if not inputs or all(x.device.type == "cpu" for x in inputs):
            return self.plain(*inputs)
        return self.launch(*inputs)

    def launch(self, *inputs) -> tuple:
        em = self.emitted
        g = self.pattern.graph
        ins = self.pattern.external_inputs
        device = None
        prepared = []
        for name, x in zip(ins, inputs):
            if x.device.type != "cuda":
                raise ValueError(f"stitched kernel {em.digest}: input {name} "
                                 f"on {x.device}, expected cuda")
            device = x.device
            if tuple(x.shape) != tuple(g[name].shape):
                raise ValueError(f"stitched kernel {em.digest}: input {name} "
                                 f"shape {tuple(x.shape)} != {g[name].shape}")
            x = x.to(canonical_dtype(g[name].dtype)).contiguous()
            if x.dtype == torch.bool:
                x = x.view(torch.uint8)
            prepared.append(x)
        outs = []
        for k, dt in zip(self._out_idx, em.out_dtypes):
            tdt = torch.int8 if dt == "bool" else canonical_dtype(dt)
            outs.append(torch.empty(self.out_shapes[k], dtype=tdt, device=device))
        t0 = time.perf_counter() if self.build_seconds is None else None
        mod = _load_module(em)
        args = [prepared[i] for i in self._in_idx] + outs
        mod.stitched_kernel[(em.grid,)](*args, num_warps=em.num_warps)
        if t0 is not None:
            self.build_seconds = time.perf_counter() - t0
        self.launches += 1
        _LAUNCHES[em.digest] = _LAUNCHES.get(em.digest, 0) + 1
        result: list = [None] * len(outs)
        for o, k, dt in zip(outs, self._out_idx, em.out_dtypes):
            result[k] = o.view(torch.bool) if dt == "bool" else o
        return tuple(result)


def build_stitched_callable(p: FusionPattern, *,
                            row_block: int | None = None) -> StitchedKernel:
    """Emit the fused kernel.  Returns ``f(*external_inputs) -> tuple(outputs)``
    (input/output order = ``p.external_inputs`` / ``p.external_outputs``).

    A template's scratch-marked intermediates need no code of their own:
    every intermediate already stays in registers."""
    emit_p, ana = emission_plan(p)
    rb = row_block or ana.feasible_blocks[0]
    em = _Emitter(emit_p, ana, rb).run()
    return StitchedKernel(p, ana, em)
