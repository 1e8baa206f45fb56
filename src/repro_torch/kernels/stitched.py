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
the design keeps every intermediate out of device memory (a value stored
to the program's scratch to be loaded at other offsets stays in L2; a wide
row's later sweeps read its inputs again, ``_Emitted.rereads``).

Emitted: ELEMENTWISE (the whole ``EW_OPS`` vocabulary, an operand with
size-1 dims broadcast implicitly as jnp does, lowered as an explicit
BROADCAST), BROADCAST, REDUCTION over trailing axes, and data movement:
SLICE (trailing dims of a ROW value, any slice of an INV one), TRANSPOSE
keeping the row axis first, RESHAPE of a ROW value's trailing dims (any
reshape of an INV one) and GATHER from an INV table, wherever the
reference's analysis admits them, in rows of any width (:class:`_Emitter`:
index maps composed into loads, register routes, scratch, sweeps over wide
rows).  A pattern the reference's analysis rejects, or whose rows would
need sweeps, is retried with its leading (B, S) dims folded into one row
axis (:func:`fold_rows`): one row per token, as a prefill's norms and
activations need.  Everything else (accumulator roles, GEMMs, customs)
raises :class:`StitchInfeasible` from the static check, naming the ROADMAP
stage that will emit it (:func:`emittable_causes` lists every cause,
:func:`refusal_causes` those of a pattern's best form); the compiler then
runs the group as a ``"torch"`` group.

Two layouts.  A pattern that computes element by element (no reduction,
every value the same N elements in row-major order or a scalar,
:func:`flat_elements`) is emitted flat: each program owns consecutive
elements, 16 bytes a thread, so a decode step's 4 rows of 2048-6144 spread
over 32-96 programs where the rows layout gave one; each element's
arithmetic is the rows layout's, expression for expression.  Layouts are
chosen here, not by the tuner, so plans do not depend on them.

An output that is a run of an input's contiguous elements (through
reshapes, transposes of size-1 axes, broadcasts adding size-1 dims,
converts to the same dtype and slices of one run, :func:`view_outputs`) is
returned as a view of the input at its offset and stored by no kernel.  A
pattern whose outputs are all such views launches nothing:
:class:`StitchedView` serves it, counted apart from the launches
(:func:`view_counts`).  A Pallas output is a fresh buffer on a TPU, so the
reference copies; a torch tensor carries strides.  A graph output that
would alias what a caller holds is refused the view (:func:`alias_refusal`)
and is stored by a kernel.

The wrapper runs the plain version (the members evaluated eagerly with
:func:`repro_torch.core.codegen.eval_node`) only for CPU tensors; for CUDA
tensors it launches the generated kernel, counting each launch.
"""

from __future__ import annotations

import hashlib
import importlib.util
import math
import os
import re
import threading
import time
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import torch

from repro_torch.core.codegen import canonical_dtype, eval_node
from repro_torch.core.ir import Graph, OpKind, OpNode
from repro_torch.core.pattern import FusionPattern, PackPattern

__all__ = ["StitchAnalysis", "analyze_pattern", "build_stitched_callable",
           "StitchInfeasible", "StitchedKernel", "StitchedView",
           "check_emittable", "emittable_causes", "refusal_causes",
           "cause_stage", "emission_plan", "explicit_broadcasts",
           "flat_elements", "fold_rows", "layout_member", "layout_only",
           "reset_launch_counts", "launch_counts", "view_counts",
           "view_copy_counts", "view_outputs", "alias_refusal",
           "MAX_BLOCK_ELEMS"]


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
    """A value inside the kernel as a register tile: its logical trailing
    dims that are kernel axes (extent > 1), whether axis 0 is the program's
    row block, and which kernel axis (if any) holds a chunk of ``ch``
    elements of a wide row instead of the whole padded extent."""
    var: str
    row: bool
    dims: tuple[int, ...]          # logical extents of the non-row kernel axes
    dtype: str
    chunk: int | None = None       # kernel axis (row axis counted) chunked
    ch: int = 0

    @property
    def pads(self) -> tuple[int, ...]:
        return tuple(_pow2(d) for d in self.dims)

    def kshape(self, block_r: int) -> tuple[int, ...]:
        shape = ((block_r,) if self.row else ()) + self.pads
        if self.chunk is not None:
            shape = shape[:self.chunk] + (self.ch,) + shape[self.chunk + 1:]
        return shape


@dataclass
class _View:
    """Where a value's elements lie in memory: a base (a kernel argument or
    a program's scratch) of logical shape ``shape``, contiguous, and the map
    from the value's logical indices to the base's (``index``: index
    expressions over the value's axes and the lanes' mask -> expressions
    over the base's axes).  Slices, transposes, reshapes, broadcasts and
    gathers compose their maps; nothing moves until a consumer loads."""
    ptr: str
    shape: tuple[int, ...]
    dtype: str
    index: Callable
    base: str | None = None        # the external input it reads, if one
    identity: bool = False         # the value is the base itself, reshaped


def _same(ctx, mask):
    return ctx


def _contiguous_part(node: OpNode, g: Graph) -> int | None:
    """The element offset at which ``node``'s value lies, whole and in
    order, in its operand's contiguous bytes (a :func:`layout_member`, a
    slice of one run of elements), else None."""
    if layout_member(node, g):
        return 0
    if node.kind is not OpKind.SLICE:
        return None
    src = g[node.operands[0]].shape
    starts, limits = node.attrs["starts"], node.attrs["limits"]
    steps = node.attrs.get("strides") or (1,) * len(src)
    cut = [a for a in range(len(src))
           if (starts[a], limits[a], steps[a]) != (0, src[a], 1)]
    if not cut:
        return 0
    a = cut[0]
    if cut != [a] or steps[a] != 1 or any(src[i] != 1 for i in range(a)):
        return None
    return starts[a] * math.prod(src[a + 1:])


def _kernel_dims(shape: tuple[int, ...], row: bool) -> tuple[int, ...]:
    trailing = shape[1:] if row else shape
    return tuple(d for d in trailing if d != 1)


_ATOM = re.compile(r"^[\w.]+(\([^()]*\))?(\[[^\]]*\])?$")


def _par(e: str) -> str:
    return e if _ATOM.match(e) else f"({e})"


def _times(e: str, k: int) -> str:
    if e == "0" or k == 0:
        return "0"
    return e if k == 1 else f"{_par(e)} * {k}"


def _sum(terms) -> str:
    kept = [t for t in terms if t != "0"]
    return " + ".join(kept) or "0"


def _strides(shape) -> list[int]:
    return [math.prod(shape[i + 1:]) for i in range(len(shape))]


def _shape_s(shape) -> str:
    return "(" + ", ".join(str(s) for s in shape) + ("," if len(shape) == 1 else "") + ")"


def emittable_causes(p: FusionPattern, ana: StitchAnalysis) -> list[str]:
    """Every reason the emitter cannot render ``p`` under ``ana``, member by
    member, each naming the ROADMAP stage that will emit it; empty when it
    can.  :func:`check_emittable` raises the first.  A pattern with no
    member-level cause is rendered once here, so what the renderer refuses
    (:class:`_Emitter`) is a cause too."""
    return _rendered(p, ana)[0]


def _rendered(p: FusionPattern, ana: StitchAnalysis, aliases=None
              ) -> tuple[list[str], _Emitter | None, _Emitted | None]:
    """(:func:`emittable_causes`, and when there is none the emitter and
    the kernel it rendered at ``ana``'s first row block with ``aliases``
    returned as views)."""
    g = p.graph
    causes: list[str] = []
    for name in p.external_inputs:
        if ana.roles.get(name) not in (ROW, INV):
            causes.append(f"input {name} is not ROW/INV")
        causes += _dtype_causes(g[name])
    for node in p.compute_members:
        role = ana.roles.get(node.name)
        k = node.kind
        if role == ACC or ana.single_block:
            causes.append(
                f"{node.name}: accumulator roles are not emitted yet "
                f"(ROADMAP Queue 2 stage 3, ACC roles)")
        if k in (OpKind.GEMM, OpKind.BATCHED_GEMM):
            causes.append(
                f"{node.name}: GEMM members are not emitted yet "
                f"(ROADMAP Queue 2 stage 2, in-kernel GEMM)")
            continue
        if k in (OpKind.CUSTOM, OpKind.SCATTER, OpKind.TUPLE):
            # a TUPLE member only carries a multi-output custom's results
            causes.append(
                f"{node.name}: custom members are not emitted yet "
                f"(ROADMAP Queue 2 stage 5, registered customs)")
            continue
        causes += _dtype_causes(node)
        if k is OpKind.ELEMENTWISE:
            op = node.attrs["op"]
            if op not in ("convert", "integer_pow", "select") \
                    and op not in _FLOAT_EW and op not in _INT_EW \
                    and op not in _BOOL_EW and op not in _CMP:
                causes.append(f"{node.name}: elementwise op {op!r}")
            for o in node.operands:
                if g[o].shape and g[o].shape != node.shape:
                    # size-1 broadcasts are explicit by now
                    # (explicit_broadcasts); any other mismatch is refused
                    causes.append(
                        f"{node.name}: operand {o} of shape {g[o].shape} does "
                        f"not broadcast to {node.shape} by size-1 dims")
        elif k is OpKind.REDUCTION:
            if node.attrs.get("op", "sum") not in _NEUTRAL:
                causes.append(
                    f"{node.name}: reduce op {node.attrs.get('op')!r}")
    if causes:
        return causes, None, None
    try:
        em = _Emitter(p, ana, ana.feasible_blocks[0], aliases)
        return [], em, em.run()
    except StitchInfeasible as err:
        return [str(err)], None, None


def check_emittable(p: FusionPattern, ana: StitchAnalysis) -> None:
    """The emitter's static feasibility check (made at tune time).  Raises
    :class:`StitchInfeasible` with the first of :func:`emittable_causes`."""
    _checked(p, ana)


def _checked(p, ana, aliases=None) -> tuple[_Emitter, _Emitted]:
    causes, em, emitted = _rendered(p, ana, aliases)
    if causes:
        raise StitchInfeasible(causes[0])
    return em, emitted


def _dtype_causes(node: OpNode) -> list[str]:
    if str(node.dtype) not in _TL_DTYPES:
        return [f"{node.name}: dtype {node.dtype} not emitted"]
    return []


# ---------------------------------------------------------------------------
# layout-only patterns
# ---------------------------------------------------------------------------

def layout_member(node: OpNode, g: Graph) -> bool:
    """Whether ``node`` only relabels its operand's elements and keeps their
    order: a RESHAPE, a TRANSPOSE whose moved axes all have extent 1, a
    BROADCAST that only adds size-1 dims, or a ``convert`` to the operand's
    own dtype.  Its value is then its operand's bytes, reshaped."""
    k = node.kind
    if k not in (OpKind.RESHAPE, OpKind.TRANSPOSE, OpKind.BROADCAST,
                 OpKind.ELEMENTWISE) or len(node.operands) != 1:
        return False
    src = g[node.operands[0]]
    if k is OpKind.RESHAPE:
        return True
    if k is OpKind.TRANSPOSE:
        kept = [a for a in node.attrs["perm"] if src.shape[a] != 1]
        return kept == sorted(kept)
    if k is OpKind.BROADCAST:
        dims = tuple(node.attrs["bcast_dims"])
        kept = [dims[j] for j, d in enumerate(src.shape) if d != 1]
        return (math.prod(src.shape) == math.prod(node.shape)
                and kept == sorted(kept)
                and all(node.shape[dims[j]] == d
                        for j, d in enumerate(src.shape) if d != 1))
    return (node.attrs.get("op") == "convert"
            and canonical_dtype(node.dtype) == canonical_dtype(src.dtype))


def layout_only(p: FusionPattern) -> bool:
    """Whether every compute member of ``p`` is a :func:`layout_member`,
    each fed from the pattern's external inputs (no constant member)."""
    members = p.compute_members
    return (bool(members) and len(members) == len(p.members)
            and all(layout_member(n, p.graph) for n in members))


def _view_base(g: Graph, name: str) -> str:
    """The node whose bytes ``name`` views: back through layout members and
    slices of one run of elements."""
    while not g[name].is_source() and _contiguous_part(g[name], g) is not None:
        name = g[name].operands[0]
    return name


def input_run(p: FusionPattern, name: str) -> tuple[str, int] | None:
    """(external input, element offset) when ``name`` is a run of an
    input's contiguous elements in their order (layout members, slices of
    one run), else None."""
    g, off = p.graph, 0
    while name not in p.external_inputs:
        part = _contiguous_part(g[name], g)
        if part is None:
            return None
        off += part
        name = g[name].operands[0]
    return name, off


def alias_refusal(g: Graph, name: str) -> str | None:
    """Why ``name`` must not be a view of the bytes it views, or None.  A
    view aliases its input, so a graph output must not be one whose bytes
    a caller also holds: not a view of a graph input (the engine writes its
    KV cache and its inputs in place between calls), and not one whose
    bytes another graph output views too.  Within a call nothing writes in
    place."""
    outs = set(g.outputs)
    if name not in outs:
        return None
    base = _view_base(g, name)
    if g[base].is_source():
        return f"graph output {name} would view graph input {base}"
    if base in outs or any(o != name and _view_base(g, o) == base
                           for o in outs):
        return f"graph output {name} would share {base} with another output"
    return None


def view_outputs(p: FusionPattern) -> dict[str, tuple[str, int]]:
    """The outputs of ``p`` returned as views of an input: each that is a
    run of its elements (:func:`input_run`) and that :func:`alias_refusal`
    allows, with its (input, element offset)."""
    views = {}
    for o in p.external_outputs:
        run = input_run(p, o)
        if run is not None and alias_refusal(p.graph, o) is None:
            views[o] = run
    return views


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
    elif kind is OpKind.SLICE:
        if bool(k) != bool(ks):
            raise fold_err
        if ks:
            starts = tuple(attrs["starts"])
            limits = tuple(attrs["limits"])
            strides = tuple(attrs.get("strides") or (1,) * len(starts))
            # the folded axes must be kept whole, and the slice must keep
            # the folded rank (a trailing axis cut to extent 1 would move
            # the fold's prefix)
            if (any(starts[a] != 0 or limits[a] != src.shape[a]
                    or strides[a] != 1 for a in range(ks))
                    or len(shape) != 1 + len(src.shape) - ks):
                raise fold_err
            attrs["starts"] = (0,) + starts[ks:]
            attrs["limits"] = (rows,) + limits[ks:]
            attrs["strides"] = (1,) + strides[ks:]
    elif kind is OpKind.GATHER:
        ki = pre[node.operands[1]]
        # a row-varying table would cross the rows; the indices carry them
        if ks or bool(k) != bool(ki) or (k and tuple(shape) != (
                (rows,) + tuple(g[node.operands[1]].shape[ki:])
                + tuple(src.shape[1:]))):
            raise fold_err
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
    return _fold(p)[:2]


def _fold(p: FusionPattern, aliases=None):
    """:func:`fold_rows`, with the emitter and kernel of the check."""
    last: StitchInfeasible | None = None
    for rows in _fold_rows_candidates(p):
        try:
            fp = _folded_pattern(p, rows)
            ana = _analyze_with_rows(fp, rows)
            return (fp, ana) + _checked(fp, ana, aliases)
        except StitchInfeasible as err:
            last = err
    raise last if last is not None else StitchInfeasible("no rows to fold")


def _fold_rows_candidates(p: FusionPattern) -> list[int]:
    """Row counts to fold to: the products of each boundary value's leading
    dims, in order of first appearance."""
    g = p.graph
    cands: list[int] = []
    for n in list(p.external_outputs) + list(p.external_inputs):
        shp = g[n].shape
        prod = shp[0] if shp else 1
        for d in shp[1:-1]:
            prod *= d
            if d != 1 and prod not in cands:
                cands.append(prod)
    return cands


def _folded_pattern(p: FusionPattern, rows: int) -> FusionPattern:
    """``p`` with every value's leading dims that multiply to ``rows``
    folded into one row axis; raises StitchInfeasible when a member
    crosses the folded rows."""
    g = p.graph
    names = list(p.external_inputs) + [n.name for n in p.nodes]
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
    return (PackPattern(fg, p.members, p.origin, member_groups=groups)
            if groups else FusionPattern(fg, p.members, p.origin))


def refusal_causes(p: FusionPattern) -> list[str]:
    """Every cause that keeps the emitter from rendering ``p`` (empty when
    :func:`emission_plan` admits it): of ``p`` itself and of each of its
    row folds, a form the analysis admits before one it refuses (the
    refusal is then its one cause), then the form with the fewest causes
    that no stage-1 work would remove, then the fewest causes."""
    p = explicit_broadcasts(p)
    forms: list[tuple[int, list[str]]] = []     # (analysis refused, causes)
    try:
        forms.append((0, emittable_causes(p, analyze_pattern(p))))
    except StitchInfeasible as err:
        forms.append((1, [str(err)]))
    if forms[0][1]:
        for rows in _fold_rows_candidates(p):
            try:
                fp = _folded_pattern(p, rows)
                forms.append((0, emittable_causes(
                    fp, _analyze_with_rows(fp, rows))))
            except StitchInfeasible as err:
                forms.append((1, [f"folded rows: {err}"]))
    return min(forms, key=lambda f: (
        f[0], sum(cause_stage(x) != 1 for x in f[1]), len(f[1])))[1]


def cause_stage(cause: str) -> int | None:
    """The ROADMAP Queue 2 stage a cause names, or None (a refusal of the
    reference's own analysis, an op or dtype outside the vocabulary)."""
    for s in (1, 2, 3, 5):
        if f"stage {s}" in cause:
            return s
    return None


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
    when the reference's analysis admits it and its rows fit a tile, else
    its row-folded form (when that too is refused, ``p`` with its wide rows
    swept chunk by chunk).  When neither is emitted, the StitchInfeasible
    names both reasons."""
    return _emission(p)[:2]


def _emission(p: FusionPattern, aliases=None):
    """:func:`emission_plan`, with the kernel its check rendered at the
    chosen form's first row block (``aliases`` returned as views)."""
    p = explicit_broadcasts(p)
    try:
        ana = analyze_pattern(p)
        em, emitted = _checked(p, ana, aliases)
    except StitchInfeasible as err:
        try:
            fp, fana, _, emitted = _fold(p, aliases)
        except StitchInfeasible as fold_err:
            raise StitchInfeasible(f"{err}; folded rows: {fold_err}") from None
        return fp, fana, emitted
    if any(pl.chunk or any(em.role(o) == ROW
                           and em.row_elems(o, pl) > MAX_BLOCK_ELEMS
                           for o in pl.copies) for pl in em.plans):
        # rows too wide for one tile: one row per token where the fold
        # admits it, before sweeping each wide row chunk by chunk (or
        # copying it with one program a few rows)
        try:
            fp, fana, _, emitted = _fold(p, aliases)
            return fp, fana, emitted
        except StitchInfeasible:
            pass
    return p, ana, emitted


@dataclass
class _Emitted:
    source: str
    digest: str
    block_r: int               # rows a program ("rows" layout; 0 if "flat")
    grid: int
    num_warps: int
    in_names: list[str]        # kernel arg i <- this external input
    out_names: list[str]       # kernel out j -> this external output
    out_dtypes: list[str]
    layout: str = "rows"       # "rows" | "flat"
    block: int = 0             # elements a program ("flat" layout)
    # scratch j: (elements, dtype) of the workspace the wrapper allocates
    # for a value the kernel stores and reloads at other offsets
    scratch: tuple = ()
    # external inputs a wide row's sweeps read again (one name per extra
    # read), and the sweeps over a row (0: the row fits one tile)
    rereads: tuple = ()
    sweeps: int = 0
    # outputs returned as views of an input, not stored: (output, input,
    # element offset)
    view_outs: tuple = ()


# the flat layout's programs: a warp's 32 threads load 16 bytes each of the
# widest value (16 int64s a thread, for a bool's 16 bytes, ran a third
# slower than the rows layout on the card), 1 warp a program
# while that gives at most FLAT_PROGRAMS programs, else 4 warps of 4 loads
# a thread
FLAT_PROGRAMS = 528                     # 4 a SM on the H100's 132


def flat_elements(p: FusionPattern, ana: StitchAnalysis) -> int:
    """N when ``p`` computes element by element over N elements in their
    row-major order, else 0: no reduction, not a pack, every value either
    N elements (a reshape, a transpose of size-1 axes and a broadcast that
    only adds size-1 dims keep the order) or one element."""
    if getattr(p, "member_groups", None):
        return 0
    g = p.graph
    members = p.compute_members
    if any(m.kind is OpKind.REDUCTION for m in members):
        return 0
    n = max(g[o].size for o in p.external_outputs)
    if n < 2:
        return 0
    for name in list(p.external_inputs) + [m.name for m in members]:
        if g[name].size not in (1, n):
            return 0
    for m in members:
        if m.kind is OpKind.BROADCAST and g[m.operands[0]].size != 1 \
                and not layout_member(m, g):
            return 0
        if m.kind in (OpKind.SLICE, OpKind.GATHER) or (
                m.kind is OpKind.TRANSPOSE and not layout_member(m, g)):
            return 0                # moves elements: not the same order
    return n


# elements of a wide row a sweep step holds at most, and the elements a
# copy loop moves a step
COPY_BLOCK = 4096

_MOVES = (OpKind.RESHAPE, OpKind.TRANSPOSE, OpKind.SLICE, OpKind.GATHER)


class _Plan:
    """How one subgraph is rendered (:meth:`_Emitter.plan`): each member's
    route to its tile, the values stored to scratch, the tiles the kernel
    holds, the outputs copied through their views, and for a wide row the
    chunked axis of each tile and the sweep (level) that completes each
    value."""

    def __init__(self):
        self.route: dict[str, str] = {}
        self.spills: list[str] = []
        self.need: set[str] = set()
        self.copies: list[str] = []
        self.chunk: dict[str, int] = {}     # tile -> chunked logical axis
        self.group: dict[str, int] = {}     # tile -> its chunk group
        # chunk group -> (the chunked axis's extent, its elements a step)
        self.loops: list[tuple[int, int]] = []
        self.level: dict[str, int] = {}
        self.sweeps = 0


class _Emitter:
    """Renders a pattern in one of two layouts.  ``"rows"``: each program
    owns ``block_r`` rows of R, a value a register tile of its padded
    trailing dims.  ``"flat"`` (:func:`flat_elements`): each program owns
    ``block`` consecutive elements, 16-byte accesses, enough programs to
    spread a decode step's few rows over the SMs; every element's
    arithmetic is the rows layout's expression for expression.

    Data movement (the rows layout).  A slice, a transpose, a reshape, a
    broadcast or a gather of a value in memory (an external input, or a
    value stored to scratch) is a :class:`_View`: its index map is composed
    into the consumer's load, and nothing moves before.  A reshape of a
    register tile stays in registers where the padded tile allows it (the
    same kernel dims, or every kernel axis but the first a power of two on
    both sides and the padded totals equal: then the padded offset of each
    real element is its logical offset), and a transpose is ``tl.permute``
    of the padded tile.  Everything else of a computed value goes through
    a program-private scratch: the tile is stored, the program's threads
    meet at ``tl.debug_barrier()``, and the consumer loads at its own
    offsets (the TPU kernel's block composition through VMEM scratch; the
    workspace is the wrapper's, a few KB a program, and stays in L2).  An
    output whose every member is data movement of the inputs is copied
    through its view, a flat loop over its elements (an invariant output
    split across the programs).

    An output in ``aliases`` (:func:`view_outputs`) is a view of an input,
    made by the wrapper: the kernel stores nothing for it.

    Wide rows.  A tile of more than ``MAX_BLOCK_ELEMS`` padded elements a
    row is held a chunk of its outermost kernel axis at a time, with every
    tile that axis flows into element by element (a chunk group): the
    kernel loops over the chunks.  A row reduction over that axis (or a
    chunked value stored to scratch) completes only after the whole row:
    it takes one sweep of the loop, and what depends on it a later sweep
    that loads the inputs again and recomputes the chunk.  A group of
    invariant tiles alone, the same in every program, deals its chunks out
    to the programs."""

    def __init__(self, p: FusionPattern, ana: StitchAnalysis, rb: int,
                 aliases: dict | None = None):
        self.p = p
        self.g = p.graph
        # output -> (input, element offset): the outputs returned as views
        self.aliases = aliases or {}
        self.ana = ana
        self.rows = ana.rows
        self.lines: list[str] = []
        self.vals: dict[str, _Val] = {}
        self.views: dict[str, _View] = {}
        self.nvar = 0
        self.indent = 1
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
        self.plans = [self.plan(sub) for sub in self.subgraphs]
        widest = 1
        for pl in self.plans:
            for name in pl.need:
                if self.role(name) == ROW:
                    widest = max(widest, self.row_elems(name, pl))
        cap = max(1, MAX_BLOCK_ELEMS // widest)
        self.block_r = min(_pow2(min(rb, self.rows)), 1 << (cap.bit_length() - 1))
        self.blocks = -(-self.rows // self.block_r)
        self.grid = self.blocks * len(self.subgraphs)
        tile = self.block_r * widest
        if any(pl.copies for pl in self.plans):
            tile = max(tile, COPY_BLOCK)   # a copy loop's step
        self.num_warps = (1 if tile <= 256 else 2 if tile <= 1024
                          else 4 if tile <= 4096 else 8)
        self.flat = flat_elements(p, ana)
        if self.flat:
            names = list(p.external_inputs) + [n.name for n in p.compute_members]
            item = max(1 if str(self.g[n].dtype) == "bool"
                       else canonical_dtype(self.g[n].dtype).itemsize
                       for n in names)
            vec = max(1, 16 // item)
            if -(-self.flat // (32 * vec)) <= FLAT_PROGRAMS:
                num_warps, block = 1, 32 * vec
            else:
                num_warps, block = 4, 4 * 4 * 32 * vec
            grid = -(-self.flat // block)
            # flat only where it spreads the work over at least as many
            # programs as the rows layout: on the card a decode step's adds
            # ran faster flat, while index patterns whose rows layout already
            # gave 32-1280 one-warp programs ran as fast or faster in it
            if grid < self.grid:
                self.flat = 0
            else:
                self.num_warps, self.block, self.grid = num_warps, block, grid
                self.block_r = block       # a flat value's tile: (block,)
        self.pl = self.plans[0]
        self.scratch: list[tuple[int, str]] = []
        self.sweep = 0                     # the sweep being rendered (1-based)
        self.spread = False                # its chunks dealt out to programs
        self.sweep_reads: set[tuple[int, str]] = set()

    # -- small helpers ---------------------------------------------------------
    def var(self) -> str:
        self.nvar += 1
        return f"v{self.nvar}"

    def emit(self, line: str) -> None:
        self.lines.append("    " * self.indent + line)

    def role(self, name: str) -> str:
        return self.ana.roles[name]

    def arange(self, n_axes: int, axis: int, size: int) -> str:
        idx = ", ".join(":" if i == axis else "None" for i in range(n_axes))
        return f"tl.arange(0, {size})" + (f"[{idx}]" if n_axes > 1 else "")

    def kaxes(self, name: str) -> list[int]:
        """The logical axes of ``name`` that are kernel axes, in order: the
        row axis of a ROW value, then every other axis of extent > 1."""
        row = self.role(name) == ROW
        return ([0] if row else []) + [
            i for i, d in enumerate(self.g[name].shape)
            if d != 1 and not (row and i == 0)]

    def row_elems(self, name: str, pl: _Plan) -> int:
        """Padded elements a row of ``name``'s tile holds (a chunk of its
        chunked axis, where it has one)."""
        node = self.g[name]
        row = self.role(name) == ROW
        n = 1
        for i, d in enumerate(node.shape):
            if d == 1 or (row and i == 0):
                continue
            n *= (pl.loops[pl.group[name]][1] if pl.chunk.get(name) == i
                  else _pow2(d))
        return n

    def new_val(self, name: str) -> _Val:
        node = self.g[name]
        if self.flat:               # a flat value is N elements or a scalar
            return _Val(self.var(), node.size == self.flat, (),
                        str(node.dtype))
        row = self.role(name) == ROW
        v = _Val(self.var(), row, _kernel_dims(node.shape, row),
                 str(node.dtype))
        axis = self.pl.chunk.get(name)
        if axis is not None:
            v.chunk = self.kaxes(name).index(axis)
            v.ch = self.pl.loops[self.pl.group[name]][1]
        return v

    def ctx(self, name: str):
        """The index expression of each logical axis of ``name`` over its
        tile in the current scope, and the mask of the tile's real lanes."""
        node = self.g[name]
        row = self.role(name) == ROW
        kax = self.kaxes(name)
        n = len(kax)
        chunk = self.pl.chunk.get(name)
        ch = self.pl.loops[self.pl.group[name]][1] if chunk is not None else 0
        exprs, masks = [], []
        for i, d in enumerate(node.shape):
            if row and i == 0:
                r = "rows" + ("" if n == 1 else
                              "[" + ", ".join([":"] + ["None"] * (n - 1)) + "]")
                exprs.append(r)
                masks.append(f"({r} < {self.rows})")
            elif d == 1:
                exprs.append("0")
            elif chunk == i:
                k = kax.index(i)
                idx = ", ".join(":" if j == k else "None" for j in range(n))
                a = "ck" + (f"[{idx}]" if n > 1 else "")
                exprs.append(a)
                if d % ch:
                    masks.append(f"({a} < {d})")
            else:
                a = self.arange(n, kax.index(i), _pow2(d))
                exprs.append(a)
                if _pow2(d) != d:
                    masks.append(f"({a} < {d})")
        return exprs, " & ".join(masks) or None

    def offsets(self, name: str):
        """Offsets and mask of ``name``'s tile in a contiguous tensor of its
        logical shape (global rows for a ROW value)."""
        node = self.g[name]
        exprs, mask = self.ctx(name)
        strides = _strides(node.shape)
        terms = []
        for i, (e, s) in enumerate(zip(exprs, strides)):
            if e == "0":
                continue
            if i == 0 and self.role(name) == ROW:
                terms.append(f"{e} * {s}")
            else:
                terms.append(f"{e} * {s}" if s != 1 else e)
        return " + ".join(terms) or "0", mask

    def axis_masks(self, v: _Val, axes: list[int]) -> str | None:
        """Mask of the padded lanes on the given kernel axes of ``v``."""
        n = len(v.kshape(self.block_r))
        off = 1 if v.row else 0
        masks = []
        for ax in axes:
            d = v.dims[ax - off]
            if ax == v.chunk:
                if d % v.ch:
                    idx = ", ".join(":" if j == ax else "None" for j in range(n))
                    masks.append("(ck" + (f"[{idx}]" if n > 1 else "")
                                 + f" < {d})")
            elif _pow2(d) != d:
                masks.append(f"({self.arange(n, ax, _pow2(d))} < {d})")
        return " & ".join(masks) or None

    # -- planning --------------------------------------------------------------
    def reg_route(self, node: OpNode) -> str | None:
        """How a reshape or transpose of a register tile stays in registers
        ("alias", "reshape", "permute"), or None."""
        src = self.g[node.operands[0]]
        row = self.role(node.name) == ROW
        if node.kind is OpKind.RESHAPE:
            a = _kernel_dims(src.shape, row)
            b = _kernel_dims(node.shape, row)
            if a == b:
                return "alias"
            if (all(_pow2(d) == d for d in a[1:] + b[1:])
                    and math.prod(map(_pow2, a)) == math.prod(map(_pow2, b))):
                return "reshape"
            return None
        if node.kind is OpKind.TRANSPOSE:
            kept = [a for a in node.attrs["perm"] if src.shape[a] != 1]
            return "alias" if kept == sorted(kept) else "permute"
        return None

    def plan(self, sub: list[OpNode]) -> _Plan:
        no_reg: set[str] = set()
        while True:
            pl = self._plan(sub, no_reg)
            if isinstance(pl, _Plan):
                return pl
            no_reg |= pl

    def _plan(self, sub, no_reg):
        g = self.g
        ins = set(self.p.external_inputs)
        outs = [n.name for n in sub if n.name in self.p.external_outputs]
        pl = _Plan()
        has_view = {n: True for n in ins}
        for m in sub:
            k, ops, name = m.kind, m.operands, m.name
            if k is OpKind.GATHER:
                for o in ops:
                    if not has_view.get(o):
                        pl.spills.append(o)
                        has_view[o] = True
                pl.route[name], has_view[name] = "load", True
            elif k in _MOVES:
                u = ops[0]
                reg = None if name in no_reg else self.reg_route(m)
                if has_view.get(u):
                    # a tile from the operand's tile where that is only a
                    # rename or a reshape in registers, else a load
                    pl.route[name] = reg if reg in ("alias", "reshape") else "load"
                    has_view[name] = True
                elif reg:
                    pl.route[name], has_view[name] = reg, False
                else:
                    pl.spills.append(u)
                    has_view[u] = True
                    pl.route[name], has_view[name] = "load", True
            elif k is OpKind.BROADCAST:
                pl.route[name] = "compute"
                has_view[name] = bool(has_view.get(ops[0]))
            else:
                pl.route[name], has_view[name] = "compute", False
        need = set(pl.spills) | {o for o in outs if not has_view[o]}
        for m in reversed(sub):
            if m.name in need and pl.route[m.name] != "load":
                need.update(m.operands)
        pl.need = need
        pl.copies = [o for o in outs if o not in need]
        # wide rows: chunk the outermost kernel axis of a tile too wide for
        # one block, and that axis of every tile it flows through element
        # by element (a chunk group); then the next wide tile not reached
        wide = [n for n in sorted(need)
                if self.row_elems(n, pl) > MAX_BLOCK_ELEMS]
        if not wide:
            return pl
        chunk: dict[str, int] = {}
        group: dict[str, int] = {}
        parent: list[int] = []
        boundary: set[str] = set()

        def root(c: int) -> int:
            while parent[c] != c:
                c = parent[c]
            return c

        def label(n, a, c) -> bool:
            if n not in need:
                return False
            if n in chunk:
                if chunk[n] != a:
                    raise StitchInfeasible(
                        f"{n}: a wide row chunked along two axes "
                        f"(ROADMAP Queue 2 stage 1, wide rows)")
                r1, r2 = root(group[n]), root(c)
                if r1 == r2:
                    return False
                parent[r1] = r2
                return True
            chunk[n], group[n] = a, c
            return True

        for seed in wide:
            if seed in chunk:
                continue
            parent.append(len(parent))
            kax = [a for a in self.kaxes(seed)
                   if not (self.role(seed) == ROW and a == 0)]
            label(seed, kax[0], parent[-1])
            changed = True
            while changed:
                changed = False
                for m in sub:
                    if m.name not in need:
                        continue
                    r = pl.route[m.name]
                    if r in ("alias", "reshape", "permute"):
                        if m.name in chunk or m.operands[0] in chunk:
                            return {m.name}         # retry: no register route
                        continue
                    if r != "compute":
                        continue
                    changed |= self.propagate(m, chunk, group, label, boundary)
        roots = sorted({root(c) for c in group.values()})
        loops = []
        for r in roots:
            tiles = [n for n in chunk if root(group[n]) == r]
            extents = {g[n].shape[chunk[n]] for n in tiles}
            if len(extents) != 1:
                raise StitchInfeasible(
                    f"wide rows chunked along axes of extents "
                    f"{sorted(extents)} (ROADMAP Queue 2 stage 1, wide rows)")
            wc = extents.pop()
            rest = max(math.prod(_pow2(d) for i, d in enumerate(g[n].shape)
                                 if d != 1 and i != chunk[n]
                                 and not (self.role(n) == ROW and i == 0))
                       for n in tiles)
            if rest > MAX_BLOCK_ELEMS:
                raise StitchInfeasible(
                    f"{tiles[0]}: a row whose axes off the chunked one "
                    f"alone exceed one block ({rest} padded elements; "
                    f"ROADMAP Queue 2 stage 1, wide rows)")
            ch = min(_pow2(wc), MAX_BLOCK_ELEMS // rest)
            loops.append((wc, 1 << (ch.bit_length() - 1)))
        pl.chunk = chunk
        pl.group = {n: roots.index(root(c)) for n, c in group.items()}
        pl.loops = loops
        for n in need:
            if n not in chunk and self.row_elems(n, pl) > MAX_BLOCK_ELEMS:
                raise StitchInfeasible(
                    f"{n}: a row of {self.row_elems(n, pl)} padded elements "
                    f"off the chunked axis (ROADMAP Queue 2 stage 1, wide rows)")
        # levels: a boundary (a reduction over the chunked axis, a chunked
        # value stored to scratch) completes one sweep after its operand
        lvl = {n: 0 for n in ins}

        def view_level(o):
            return lvl[o] + (1 if o in pl.spills and o in chunk else 0)

        for m in sub:
            if pl.route[m.name] == "load":
                lv = max(view_level(o) for o in m.operands)
            else:
                lv = max((lvl[o] for o in m.operands), default=0)
            lvl[m.name] = lv + (1 if m.name in boundary else 0)
        pl.level = lvl
        pl.sweeps = max([lvl[m] for m in boundary]
                        + [lvl[o] + 1 for o in pl.spills if o in chunk] + [0])
        if pl.sweeps and len(loops) > 1:
            raise StitchInfeasible(
                "sweeps over wide rows of two chunk groups "
                "(ROADMAP Queue 2 stage 1, wide rows)")
        return pl

    def propagate(self, m: OpNode, chunk, group, label, boundary) -> bool:
        """Carry a chunked axis across one computed member (either way)."""
        g = self.g
        ops = [o for o in m.operands if g[o].shape]
        changed = False
        if m.kind is OpKind.ELEMENTWISE:
            for n in [m.name] + ops:
                if n in chunk:
                    for x in [m.name] + ops:
                        changed |= label(x, chunk[n], group[n])
                    break
        elif m.kind is OpKind.BROADCAST:
            dims = tuple(m.attrs["bcast_dims"])
            src = m.operands[0]
            if src in chunk:
                changed |= label(m.name, dims[chunk[src]], group[src])
            elif m.name in chunk:
                for j, d in enumerate(g[src].shape):
                    if dims[j] == chunk[m.name] and d != 1:
                        changed |= label(src, j, group[m.name])
        elif m.kind is OpKind.REDUCTION:
            axes = set(m.attrs["axes"])
            src = m.operands[0]
            keep = bool(m.attrs.get("keepdims", False))
            if src in chunk and chunk[src] in axes:
                boundary.add(m.name)
                if m.name in chunk:
                    raise StitchInfeasible(
                        f"{m.name}: a wide row chunked along two axes "
                        f"(ROADMAP Queue 2 stage 1, wide rows)")
            elif src in chunk:
                a = chunk[src]
                changed |= label(m.name, a if keep else a - sum(
                    x < a for x in axes), group[src])
            elif m.name in chunk:
                a = chunk[m.name]
                if not keep:
                    for x in sorted(axes):
                        if x <= a:
                            a += 1
                changed |= label(src, a, group[m.name])
        return changed

    # -- views -----------------------------------------------------------------
    def input_view(self, name: str, ptr: str) -> None:
        node = self.g[name]
        self.views[name] = _View(ptr, tuple(node.shape), str(node.dtype),
                                 _same, name, True)

    def ensure_view(self, name: str) -> _View:
        v = self.views.get(name)
        if v is not None:
            return v
        node = self.g[name]
        if name in self.pl.spills:
            if name in self.pl.chunk:          # stored by its sweep
                raise StitchInfeasible(f"{name}: read before its sweep")
            self.tile(name)                    # computes and stores it
            return self.views[name]
        srcs = [self.ensure_view(o) for o in node.operands]
        if node.kind is OpKind.GATHER:
            table, idx = srcs
            m = len(self.g[node.operands[1]].shape)
            n0 = self.g[node.operands[0]].shape[0]

            def index(ctx, mask, table=table, idx=idx, m=m, n0=n0):
                i = self.load_view(idx, ctx[:m], mask)
                t = self.var()
                self.emit(f"{t} = tl.where({i} < 0, {i} + {n0}, {i})")
                return table.index([t] + list(ctx[m:]), mask)

            v = _View(table.ptr, table.shape, table.dtype, index, table.base)
        else:
            src = srcs[0]
            off = (_contiguous_part(node, self.g)
                   if src.identity and node.kind in _MOVES else None)
            if off is not None:
                # the same bytes (from an offset) under the value's shape
                ptr = f"({src.ptr} + {off})" if off else src.ptr
                v = _View(ptr, tuple(node.shape), src.dtype, _same, src.base,
                          True)
            else:
                def index(ctx, mask, node=node, src=src):
                    return src.index(self.compose(node, list(ctx)), mask)

                v = _View(src.ptr, src.shape, src.dtype, index, src.base)
        self.views[name] = v
        return v

    def compose(self, node: OpNode, ctx: list[str]) -> list[str]:
        """Index expressions over the operand's axes from those over
        ``node``'s: the inverse map of one data-movement member."""
        src = self.g[node.operands[0]].shape
        k = node.kind
        if k is OpKind.SLICE:
            starts = node.attrs["starts"]
            steps = node.attrs.get("strides") or (1,) * len(src)
            out = []
            for e, s, st in zip(ctx, starts, steps):
                e = _times(e, st)
                out.append(e if not s else str(s) if e == "0" else f"{e} + {s}")
            return out
        if k is OpKind.TRANSPOSE:
            out = [None] * len(src)
            for j, a in enumerate(node.attrs["perm"]):
                out[a] = ctx[j]
            return out
        if k is OpKind.BROADCAST:
            dims = tuple(node.attrs["bcast_dims"])
            return [ctx[dims[j]] if d != 1 else "0" for j, d in enumerate(src)]
        # RESHAPE: through the linear offset (the row axis of a ROW value
        # stays; only its trailing dims are reshaped)
        dst = node.shape
        start = 1 if (self.role(node.name) == ROW and src and dst
                      and src[0] == dst[0] == self.rows) else 0
        dstr = _strides(dst)
        lin = _sum(_times(ctx[i], dstr[i]) for i in range(start, len(dst)))
        t = self.var()
        self.emit(f"{t} = {lin}")
        out = list(ctx[:start])
        sstr = _strides(src)
        first = True
        for j in range(start, len(src)):
            if src[j] == 1:
                out.append("0")
                continue
            q = t if sstr[j] == 1 else f"{t} // {sstr[j]}"
            out.append(q if first else f"({q}) % {src[j]}")
            first = False
        return out

    def load_view(self, v: _View, ctx, mask, kshape=None,
                  into: str | None = None) -> str:
        """Load a view at the index expressions ``ctx`` of its value's axes
        (into the variable ``into``, else a new one); ``kshape`` is the
        tile's shape (the offsets are spread to it)."""
        bctx = v.index(list(ctx), mask)
        offs = _sum(_times(e, s) for e, s in zip(bctx, _strides(v.shape)))
        if kshape:
            offs = f"tl.zeros({_shape_s(kshape)}, tl.int32) + {_par(offs)}"
        t = self.var()
        self.emit(f"{t} = {offs}")
        val = f"tl.load({v.ptr} + {t}" + (f", mask={mask}, other=0)"
                                           if mask else ")")
        if v.dtype == "bool":
            val = f"({val} != 0)"
        x = into or self.var()
        self.emit(f"{x} = {val}")
        if self.sweep and v.base is not None:
            self.sweep_reads.add((self.sweep, v.base))
        return x

    # -- tiles -----------------------------------------------------------------
    def tile(self, name: str) -> _Val:
        """``name``'s register tile in the current scope, rendered (with
        what it needs) when it is not there yet."""
        v = self.vals.get(name)
        if v is not None:
            return v
        node = self.g[name]
        if name in self.in_arg:
            self.load(name, self.in_arg[name])
        elif self.pl.route[name] == "load":
            view = self.ensure_view(name)
            v = self.new_val(name)
            exprs, mask = self.ctx(name)
            self.load_view(view, exprs, mask, v.kshape(self.block_r), v.var)
            self.vals[name] = v
        else:
            for o in node.operands:
                self.tile(o)
            self.member(node)
        if name in self.pl.spills and name not in self.pl.chunk:
            self.spill(name)
        return self.vals[name]

    def spill(self, name: str, barrier: bool = True) -> None:
        """Store ``name``'s tile to a scratch of its logical shape (global
        rows of a ROW value; a region a program of an invariant one) and
        make that the value's view."""
        node = self.g[name]
        v = self.vals[name]
        j = self.scratch_of.get(name)
        if j is None:
            j = len(self.scratch)
            size = node.size
            numel = size if v.row else self.grid * size
            self.scratch.append((numel, str(node.dtype)))
            self.scratch_of[name] = j
        ptr = f"ws{j}" if v.row else f"(ws{j} + prog * {node.size})"
        if v.row or v.dims:
            offs, mask = self.offsets(name)
            val = f"{v.var}.to(tl.int8)" if v.dtype == "bool" else v.var
            m = f", mask={mask}" if mask else ""
            self.emit(f"tl.store({ptr} + ({offs}), {val}{m})")
        else:
            val = f"{v.var}.to(tl.int8)" if v.dtype == "bool" else v.var
            self.emit(f"tl.store({ptr}, {val})")
        if barrier:
            self.emit("tl.debug_barrier()")
        self.views[name] = _View(ptr, tuple(node.shape), str(node.dtype),
                                 _same, None, True)

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
        view_outs = tuple((n,) + self.aliases[n] for n in outs
                          if n in self.aliases)
        outs = [n for n in outs if n not in self.aliases]
        # what the wrapper does besides the source: the arguments' shapes
        # and the views it makes, by position, so that one digest is one
        # callable (a view-only input is an argument the body never reads)
        sig = repr(([(g[n].shape, str(g[n].dtype)) for n in order],
                    [(ext_out.index(o), order.index(i), off)
                     for o, i, off in view_outs]))
        self.in_arg = {name: f"in{i}" for i, name in enumerate(order)}
        out_arg = {name: f"out{j}" for j, name in enumerate(outs)}
        params = ([f"in{i}" for i in range(len(order))]
                  + [f"out{j}" for j in range(len(outs))])
        self.lines = []
        if self.flat:
            return self._run_flat(order, outs, self.in_arg, out_arg, params,
                                  sig, view_outs)
        self.scratch_of: dict[str, int] = {}
        self.emit("prog = tl.program_id(0)")
        for s, (sub, pl) in enumerate(zip(self.subgraphs, self.plans)):
            self.vals, self.views, self.pl = {}, {}, pl
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
                    if o in self.in_arg and o not in loaded:
                        loaded.append(o)
            for name in loaded:
                self.input_view(name, self.in_arg[name])
            for name in loaded:
                if name in pl.need and name not in pl.chunk:
                    self.load(name, self.in_arg[name])
            self.phase(sub, 0)
            for lv in range(1, pl.sweeps + 1):
                self.sweep_loop(sub, lv)
                self.phase(sub, lv)
            mine = [o for o in outs if o in names]
            for j in range(len(pl.loops)):
                wide = [o for o in mine if o in pl.need and o in pl.chunk
                        and pl.group[o] == j]
                if not wide:
                    continue
                # a group of invariant tiles alone is the same in every
                # program: each program takes its share of the chunks
                spread = not pl.sweeps and all(
                    self.role(n) != ROW for n, k in pl.group.items() if k == j)
                saved = self.loop(pl.sweeps + 1, j, spread)
                for name in wide:
                    self.store(name, out_arg[name])
                self.end_loop(saved)
            for name in mine:
                if name in pl.copies and name in out_arg:
                    self.copy(name, out_arg[name])
            for name in mine:
                if name in pl.need and name not in pl.chunk:
                    self.store(name, out_arg[name])
            self.indent = 1
        params += [f"ws{j}" for j in range(len(self.scratch))]
        body = "\n".join(self.lines)
        src = (f"@triton.jit\ndef stitched_kernel({', '.join(params)}):\n"
               f"{body}\n")
        digest = hashlib.sha1(f"{sig}\n{src}".encode()).hexdigest()[:16]
        sweeps = max(pl.sweeps + bool(pl.chunk) for pl in self.plans)
        header = (f"# generated stitched kernel {digest}: "
                  f"{len(p.compute_members)} ops, rows={self.rows}, "
                  f"block_r={self.block_r}, grid={self.grid}, "
                  f"subgraphs={len(self.subgraphs)}"
                  + (f", scratch={len(self.scratch)}" if self.scratch else "")
                  + (f", sweeps={sweeps}" if sweeps else "") + "\n")
        reads = Counter(name for _, name in self.sweep_reads)
        return _Emitted(
            source=_HEADER + header + src, digest=digest,
            block_r=self.block_r, grid=self.grid, num_warps=self.num_warps,
            in_names=order, out_names=outs,
            out_dtypes=[str(g[n].dtype) for n in outs],
            scratch=tuple(self.scratch),
            rereads=tuple(sorted(n for n, c in reads.items()
                                 for _ in range(c - 1))),
            sweeps=sweeps, view_outs=view_outs)

    def phase(self, sub, level: int) -> None:
        """Every tile off the chunked axis that completes at ``level``, in
        member order."""
        pl = self.pl
        for m in sub:
            if (m.name in pl.need and m.name not in pl.chunk
                    and pl.level.get(m.name, 0) == level):
                self.tile(m.name)

    def loop(self, sweep: int, group: int = 0, spread: bool = False) -> dict:
        """Enter a loop over the chunks of a chunk group's axis (``spread``:
        the chunks dealt out to the subgraph's programs in turn, for tiles
        every program holds alike)."""
        wc, ch = self.pl.loops[group]
        start, step = ((f"pid * {ch}", self.blocks * ch) if spread
                       else ("0", ch))
        self.emit(f"for c0 in range({start}, {wc}, {step}):")
        self.indent += 1
        self.emit(f"ck = c0 + tl.arange(0, {ch})")
        self.sweep, self.spread = sweep, spread
        return dict(self.vals)

    def end_loop(self, saved: dict) -> None:
        """Leave a sweep's loop: its chunk tiles go out of scope."""
        self.indent -= 1
        self.sweep, self.spread = 0, False
        self.vals = saved

    def sweep_loop(self, sub, level: int) -> None:
        """Sweep ``level`` over the wide rows: folds the reductions over the
        chunked axis that complete at it, chunk by chunk, and stores the
        chunked values its later sweeps load at other offsets."""
        pl, g = self.pl, self.g
        reds = [m for m in sub if m.kind is OpKind.REDUCTION
                and m.operands[0] in pl.chunk and m.name not in pl.chunk
                and pl.level.get(m.name) == level]
        stores = [o for o in pl.spills if o in pl.chunk
                  and pl.level[o] + 1 == level]
        accs = {}
        for r in reds:
            out = self.new_val(r.name)
            shape = out.kshape(self.block_r) or (1,)
            op = r.attrs.get("op", "sum")
            src_dt = str(g[r.operands[0]].dtype)
            if _is_float(src_dt):
                dt = "tl.float64" if src_dt == "float64" else "tl.float32"
                init = _NEUTRAL[op]
            else:
                dt = "tl.int64" if op in ("sum", "mean") else _TL_DTYPES[src_dt]
                init = {"max": str(_int_min(src_dt)),
                        "min": str(_int_max(src_dt))}.get(op, "0")
            acc = self.var()
            self.emit(f"{acc} = tl.full({_shape_s(shape)}, {init}, {dt})")
            accs[r.name] = (acc, out)
        saved = self.loop(level)
        for r in reds:
            acc, out = accs[r.name]
            part = self.reduce_expr(r, self.tile(r.operands[0]))
            op = r.attrs.get("op", "sum")
            fn = {"max": "tl.maximum", "min": "tl.minimum"}.get(op)
            self.emit(f"{acc} = {fn}({acc}, {part})" if fn
                      else f"{acc} = {acc} + {part}")
        for o in stores:
            self.tile(o)
            self.spill(o, barrier=False)
        self.end_loop(saved)
        if stores:
            self.emit("tl.debug_barrier()")
        for r in reds:
            acc, out = accs[r.name]
            op = r.attrs.get("op", "sum")
            expr = acc
            if not out.kshape(self.block_r):      # a scalar held as (1,)
                expr = f"{'tl.sum' if op in ('sum', 'mean') else 'tl.' + op}({acc}, axis=0)"
            expr = self.finish_reduction(r, g[r.operands[0]], expr)
            self.emit(f"{out.var} = {expr}")
            self.vals[r.name] = out

    def copy(self, name: str, ptr: str) -> None:
        """Store an output that is data movement of the inputs straight from
        its view: a loop over its elements, ``COPY_BLOCK`` a step (a ROW
        output's rows of this program; an invariant output split across
        the programs)."""
        node = self.g[name]
        view = self.ensure_view(name)
        if self.role(name) == ROW:
            tshape = tuple(node.shape[1:])
            e_n = math.prod(tshape)
            total = self.block_r * e_n
            n = min(_pow2(total), COPY_BLOCK)
            self.emit(f"for f0 in range(0, {total}, {n}):")
            self.indent += 1
            f = self.var()
            self.emit(f"{f} = f0 + tl.arange(0, {n})")
            r = self.var()
            self.emit(f"{r} = pid * {self.block_r} + "
                      + (f"{f} // {e_n}" if e_n != 1 else f))
            if e_n != 1:
                e = self.var()
                self.emit(f"{e} = {f} % {e_n}")
                offs = f"{r} * {e_n} + {e}"
            else:
                e, offs = "0", r
            ctx = [r] + self.unflatten(e, tshape)
            masks = [f"({r} < {self.rows})"] + (
                [f"({f} < {total})"] if total % n else [])
        else:
            size = node.size
            share = -(-size // self.blocks)
            n = min(_pow2(share), COPY_BLOCK)
            share = -(-share // n) * n
            self.emit(f"for f0 in range(0, {share}, {n}):")
            self.indent += 1
            f = self.var()
            self.emit(f"{f} = pid * {share} + f0 + tl.arange(0, {n})")
            ctx = self.unflatten(f, tuple(node.shape))
            offs, masks = f, [f"({f} < {size})"]
        mask = " & ".join(masks)
        if view.identity:           # the same order: a copy of a run
            x = self.var()
            val = f"tl.load({view.ptr} + {offs}, mask={mask}, other=0)"
            self.emit(f"{x} = ({val} != 0)" if view.dtype == "bool"
                      else f"{x} = {val}")
        else:
            x = self.load_view(view, ctx, mask, (n,))
        val = f"{x}.to(tl.int8)" if str(node.dtype) == "bool" else x
        self.emit(f"tl.store({ptr} + {offs}, {val}, mask={mask})")
        self.indent -= 1

    @staticmethod
    def unflatten(e: str, shape) -> list[str]:
        out, first = [], True
        for d, s in zip(shape, _strides(shape)):
            if d == 1:
                out.append("0")
                continue
            q = e if s == 1 else f"{e} // {s}"
            out.append(q if first else f"({q}) % {d}")
            first = False
        return out

    def load(self, name: str, ptr: str) -> None:
        v = self.new_val(name)
        self.vals[name] = v
        if not v.row and not v.dims:
            val = f"tl.load({ptr})"
        else:
            offs, mask = self.offsets(name)
            m = f", mask={mask}, other=0" if mask else ""
            val = f"tl.load({ptr} + ({offs}){m})"
        if v.dtype == "bool":
            val = f"({val} != 0)"
        self.emit(f"{v.var} = {val}")
        if self.sweep:
            self.sweep_reads.add((self.sweep, name))

    def store(self, name: str, ptr: str) -> None:
        v = self.tile(name)
        val = v.var
        if v.dtype == "bool":
            val = f"{val}.to(tl.int8)"
        if not v.row and not v.dims:
            self.emit(f"tl.store({ptr}, {val}, mask=pid == 0)")
            return
        offs, mask = self.offsets(name)
        if not v.row and not self.spread:
            # every program holds the invariant value; program 0 writes it
            mask = f"({mask}) & (pid == 0)" if mask else "pid == 0"
        m = f", mask={mask}" if mask else ""
        self.emit(f"tl.store({ptr} + ({offs}), {val}{m})")

    def member(self, node: OpNode) -> None:
        k = node.kind
        ops = [self.vals[o] for o in node.operands]
        v = self.new_val(node.name)
        route = self.pl.route.get(node.name)
        if k is OpKind.ELEMENTWISE:
            expr = self.elementwise(node, ops)
        elif k is OpKind.BROADCAST:
            expr = self.broadcast(node, ops[0], v)
        elif route == "alias":
            expr = ops[0].var
        elif route == "reshape":
            shape = v.kshape(self.block_r)
            expr = f"tl.reshape({ops[0].var}, ({', '.join(str(s) for s in shape)},))"
        elif route == "permute":
            expr = self.permute(node, ops[0])
        elif k is OpKind.REDUCTION:
            expr = self.reduction(node, ops[0], v)
        else:  # pragma: no cover - the plan loads the other members
            raise StitchInfeasible(f"cannot emit {k}")
        self.emit(f"{v.var} = {expr}")
        self.vals[node.name] = v

    def permute(self, node: OpNode, src: _Val) -> str:
        perm = tuple(node.attrs["perm"])
        ka_src = self.kaxes(node.operands[0])
        kperm = [ka_src.index(perm[j]) for j in self.kaxes(node.name)]
        if kperm == sorted(kperm):
            return src.var
        return f"tl.permute({src.var}, ({', '.join(map(str, kperm))},))"

    def _run_flat(self, order, outs, in_arg, out_arg, params, sig,
                  view_outs) -> _Emitted:
        p, g, n = self.p, self.g, self.flat
        start = "tl.program_id(0)" + (".to(tl.int64)" if n >= 2 ** 31 else "")
        self.emit(f"offs = {start} * {self.block} + tl.arange(0, {self.block})")
        if any(g[o].size == 1 for o in outs):
            self.emit("pid = tl.program_id(0)")
        mask = None if n % self.block == 0 else f"offs < {n}"
        for name in order:
            v = self.new_val(name)
            self.vals[name] = v
            val = (f"tl.load({in_arg[name]})" if not v.row else
                   f"tl.load({in_arg[name]} + offs"
                   + (f", mask={mask}, other=0)" if mask else ")"))
            if v.dtype == "bool":
                val = f"({val} != 0)"
            self.emit(f"{v.var} = {val}")
        for node in self.subgraphs[0]:
            v = self.new_val(node.name)
            ops = [self.vals[o] for o in node.operands]
            if node.kind is OpKind.ELEMENTWISE:
                self.emit(f"{v.var} = {self.elementwise(node, ops)}")
            elif node.kind is OpKind.BROADCAST and v.row and not ops[0].row:
                self.emit(f"{v.var} = {self.broadcast(node, ops[0], v)}")
            else:                   # the same elements in the same order
                v = _Val(ops[0].var, v.row, v.dims, v.dtype)
            self.vals[node.name] = v
        for name in outs:
            v = self.vals[name]
            val = f"{v.var}.to(tl.int8)" if v.dtype == "bool" else v.var
            if not v.row:
                self.emit(f"tl.store({out_arg[name]}, {val}, mask=pid == 0)")
            else:
                m = f", mask={mask}" if mask else ""
                self.emit(f"tl.store({out_arg[name]} + offs, {val}{m})")
        body = "\n".join(self.lines)
        src = (f"@triton.jit\ndef stitched_kernel({', '.join(params)}):\n"
               f"{body}\n")
        # the source leaves out N where no mask needs it: the digest keeps
        # each N's kernel (its launches, its check on the card) apart
        digest = hashlib.sha1(f"{n}\n{sig}\n{src}".encode()).hexdigest()[:16]
        header = (f"# generated stitched kernel {digest}: "
                  f"{len(p.compute_members)} ops, flat over {n} elements, "
                  f"block={self.block}, grid={self.grid}\n")
        return _Emitted(
            source=_HEADER + header + src, digest=digest, block_r=0,
            grid=self.grid, num_warps=self.num_warps, in_names=order,
            out_names=outs, out_dtypes=[str(g[n].dtype) for n in outs],
            layout="flat", block=self.block, view_outs=view_outs)

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

    def reduce_expr(self, node: OpNode, src: _Val) -> str:
        """The reduction over ``src``'s tile (its padded lanes neutral), in
        f32 for a float below f32, before the mean's division and the
        rounding to the node's dtype."""
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
            return x
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
        return expr

    def finish_reduction(self, node: OpNode, src: OpNode, expr: str) -> str:
        """A reduction's value from its folded sum, max or min: the mean's
        division, then the rounding to the node's dtype."""
        op = node.attrs.get("op", "sum")
        count = math.prod(src.shape[a] for a in node.attrs["axes"])
        if op == "mean" and count != 1:
            expr = f"({expr} / {float(count)})"
        dt = str(node.dtype)
        if dt not in ("float32", "float64") or not _is_float(str(src.dtype)):
            expr = f"({expr}).to({_TL_DTYPES[dt]})"
        return expr

    def reduction(self, node: OpNode, src: _Val, out: _Val) -> str:
        return self.finish_reduction(node, self.g[node.operands[0]],
                                     self.reduce_expr(node, src))


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
_VIEWS: dict[str, int] = {}          # view pattern digest -> calls
_VIEW_COPIES: dict[str, int] = {}    # view pattern digest -> outputs copied
_MODULES: dict[str, object] = {}     # kernel digest -> imported module
# one import at a time: a background plan compile may load the kernels it
# chose while the serving thread loads others, or the same digest
_MODULES_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    """Zero the launch, view and view-copy counts."""
    for counts in (_LAUNCHES, _VIEWS, _VIEW_COPIES):
        for k in counts:
            counts[k] = 0


def launch_counts() -> dict[str, int]:
    """Launches per generated kernel (by source digest) since the last
    :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def view_counts() -> dict[str, int]:
    """Calls per layout-only pattern served as views (by its digest) since
    the last :func:`reset_launch_counts`; none of them launches."""
    return dict(_VIEWS)


def view_copy_counts() -> dict[str, int]:
    """Outputs of those calls that ``reshape`` had to copy (an input whose
    strides admit no view), by digest."""
    return dict(_VIEW_COPIES)


def build_dir() -> Path:
    """Where generated kernels are written: ``build/stitched`` at the
    repository root."""
    return Path(__file__).resolve().parents[3] / "build" / "stitched"


def _load_module(em: _Emitted):
    mod = _MODULES.get(em.digest)
    if mod is not None:
        return mod
    with _MODULES_LOCK:
        mod = _MODULES.get(em.digest)
        if mod is None:
            d = build_dir()
            d.mkdir(parents=True, exist_ok=True)
            path = d / f"k_{em.digest}.py"
            if not path.exists() or path.read_text() != em.source:
                # written whole under a name of this process and thread,
                # then renamed: another process writing the same digest
                # never leaves a torn file
                tmp = path.with_suffix(
                    f".{os.getpid()}.{threading.get_ident()}.tmp")
                tmp.write_text(em.source)
                tmp.replace(path)
            spec = importlib.util.spec_from_file_location(
                f"stitched_{em.digest}", path)
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
        # outputs that are runs of an input's elements: views of it
        self._view_idx = [(p.external_outputs.index(o),
                           p.external_inputs.index(i), off)
                          for o, i, off in em.view_outs]
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

    def __call__(self, *inputs, count: bool = True) -> tuple:
        if not inputs or all(x.device.type == "cpu" for x in inputs):
            return self.plain(*inputs)
        return self.launch(*inputs, count=count)

    def load(self) -> None:
        """Write the kernel's source into :func:`build_dir` and import it,
        ahead of the first launch (a background plan compile does this for
        the kernels it chose); Triton still compiles at the first launch."""
        _load_module(self.emitted)

    def launch(self, *inputs, count: bool = True) -> tuple:
        """Launch the Triton kernel; ``count=False`` leaves the launch out of
        ``launches`` and :func:`launch_counts` (the tuner's timing runs)."""
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
        # the program-private scratch of values stored and reloaded at other
        # offsets: a kernel's own workspace, never read outside it
        scratch = [torch.empty(n, dtype=torch.int8 if dt == "bool"
                               else canonical_dtype(dt), device=device)
                   for n, dt in em.scratch]
        t0 = time.perf_counter() if self.build_seconds is None else None
        mod = _load_module(em)
        args = [prepared[i] for i in self._in_idx] + outs + scratch
        mod.stitched_kernel[(em.grid,)](*args, num_warps=em.num_warps)
        if t0 is not None:
            self.build_seconds = time.perf_counter() - t0
        if count:
            self.launches += 1
            _LAUNCHES[em.digest] = _LAUNCHES.get(em.digest, 0) + 1
        result: list = [None] * len(self.out_shapes)
        for o, k, dt in zip(outs, self._out_idx, em.out_dtypes):
            result[k] = o.view(torch.bool) if dt == "bool" else o
        for k, i, off in self._view_idx:
            shape = self.out_shapes[k]
            x = prepared[i].reshape(-1)[off:off + math.prod(shape)].view(shape)
            result[k] = x.view(torch.bool) if self.out_dtypes[k] == "bool" else x
        return tuple(result)


class StitchedView:
    """A pattern whose every output is a view of an input
    (:func:`view_outputs`) served with no kernel: each output is a run of
    its input's elements, in their order, at its offset, under the output's
    shape, so ``f(*external_inputs) -> tuple(outputs)`` gives it as a view
    of the input on any device, and nothing is built or launched.  Where an
    input's strides admit no view it is copied first, as the launch path's
    ``.contiguous()`` does; an output is contiguous, as a kernel's is; each
    copied output is counted (:func:`view_copy_counts`), each call too
    (:func:`view_counts`)."""

    def __init__(self, p: FusionPattern, views: dict[str, tuple[str, int]]):
        g = p.graph
        self.pattern = p
        self.out_shapes = [tuple(g[n].shape) for n in p.external_outputs]
        self.out_dtypes = [str(g[n].dtype) for n in p.external_outputs]
        self._dtypes = [canonical_dtype(d) for d in self.out_dtypes]
        ins = p.external_inputs
        # output j <- (external input index, element offset)
        self.runs = [views[o] for o in p.external_outputs]
        self._roots = [(ins.index(i), off) for i, off in self.runs]
        spec = ";".join(f"{g[ins[r]].shape}+{off}->{s}:{d}" for (r, off), s, d
                        in zip(self._roots, self.out_shapes, self.out_dtypes))
        self.digest = "view_" + hashlib.sha1(spec.encode()).hexdigest()[:11]
        _VIEWS.setdefault(self.digest, 0)
        _VIEW_COPIES.setdefault(self.digest, 0)

    def plain(self, *inputs) -> tuple:
        """The plain PyTorch version: the members evaluated eagerly."""
        return StitchedKernel.plain(self, *inputs)

    def __call__(self, *inputs, count: bool = True) -> tuple:
        outs, copies = [], 0
        for (r, off), shape, dt in zip(self._roots, self.out_shapes,
                                       self._dtypes):
            x = inputs[r]
            base = x.to(dt).contiguous()
            copies += base.data_ptr() != x.data_ptr()
            outs.append(base.reshape(-1)[off:off + math.prod(shape)].view(shape))
        if count:
            _VIEWS[self.digest] += 1
            _VIEW_COPIES[self.digest] += copies
        return tuple(outs)


def build_stitched_callable(p: FusionPattern, *, row_block: int | None = None):
    """Emit the fused kernel.  Returns ``f(*external_inputs) -> tuple(outputs)``
    (input/output order = ``p.external_inputs`` / ``p.external_outputs``):
    a :class:`StitchedView` when every output is a view of an input
    (:func:`view_outputs`), else a :class:`StitchedKernel` that stores the
    other outputs, in the flat layout where the pattern computes element by
    element.  A pattern :func:`emission_plan` refuses raises, views or not.

    A template's scratch-marked intermediates need no code of their own:
    every intermediate stays in registers, except what the emitter itself
    stores to scratch to load it at other offsets (:class:`_Emitter`)."""
    views = view_outputs(p)
    emit_p, ana, emitted = _emission(p, views)
    if len(views) == len(p.external_outputs):
        return StitchedView(p, views)
    rb = row_block or ana.feasible_blocks[0]
    if rb != ana.feasible_blocks[0]:
        emitted = _Emitter(emit_p, ana, rb, views).run()
    return StitchedKernel(p, ana, emitted)
