"""PyTorch -> StitchIR frontend.

``trace_to_graph(fn, *example_args)`` traces a PyTorch function with
``make_fx`` (functionalized, under the core-ATen decomposition table, on
fake tensors) and translates the ATen graph into a :class:`Graph`, so the
fusion planner runs on real model code.

Translation rules, chosen so the IR reads node for node like the
reference's translation of the same function written with ``jnp``:

* Elementwise operands broadcast as in ``jnp``: a tensor operand of lower
  rank (not a scalar) gets a BROADCAST to its rank-promoted shape (size-1
  dims in front, ``bcast_dims`` right-aligned), and size-1 dims then
  broadcast implicitly, with no node; mixed operand dtypes get explicit
  converts to the promoted dtype.  ``where``'s operands, like
  ``select_n``'s, are broadcast to the full shape.
* Python scalars become shape-``()`` CONSTANT nodes in the promoted dtype
  (the jaxpr's scalar literals), used without a broadcast; a scalar
  ``where`` operand is ``jnp.where``'s literal: a float64 CONSTANT, a
  convert and a BROADCAST.
* ``arange`` becomes the jaxpr's ``iota``: an executable CUSTOM node (and a
  ``mul`` / ``add`` by the step / start when they are not 1 / 0); ``full``
  of a non-scalar shape is a scalar CONSTANT and a BROADCAST; other ops
  with no tensor operand (``scalar_tensor``) are evaluated once at trace
  time into CONSTANT nodes.
* ``unsqueeze`` is ``jnp``'s ``x[..., None]``, a BROADCAST adding size-1
  dims; the unsqueezes of one indexing expression (consecutive in the ATen
  graph) become one BROADCAST, and an unsqueeze that only feeds an
  ``expand`` folds into it (``jnp.repeat``'s one ``broadcast_in_dim``).
* Inside the trace, ``torch.einsum`` of two operands and a matmul of an
  operand of rank >= 3 by a matrix run as ``repro_torch::dot_general``,
  which translates to one GEMM / BATCHED_GEMM node with ``jnp.einsum``'s
  operand order and dimension numbers and, when the output order differs,
  its TRANSPOSE; ``reciprocal(x) * c`` (ATen's ``c / x``) is ``div(c, x)``.
* ``_softmax`` / ``_log_softmax`` are spelled as ``jax.nn.softmax`` /
  ``log_softmax`` trace: a REDUCTION ``max``, its ``max`` with ``-inf``,
  a BROADCAST to the kept rank, the subtraction, ``exp``, a REDUCTION
  ``sum`` and its BROADCAST, then the division (the ``log`` and the
  subtraction); ``mean`` is spelled as the jaxpr of ``jnp.mean``: a
  REDUCTION ``sum``, a BROADCAST back to the kept rank when ``keepdim``,
  and a ``div`` by the count as a scalar literal.
* Nodes that a fold above leaves without a user are dropped.
* Any other op (``embedding``, ``index_put``, ``cat``, ``index``, ...)
  becomes an executable CUSTOM node whose closure calls the ATen op: it
  partitions fusion, like the paper's opaque ops, and the graph stays
  runnable end to end.  Multi-output ops get a shapeless base node plus
  ``.o{i}`` projections.
* The hand-written kernels' custom ops (``repro_torch::rmsnorm`` etc.) are
  CUSTOM nodes tagged ``attrs["kernel"]`` with the reference kernel body
  they port (:data:`repro_torch.kernels.ops.KERNEL_TAGS`), the name the
  planner's registry knows them by, so they fuse with their neighbours
  instead of partitioning the graph.  A multi-output kernel's ``.o{i}``
  projections carry the same tag, as in the reference.
"""

from __future__ import annotations

import math
import operator
from typing import Callable

import torch
import torch.fx as fx
from torch.utils import _pytree as pytree

from repro_torch.kernels.ops import KERNEL_TAGS

from .codegen import canonical_dtype as _torch_dtype, dtype_name, is_float
from .ir import Graph, OpKind, OpNode, itemsize

__all__ = ["trace_to_graph", "TraceError"]


class TraceError(Exception):
    pass


_UNARY = {
    "neg": "neg", "exp": "exp", "log": "log", "log1p": "log1p",
    "tanh": "tanh", "sqrt": "sqrt", "rsqrt": "rsqrt", "abs": "abs",
    "sign": "sign", "erf": "erf", "sigmoid": "sigmoid", "relu": "relu",
    "cos": "cos", "sin": "sin", "silu": "silu", "bitwise_not": "not",
    "logical_not": "not",
}

_BINARY = {
    "add": "add", "sub": "sub", "mul": "mul", "div": "div",
    "maximum": "max", "minimum": "min",
    "bitwise_and": "and", "bitwise_or": "or", "bitwise_xor": "xor",
    "logical_and": "and", "logical_or": "or", "logical_xor": "xor",
    "ge": "ge", "gt": "gt", "le": "le", "lt": "lt", "eq": "eq",
}

_REDUCE = {"sum": "sum", "amax": "max", "amin": "min", "prod": "prod"}

_IDENTITY = {"clone", "alias", "alias_copy", "lift_fresh_copy", "detach",
             "detach_copy", "contiguous"}

_RESHAPE = {"view", "view_copy", "_unsafe_view", "reshape", "squeeze",
            "squeeze_copy", "flatten", "_reshape_alias", "_reshape_alias_copy"}


def _decomp_table() -> dict:
    from torch._decomp import core_aten_decompositions
    return core_aten_decompositions()


# ---------------------------------------------------------------------------
# jnp's dots: one dot_general node per einsum / batched matmul
# ---------------------------------------------------------------------------

@torch.library.custom_op("repro_torch::dot_general", mutates_args=())
def dot_general_op(lhs: torch.Tensor, rhs: torch.Tensor, lc: list[int],
                   rc: list[int], lb: list[int],
                   rb: list[int]) -> torch.Tensor:
    """``lax.dot_general`` (output: batch dims, lhs free dims, rhs free
    dims); the tracer's stand-in for ``einsum`` and batched matmuls."""
    from .codegen import _dot_general
    return _dot_general(lhs, rhs, (tuple(lc), tuple(rc)),
                        (tuple(lb), tuple(rb)))


@dot_general_op.register_fake
def _(lhs, rhs, lc, rc, lb, rb):
    free_l = [d for i, d in enumerate(lhs.shape) if i not in lc and i not in lb]
    free_r = [d for i, d in enumerate(rhs.shape) if i not in rc and i not in rb]
    shape = [lhs.shape[i] for i in lb] + free_l + free_r
    return lhs.new_empty(shape, dtype=torch.promote_types(lhs.dtype, rhs.dtype))


def _einsum_as_dot(equation, *operands):
    """``jnp.einsum`` of two operands as its one ``dot_general`` (and the
    transpose to the output order): opt_einsum hands jax the pair in
    reverse, so the second operand is the lhs; the rhs-first order is
    taken when it needs no transpose.  None (the ATen decomposition then
    runs) for what jax spells otherwise: ellipses, repeated indices, an
    index summed on one side only, size-1 dims against full ones, or
    mixed dtypes."""
    if len(operands) != 2 or not isinstance(equation, str) \
            or "..." in equation or "->" not in equation:
        return None
    ins, out = equation.replace(" ", "").split("->")
    a, b = operands
    if ins.count(",") != 1 or a.dtype != b.dtype:
        return None
    an, bn = ins.split(",")
    if any(len(set(n)) != len(n) for n in (an, bn, out)):
        return None
    ln, rn = bn, an
    lhs, rhs = b, a
    contracted = sorted((set(ln) | set(rn)) - set(out))
    batch = [c for c in out if c in ln and c in rn]
    if any(c not in ln or c not in rn for c in contracted) or any(
            lhs.shape[ln.index(c)] != rhs.shape[rn.index(c)]
            for c in contracted + batch):
        return None
    lb = [ln.index(c) for c in batch]
    rb = [rn.index(c) for c in batch]
    lc = [ln.index(c) for c in contracted]
    rc = [rn.index(c) for c in contracted]
    gone = set(batch) | set(contracted)
    rest_l = "".join(c for c in ln if c not in gone)
    rest_r = "".join(c for c in rn if c not in gone)
    names = "".join(batch) + rest_r + rest_l
    if names == out:
        res = dot_general_op(rhs, lhs, rc, lc, rb, lb)
    else:
        names = "".join(batch) + rest_l + rest_r
        res = dot_general_op(lhs, rhs, lc, rc, lb, rb)
    if names != out:
        res = res.permute([names.index(c) for c in out])
    return res


_MATMULS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__)


class _JnpDots(torch.overrides.TorchFunctionMode):
    """Active while the tracer runs the function: ``einsum`` of two
    operands and ``x @ w`` with x of rank >= 3 and w a matrix go through
    ``repro_torch::dot_general``, so ``make_fx`` records one node where the
    ATen decomposition would record permutes, reshapes and ``bmm``/``mm``."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.einsum and not kwargs:
            out = _einsum_as_dot(*args)
            if out is not None:
                return out
        elif func in _MATMULS and not kwargs and len(args) == 2:
            a, b = args
            if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) \
                    and a.dim() >= 3 and b.dim() == 2 and a.dtype == b.dtype:
                return dot_general_op(a, b, [a.dim() - 1], [0], [], [])
        return func(*args, **kwargs)


class _Slot:
    """Placeholder for the i-th tensor operand inside a CUSTOM node's
    saved ATen arguments."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


def _params_sig(args, kwargs) -> str:
    """Deterministic spelling of an op's non-tensor arguments (the identity
    of an opaque op, invariant to node naming)."""
    def spell(v) -> str:
        if isinstance(v, _Slot):
            return "T"
        if isinstance(v, (bool, int, float, str, type(None))):
            return repr(v)
        if isinstance(v, (tuple, list)):
            return "(" + ",".join(spell(x) for x in v) + ")"
        if isinstance(v, dict):
            return "{" + ",".join(f"{k}={spell(v[k])}" for k in sorted(v)) + "}"
        return type(v).__name__
    return spell(args) + spell(kwargs)


def _meta(node: fx.Node):
    val = node.meta.get("val")
    if val is None:
        val = node.meta.get("tensor_meta")
    return val


def trace_to_graph(fn: Callable, *example_args, name: str = "traced",
                   return_outputs: bool = False):
    """Returns (graph, input_names) where input_names[i] is the PARAMETER
    node for the i-th tensor leaf of ``example_args`` (pytree order).
    ``fn`` must return a pytree of tensors.  With ``return_outputs`` also
    returns the IR name of every output leaf (repeats kept) and the output
    pytree spec: (graph, input_names, output_names, out_spec)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    leaves, in_spec = pytree.tree_flatten(example_args)
    for leaf in leaves:
        if not isinstance(leaf, torch.Tensor):
            raise TraceError(f"non-tensor argument leaf {type(leaf).__name__}"
                             f" (pass it as a static argument)")

    out_spec = []

    def flat_fn(*flat):
        with _JnpDots():
            out = fn(*pytree.tree_unflatten(list(flat), in_spec))
        leaves_out, spec = pytree.tree_flatten(out)
        out_spec.append(spec)
        return leaves_out

    gm = make_fx(torch.func.functionalize(flat_fn, remove="mutations_and_views"),
                 decomposition_table=_decomp_table(),
                 tracing_mode="fake")(*leaves)
    gm.graph.eliminate_dead_code()
    tr = _Translator(gm, name)
    g = _drop_unused(tr.run())
    _fold_widening_converts(g)
    g.validate()
    names = [f"arg{i}" for i in range(len(leaves))]
    if return_outputs:
        return g, names, tr.outputs, out_spec[-1]
    return g, names


class _Translator:
    def __init__(self, gm: fx.GraphModule, name: str):
        self.gm = gm
        self.g = Graph(name)
        self.env: dict[fx.Node, str] = {}
        self.ctr = 0
        self.outputs: list[str] = []
        self._unsq: set[str] = set()          # BROADCASTs made by unsqueeze
        self._last: fx.Node | None = None     # the last op that is no alias

    # -- helpers ---------------------------------------------------------------
    def fresh(self, stem: str) -> str:
        self.ctr += 1
        return f"{stem}_{self.ctr}"

    def add(self, stem: str, kind: OpKind, shape, dtype: str, operands=(),
            attrs=None) -> str:
        nm = self.fresh(stem)
        self.g.add(OpNode(nm, kind, tuple(int(d) for d in shape), dtype,
                          tuple(operands), dict(attrs or {})))
        return nm

    def const(self, value: torch.Tensor, stem: str = "const") -> str:
        value = value.detach()
        return self.add(stem, OpKind.CONSTANT, tuple(value.shape),
                        dtype_name(value.dtype), (), {"value": value})

    def bcast_to(self, name: str, shape) -> str:
        src = self.g[name]
        shape = tuple(int(d) for d in shape)
        if src.shape == shape:
            return name
        n, r = len(shape), len(src.shape)
        dims = tuple(range(n - r, n))
        return self.add("bcast", OpKind.BROADCAST, shape, src.dtype, (name,),
                        {"bcast_dims": dims})

    def promote_rank(self, name: str, rank: int) -> str:
        """``jnp``'s rank promotion of an elementwise operand: a tensor of
        lower rank (not a scalar) is broadcast to ``(1, ..., 1) + shape``;
        its size-1 dims then broadcast implicitly."""
        src = self.g[name]
        r = len(src.shape)
        if r == 0 or r >= rank:
            return name
        return self.add("bcast", OpKind.BROADCAST,
                        (1,) * (rank - r) + tuple(src.shape), src.dtype,
                        (name,), {"bcast_dims": tuple(range(rank - r, rank))})

    def convert(self, name: str, dtype: str) -> str:
        src = self.g[name]
        if src.dtype == dtype:
            return name
        return self.add("convert", OpKind.ELEMENTWISE, src.shape, dtype,
                        (name,), {"op": "convert"})

    def reshape(self, name: str, shape) -> str:
        if self.g[name].shape == tuple(shape):
            return name
        return self.add("reshape", OpKind.RESHAPE, shape, self.g[name].dtype,
                        (name,))

    # -- elementwise with implicit broadcasting / promotion ---------------------
    def ew(self, op: str, args, shape, dtype: str, promote=None) -> str:
        """``args``: fx Nodes or Python scalars.  Tensor operands are
        converted to ``promote`` (default: the promoted dtype of all
        operands) and broadcast to ``shape``; scalars become shape-()
        constants of the promoted dtype."""
        if promote is None:
            promote = dtype_name(torch.result_type(*[
                _meta(a) if isinstance(a, fx.Node) else a for a in args]))
        names = []
        for a in args:
            if isinstance(a, fx.Node):
                nm = self.convert(self.env[a], promote)
                names.append(self.promote_rank(nm, len(shape)))
            else:
                names.append(self.const(torch.tensor(
                    a, dtype=_torch_dtype(promote)), "lit"))
        return self.add(op, OpKind.ELEMENTWISE, shape, dtype, names,
                        {"op": op})

    # -- main loop ---------------------------------------------------------------
    def run(self) -> Graph:
        n_in = 0
        outputs = self.outputs
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                v = _meta(node)
                nm = f"arg{n_in}"
                n_in += 1
                self.g.add(OpNode(nm, OpKind.PARAMETER, tuple(v.shape),
                                  dtype_name(v.dtype)))
                self.env[node] = nm
            elif node.op == "get_attr":
                self.env[node] = self.const(getattr(self.gm, node.target))
            elif node.op == "call_function":
                self.env[node] = self.call(node)
                if getattr(node.target, "__name__", "").split(".")[0] \
                        not in _IDENTITY:
                    self._last = node
            elif node.op == "output":
                for a in pytree.tree_flatten(node.args[0])[0]:
                    if not isinstance(a, fx.Node):
                        raise TraceError("non-tensor output")
                    outputs.append(self.env[a])
            else:
                raise TraceError(f"unsupported fx node {node.op}")
        self.g.mark_output(*outputs)
        return self.g

    def call(self, node: fx.Node) -> str:
        target = node.target
        if target is operator.getitem:
            base, idx = node.args
            return f"{self.env[base]}.o{idx}"
        has_tensor = []
        fx.node.map_arg((node.args, node.kwargs), has_tensor.append)
        if not has_tensor:
            return self.factory(node)
        tag = KERNEL_TAGS.get(target)
        if tag is not None:
            return self.custom(node, kernel=tag)
        packet = getattr(target, "__name__", str(target)).split(".")[0]
        handler = getattr(self, f"op_{packet}", None)
        if handler is not None:
            out = handler(node)
            if out is not None:
                return out
        if packet in _UNARY:
            v = _meta(node)
            x = node.args[0]
            return self.ew(_UNARY[packet], [x], v.shape, dtype_name(v.dtype),
                           promote=dtype_name(_meta(x).dtype)
                           if packet in ("logical_not", "bitwise_not")
                           else dtype_name(v.dtype))
        if packet in _BINARY and len(node.args) == 2 and not node.kwargs:
            v = _meta(node)
            return self.ew(_BINARY[packet], list(node.args), v.shape,
                           dtype_name(v.dtype))
        if packet in _IDENTITY:
            return self.env[node.args[0]]
        if packet in _RESHAPE:
            return self.reshape(self.env[node.args[0]], _meta(node).shape)
        if packet in _REDUCE:
            return self.reduction(node, _REDUCE[packet])
        return self.custom(node)

    # -- ops with no tensor operand ---------------------------------------------
    def factory(self, node):
        """``arange`` as ``iota``, a non-scalar ``full`` as a broadcast
        literal; any other factory op's value is fixed at trace time."""
        packet = getattr(node.target, "__name__", "").split(".")[0]
        v = _meta(node)
        dt = dtype_name(v.dtype)
        if packet == "arange" and v.dim() == 1:
            args = node.args
            start, step = (0, 1) if len(args) == 1 else (
                args[0], args[2] if len(args) > 2 else 1)
            n = int(v.shape[0])
            dev = node.kwargs.get("device")

            def run(_n=n, _dt=v.dtype, _dev=dev):
                return torch.arange(_n, dtype=_dt, device=_dev)
            out = self.add("iota", OpKind.CUSTOM, (n,), dt, (),
                           {"prim": "iota", "params_sig": f"({n},{dt!r})",
                            "eval_fn": run})
            if step != 1:
                step = self.const(torch.tensor(step, dtype=v.dtype), "lit")
                out = self.add("mul", OpKind.ELEMENTWISE, (n,), dt,
                               (out, step), {"op": "mul"})
            if start != 0:
                start = self.const(torch.tensor(start, dtype=v.dtype), "lit")
                out = self.add("add", OpKind.ELEMENTWISE, (n,), dt,
                               (start, out), {"op": "add"})
            return out
        if packet == "full" and v.dim():
            lit = self.const(torch.tensor(node.args[1], dtype=v.dtype), "lit")
            return self.add("bcast", OpKind.BROADCAST, v.shape, dt, (lit,),
                            {"bcast_dims": ()})
        return self.const(node.target(*node.args, **node.kwargs))

    # -- op handlers (return None to fall through to the generic rules) ---------
    def op_add(self, node):
        return self._alpha(node, "add")

    def op_sub(self, node):
        return self._alpha(node, "sub")

    def _alpha(self, node, op):
        """``a op alpha * b``; None (the generic rule) when alpha is 1."""
        alpha = node.kwargs.get("alpha", 1)
        if alpha == 1:
            return None
        a, b = node.args
        scaled = self.ew("mul", [b, alpha], _meta(b).shape,
                         dtype_name(torch.result_type(_meta(b), alpha)))
        return self._ew_names(op, [self.env[a], scaled], _meta(node))

    def _ew_names(self, op, names, v):
        dt = dtype_name(v.dtype)
        names = [self.promote_rank(self.convert(n, dt), len(v.shape))
                 for n in names]
        return self.add(op, OpKind.ELEMENTWISE, v.shape, dt, names, {"op": op})

    def op_div(self, node):
        if node.kwargs.get("rounding_mode") is not None:
            return self.custom(node)
        return None

    def op_ne(self, node):
        v = _meta(node)
        eq = self.ew("eq", list(node.args), v.shape, "bool")
        return self.add("not", OpKind.ELEMENTWISE, v.shape, "bool", (eq,),
                        {"op": "not"})

    def op_mul(self, node):
        """``c / x`` decomposes to ``reciprocal(x) * c``: spelled as the
        jaxpr's ``div(c, x)`` (the reciprocal is then dropped)."""
        a, b = (list(node.args) + [None])[:2]
        if isinstance(a, fx.Node) and not isinstance(b, fx.Node) \
                and isinstance(b, (int, float)) and not isinstance(b, bool) \
                and a.op == "call_function" \
                and getattr(a.target, "__name__", "") == "reciprocal.default" \
                and len(a.users) == 1:
            v = _meta(node)
            return self.ew("div", [b, a.args[0]], v.shape, dtype_name(v.dtype))
        return None

    def op_reciprocal(self, node):
        v = _meta(node)
        return self.ew("div", [1.0, node.args[0]], v.shape, dtype_name(v.dtype))

    def op_pow(self, node):
        v = _meta(node)
        x, y = node.args
        dt = dtype_name(v.dtype)
        if isinstance(y, (int, float)) and float(y).is_integer() \
                and isinstance(x, fx.Node):
            xi = self.convert(self.env[x], dt)
            if int(y) == 2:
                return self.add("square", OpKind.ELEMENTWISE, v.shape, dt,
                                (xi,), {"op": "square"})
            return self.add("ipow", OpKind.ELEMENTWISE, v.shape, dt, (xi,),
                            {"op": "integer_pow", "y": int(y)})
        return self.ew("pow", [x, y], v.shape, dt)

    def op_where(self, node):
        if len(node.args) != 3:
            return self.custom(node)
        v = _meta(node)
        c, a, b = node.args
        dt = dtype_name(v.dtype)
        cond = self.bcast_to(self.env[c], v.shape) if isinstance(c, fx.Node) \
            else self.const(torch.tensor(bool(c)))
        ops = [cond]
        for x in (a, b):
            if isinstance(x, fx.Node) and getattr(
                    x.target, "__name__", "") == "scalar_tensor.default":
                x = x.args[0]
            if isinstance(x, fx.Node):
                ops.append(self.bcast_to(self.convert(self.env[x], dt), v.shape))
            elif isinstance(x, float) and v.dtype.is_floating_point:
                # jnp.where's Python float: a float64 literal, converted
                lit = self.const(torch.tensor(x, dtype=torch.float64), "lit")
                ops.append(self.bcast_to(self.convert(lit, dt), v.shape))
            else:
                ops.append(self.bcast_to(self.const(
                    torch.tensor(x, dtype=v.dtype), "lit"), v.shape))
        return self.add("select", OpKind.ELEMENTWISE, v.shape, dt, ops,
                        {"op": "select"})

    def op_clamp(self, node):
        """``clamp`` with one scalar bound, what ``clamp_min`` and
        ``clamp_max`` decompose to: a ``max`` (``min``) node against a
        scalar literal, as ``jnp.maximum(x, 0.0)`` traces.  Any other clamp
        falls through to a CUSTOM node."""
        x, lo, hi = (list(node.args) + [None, None])[:3]
        lo = node.kwargs.get("min", lo)
        hi = node.kwargs.get("max", hi)
        bound = lo if hi is None else hi
        if (lo is None) == (hi is None) or isinstance(bound, bool) \
                or not isinstance(bound, (int, float)):
            return None
        v = _meta(node)
        return self.ew("max" if hi is None else "min", [x, bound], v.shape,
                       dtype_name(v.dtype))

    def op_gelu(self, node):
        if node.kwargs.get("approximate", "none") != "tanh":
            return self.custom(node)
        v = _meta(node)
        # one operand: no promotion to work out (result_type needs two)
        return self.ew("gelu", [node.args[0]], v.shape, dtype_name(v.dtype),
                       promote=dtype_name(v.dtype))

    def op__to_copy(self, node):
        v = _meta(node)
        src = _meta(node.args[0])
        if src.device != v.device:
            return self.custom(node)
        return self.convert(self.env[node.args[0]], dtype_name(v.dtype))

    def op_expand(self, node):
        """An expand of an unsqueeze that feeds only it is one BROADCAST
        from the unsqueeze's operand (``jnp.repeat``'s ``broadcast_in_dim``)."""
        src, base, dims = self._unsqueezed(node.args[0])
        shape = tuple(int(d) for d in _meta(node).shape)
        if base is not None:
            lead = len(shape) - len(_meta(src).shape)   # new leading dims
            return self.add("bcast", OpKind.BROADCAST, shape,
                            self.g[base].dtype, (base,),
                            {"bcast_dims": tuple(d + lead for d in dims)})
        return self.bcast_to(self.env[node.args[0]], shape)

    op_expand_copy = op_expand

    def _unsqueezed(self, arg):
        """(the fx node, the IR operand, its ``bcast_dims``) when ``arg`` is
        an unsqueeze BROADCAST (through clones) whose only user leads here;
        else (arg, None, None)."""
        x = arg
        while isinstance(x, fx.Node) and x.op == "call_function" \
                and getattr(x.target, "__name__", "").split(".")[0] \
                in _IDENTITY and len(x.users) == 1:
            x = x.args[0]
        nm = self.env.get(x) if isinstance(x, fx.Node) else None
        if nm is None or nm not in self._unsq or len(x.users) != 1:
            return arg, None, None
        base = self.g[nm].operands[0]
        return x, base, tuple(self.g[nm].attrs["bcast_dims"])

    def op_unsqueeze(self, node):
        """``x[..., None]``: a BROADCAST adding a size-1 dim.  An unsqueeze
        of the unsqueeze just before it in the graph (one indexing
        expression, ``x[:, None, :, None]``) extends that BROADCAST."""
        shape = tuple(int(d) for d in _meta(node).shape)
        dim = int(node.args[1]) % len(shape)
        prev, base, dims = self._unsqueezed(node.args[0])
        if base is not None and self._last is prev:
            src = self.g[base]
        else:
            base = self.env[node.args[0]]
            src = self.g[base]
            dims = tuple(range(len(src.shape)))
        # the new dim shifts every operand dim at or after it
        dims = tuple(d + 1 if d >= dim else d for d in dims)
        nm = self.add("bcast", OpKind.BROADCAST, shape, src.dtype, (base,),
                      {"bcast_dims": dims})
        self._unsq.add(nm)
        return nm

    op_unsqueeze_copy = op_unsqueeze

    def op_permute(self, node):
        x = self.env[node.args[0]]
        rank = len(self.g[x].shape)
        perm = tuple(int(d) % rank for d in node.args[1])
        return self._transpose(x, perm, _meta(node).shape)

    op_permute_copy = op_permute

    def op_transpose(self, node):
        x = self.env[node.args[0]]
        rank = len(self.g[x].shape)
        d0, d1 = (int(d) % rank for d in node.args[1:3])
        perm = list(range(rank))
        perm[d0], perm[d1] = perm[d1], perm[d0]
        return self._transpose(x, tuple(perm), _meta(node).shape)

    op_transpose_copy = op_transpose

    def op_t(self, node):
        x = self.env[node.args[0]]
        rank = len(self.g[x].shape)
        perm = (1, 0) if rank == 2 else tuple(range(rank))
        return self._transpose(x, perm, _meta(node).shape)

    op_t_copy = op_t

    def _transpose(self, x, perm, shape):
        if perm == tuple(range(len(perm))):
            return x
        return self.add("transpose", OpKind.TRANSPOSE, shape, self.g[x].dtype,
                        (x,), {"perm": perm})

    def op_slice(self, node):
        x = self.env[node.args[0]]
        shp = self.g[x].shape
        dim = int(node.args[1]) % len(shp) if len(node.args) > 1 else 0
        start = node.args[2] if len(node.args) > 2 else None
        end = node.args[3] if len(node.args) > 3 else None
        step = int(node.args[4]) if len(node.args) > 4 else 1
        start, end, _ = slice(start, end, step).indices(shp[dim])
        starts = [0] * len(shp)
        limits = list(shp)
        starts[dim], limits[dim] = start, max(start, end)
        strides = None
        if step != 1:
            strides = [1] * len(shp)
            strides[dim] = step
            strides = tuple(strides)
        return self.add("slice", OpKind.SLICE, _meta(node).shape,
                        self.g[x].dtype, (x,),
                        {"starts": tuple(starts), "limits": tuple(limits),
                         "strides": strides})

    op_slice_copy = op_slice

    def op_select(self, node):
        # static integer indexing: slice + squeeze, as the jaxpr spells it
        x = self.env[node.args[0]]
        shp = self.g[x].shape
        dim = int(node.args[1]) % len(shp)
        idx = int(node.args[2]) % shp[dim]
        starts = [0] * len(shp)
        limits = list(shp)
        starts[dim], limits[dim] = idx, idx + 1
        sl_shape = list(shp)
        sl_shape[dim] = 1
        sl = self.add("slice", OpKind.SLICE, sl_shape, self.g[x].dtype, (x,),
                      {"starts": tuple(starts), "limits": tuple(limits),
                       "strides": None})
        return self.reshape(sl, _meta(node).shape)

    op_select_copy = op_select

    def reduction(self, node, op: str, keepdim: bool | None = None):
        """A REDUCTION over the node's dims, as ``jnp``'s reductions trace:
        the reduced value without kept dims and, where dims are kept, a
        BROADCAST back to the kept rank.  ``keepdim`` overrides the node's
        own."""
        x = node.args[0]
        xm = _meta(x)
        rank = xm.dim()
        dims = node.args[1] if len(node.args) > 1 else node.kwargs.get("dim")
        if isinstance(dims, int):
            dims = [dims]
        if not dims:
            dims = list(range(rank))
        if keepdim is None:
            keepdim = bool(node.args[2] if len(node.args) > 2
                           else node.kwargs.get("keepdim", False))
        if node.kwargs.get("dtype") is not None:
            return self.custom(node)
        v = _meta(node)
        dt = dtype_name(v.dtype)
        axes = tuple(sorted(int(d) % rank for d in dims)) if rank else ()
        shape = tuple(d for i, d in enumerate(xm.shape) if i not in axes)
        out = self._reduce(op, self.env[x], axes, False, shape, dt)
        if keepdim and axes:
            kshape = tuple(1 if i in axes else d
                           for i, d in enumerate(xm.shape))
            kept = tuple(i for i in range(rank) if i not in axes)
            out = self.add("bcast", OpKind.BROADCAST, kshape, dt, (out,),
                           {"bcast_dims": kept})
        return out

    def op_mean(self, node):
        """``sum`` over the axes without keepdims, a broadcast to the kept
        shape, and a division by the count (a literal in the result's
        dtype), as ``jnp.mean`` traces.  A mean with a ``dtype`` argument
        stays one CUSTOM node running the mean itself."""
        v = _meta(node)
        total = self.reduction(node, "sum", keepdim=False)
        if self.g[total].kind is not OpKind.REDUCTION:
            return total
        axes = self.g[total].attrs["axes"]
        in_shape = self.g[self.env[node.args[0]]].shape
        dt = dtype_name(v.dtype)
        out = total
        if tuple(v.shape) != self.g[total].shape:
            kept = tuple(i for i in range(len(in_shape)) if i not in axes)
            out = self.add("bcast", OpKind.BROADCAST, v.shape, dt, (total,),
                           {"bcast_dims": kept})
        count = math.prod(in_shape[a] for a in axes)
        lit = self.const(torch.tensor(float(count), dtype=v.dtype), "lit")
        return self.add("div", OpKind.ELEMENTWISE, v.shape, dt, (out, lit),
                        {"op": "div"})

    def _reduce(self, op, x, axes, keepdims, shape, dtype):
        return self.add(f"reduce_{op}", OpKind.REDUCTION, shape, dtype, (x,),
                        {"op": op, "axes": axes,
                         "in_rank": len(self.g[x].shape),
                         "keepdims": keepdims})

    def op__softmax(self, node, log: bool = False):
        """``jax.nn.softmax`` (``log_softmax``) as it traces: the row max
        without kept dims and its ``max`` with ``-inf``, a BROADCAST to the
        kept rank, ``x - max`` (an implicit size-1 broadcast), ``exp``, the
        sum and its BROADCAST, then the division (``log`` of the sum and
        the subtraction)."""
        x, dim = node.args[0], int(node.args[1])
        v = _meta(node)
        dt = dtype_name(v.dtype)
        xs = self.convert(self.env[x], dt)
        shape = tuple(v.shape)
        rank = len(shape)
        axis = dim % rank
        kept = tuple(i for i in range(rank) if i != axis)
        rshape = tuple(shape[i] for i in kept)
        kshape = tuple(1 if i == axis else d for i, d in enumerate(shape))

        def keep(name):
            return self.add("bcast", OpKind.BROADCAST, kshape, dt, (name,),
                            {"bcast_dims": kept})
        m = self._reduce("max", xs, (axis,), False, rshape, dt)
        ninf = self.const(torch.tensor(-math.inf, dtype=v.dtype), "lit")
        m = self.add("max", OpKind.ELEMENTWISE, rshape, dt, (ninf, m),
                     {"op": "max"})
        z = self.add("sub", OpKind.ELEMENTWISE, shape, dt, (xs, keep(m)),
                     {"op": "sub"})
        e = self.add("exp", OpKind.ELEMENTWISE, shape, dt, (z,), {"op": "exp"})
        s = keep(self._reduce("sum", e, (axis,), False, rshape, dt))
        if log:
            ls = self.add("log", OpKind.ELEMENTWISE, kshape, dt, (s,),
                          {"op": "log"})
            return self.add("sub", OpKind.ELEMENTWISE, shape, dt, (z, ls),
                            {"op": "sub"})
        return self.add("div", OpKind.ELEMENTWISE, shape, dt, (e, s),
                        {"op": "div"})

    def op__log_softmax(self, node):
        return self.op__softmax(node, log=True)

    def op_mm(self, node):
        return self._dot(node, ((1,), (0,)), ((), ()), OpKind.GEMM)

    def op_dot_general(self, node):
        _, _, lc, rc, lb, rb = node.args
        return self._dot(node, (tuple(lc), tuple(rc)), (tuple(lb), tuple(rb)),
                         OpKind.BATCHED_GEMM if lb else OpKind.GEMM)

    def op_bmm(self, node):
        return self._dot(node, ((2,), (1,)), ((0,), (0,)), OpKind.BATCHED_GEMM)

    def _dot(self, node, contract, batch, kind, args=None):
        a, b = args or node.args[:2]
        v = _meta(node)
        dt = dtype_name(v.dtype)
        la = self.convert(self.env[a], dt)
        lb = self.convert(self.env[b], dt)
        shape = tuple(v.shape)
        return self.add("dot", kind, shape, dt, (la, lb),
                        {"contract": contract, "batch": batch,
                         "preferred": None})

    def op_gather(self, node):
        """``jnp.take_along_axis``'s gather: the index reshaped to end in an
        index-vector dim of 1, then the gather (a CUSTOM node that drops
        that dim and calls ``torch.gather``)."""
        x, dim, idx = node.args[:3]
        if node.kwargs or len(node.args) > 3:
            return None
        ishape = tuple(_meta(idx).shape)
        vec = self.reshape(self.env[idx], ishape + (1,))
        d = int(dim)

        def run(t, i, _d=d):
            return torch.gather(t, _d, i.reshape(i.shape[:-1]))
        v = _meta(node)
        return self.add("custom_gather", OpKind.CUSTOM, tuple(v.shape),
                        dtype_name(v.dtype), (self.env[x], vec),
                        {"prim": str(node.target),
                         "params_sig": _params_sig((_Slot(0), d, _Slot(1)),
                                                   {}),
                         "eval_fn": run})

    def op_addmm(self, node):
        if node.kwargs.get("beta", 1) != 1 or node.kwargs.get("alpha", 1) != 1:
            return self.custom(node)
        bias, a, b = node.args[:3]
        v = _meta(node)
        d = self._dot(node, ((1,), (0,)), ((), ()), OpKind.GEMM, args=(a, b))
        return self._ew_names("add", [d, self.env[bias]], v)

    # -- opaque but executable -----------------------------------------------------
    def custom(self, node: fx.Node, kernel: str | None = None) -> str:
        tensors: list[fx.Node] = []

        def slot(n: fx.Node):
            tensors.append(n)
            return _Slot(len(tensors) - 1)

        template = fx.node.map_arg((node.args, node.kwargs), slot)
        target = node.target

        def run(*vals, _t=target, _tmpl=template):
            args, kwargs = pytree.tree_map(
                lambda s: vals[s.i] if isinstance(s, _Slot) else s, _tmpl,
                is_leaf=lambda s: isinstance(s, _Slot))
            return _t(*args, **kwargs)

        operands = [self.env[t] for t in tensors]
        prim = str(target)
        attrs = {"prim": prim, "params_sig": _params_sig(*template),
                 "eval_fn": run}
        if kernel is not None:
            attrs["kernel"] = kernel
        stem = "custom_" + prim.split(".")[1] if prim.startswith("aten.") \
            else "custom"
        v = _meta(node)
        if isinstance(v, (tuple, list)):
            base = self.add(stem, OpKind.CUSTOM, (), "float32", operands,
                            {**attrs, "multi": True})
            for i, o in enumerate(v):
                if not isinstance(o, torch.Tensor):
                    continue
                proj = {"prim": prim, "project": i}
                if kernel is not None:
                    # the projections carry the base's tag, so the registry
                    # admits them as the reference's do
                    proj["kernel"] = kernel
                self.g.add(OpNode(f"{base}.o{i}", OpKind.CUSTOM,
                                  tuple(o.shape), dtype_name(o.dtype),
                                  (base,), proj))
            return base
        return self.add(stem, OpKind.CUSTOM, tuple(v.shape),
                        dtype_name(v.dtype), operands, attrs)


def _drop_unused(g: Graph) -> Graph:
    """``g`` without the nodes no output depends on (the ones a fold left
    behind); a multi-output node's projections are kept while their base
    is, as the reference keeps every ``.o{i}``."""
    live: set[str] = set()
    stack = list(g.outputs)
    while stack:
        n = stack.pop()
        if n in live:
            continue
        live.add(n)
        stack.extend(g[n].operands)
    for n in list(live):
        if g[n].attrs.get("multi"):
            live.update(u for u in g.users(n))
    live.update(n for n, node in g.nodes.items()
                if node.kind is OpKind.PARAMETER)
    if len(live) == len(g.nodes):
        return g
    out = Graph(g.name)
    for n, node in g.nodes.items():
        if n in live:
            out.add(node)
    out.mark_output(*g.outputs)
    return out


def _fold_widening_converts(g: Graph) -> None:
    """Mirror the ``convert_f32(dot_bf16) -> dot_f32`` simplification.

    A dot whose value is consumed only by converts to a *wider* float type
    never materializes the narrow intermediate: its declared dtype is
    widened here (the converts become value-preserving no-ops), so every
    executor computes the dot at the wide type and rounds once.  Dots that
    are graph outputs keep their spelled dtype."""
    for node in g.nodes.values():
        if node.kind not in (OpKind.GEMM, OpKind.BATCHED_GEMM):
            continue
        if node.name in g.outputs or not is_float(node.dtype):
            continue
        pref = node.attrs.get("preferred")
        if pref is not None and itemsize(pref) > itemsize(node.dtype):
            continue
        users = g.users(node.name)
        if not users:
            continue
        widths = []
        for u in users:
            un = g[u]
            if (un.kind is not OpKind.ELEMENTWISE
                    or un.attrs.get("op") != "convert"
                    or not is_float(un.dtype)
                    or itemsize(un.dtype) <= itemsize(node.dtype)):
                break
            widths.append(un.dtype)
        else:
            wide = max(widths, key=itemsize)
            node.dtype = wide
            node.attrs["preferred"] = wide

