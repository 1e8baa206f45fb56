"""PyTorch -> StitchIR frontend.

``trace_to_graph(fn, *example_args)`` traces a PyTorch function with
``make_fx`` (functionalized, under the core-ATen decomposition table, on
fake tensors) and translates the ATen graph into a :class:`Graph`, so the
fusion planner runs on real model code.

Translation rules, chosen so the IR reads like the reference's jaxpr
translation:

* ATen elementwise ops broadcast implicitly; the jaxpr always spells
  ``broadcast_in_dim``.  Every tensor operand whose shape differs from the
  result gets an explicit BROADCAST node with right-aligned ``bcast_dims``,
  and mixed operand dtypes get explicit converts to the promoted dtype.
* Python scalars become shape-``()`` CONSTANT nodes in the promoted dtype
  (the jaxpr's scalar literals), used without a broadcast.
* Ops with no tensor operand (``arange``, ``full``, ``scalar_tensor``) are
  evaluated once at trace time into CONSTANT nodes.
* ``_softmax`` / ``_log_softmax`` are spelled out as reductions and
  elementwise ops (the planner must see them); ``mean`` is spelled as the
  jaxpr of ``jnp.mean``: a REDUCTION ``sum``, a BROADCAST back to the kept
  rank when ``keepdim``, and a ``div`` by the count as a scalar literal.
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

_RESHAPE = {"view", "view_copy", "_unsafe_view", "reshape", "unsqueeze",
            "unsqueeze_copy", "squeeze", "squeeze_copy", "flatten",
            "_reshape_alias", "_reshape_alias_copy"}


def _decomp_table() -> dict:
    from torch._decomp import core_aten_decompositions
    return core_aten_decompositions()


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
        out = fn(*pytree.tree_unflatten(list(flat), in_spec))
        leaves_out, spec = pytree.tree_flatten(out)
        out_spec.append(spec)
        return leaves_out

    gm = make_fx(torch.func.functionalize(flat_fn, remove="mutations_and_views"),
                 decomposition_table=_decomp_table(),
                 tracing_mode="fake")(*leaves)
    gm.graph.eliminate_dead_code()
    tr = _Translator(gm, name)
    g = tr.run()
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
                names.append(self.bcast_to(nm, shape))
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
            # factory op (arange, full, scalar_tensor): value fixed at trace
            return self.const(target(*node.args, **node.kwargs))
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
        names = [self.bcast_to(self.convert(n, dt), v.shape) for n in names]
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
            if isinstance(x, fx.Node):
                ops.append(self.bcast_to(self.convert(self.env[x], dt), v.shape))
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
        return self.bcast_to(self.env[node.args[0]], _meta(node).shape)

    op_expand_copy = op_expand

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
        """A REDUCTION over the node's dims; ``keepdim`` overrides the
        node's own (the result's shape follows it)."""
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
        axes = tuple(sorted(int(d) % rank for d in dims)) if rank else ()
        shape = tuple(1 if i in axes else d for i, d in enumerate(xm.shape)) \
            if keepdim else tuple(d for i, d in enumerate(xm.shape)
                                  if i not in axes)
        return self._reduce(op, self.env[x], axes, keepdim, shape,
                            dtype_name(v.dtype))

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
        x, dim = node.args[0], int(node.args[1])
        v = _meta(node)
        dt = dtype_name(v.dtype)
        xs = self.convert(self.env[x], dt)
        shape = tuple(v.shape)
        rank = len(shape)
        axis = dim % rank
        kshape = tuple(1 if i == axis else d for i, d in enumerate(shape))
        m = self._reduce("max", xs, (axis,), True, kshape, dt)
        mb = self.bcast_to(m, shape)
        z = self.add("sub", OpKind.ELEMENTWISE, shape, dt, (xs, mb),
                     {"op": "sub"})
        e = self.add("exp", OpKind.ELEMENTWISE, shape, dt, (z,), {"op": "exp"})
        s = self._reduce("sum", e, (axis,), True, kshape, dt)
        if log:
            ls = self.add("log", OpKind.ELEMENTWISE, kshape, dt, (s,),
                          {"op": "log"})
            return self.add("sub", OpKind.ELEMENTWISE, shape, dt,
                            (z, self.bcast_to(ls, shape)), {"op": "sub"})
        return self.add("div", OpKind.ELEMENTWISE, shape, dt,
                        (e, self.bcast_to(s, shape)), {"op": "div"})

    def op__log_softmax(self, node):
        return self.op__softmax(node, log=True)

    def op_mm(self, node):
        return self._dot(node, ((1,), (0,)), ((), ()), OpKind.GEMM)

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

