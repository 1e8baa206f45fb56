"""Node evaluation for StitchIR graphs in PyTorch.

Two consumers share the single node evaluator below:

* :func:`build_reference_fn` — eager PyTorch executor for a whole graph.
  It is the numerical oracle every generated kernel is tested against, and
  the executor of the compiler's ``"torch"`` and ``"op"`` groups.
* the stitched kernel's plain version (:mod:`repro_torch.kernels.stitched`)
  — evaluates a pattern's members value-to-value with the same function.

Dtypes are spelled as strings in the IR (``"float32"``, ``"bfloat16"``,
``"int32"``, ``"bool"``); :func:`canonical_dtype` maps them to torch dtypes.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from .ir import Graph, OpKind, OpNode

__all__ = ["EW_OPS", "canonical_dtype", "accumulation_dtype", "dot_accumulate",
           "eval_node", "build_reference_fn", "source_value", "is_float"]


_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}


def canonical_dtype(dtype) -> torch.dtype:
    """The torch dtype of an IR dtype spelling (or a torch dtype)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise TypeError(f"unsupported IR dtype {dtype!r}") from None


def dtype_name(dtype: torch.dtype) -> str:
    """The IR spelling of a torch dtype."""
    return str(dtype).replace("torch.", "")


def is_float(dtype) -> bool:
    return canonical_dtype(dtype).is_floating_point


# -- elementwise vocabulary --------------------------------------------------

def _div(a, b):
    if a.dtype.is_floating_point or b.dtype.is_floating_point:
        return torch.div(a, b)
    return torch.div(a, b, rounding_mode="trunc")   # lax.div on integers


EW_OPS: dict[str, Callable] = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": _div,
    "max": torch.maximum,
    "min": torch.minimum,
    "pow": torch.pow,
    "neg": torch.neg,
    "exp": torch.exp,
    "log": torch.log,
    "log1p": torch.log1p,
    "tanh": torch.tanh,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "abs": torch.abs,
    "sign": torch.sign,
    "erf": torch.erf,
    "square": lambda x: x * x,
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh form
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": torch.relu,
    # jax.nn.softplus is logaddexp(x, 0)
    "softplus": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "select": lambda c, a, b: torch.where(c.bool(), a, b),
    "cos": torch.cos,
    "sin": torch.sin,
    "and": torch.bitwise_and,
    "or": torch.bitwise_or,
    "not": torch.bitwise_not,
    "xor": torch.bitwise_xor,
    "ge": torch.ge,
    "gt": torch.gt,
    "le": torch.le,
    "lt": torch.lt,
    "eq": torch.eq,
}


def _prod(x, axis, keepdims):
    for a in sorted(axis, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdims)
    return x


_REDUCERS = {
    "sum": lambda x, axis, keepdims: torch.sum(x, dim=axis, keepdim=keepdims),
    "max": lambda x, axis, keepdims: torch.amax(x, dim=axis, keepdim=keepdims),
    "min": lambda x, axis, keepdims: torch.amin(x, dim=axis, keepdim=keepdims),
    "prod": _prod,
    "mean": lambda x, axis, keepdims: torch.mean(x, dim=axis, keepdim=keepdims),
}


def accumulation_dtype(node: OpNode) -> torch.dtype:
    """Accumulation dtype for a GEMM/BATCHED_GEMM node.

    The traced ``preferred`` attr wins; otherwise float dots accumulate in
    at least f32 (rounding once to the declared output dtype)."""
    pref = node.attrs.get("preferred")
    if pref is not None:
        return canonical_dtype(pref)
    out_dt = canonical_dtype(node.dtype)
    if out_dt.is_floating_point:
        return torch.promote_types(out_dt, torch.float32)
    return out_dt


_LETTERS = "abcdefghijklmnopqrstuvwxyz"


def _dot_general(lhs, rhs, contract, batch):
    """``lax.dot_general`` semantics (output = batch, lhs free, rhs free)
    spelled as an einsum."""
    (lc, rc), (lb, rbd) = contract, batch
    names = iter(_LETTERS)
    lsub = [None] * lhs.dim()
    rsub = [None] * rhs.dim()
    for a, b in zip(lb, rbd):
        lsub[a] = rsub[b] = next(names)
    for a, b in zip(lc, rc):
        lsub[a] = rsub[b] = next(names)
    for i in range(lhs.dim()):
        if lsub[i] is None:
            lsub[i] = next(names)
    for i in range(rhs.dim()):
        if rsub[i] is None:
            rsub[i] = next(names)
    out = ([lsub[a] for a in lb]
           + [lsub[i] for i in range(lhs.dim()) if i not in lb and i not in lc]
           + [rsub[i] for i in range(rhs.dim()) if i not in rbd and i not in rc])
    spec = f"{''.join(lsub)},{''.join(rsub)}->{''.join(out)}"
    return torch.einsum(spec, lhs, rhs)


def dot_accumulate(node: OpNode, lhs, rhs, *, dimension_numbers):
    """Dot with explicit accumulation dtype, rounded once to the node's
    declared output dtype.  Every executor funnels through here.

    When the operands already carry the output dtype, the library GEMM
    accumulates in f32 and rounds once (cuBLAS on the card, with reduced-
    precision reductions switched off by the caller); only a widening dot
    (bf16 operands, f32 output) upcasts its operands first."""
    contract, batch = dimension_numbers
    out_dt = canonical_dtype(node.dtype)
    acc = accumulation_dtype(node)
    if lhs.dtype == out_dt and rhs.dtype == out_dt and (
            not out_dt.is_floating_point or out_dt.itemsize <= acc.itemsize):
        return _dot_general(lhs, rhs, contract, batch).to(out_dt)
    out = _dot_general(lhs.to(acc), rhs.to(acc), contract, batch)
    return out.to(out_dt)


def broadcast_in_dim(x, shape, dims):
    """``lax.broadcast_in_dim``: operand dim i lands on target dim dims[i]."""
    view = [1] * len(shape)
    for i, d in enumerate(dims):
        view[d] = x.shape[i]
    return x.reshape(view).expand(tuple(shape))


def eval_node(node: OpNode, operands: list, g: Graph | None = None):
    """Evaluate one StitchIR node on concrete torch tensors."""
    k = node.kind
    if k is OpKind.ELEMENTWISE:
        op = node.attrs["op"]
        dt = canonical_dtype(node.dtype)
        if op == "convert":
            return operands[0].to(dt)
        if op == "integer_pow":
            return torch.pow(operands[0], int(node.attrs["y"])).to(dt)
        fn = EW_OPS.get(op)
        if fn is None:
            raise NotImplementedError(f"elementwise op {op!r}")
        out = fn(*operands)
        # the node's declared dtype is authoritative (comparisons declare
        # bool; scalar operands may promote)
        if out.dtype != dt:
            out = out.to(dt)
        return out
    if k is OpKind.BROADCAST:
        return broadcast_in_dim(operands[0], node.shape,
                                tuple(node.attrs["bcast_dims"]))
    if k is OpKind.RESHAPE:
        return operands[0].reshape(node.shape)
    if k is OpKind.TRANSPOSE:
        return operands[0].permute(tuple(node.attrs["perm"]))
    if k is OpKind.SLICE:
        x = operands[0]
        strides = node.attrs.get("strides") or (1,) * x.dim()
        idx = tuple(slice(s, l, st) for s, l, st in
                    zip(node.attrs["starts"], node.attrs["limits"], strides))
        return x[idx]
    if k is OpKind.REDUCTION:
        red = _REDUCERS[node.attrs.get("op", "sum")]
        out = red(operands[0], tuple(node.attrs["axes"]),
                  bool(node.attrs.get("keepdims", False)))
        dt = canonical_dtype(node.dtype)
        return out if out.dtype == dt else out.to(dt)
    if k in (OpKind.GEMM, OpKind.BATCHED_GEMM):
        contract = tuple(tuple(d) for d in node.attrs["contract"])
        batch = tuple(tuple(d) for d in node.attrs.get("batch", ((), ())))
        return dot_accumulate(node, operands[0], operands[1],
                              dimension_numbers=(contract, batch))
    if k is OpKind.GATHER:
        table, idx = operands
        return table[idx.long()]
    if k is OpKind.TUPLE:
        return tuple(operands)
    if k in (OpKind.CUSTOM, OpKind.SCATTER):
        if "project" in node.attrs:
            return operands[0][node.attrs["project"]]
        fn = node.attrs.get("eval_fn")
        if fn is not None:
            return fn(*operands)
    raise NotImplementedError(f"cannot evaluate node kind {k}")


def source_value(node: OpNode, inputs: Mapping | None = None, device=None):
    """Resolve a PARAMETER/CONSTANT node to a tensor: explicit input first,
    then the constant payload captured at trace time (moved to ``device``)."""
    dt = canonical_dtype(node.dtype)
    if inputs is not None and node.name in inputs:
        x = inputs[node.name]
        if not isinstance(x, torch.Tensor):
            return torch.as_tensor(x, dtype=dt, device=device)
        return x if x.dtype == dt else x.to(dt)
    if node.kind is OpKind.CONSTANT and "value" in node.attrs:
        return torch.as_tensor(node.attrs["value"], dtype=dt, device=device)
    raise KeyError(f"missing input {node.name!r}")


def _device_of(inputs: Mapping):
    for v in inputs.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return None


def build_reference_fn(g: Graph) -> Callable[[Mapping], dict]:
    """Whole-graph executor: {param/const name: tensor} -> {output: tensor}."""
    topo = g.topo_order()

    def run(inputs: Mapping) -> dict:
        device = _device_of(inputs)
        env: dict = {}
        for name in topo:
            node = g[name]
            if node.is_source():
                env[name] = source_value(node, inputs, device)
            else:
                env[name] = eval_node(node, [env[o] for o in node.operands], g)
        return {o: env[o] for o in g.outputs}

    return run
