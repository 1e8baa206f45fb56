"""Registry of *stitchable* custom (Pallas) kernels.

The tracer lowers every ``pallas_call`` to an opaque ``OpKind.CUSTOM`` node
carrying an ``eval_fn`` that replays the saved primitive.  By default the
fusion generator treats CUSTOM as a hard partition boundary — correct for
arbitrary foreign ops, but it forces e.g. a transformer decode step into
``gemm | attention | gemm | ...`` islands even though the attention kernel's
body is perfectly composable with its surrounding projections.

This module is the allow-list that relaxes that: a kernel registered here
declares the two facts the compiler needs to treat its CUSTOM node as a
first-class stitching citizen —

* ``flops``  — an MXU/compute estimate so the cost model's roofline sees
  the kernel as compute-bearing rather than free;
* ``scratch_bytes`` — the on-chip (VMEM) footprint its body allocates, so
  the ILP can reject partitions whose combined scratch would not fit.

The registry is keyed on the Pallas *kernel-body function name* (what
``pl.pallas_call`` records as ``name_and_src_info``), which the tracer tags
onto the node as ``attrs["kernel"]``.  Only :mod:`repro_torch.core.ir` is imported
here — no Pallas, no jax — so ``core.fusiongen -> kernels.registry`` adds no
import cycles and no accelerator requirements at planning time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.core.ir import Graph, OpKind, OpNode

__all__ = ["StitchableKernel", "register", "lookup", "registered_names"]


@dataclass(frozen=True)
class StitchableKernel:
    """Compiler-facing descriptor of one registered Pallas kernel.

    ``flops``/``scratch_bytes`` receive the CUSTOM node and its graph and
    derive estimates from the *operand* shapes (output shapes are unreliable
    for multi-output kernels, whose base node is shapeless)."""

    name: str
    flops: Callable[[OpNode, Graph], float]
    scratch_bytes: Callable[[OpNode, Graph], int]


_REGISTRY: dict[str, StitchableKernel] = {}


def register(desc: StitchableKernel) -> StitchableKernel:
    """Install (or replace) a descriptor under ``desc.name``."""
    _REGISTRY[desc.name] = desc
    return desc


def registered_names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def lookup(node: OpNode) -> Optional[StitchableKernel]:
    """Descriptor for a CUSTOM node whose traced kernel tag is registered.

    Projection nodes (``attrs["project"]``) resolve through the same tag as
    their multi-output base, so callers can ask about either."""
    if node.kind is not OpKind.CUSTOM:
        return None
    tag = node.attrs.get("kernel")
    if not tag:
        return None
    return _REGISTRY.get(tag)


# -- built-in descriptors -----------------------------------------------------
#
# The formulas mirror the actual kernel bodies (kernels/flash_attention.py,
# kernels/router.py): flash keeps a (qb,) m/l pair plus a (qb, Dh) f32
# accumulator in VMEM per grid step; the router is purely row-blocked with
# no explicit scratch.


def _flash_flops(node: OpNode, g: Graph) -> float:
    q = g[node.operands[0]].shape            # (B, Lq, Hq, Dh)
    kv = g[node.operands[1]].shape           # (B, Lkv, Hkv, Dh)
    if len(q) != 4 or len(kv) != 4:
        return 0.0
    b, lq, hq, dh = q
    lkv = kv[1]
    # QK^T and PV each cost 2*Lq*Lkv*Dh MACs per (batch, head)
    return 4.0 * b * hq * lq * lkv * dh


def _flash_scratch(node: OpNode, g: Graph) -> int:
    q = g[node.operands[0]].shape
    if len(q) != 4:
        return 0
    _, lq, _, dh = q
    qb = min(128, lq)                        # default block_q in the kernel
    return qb * (2 + dh) * 4                 # f32 m + l + (qb, Dh) acc


def _router_flops(node: OpNode, g: Graph) -> float:
    logits = g[node.operands[0]].shape       # (T, E)
    if len(logits) != 2:
        return 0.0
    t, e = logits
    # per row: k iterative max-scans over E plus softmax-ish normalisation
    return float(t * e * 8)


def _decode_attn_flops(node: OpNode, g: Graph) -> float:
    # pallas_call operands: (positions, q^T, k^T, v^T) — see
    # kernels/decode_attention.py; q^T is (B, Hq, 1, Dh), kv^T (B, Hkv, Smax, Dh)
    if len(node.operands) < 3:
        return 0.0
    q = g[node.operands[1]].shape
    kv = g[node.operands[2]].shape
    if len(q) != 4 or len(kv) != 4:
        return 0.0
    b, hq, _, dh = q
    smax = kv[2]
    # one QK^T row and one PV row per (batch, head): 2*Smax*Dh MACs each
    return 4.0 * b * hq * smax * dh


def _decode_attn_scratch(node: OpNode, g: Graph) -> int:
    if len(node.operands) < 2:
        return 0
    q = g[node.operands[1]].shape
    if len(q) != 4:
        return 0
    dh = q[3]
    return (2 + dh) * 4                      # f32 m + l + (1, Dh) acc


def _vpu_flops(per_elem: float, operand: int = 0):
    """Memory-bound VPU kernels (norms, rope, GLU): a few ops per element of
    the named operand, no MXU work, no explicit scratch (VREG-only)."""

    def flops(node: OpNode, g: Graph) -> float:
        if len(node.operands) <= operand:
            return 0.0
        return per_elem * float(g[node.operands[operand]].size)

    return flops


register(StitchableKernel("_flash_kernel", _flash_flops, _flash_scratch))
register(StitchableKernel("_router_kernel", _router_flops, lambda n, g: 0))
register(StitchableKernel("_decode_attn_kernel", _decode_attn_flops,
                          _decode_attn_scratch))
register(StitchableKernel("_rmsnorm_kernel", _vpu_flops(4.0), lambda n, g: 0))
register(StitchableKernel("_rmsnorm_residual_kernel", _vpu_flops(5.0),
                          lambda n, g: 0))
register(StitchableKernel("_layernorm_kernel", _vpu_flops(6.0), lambda n, g: 0))
register(StitchableKernel("_rope_kernel", _vpu_flops(6.0), lambda n, g: 0))
register(StitchableKernel("_glu_kernel", _vpu_flops(4.0), lambda n, g: 0))
