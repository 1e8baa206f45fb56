"""Cross-entropy over vocabulary rows: the port of the reference's
``_xent_kernel`` (``src/repro/kernels/cross_entropy.py:23``), a Triton
kernel.

What it computes: per row, ``m + log(l) - gold`` in f32, with ``m`` the
row max, ``l = sum(exp(x - m))`` and ``gold`` the label's logit; the caller
takes the mean, as the reference's does.  Labels are assumed in range, as
in the reference; there is no ignore index.

Bound on this card: bytes.  A launch reads the logits once: 311.2 MB for
qwen3-1.7b's (1024, 151936) bf16 LM-head logits, 92.9 us at 3.35 TB/s (its
155.6 M exponentials take 37.2 us on the SFU).  The Pallas kernel walks the
vocabulary as a grid axis and carries (m, l, gold) in scratch from one step
to the next, which the TPU's in-order grid allows; CUDA blocks run in no
order, so here one program owns a row and walks its vocabulary in a loop of
``BLOCK_V`` columns, the running state in registers: ``m_new = max(m,
max(x))``, ``l = l * exp(m - m_new) + sum(exp(x - m_new))``, ``gold +=
sum(where(col == label, x, 0))``.  Lanes past the row load ``-inf``.  The
rows of one call give as many programs (1024 at qwen3-1.7b's path); a few
rows fill few SMs, and splitting a row's vocabulary across programs needs a
second, combining pass.

It is the custom op ``repro_torch::cross_entropy(logits, labels)`` ->
(rows,) f32: the CPU implementation is the plain version, the CUDA
implementation launches the kernel.  :func:`cross_entropy` casts the labels
to int32 and takes the mean outside the op.
"""

from __future__ import annotations

from collections import Counter

import torch

from . import build
from . import ref as _ref

__all__ = ["cross_entropy", "cross_entropy_plain", "launches"]

_FLOAT = (torch.float32, torch.bfloat16)
BLOCK_V = 4096        # vocabulary columns a loop step

# kernel launches since the last reset, by build.signature of the arguments
launches: Counter = Counter()               # _xent_kernel
_JIT = None
tl = None             # triton.language, bound by build.triton_jit at launch


def _xent_kernel(x_ptr, lbl_ptr, loss_ptr, V, stride_x,
                 BLOCK_V: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    x_row = x_ptr + row * stride_x
    lbl = tl.load(lbl_ptr + row)
    zero = tl.zeros([BLOCK_V], tl.float32)
    # f32 scalars, typed as the loop carries them
    m = tl.max(zero, axis=0) - float("inf")
    l = tl.sum(zero, axis=0)
    gold = tl.sum(zero, axis=0)
    for v0 in range(0, V, BLOCK_V):
        col = v0 + tl.arange(0, BLOCK_V)
        x = tl.load(x_row + col, mask=col < V,
                    other=float("-inf")).to(tl.float32)
        m_new = tl.maximum(m, tl.max(x, axis=0))
        l = l * tl.exp(m - m_new) + tl.sum(tl.exp(x - m_new), axis=0)
        m = m_new
        gold += tl.sum(tl.where(col == lbl, x, 0.0), axis=0)
    tl.store(loss_ptr + row, m + tl.log(l) - gold)


def cross_entropy_plain(logits, labels):
    """The plain version: the reference's ``ref`` oracle per row."""
    return _ref.xent_rows(logits, labels)


def _launch(logits, labels):
    global _JIT
    if logits.dim() != 2 or logits.dtype not in _FLOAT:
        raise ValueError(f"cross_entropy: logits {tuple(logits.shape)} "
                         f"{logits.dtype}; need (rows, V) f32 or bf16")
    if labels.shape != logits.shape[:1] or labels.dtype != torch.int32 \
            or labels.device != logits.device:
        raise ValueError(f"cross_entropy: labels {tuple(labels.shape)} "
                         f"{labels.dtype} on {labels.device}; need (rows,) "
                         f"int32 on {logits.device}")
    if logits.stride(1) != 1 or not labels.is_contiguous():
        raise ValueError(f"cross_entropy: strides {logits.stride()}, "
                         f"{labels.stride()}: rows must be contiguous")
    rows, V = logits.shape
    out = torch.empty((rows,), dtype=torch.float32, device=logits.device)
    if _JIT is None:
        _JIT = build.triton_jit(_xent_kernel)
    _JIT[(rows,)](logits, labels, out, V, logits.stride(0),
                  BLOCK_V=min(BLOCK_V, build.next_pow2(V)), num_warps=8)
    launches[build.signature(logits, labels)] += 1
    return out


@torch.library.custom_op("repro_torch::cross_entropy", mutates_args=(),
                         device_types="cpu")
def cross_entropy_op(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return cross_entropy_plain(logits, labels)


cross_entropy_op.register_kernel("cuda")(_launch)


@cross_entropy_op.register_fake
def _(logits, labels):
    return logits.new_empty(logits.shape[:1], dtype=torch.float32)


def cross_entropy(logits, labels):
    """logits (B, V), labels (B,) int -> the mean NLL, an f32 scalar.  The
    mean is a sum and a division, as ``jnp.mean`` traces."""
    rows = cross_entropy_op(logits, labels.to(torch.int32))
    return torch.sum(rows) / rows.shape[0]
