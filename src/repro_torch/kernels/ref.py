"""Plain-PyTorch oracles of the reference's kernel API (``ref`` mode).

Each function computes what ``repro/kernels/ref.py`` computes, in the same
layouts: activations are ``(B, S, H, Dh)``, statistics in f32, results cast
back to the input dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["rmsnorm", "rmsnorm_residual", "layernorm", "softmax", "swiglu",
           "geglu", "squared_relu", "rope", "cross_entropy", "xent_rows",
           "attention", "topk_router", "mamba_scan", "softplus", "rg_lru"]


def rmsnorm(x, gamma, eps: float = 1e-6):
    # x converted to f32 once for the statistics and once for the product,
    # and jnp.square's square, as the reference spells it (its trace
    # carries both converts)
    var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
    out = x.to(torch.float32) * torch.rsqrt(var + eps)
    return (out * gamma.to(torch.float32)).to(x.dtype)


def rmsnorm_residual(x, res, gamma, eps: float = 1e-6):
    """Residual add + RMSNorm: ``s = x + res`` in f32; returns (the norm of
    s, s), each in x's dtype."""
    s = x.to(torch.float32) + res.to(torch.float32)
    return rmsnorm(s, gamma, eps).to(x.dtype), s.to(x.dtype)


def layernorm(x, gamma, beta, eps: float = 1e-5):
    """Mean, then the variance as the mean of ``(x - mu)^2`` (``square``,
    as ``jnp.square`` traces), in f32; gamma and beta promote to f32."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


def softmax(x, scale: float = 1.0, mask=None):
    """Softmax of ``x * scale`` over the last axis in f32, masked lanes
    ``-inf``: a fully masked row is NaN here, as in the reference's oracle
    (only the masked kernel makes it 0)."""
    xf = x.to(torch.float32) * scale
    if mask is not None:
        xf = torch.where(mask, xf, -math.inf)
    m = torch.amax(xf, dim=-1, keepdim=True)
    e = torch.exp(xf - m)
    return (e / torch.sum(e, dim=-1, keepdim=True)).to(x.dtype)


def swiglu(gate, up):
    return (F.silu(gate.to(torch.float32)) * up.to(torch.float32)).to(gate.dtype)


def geglu(gate, up):
    """GELU in its tanh form, which is ``jax.nn.gelu``'s default."""
    return (F.gelu(gate.to(torch.float32), approximate="tanh")
            * up.to(torch.float32)).to(gate.dtype)


def squared_relu(x):
    """``max(x, 0)^2`` in f32.  ``clamp_min`` with a Python scalar traces
    to a ``max`` node against a scalar literal, as ``jnp.maximum(x, 0.0)``
    does in the reference."""
    r = torch.clamp_min(x.to(torch.float32), 0.0)
    return (r * r).to(x.dtype)


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding on halves. x: (..., L, H, Dh) or (..., L, Dh);
    positions (..., L)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.to(torch.float32)[..., None] * freq       # (..., L, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == positions.dim() + 2:                         # (..., L, H, Dh)
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def xent_rows(logits, labels):
    """Per-row NLL ``logsumexp(row) - row[label]`` in f32: logits (B, V),
    labels (B,) int.  The gold logit is ``jnp.take_along_axis``'s steps on
    ``labels[:, None]``: the (B, 1) index, a negative label's wrap (``lt``,
    ``add``, ``select``), a gather, and the ``[..., 0]`` slice."""
    lf = logits.to(torch.float32)
    m = torch.amax(lf, dim=-1, keepdim=True)
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    idx = labels.to(torch.int32)[:, None]
    idx = torch.where(idx < 0, idx + lf.shape[-1], idx)
    gold = torch.gather(lf, 1, idx)[..., 0]
    return lse - gold


def cross_entropy(logits, labels):
    """Mean token NLL: logits (B, V) float, labels (B,) int."""
    return torch.mean(xent_rows(logits, labels))


def attention(q, k, v, *, causal: bool = True, scale: float | None = None,
              positions_q=None, positions_kv=None, window: int | None = None):
    """GQA attention oracle.  q: (B, Lq, Hq, Dh), k/v: (B, Lkv, Hkv, Dh);
    masked logits are -inf."""
    B, Lq, Hq, Dh = q.shape
    _, Lkv, Hkv, _ = k.shape
    group = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    kr = torch.repeat_interleave(k, group, dim=2)
    vr = torch.repeat_interleave(v, group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          kr.to(torch.float32)) * scale
    dev = q.device
    # int32 positions, as jnp.arange gives them
    pq = positions_q if positions_q is not None else \
        torch.arange(Lq, dtype=torch.int32, device=dev)[None]
    pk = positions_kv if positions_kv is not None else \
        torch.arange(Lkv, dtype=torch.int32, device=dev)[None]
    mask = torch.ones((B, 1, Lq, Lkv), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (pq[:, None, :, None] >= pk[:, None, None, :])
    if window is not None:
        mask = mask & (pq[:, None, :, None] - pk[:, None, None, :] < window)
    logits = torch.where(mask, logits, -math.inf)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vr.to(torch.float32))
    return out.to(q.dtype)


def topk_router(logits, k: int, renormalize: bool = True):
    """MoE router oracle: softmax over experts in f32, top k, optional
    renormalisation.  logits (T, E) -> (weights (T, k) in the logits'
    dtype, ids (T, k) int32).  Equal probabilities rank by the lower
    expert index, as ``jax.lax.top_k`` and the reference's kernel rank
    them: a stable descending sort, never ``torch.topk``, whose order
    among ties is unspecified."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :k], idx[:, :k]
    if renormalize:
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    return weights.to(logits.dtype), idx.to(torch.int32)


def _scan(x, delta, A, B, C, D):
    """The selective scan's loop, f32 throughout: one ``(Bb, Dm, N)`` state
    tile per step, never the ``(Bb, L, Dm, N)`` tensor.  Returns y in x's
    dtype and the final state (f32)."""
    xf, df = x.to(torch.float32), delta.to(torch.float32)
    Af, Bf, Cf = A.to(torch.float32), B.to(torch.float32), C.to(torch.float32)
    Bb, L, Dm = x.shape
    h = xf.new_zeros((Bb, Dm, A.shape[1]))
    ys = xf.new_empty((Bb, L, Dm))
    for t in range(L):
        d_t = df[:, t]
        dA_t = torch.exp(d_t[..., None] * Af)
        dBx_t = (d_t * xf[:, t])[..., None] * Bf[:, t, None, :]
        h = dA_t * h + dBx_t
        ys[:, t] = torch.einsum("bdn,bn->bd", h, Cf[:, t])
    y = ys + xf * D.to(torch.float32)
    return y.to(x.dtype), h


# The oracle is a custom op on every device, so a trace holds it as one
# untagged CUSTOM node (the reference's lax.scan is one node), not L
# unrolled steps; the planner cuts the graph there.
@torch.library.custom_op("repro_torch::mamba_scan_ref", mutates_args=())
def _mamba_scan_ref(x: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor,
                    D: torch.Tensor) -> torch.Tensor:
    return _scan(x, delta, A, B, C, D)[0]


@_mamba_scan_ref.register_fake
def _(x, delta, A, B, C, D):
    return x.new_empty(x.shape)


@torch.library.custom_op("repro_torch::mamba_scan_ref_state", mutates_args=())
def _mamba_scan_ref_state(x: torch.Tensor, delta: torch.Tensor,
                          A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                          D: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _scan(x, delta, A, B, C, D)


@_mamba_scan_ref_state.register_fake
def _(x, delta, A, B, C, D):
    return (x.new_empty(x.shape),
            x.new_empty((x.shape[0], x.shape[2], A.shape[1]),
                        dtype=torch.float32))


def mamba_scan(x, delta, A, B, C, D, return_state: bool = False):
    """Mamba-1 selective scan oracle.  x, delta (Bb, L, Dm); A (Dm, N);
    B, C (Bb, L, N); D (Dm,).  Returns y (Bb, L, Dm) in x's dtype [, the
    final state (Bb, Dm, N) f32]."""
    if return_state:
        return _mamba_scan_ref_state(x, delta, A, B, C, D)
    return _mamba_scan_ref(x, delta, A, B, C, D)


def softplus(x):
    """``jax.nn.softplus`` = ``logaddexp(x, 0)`` in the reference's own
    steps, each in x's dtype: ``max(x, 0) + log1p(exp(-|x - 0|))``, and
    ``x + 0`` where ``x - 0`` is NaN.  (``F.softplus`` has a threshold and
    is one node.)"""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    d = x - zero
    out = torch.maximum(x, zero) + torch.log1p(torch.exp(-torch.abs(d)))
    return torch.where(d != d, x + zero, out)


def _linear_scan(a, gx):
    """``h_t = a_t * h_{t-1} + gx_t`` from ``h = 0``, f32: a, gx (B, L, D)
    -> (every h_t (B, L, D), the last h (B, D))."""
    h = a.new_zeros((a.shape[0], a.shape[2]))
    hs = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + gx[:, t]
        hs[:, t] = h
    return hs, h


# Only the recurrence is a custom op, so a trace holds the gate chain as
# ordinary nodes and the loop as one untagged CUSTOM node, as the
# reference's jaxpr holds its lax.scan; the planner cuts the graph there.
@torch.library.custom_op("repro_torch::linear_scan_ref", mutates_args=())
def _linear_scan_ref(a: torch.Tensor, gx: torch.Tensor) -> torch.Tensor:
    return _linear_scan(a, gx)[0]


@_linear_scan_ref.register_fake
def _(a, gx):
    return a.new_empty(a.shape)


@torch.library.custom_op("repro_torch::linear_scan_ref_state", mutates_args=())
def _linear_scan_ref_state(a: torch.Tensor,
                           gx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _linear_scan(a, gx)


@_linear_scan_ref_state.register_fake
def _(a, gx):
    return a.new_empty(a.shape), a.new_empty((a.shape[0], a.shape[2]))


def rg_lru(x, input_gate, rec_gate, Lambda, c: float = 8.0,
           return_state: bool = False):
    """RG-LRU (RecurrentGemma) oracle.  x, input_gate, rec_gate (B, L, D);
    Lambda (D,).  ``a_t = exp(-c * softplus(Lambda) * sigmoid(rec_gate))``,
    ``h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * (sigmoid(input_gate)
    * x_t)``, in f32.  Returns every h_t in x's dtype (B, L, D) [, the last
    h (B, D) f32]."""
    xf = x.to(torch.float32)
    log_a = -c * softplus(Lambda.to(torch.float32)) * torch.sigmoid(
        rec_gate.to(torch.float32))
    a = torch.exp(log_a)
    gated = torch.sigmoid(input_gate.to(torch.float32)) * xf
    # a max node against a 0-d constant, broadcast (the reference's is a max
    # against a scalar literal)
    floor = torch.full((), 1e-12, dtype=torch.float32, device=a.device)
    gx = torch.sqrt(torch.maximum(1.0 - a * a, floor)) * gated
    if return_state:
        hs, h = _linear_scan_ref_state(a, gx)
        return hs.to(x.dtype), h
    return _linear_scan_ref(a, gx).to(x.dtype)
