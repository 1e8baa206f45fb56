"""Layer library of the dense and MoE families: GQA attention (RoPE /
qk-norm / dense KV cache), the SwiGLU / GeGLU MLP, RMSNorm, the sort-based
capacity MoE, and their initializers.

All functions are pure; parameters are nested dicts of tensors in the
reference's layout (weights ``(in, out)`` for ``x @ w``, activations
``(B, S, H, Dh)``).  Params live in ``cfg.param_dtype`` (f32) and are cast
to ``cfg.dtype`` at use; reductions run in f32.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as _ref
from .config import ModelConfig

Params = dict[str, Any]


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float, cfg: ModelConfig,
            device) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(torch_dtype(cfg.param_dtype))


def init_norm(cfg: ModelConfig, device, d: int | None = None) -> Params:
    return {"g": torch.ones((d or cfg.d_model,),
                           dtype=torch_dtype(cfg.param_dtype), device=device)}


def init_attention(gen, cfg: ModelConfig, device) -> Params:
    D, dh, Hq, Hkv = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads
    sc = 1.0 / math.sqrt(D)
    p = {
        "wq": _normal(gen, (D, Hq * dh), sc, cfg, device),
        "wk": _normal(gen, (D, Hkv * dh), sc, cfg, device),
        "wv": _normal(gen, (D, Hkv * dh), sc, cfg, device),
        "wo": _normal(gen, (Hq * dh, D), 1.0 / math.sqrt(Hq * dh), cfg, device),
    }
    if cfg.qk_norm:
        p["q_norm_g"] = init_norm(cfg, device, dh)["g"]
        p["k_norm_g"] = init_norm(cfg, device, dh)["g"]
    return p


def init_mlp(gen, cfg: ModelConfig, device) -> Params:
    D, F = cfg.d_model, cfg.d_ff
    sc_in, sc_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(F)
    return {
        "w_gate": _normal(gen, (D, F), sc_in, cfg, device),
        "w_up": _normal(gen, (D, F), sc_in, cfg, device),
        "w_down": _normal(gen, (F, D), sc_out, cfg, device),
    }


def init_moe(gen, cfg: ModelConfig, device) -> Params:
    m = cfg.moe
    D, E, F = cfg.d_model, m.n_experts, m.d_expert
    if m.n_shared:
        raise NotImplementedError("shared experts are not ported yet")
    sc_in, sc_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(F)
    return {
        "router": _normal(gen, (D, E), sc_in, cfg, device),
        "w_gate": _normal(gen, (E, D, F), sc_in, cfg, device),
        "w_up": _normal(gen, (E, D, F), sc_in, cfg, device),
        "w_down": _normal(gen, (E, F, D), sc_out, cfg, device),
    }


# ---------------------------------------------------------------------------
# norms / MLPs
# ---------------------------------------------------------------------------

def apply_norm(p: Params, x, cfg: ModelConfig):
    return ops.rmsnorm(x, p["g"].to(torch_dtype(cfg.dtype)))


def apply_mlp(p: Params, x, cfg: ModelConfig):
    dt = torch_dtype(cfg.dtype)
    gate = x @ p["w_gate"].to(dt)
    up = x @ p["w_up"].to(dt)
    h = ops.swiglu(gate, up) if cfg.act == "swiglu" else ops.geglu(gate, up)
    return h @ p["w_down"].to(dt)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

_CHUNK_Q = 512  # ref-path q-chunking threshold/size for long sequences


def _chunked_causal_attention(q, k, v, scale: float, window: int | None):
    """Causal attention over 512-row q chunks, so the logits never exceed
    (B, Hkv, group, 512, S): the reference's unrolled branch
    (``use_scan=False``).  K and V are contracted at their native Hkv width
    (grouped GQA, no repeat), in f32; masked logits are -1e30."""
    B, Lq, Hq, Dh = q.shape
    _, Lkv, Hkv, _ = k.shape
    group = Hq // Hkv
    nq = Lq // _CHUNK_Q
    qg = q.reshape(B, nq, _CHUNK_Q, Hkv, group, Dh).permute(1, 0, 2, 3, 4, 5)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    kpos = torch.arange(Lkv, device=q.device)
    outs = []
    for ci in range(nq):
        qb = qg[ci]                        # (B, qc, Hkv, group, Dh)
        qpos = ci * _CHUNK_Q + torch.arange(_CHUNK_Q, device=q.device)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qb.to(torch.float32),
                              kf) * scale
        mask = qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        logits = torch.where(mask[None, None, None], logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, vf)
        outs.append(out.to(qb.dtype))
    # (nq, B, qc, Hkv, group, Dh) -> (B, Lq, Hq, Dh)
    return torch.stack(outs).permute(1, 0, 2, 3, 4, 5).reshape(B, Lq, Hq, Dh)


def apply_attention(p: Params, x, cfg: ModelConfig, positions,
                    cache: Params | None = None, window: int | None = None,
                    return_kv: bool = False):
    """x: (B, S, D).  With ``cache`` (decode), S is the new-token count and
    attention runs against cache+new; returns (out, new_cache).  With
    ``return_kv`` (prefill) the post-RoPE k/v are returned instead.
    ``window``: local-attention window (keys within ``window`` positions)."""
    dt = torch_dtype(cfg.dtype)
    B, S, D = x.shape
    Hq, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh

    q = (x @ p["wq"].to(dt)).reshape(B, S, Hq, dh)
    k = (x @ p["wk"].to(dt)).reshape(B, S, Hkv, dh)
    v = (x @ p["wv"].to(dt)).reshape(B, S, Hkv, dh)
    if cfg.qk_norm:
        q = ops.rmsnorm(q, p["q_norm_g"].to(dt))
        k = ops.rmsnorm(k, p["k_norm_g"].to(dt))
    q = ops.rope(q, positions, cfg.rope_theta)
    k = ops.rope(k, positions, cfg.rope_theta)

    scale = 1.0 / math.sqrt(dh)
    new_cache = {"k": k, "v": v} if return_kv else None
    if cache is not None:
        # dense static-shape serving: cache (B, Smax, Hkv, dh).  A scalar
        # ``length`` is the lock-step batch; a (B,) vector is the ragged
        # batch, each slot writing its new KV at its own offset.  The
        # functional write returns a fresh cache tensor (a full copy).
        length = cache["length"]
        base = length[:, None] if length.dim() else length
        pos = base + torch.arange(S, dtype=torch.int32, device=x.device)
        pos = pos.expand(B, S).long()
        rows = torch.arange(B, device=x.device)[:, None].expand(B, S)
        ck = cache["k"].index_put((rows, pos), k.to(cache["k"].dtype))
        cv = cache["v"].index_put((rows, pos), v.to(cache["v"].dtype))
        new_cache = {"k": ck, "v": cv, "length": length + S}
        if S == 1 and ops.get_mode() == "kernels":
            # the decode-attention kernel: the whole masked-softmax chain is
            # one registered CUSTOM node (the position mask covers length
            # validity, as in the einsum chain below)
            out = ops.decode_attention(q, ck, cv, positions[:, 0], scale=scale,
                                       window=window)
            out = out.reshape(B, S, Hq * dh) @ p["wo"].to(dt)
            return out, new_cache
        Smax = ck.shape[1]
        group = Hq // Hkv
        # grouped-GQA contraction at native Hkv width, f32 accumulation
        qg = q.reshape(B, S, Hkv, group, dh)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                              ck.to(torch.float32)) * scale
        kpos = torch.arange(Smax, device=x.device)[None, None, None, None, :]
        qpos = positions[:, None, None, :, None]
        mask = kpos <= qpos
        if window is not None:
            mask = mask & (qpos - kpos < window)
        logits = torch.where(mask, logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd",
                           probs.to(dt).to(torch.float32),
                           cv.to(torch.float32))
        out = out.reshape(B, S, Hq, dh).to(dt)
    elif ops.get_mode() == "kernels" and S % 128 == 0:
        # the flash-attention kernel, as the reference's pallas mode
        out = ops.attention(q, k, v, causal=True, scale=scale, window=window)
    elif S > _CHUNK_Q and S % _CHUNK_Q == 0:
        out = _chunked_causal_attention(q, k, v, scale, window)
    else:
        out = _ref.attention(q, k, v, causal=True, scale=scale, window=window,
                             positions_q=positions)
    out = out.reshape(B, S, Hq * dh) @ p["wo"].to(dt)
    return out, new_cache


# ---------------------------------------------------------------------------
# sort-based capacity MoE (dropless up to capacity, GShard semantics)
# ---------------------------------------------------------------------------

def _moe_group_dispatch(xg, wg, ig, p: Params, cfg: ModelConfig, C: int):
    """Dispatch ONE token group: xg (Tg, D), router weights wg (Tg, k),
    expert ids ig (Tg, k) int32 -> (yg (Tg, D), counts (E,), n_dropped ()).

    The index arithmetic is int32, as in the reference; indices become
    int64 only where they index.  Both index assignments are exact: the
    buffer's duplicate indices all land in the drop bin, which is sliced
    off, and ``slot_of_flat``'s indices form a permutation.  The combine
    adds each token's k contributions left to right in the activation
    dtype from a zero start, the order of the reference's
    ``zeros.at[flat_tok].add(contrib)``, and with no atomics, so a bf16
    result does not change from run to run."""
    m = cfg.moe
    dt = torch_dtype(cfg.dtype)
    Tg, D = xg.shape
    E, k = m.n_experts, m.top_k
    dev = xg.device
    i32 = torch.int32

    flat_e = ig.reshape(-1)                                    # (Tg*k,)
    flat_w = wg.reshape(-1).to(dt)
    flat_tok = torch.arange(Tg * k, dtype=i32, device=dev) // k

    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_tok = flat_tok[order]

    counts = torch.zeros((E,), dtype=i32, device=dev).index_add(
        0, flat_e, torch.ones_like(flat_e))
    offsets = torch.cat([torch.zeros((1,), dtype=i32, device=dev),
                         torch.cumsum(counts, 0, dtype=i32)[:-1]])
    pos_in_e = torch.arange(Tg * k, dtype=i32, device=dev) \
        - offsets[sorted_e.long()]
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e, E * C)  # E*C: drop bin

    buf_tok = torch.full((E * C + 1,), -1, dtype=i32, device=dev).index_put(
        (slot.long(),), sorted_tok)[:-1]
    gathered = torch.where(
        (buf_tok >= 0)[:, None],
        xg[buf_tok.clamp(0, Tg - 1).long()],
        torch.zeros((), dtype=dt, device=dev),
    ).reshape(E, C, D)

    gate = torch.einsum("ecd,edf->ecf", gathered, p["w_gate"].to(dt))
    up = torch.einsum("ecd,edf->ecf", gathered, p["w_up"].to(dt))
    h = ops.swiglu(gate, up)
    yexp = torch.einsum("ecf,efd->ecd", h, p["w_down"].to(dt)).reshape(E * C, D)
    yexp = torch.cat([yexp, torch.zeros((1, D), dtype=dt, device=dev)])

    slot_of_flat = torch.full((Tg * k,), E * C, dtype=i32, device=dev
                              ).index_put((order,), slot)
    contrib = (flat_w[:, None] * yexp[slot_of_flat.long()]).reshape(Tg, k, D)
    yg = torch.zeros((Tg, D), dtype=dt, device=dev)
    for j in range(k):
        yg = yg + contrib[:, j]
    return yg, counts, torch.sum(~keep)


def _moe_groups(cfg: ModelConfig, T: int) -> int:
    m = cfg.moe
    G = m.n_groups if m.n_groups else 16
    while T % G:
        G //= 2
    return max(G, 1)


def apply_moe(p: Params, x2d, cfg: ModelConfig):
    """x2d: (T, D) -> (T, D), aux metrics dict.

    Sort-based capacity dispatch, as the reference's: token-expert
    assignments are sorted by expert, packed into (E, C, D) buffers
    (overflow dropped: GShard token-choice semantics), run through batched
    expert FFNs and combined back with the router weights.  The grouped
    dispatch (the reference's vmap over ``moe.n_groups`` token groups,
    which only its perf launcher sets) is not ported.  A caller that drops
    the aux metrics leaves them out of a traced graph: the tracer removes
    dead nodes."""
    m = cfg.moe
    T, D = x2d.shape
    E, k = m.n_experts, m.top_k
    dt = torch_dtype(cfg.dtype)

    logits = (x2d @ p["router"].to(dt)).to(torch.float32)
    weights, idx = ops.topk_router(logits, k, m.renormalize)   # (T, k)

    if _moe_groups(cfg, T) != 1:
        raise NotImplementedError("grouped MoE dispatch (moe.n_groups != 1) "
                                  "is not ported yet")
    C = int(math.ceil(m.capacity_factor * T * k / E))
    C = max(8, -(-C // 8) * 8)  # round up to a multiple of 8
    y, counts, n_drop = _moe_group_dispatch(x2d, weights, idx, p, cfg, C)

    # load-balance aux (Switch): E * sum_e f_e * p_e
    probs = torch.softmax(logits, dim=-1)
    frac = counts.to(torch.float32) / (T * k)
    moe_aux = E * torch.sum(frac * torch.mean(probs, dim=0))
    dropped = n_drop / (T * k)
    return y, {"moe_aux": moe_aux, "moe_drop_frac": dropped.to(torch.float32)}
