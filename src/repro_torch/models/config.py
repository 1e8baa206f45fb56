"""Model & shape configuration for the 10 assigned architectures."""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN width
    n_shared: int = 0             # shared (always-on) experts
    d_shared: int = 0             # combined shared-expert FFN width
    capacity_factor: float = 1.25
    renormalize: bool = True
    # dispatch group count: tokens are routed/sorted/capacity-packed within
    # groups (GShard G); groups align with DP shards so dispatch stays local.
    # 1 = global dispatch (baseline); 0 = auto (min(16, divisors of T)).
    n_groups: int = 1


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style: repeating (recurrent, recurrent, local-attn)."""
    window: int = 2048
    pattern: tuple[str, ...] = ("rec", "rec", "attn")
    d_rnn: int = 0                # RG-LRU width (0 -> d_model)
    c: float = 8.0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    act: str = "swiglu"           # swiglu | geglu | sqrelu
    norm: str = "rms"             # rms | ln
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    hybrid: HybridConfig | None = None
    # encoder-decoder (seamless): encoder depth; decoder uses n_layers
    n_encoder_layers: int = 0
    # modality frontend stub sizes
    n_patch_tokens: int = 0       # vlm: image patch embeddings per sample
    n_frame_tokens: int = 0       # audio: frames per sample (encoder input)
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"
    remat: str = "full"           # full | dots | none
    # False -> python-loop layers/chunks instead of lax.scan.  Used by the
    # dry-run probes: XLA cost analysis counts while bodies once, so probes
    # unroll to make flops/bytes/collective counts exact.
    scan_layers: bool = True
    # pin activation token-dim sharding to the DP axes at layer boundaries
    # (beyond-paper collective fix; see DESIGN.md and EXPERIMENTS.md §Perf)
    shard_activations: bool = False
    # chunked-CE grouping: chunk the loss WITHIN each of `loss_groups` token
    # groups (aligned with DP shards) instead of across the global batch, so
    # every chunk matmul stays DP-parallel.  1 = global chunks (baseline).
    loss_groups: int = 1

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid-with-local-window)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline math)."""
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        dh, Hq, Hkv = self.dh, self.n_heads, self.n_kv_heads
        total = V * D                              # embed
        if not self.tie_embeddings:
            total += D * V                         # lm head
        def attn_params() -> int:
            p = D * Hq * dh + 2 * D * Hkv * dh + Hq * dh * D
            if self.qkv_bias:
                p += (Hq + 2 * Hkv) * dh
            if self.qk_norm:
                p += 2 * dh
            return p
        def dense_mlp(f: int) -> int:
            return (3 if self.act in ("swiglu", "geglu") else 2) * D * f
        if self.family == "ssm":
            s = self.ssm or SSMConfig()
            dm = s.expand * D
            dtr = s.dt_rank or math.ceil(D / 16)
            per = (D * 2 * dm) + (dm * s.d_conv) + (dm * (dtr + 2 * s.d_state)) \
                + (dtr * dm) + (dm * s.d_state) + 2 * dm + (dm * D)
            total += L * (per + D)                  # + norm
            total += D                              # final norm
            return total
        if self.family == "hybrid":
            h = self.hybrid or HybridConfig()
            drnn = h.d_rnn or D
            rec = 2 * D * drnn + drnn * D + 3 * drnn  # gates+proj+lru params (approx)
            att = attn_params()
            mlp = dense_mlp(F)
            n_rec = sum(1 for i in range(L) if h.pattern[i % len(h.pattern)] == "rec")
            n_att = L - n_rec
            total += n_rec * (rec + mlp + 2 * D) + n_att * (att + mlp + 2 * D)
            total += D
            return total
        per_layer = attn_params() + 2 * D           # norms
        if self.family == "moe" and self.moe:
            m = self.moe
            per_layer += D * m.n_experts            # router
            per_layer += m.n_experts * (3 * D * m.d_expert)
            if m.n_shared:
                per_layer += 3 * D * m.d_shared
        else:
            per_layer += dense_mlp(F)
        total += L * per_layer
        if self.n_encoder_layers:
            enc_per = attn_params() + dense_mlp(F) + 2 * D
            total += self.n_encoder_layers * (enc_per + attn_params() + D)  # +cross-attn
        total += D                                   # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed-in experts)."""
        if self.family != "moe" or not self.moe:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        all_exp = self.n_layers * m.n_experts * 3 * self.d_model * m.d_expert
        act_exp = self.n_layers * m.top_k * 3 * self.d_model * m.d_expert
        return full - all_exp + act_exp


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode | long_decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "long_decode"),
}
