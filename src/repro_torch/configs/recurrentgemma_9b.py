"""recurrentgemma-9b [arXiv:2402.19427; unverified]
38L d_model=4096 16H (GQA kv=1 = MQA) d_ff=12288 vocab=256000,
RG-LRU + local attention 1:2 ((rec, rec, attn) pattern), window 2048."""
from dataclasses import replace
from repro_torch.models.config import HybridConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, act="geglu", norm="rms", head_dim=256,
    hybrid=HybridConfig(window=2048, pattern=("rec", "rec", "attn")),
)

def reduced() -> ModelConfig:
    return replace(
        CONFIG, name="recurrentgemma-smoke", n_layers=5, d_model=64,
        n_heads=4, n_kv_heads=1, d_ff=128, vocab=256, head_dim=16,
        hybrid=HybridConfig(window=16, pattern=("rec", "rec", "attn")),
    )
