"""qwen3-1.7b [hf:Qwen/Qwen3-8B; hf]
28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936, qk_norm."""
from dataclasses import replace
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab=151936, act="swiglu", norm="rms",
    qk_norm=True, head_dim=128, rope_theta=1e6,
)

def reduced() -> ModelConfig:
    return replace(CONFIG, name="qwen3-smoke", n_layers=2, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, head_dim=16)
