"""nemotron-4-15b [arXiv:2402.16819; unverified]
32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000, squared-ReLU, LN."""
from dataclasses import replace
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=24576, vocab=256000, act="sqrelu", norm="ln",
)

def reduced() -> ModelConfig:
    return replace(CONFIG, name="nemotron-smoke", n_layers=2, d_model=96,
                   n_heads=6, n_kv_heads=2, d_ff=192, vocab=256)
