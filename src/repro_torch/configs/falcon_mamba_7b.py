"""falcon-mamba-7b [arXiv:2410.05355; unverified]
64L d_model=4096 attention-free mamba-1, ssm_state=16, vocab=65024."""
from dataclasses import replace
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=65024, norm="rms",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
)

def reduced() -> ModelConfig:
    return replace(CONFIG, name="falcon-mamba-smoke", n_layers=2, d_model=64,
                   vocab=256, ssm=SSMConfig(d_state=8, d_conv=4, expand=2))
