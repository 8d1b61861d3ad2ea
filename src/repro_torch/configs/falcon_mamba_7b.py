"""falcon-mamba-7b [ssm]: 64L d_model=4096, attention-free Mamba-1,
ssm_state=16, vocab=65024.  [arXiv:2410.05355; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    d_ff=0, vocab=65024, mamba_version=1, ssm_state=16, ssm_expand=2,
    ssm_conv=4,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=3, d_model=64, vocab=128, ssm_state=8, ssm_chunk=8)
