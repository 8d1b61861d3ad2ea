"""zamba2-1.2b [hybrid]: Mamba-2 backbone + ONE shared attention block
(invoked every 6 SSM layers).  38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64.  [arXiv:2411.15242; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv=32, d_ff=8192, vocab=32000,
    mamba_version=2, ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    shared_attn_every=6, tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=5, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=128,
    ssm_state=16, ssm_head_dim=16, shared_attn_every=2, ssm_chunk=8,
    attn_q_chunk=16, attn_kv_chunk=16)
