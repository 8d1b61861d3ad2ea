"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2.  [hf:xai-org/grok-1; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv=8, d_head=128, d_ff=32768, vocab=131072,
    n_experts=8, top_k=2,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_head=16, d_ff=96,
    vocab=128, n_experts=4, top_k=2, moe_group=64,
    attn_q_chunk=16, attn_kv_chunk=16)
