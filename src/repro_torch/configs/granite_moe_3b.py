"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
(per expert) vocab=49155, MoE 40 experts top-8 — fine-grained experts.
[hf:ibm-granite/granite-3.0-3b-a800m-base; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv=8, d_head=64, d_ff=512, vocab=49155,
    n_experts=40, top_k=8, tie_embeddings=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=48, n_heads=4, n_kv=2, d_head=12, d_ff=32,
    vocab=128, n_experts=8, top_k=4, moe_group=64,
    attn_q_chunk=16, attn_kv_chunk=16)
