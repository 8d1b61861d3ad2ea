"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256.  GQA + 128k vocab.  [arXiv:2407.21783; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense", n_layers=126, d_model=16384,
    n_heads=128, n_kv=8, d_head=128, d_ff=53248, vocab=128256,
    rope_theta=5e5,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv=2, d_head=8, d_ff=160,
    vocab=128, attn_q_chunk=16, attn_kv_chunk=16)
