"""qwen1.5-110b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=49152
vocab=152064, QKV bias.  [hf:Qwen/Qwen1.5-110B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv=8, d_ff=49152, vocab=152064, qkv_bias=True,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=8, n_kv=2, d_ff=160, vocab=128,
    attn_q_chunk=16, attn_kv_chunk=16)
