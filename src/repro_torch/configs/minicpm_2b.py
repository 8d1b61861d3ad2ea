"""minicpm-2b [dense]: 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753, llama-like arch; trained with the WSD schedule (wired to
optim.wsd_schedule via lr_schedule).  [arXiv:2404.06395; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense", n_layers=40, d_model=2304,
    n_heads=36, n_kv=36, d_ff=5760, vocab=122753, tie_embeddings=True,
    lr_schedule="wsd",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=72, n_heads=6, n_kv=6, d_ff=144, vocab=128,
    attn_q_chunk=16, attn_kv_chunk=16)
