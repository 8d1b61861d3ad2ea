"""phi-3-vision-4.2b [vlm]: phi3-mini backbone 32L d_model=3072 32H
(GQA kv=32) d_ff=8192 vocab=32064 + CLIP frontend STUB (input_specs
supplies precomputed patch embeddings, 576 patches).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
    n_heads=32, n_kv=32, d_ff=8192, vocab=32064, n_patches=576,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=128,
    n_patches=8, attn_q_chunk=16, attn_kv_chunk=16)
