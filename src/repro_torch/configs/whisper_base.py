"""whisper-base [audio]: enc-dec, 6L encoder + 6L decoder, d_model=512,
8H, d_ff=2048, vocab=51865.  Conv frontend is a STUB (input_specs gives
precomputed frame embeddings, 1500 positions).  [arXiv:2212.04356]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec", n_layers=6, enc_layers=6,
    d_model=512, n_heads=8, n_kv=8, d_ff=2048, vocab=51865,
    enc_positions=1500,
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, enc_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
    vocab=128, enc_positions=32, attn_q_chunk=16, attn_kv_chunk=16)
