"""Model configuration schema + registry for the assigned architectures.

Every field and default is the JAX package's, so a config compares field
for field.  ``remat`` selects each layer's rematerialisation in training
(``models.layers.remat``: "full" recomputes the layer in backward, "dots"
keeps its products' outputs, "none" keeps everything).  The port runs
eagerly with its layers looped in Python, so ``scan_layers`` and
``analysis_mode`` change nothing here; they stay for that parity."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.policy import PrecisionPolicy


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv: int = 0
    d_head: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False         # Qwen-style
    d_ff: int = 0
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba)
    mamba_version: int = 0         # 0 = none, 1 = mamba1, 2 = mamba2/SSD
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64         # mamba2 head dim P
    ssm_dt_rank: int = 0           # mamba1; 0 -> d_model // 16
    ssm_chunk: int = 128           # chunked-scan chunk length
    # hybrid (zamba2): shared attention block applied every k SSM layers
    shared_attn_every: int = 0
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_positions: int = 0         # fixed encoder sequence (stub frontend)
    # VLM (phi-3-vision): stub patch embeddings prepended to the text
    n_patches: int = 0
    # implementation knobs (perf levers)
    scan_layers: bool = True
    remat: str = "full"            # none | dots | full
    attn_impl: str = "chunked"     # chunked | block_causal | flash
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    moe_group: int = 4096          # tokens per MoE dispatch group
    lr_schedule: str = "cosine"    # cosine | wsd (MiniCPM) | constant
    # analysis mode (roofline extraction): XLA's HloCostAnalysis counts a
    # while-loop body ONCE, so scans hide flops/bytes.  In analysis mode all
    # inner chunk loops are python-unrolled and the layer stack is looped in
    # python; the dry-run lowers reduced layer counts and extrapolates.
    analysis_mode: bool = False
    policy: PrecisionPolicy = PrecisionPolicy()

    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long_500k? (SSM/hybrid decode is O(1)/token in
        state; hybrid shared-attn cache is sequence-sharded.)"""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True   # every assigned arch has a decode step (none enc-only)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


ARCH_IDS = [
    "zamba2_1p2b", "llama3_405b", "qwen1p5_0p5b", "minicpm_2b",
    "qwen1p5_110b", "falcon_mamba_7b", "grok1_314b", "granite_moe_3b",
    "phi3_vision_4p2b", "whisper_base",
]

# CLI ids (--arch) mapping to module names
ARCH_ALIASES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "llama3-405b": "llama3_405b",
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "minicpm-2b": "minicpm_2b",
    "qwen1.5-110b": "qwen1p5_110b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "grok-1-314b": "grok1_314b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "phi-3-vision-4.2b": "phi3_vision_4p2b",
    "whisper-base": "whisper_base",
}


def get_config(arch: str) -> ModelConfig:
    """Full-size config for an architecture id (module name or CLI alias)."""
    mod_name = ARCH_ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    mod_name = ARCH_ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE_CONFIG
