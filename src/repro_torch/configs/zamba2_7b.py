"""zamba2-7b — Mamba-2 backbone + shared attention blocks [arXiv:2411.15242].

81 mamba2 layers (d_model=3584, d_inner=7168, state=64, 112 SSM heads of
dim 64) with ONE weight-shared attention+MLP block applied every 6 mamba
layers (32H / 32 KV, d_ff=14336).  Runs long_500k (hybrid: SSM carries
long context; shared-attn KV is the only per-token cache).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000, mlp="swiglu",
    ssm_variant="mamba2", ssm_state=64, d_inner=7168, ssm_heads=112,
    conv_width=4, ssm_chunk=128, hybrid_attn_every=6,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256,
        d_inner=128, ssm_state=4, ssm_heads=4, ssm_chunk=16,
        hybrid_attn_every=2)
