"""arctic-480b — dense-MoE hybrid: 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base].

35L, d_model=7168, 56H / 8 KV, per-expert d_ff=4864, vocab=32000.
Every layer = attention + (dense residual MLP ∥ MoE).  Pure full
attention -> long_500k skipped.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000, mlp="swiglu",
    n_experts=128, top_k=2, moe_d_ff=4864, dense_residual=True,
    capacity_factor=1.25,
    skip_shapes=("long_500k",),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=96, vocab_size=256, n_experts=8, top_k=2,
        moe_d_ff=96)
