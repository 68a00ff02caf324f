"""deepseek-moe-16b — fine-grained MoE: 64 routed top-6 + 2 shared experts
[arXiv:2401.06066].

28L, d_model=2048, 16H / 16 KV, per-expert d_ff=1408, vocab=102400.
Layer 0 is a dense FFN (d_ff=10944); layers 1..27 are MoE.  Pure full
attention -> long_500k skipped.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400, mlp="swiglu",
    n_experts=64, top_k=6, moe_d_ff=1408, n_shared_experts=2,
    first_dense_layers=1, first_dense_d_ff=10944, capacity_factor=1.25,
    skip_shapes=("long_500k",),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=64, vocab_size=256, n_experts=8, top_k=2,
        moe_d_ff=64, n_shared_experts=1, first_dense_layers=1,
        first_dense_d_ff=128)
