"""gemma-2b — dense MQA decoder, GeGLU, head_dim=256 [arXiv:2403.08295].

18L, d_model=2048, 8 heads / 1 KV head (MQA), d_ff=16384, vocab=256000.
Pure global attention -> long_500k skipped (DESIGN.md §Arch-applicability).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000, mlp="geglu",
    skip_shapes=("long_500k",),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        head_dim=16, d_ff=128, vocab_size=256)
