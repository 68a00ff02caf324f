"""gemma3-27b — 5:1 local:global, 128k context [hf:google/gemma-3 family].

62L, d_model=5376, 32H / 16 KV, d_ff=21504, vocab=262144, window 1024.
Softcaps removed in gemma3 (QK-norm instead; we keep plain scaling).
Runs long_500k: 5/6 of layers are sliding-window.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab_size=262144, mlp="geglu",
    window=1024, local_per_global=5, rope_theta=1_000_000.0,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, window=16)
