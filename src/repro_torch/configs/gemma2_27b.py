"""gemma2-27b — 1:1 local:global alternation + logit softcaps [arXiv:2408.00118].

46L, d_model=4608, 32H / 16 KV, d_ff=36864, vocab=256000, window 4096,
attn softcap 50, final logit softcap 30.  Runs long_500k: half the layers
are sliding-window; global layers are linear-in-S at decode.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000, mlp="geglu",
    window=4096, local_per_global=1,
    attn_softcap=50.0, logit_softcap=30.0,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, window=16)
