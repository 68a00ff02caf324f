"""deepseek-coder-33b — llama-arch dense decoder [arXiv:2401.14196].

62L, d_model=7168, 56H / 8 KV (GQA), d_ff=19200, vocab=32256, SwiGLU,
rope theta 100k (16k context).  Pure full attention -> long_500k skipped.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=19200, vocab_size=32256, mlp="swiglu", rope_theta=100_000.0,
    skip_shapes=("long_500k",),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
        head_dim=8, d_ff=160, vocab_size=256)
