"""internvl2-26b — InternViT frontend (STUB) + InternLM2-20B backbone
[arXiv:2404.16821].

Backbone: 48L, d_model=6144, 48H / 8 KV, d_ff=16384, vocab=92553.
The vision tower is a stub per the brief: ``input_specs()`` provides
precomputed patch embeddings (256 tokens, InternViT hidden 3200) which a
learned projector maps into d_model.  Pure full attention -> long_500k
skipped.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553, mlp="swiglu",
    n_frontend_tokens=256, frontend_dim=3200,
    skip_shapes=("long_500k",),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256,
        n_frontend_tokens=8, frontend_dim=32)
