"""seamless-m4t-large-v2 — encoder-decoder, audio frontend STUB
[arXiv:2308.11596].

24L encoder + 24L decoder, d_model=1024, 16H (kv=16 — full MHA),
d_ff=8192, vocab=256206.  The w2v-BERT speech frontend is a stub:
``input_specs()`` provides precomputed frame embeddings (dim 1024).
Adaptation notes (DESIGN.md): gated GeGLU MLP in place of the original
plain FFN; RoPE on self-attention in place of learned positions.
Enc-dec with full attention -> long_500k skipped; decode shapes run
(it has a decoder).
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=8192, vocab_size=256206, mlp="geglu",
    frontend_dim=1024,
    skip_shapes=("long_500k",),
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        frontend_dim=32)
