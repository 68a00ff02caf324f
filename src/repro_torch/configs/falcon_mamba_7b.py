"""falcon-mamba-7b — attention-free Mamba-1 LM [arXiv:2410.05355].

64L, d_model=4096, d_inner=8192, ssm_state=16, vocab=65024.
Runs long_500k: SSM state is O(1) in context length.
"""
import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, head_dim=1,
    d_ff=0, vocab_size=65024,
    ssm_variant="mamba1", ssm_state=16, d_inner=8192, conv_width=4,
    ssm_chunk=128,
)


def reduced() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, n_layers=2, d_model=64, d_inner=128, ssm_state=4,
        vocab_size=256, ssm_chunk=16)
