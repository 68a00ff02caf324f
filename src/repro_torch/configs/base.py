"""Architecture config schema + registry for the 10 assigned architectures.

Every assigned arch is a frozen ``ArchConfig`` in its own module; the
registry maps ``--arch <id>`` to it.  ``reduced()`` derives the tiny
same-family config the CPU parity tests instantiate; ``chip_smoke.py``
runs the full widths on the card (a copy of the reference's
``repro/configs/base.py``, field for field).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

ARCH_IDS = [
    "falcon-mamba-7b", "gemma-2b", "gemma2-27b", "gemma3-27b",
    "deepseek-coder-33b", "internvl2-26b", "seamless-m4t-large-v2",
    "zamba2-7b", "arctic-480b", "deepseek-moe-16b",
]

# shape name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k":    (4_096,   256, "train"),
    "prefill_32k": (32_768,  32,  "prefill"),
    "decode_32k":  (32_768,  128, "decode"),
    "long_500k":   (524_288, 1,   "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | ssm | hybrid | moe | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention pattern
    window: Optional[int] = None         # sliding-window size for local layers
    local_per_global: int = 0            # N local : 1 global; 0 = all-global
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    mlp: str = "swiglu"                  # swiglu | geglu
    # ssm (mamba)
    ssm_state: int = 0
    ssm_variant: Optional[str] = None    # mamba1 | mamba2
    d_inner: int = 0
    ssm_heads: int = 0                   # mamba2 heads
    conv_width: int = 4
    ssm_chunk: int = 128                 # chunked-associative-scan chunk
    # hybrid (zamba2): one *shared* attention block every k mamba blocks
    hybrid_attn_every: int = 0
    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_d_ff: int = 0                    # per-expert hidden size
    dense_residual: bool = False         # arctic: dense MLP in parallel w/ MoE
    first_dense_layers: int = 0          # deepseek-moe: leading dense layers
    first_dense_d_ff: int = 0
    # encoder-decoder
    n_enc_layers: int = 0
    # vlm / audio stubs
    n_frontend_tokens: int = 0           # patch/frame embeddings per sample
    frontend_dim: int = 0                # stub embedding dim (pre-projector)
    # misc
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    # which shapes this arch skips, and why (DESIGN.md §Arch-applicability)
    skip_shapes: tuple[str, ...] = ()

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def layer_windows(self, seq_len: int) -> list[int]:
        """Per-layer effective attention window (global = seq_len)."""
        if self.family in ("ssm",):
            return []
        out = []
        for i in range(self.n_layers):
            if self.local_per_global and (i + 1) % (self.local_per_global + 1) != 0:
                out.append(min(self.window or seq_len, seq_len))
            else:
                out.append(seq_len)
        return out


def get_config(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.CONFIG


def get_reduced(arch_id: str) -> ArchConfig:
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_"))
    return mod.reduced()
