"""The analytic roofline of a training or serving step, on one H100.

Port of ``repro/launch/roofline.py``'s analytic half, for the card:

    compute term    = FLOPs       / (chips × 989e12 FLOP/s)    [dense bf16]
    memory term     = HBM bytes   / (chips × 3.35e12 B/s)      [HBM3]
    collective term = coll bytes  / (chips × 450e9 B/s)        [NVLink]

The constants are the NVIDIA H100 SXM's data-sheet figures (dense rates,
no sparsity; NVLink's 900 GB/s is 450 GB/s each way), at its full 700 W
power limit.  ``count_params``, ``model_flops`` (6·N_active·D for
training, 2·N_active·D for a forward) and ``analytic_hbm_bytes`` are the
reference's arithmetic on the same ``ArchConfig`` fields, so they give
the reference's numbers; only the constants differ.  The reference's
HLO half reads XLA's compiled text; here ``collective_bytes`` takes the
collectives' tally of a step's run and ``analyze`` its per-rank counts
(``launch.op_walk``), which it multiplies by the chips, as the
reference multiplies its walker's per-device totals.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# NVIDIA H100 SXM per-card constants (data sheet)
PEAK_FLOPS = 989e12       # dense bf16
HBM_BW = 3.35e12          # bytes/s
LINK_BW = 450e9           # bytes/s, NVLink each way
HBM_PER_CARD = 80 * 10 ** 9  # bytes: the H100 SXM 80GB data sheet's 80 GB

# the reference's collective kinds (HLO op names) by the port's
# ``models.parallel.BYTES`` keys; ``broadcast`` has no HLO op of its own
KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "broadcast": "broadcast"}


@dataclasses.dataclass
class RooflineTerms:
    flops: float
    hbm_bytes: float
    coll_bytes: float
    coll_breakdown: dict
    chips: int
    model_flops: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * LINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> Optional[float]:
        if not self.model_flops or not self.flops:
            return None
        return self.model_flops / self.flops

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
        }


def collective_bytes(tally: dict) -> dict[str, int]:
    """The collectives' result bytes by the reference's kind
    (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``, and ``broadcast``) from a tally keyed as
    ``models.parallel.BYTES``."""
    out = {k: 0 for k in ("all-gather", "all-reduce", "reduce-scatter",
                          "all-to-all", "collective-permute")}
    for k, v in tally.items():
        kind = KINDS[k]
        out[kind] = out.get(kind, 0) + int(v)
    return out


def analyze(walked: dict, chips: int, model_flops: Optional[float] = None,
            hbm_bytes: Optional[float] = None) -> RooflineTerms:
    """``RooflineTerms`` of a step from one rank's counts (``op_walk``:
    its ``dot_flops`` and ``kernel_flops``, its collectives' bytes),
    times ``chips`` (every rank runs the same program; the terms hold
    global quantities and divide by chips x the per-card peaks), with
    ``hbm_bytes`` from the analytic traffic model (``analytic_hbm_bytes``;
    0 when not given: an eager run has no byte counter of its own)."""
    coll = {k: float(v) * chips for k, v in
            collective_bytes(walked["collectives"]).items()}
    flops = (float(walked["dot_flops"])
             + float(walked.get("kernel_flops", 0.0))) * chips
    return RooflineTerms(flops=flops, hbm_bytes=float(hbm_bytes or 0.0),
                         coll_bytes=float(sum(coll.values())),
                         coll_breakdown=coll, chips=chips,
                         model_flops=model_flops)


# --------------------------------------------------------------------------
# analytic MODEL_FLOPS per arch × shape
# --------------------------------------------------------------------------

def count_params(cfg, active_only: bool = False) -> float:
    """Analytic parameter count (active experts only when requested)."""
    d, v = cfg.d_model, cfg.vocab_size
    emb = v * d
    att = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim * d \
        + cfg.n_heads * cfg.head_dim * d
    mlp = 3 * d * cfg.d_ff
    if cfg.family in ("dense", "vlm"):
        layer = att + mlp
        total = emb + cfg.n_layers * layer
        if cfg.family == "vlm":
            total += cfg.frontend_dim * d
    elif cfg.family == "moe":
        e = cfg.top_k if active_only else cfg.n_experts
        moe = e * 3 * d * cfg.moe_d_ff
        moe += cfg.n_shared_experts * 3 * d * cfg.moe_d_ff
        if cfg.dense_residual:
            moe += 3 * d * cfg.d_ff
        n_moe = cfg.n_layers - cfg.first_dense_layers
        total = emb + n_moe * (att + moe) + cfg.first_dense_layers * (
            att + 3 * d * (cfg.first_dense_d_ff or cfg.d_ff))
    elif cfg.family == "ssm":
        di, n = cfg.d_inner, cfg.ssm_state
        dt_rank = max(d // 16, 1)
        layer = (d * 2 * di + di * cfg.conv_width
                 + di * (dt_rank + 2 * n) + dt_rank * di + di * n + di
                 + di * d)
        total = emb + cfg.n_layers * layer
    elif cfg.family == "hybrid":
        di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        layer = (d * (2 * di + 2 * n + nh) + (di + 2 * n) * cfg.conv_width
                 + 2 * nh + di + di * d)
        shared = att + mlp
        total = emb + cfg.n_layers * layer + shared
    elif cfg.family == "encdec":
        total = emb + cfg.frontend_dim * d \
            + cfg.n_enc_layers * (att + mlp) \
            + cfg.n_layers * (2 * att + mlp)
    else:
        raise ValueError(cfg.family)
    return float(total)


def model_flops(cfg, shape_kind: str, seq_len: int, global_batch: int
                ) -> float:
    """6·N_active·D for train, 2·N_active·D for prefill, 2·N_active·B for
    one decode token."""
    n_active = count_params(cfg, active_only=True)
    if shape_kind == "train":
        return 6.0 * n_active * seq_len * global_batch
    if shape_kind == "prefill":
        return 2.0 * n_active * seq_len * global_batch
    return 2.0 * n_active * global_batch     # decode: one token


def _cache_bytes(cfg, seq_len: int, batch: int) -> float:
    """Decode-state bytes (KV cache / SSM state), global."""
    if cfg.family == "ssm":
        return float(batch * cfg.n_layers
                     * (cfg.d_inner * cfg.ssm_state * 4         # ssm f32
                        + (cfg.conv_width - 1) * cfg.d_inner * 2))
    kv = (cfg.n_layers * batch * seq_len * cfg.n_kv_heads * cfg.head_dim
          * 2 * 2)                                              # K+V bf16
    if cfg.family == "hybrid":
        g = cfg.n_layers // cfg.hybrid_attn_every
        kv = (g * batch * seq_len * cfg.n_kv_heads * cfg.head_dim * 2 * 2
              + batch * cfg.n_layers * cfg.d_inner * cfg.ssm_state * 4)
    if cfg.family == "encdec":
        kv *= 2   # self + cross
    return float(kv)


def analytic_hbm_bytes(cfg, shape_kind: str, seq_len: int,
                       global_batch: int) -> float:
    """Analytic GLOBAL HBM traffic per step.

    Explicit, documented approximation (XLA's byte counter shares the
    scan-body undercount, so it cannot be used):

      train   = params·(2 read fwd + 2 read remat-fwd + 2 read bwd
                        + 2 write grad + 2·m opt-read + 2·m opt-write
                        + 2 read + 2 write param update)
                + activations: tokens·d_model·2B · L · c   (c≈12: residual
                  read/write, qkv/mlp internals, flash rescan)
                + logits: 2 · T·V·2B (write fwd + read bwd)
      prefill = params·2 + activations(c≈6) + cache write
      decode  = params·2 + full cache read+write + tiny activations
    """
    p = count_params(cfg, active_only=False)
    t = float(seq_len * global_batch)
    d = cfg.d_model
    v = cfg.vocab_size
    if shape_kind == "train":
        mom = 4 if getattr(cfg, "name", "") != "arctic-480b" else 2
        param_traffic = p * (2 + 2 + 2 + 2 + 2 * mom + 2 * mom + 2 + 2)
        act = t * d * 2 * cfg.n_layers * 12
        logits = 2 * t * v * 2
        return float(param_traffic + act + logits)
    if shape_kind == "prefill":
        return float(p * 2 + t * d * 2 * cfg.n_layers * 6
                     + _cache_bytes(cfg, seq_len, global_batch))
    # decode: weights + cache dominate
    return float(p * 2 + 2 * _cache_bytes(cfg, seq_len, global_batch)
                 + global_batch * d * 2 * cfg.n_layers * 8)
