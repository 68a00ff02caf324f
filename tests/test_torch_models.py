"""The port's language models against the reference, all 10 architectures.

Each reduced architecture (``get_reduced``, in float32) is drawn once by
the reference's ``M.init(cfg, PRNGKey(0))`` and carried into the port
with ``convert.model_params_from_numpy`` (never re-seeded); the same
numpy inputs then go through ``forward``, ``loss_fn``, ``prefill`` and
three teacher-forced ``decode_step``s of both packages, from one cache
(``convert.model_cache_from_numpy``).

Tolerances, as a share of the reference's largest magnitude in each
array (the reference's init draws every stacked weight with fan-in =
depth, so activations run to 1e8 and element-wise rtol is meaningless):
``TOL`` = 5e-5 for prefill/decode logits and every cache leaf, and
``TOL_FWD`` = 3e-4 for full-sequence logits: at one position of
seamless-m4t's forward both packages part from a float64 run of the
reference by up to 8e-5, and from each other by 1.3e-4.  The loss and
the MoE aux loss hold to rtol 1e-5.  The SSM scan needs no looser bound
(``tests/test_torch_model_parts.py`` holds it alone to 1e-6).

bfloat16, one architecture per family: the port's bf16 result may part
from the reference's f32 result by at most twice what the reference's
own bf16 result does, plus 1% (``BF16_FACTOR``, ``BF16_FLOOR``); the
port's ratio was at most 1.6 on these draws.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS, get_reduced
from repro.models import model as JM
from repro_torch import convert
from repro_torch.configs import get_reduced as t_get_reduced
from repro_torch.models import model as TM

from test_torch_ingest import one_torch_thread  # noqa: F401

B, S, STEPS = 2, 16, 3
TOL = 5e-5
TOL_FWD = 3e-4
BF16_FACTOR, BF16_FLOOR = 2.0, 0.01
BF16_ARCHS = ["gemma-2b", "deepseek-moe-16b", "internvl2-26b",
              "falcon-mamba-7b", "zamba2-7b", "seamless-m4t-large-v2"]


def _batch(cfg, seq=S):
    rng = np.random.default_rng(0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, seq))
           .astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.normal(
            size=(B, cfg.n_frontend_tokens, cfg.frontend_dim)
        ).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(
            size=(B, seq, cfg.frontend_dim)).astype(np.float32)
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _share(got, want) -> float:
    """max |got - want| as a share of max |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(cache):
    """A cache dict's leaves in the reference's tree order (sorted keys);
    the port's as copies (its later steps write the cache in place)."""
    if isinstance(cache, dict):
        return [x for k in sorted(cache) for x in _leaves(cache[k])]
    return [cache.clone() if isinstance(cache, torch.Tensor) else cache]


def _run_ref(cfg, params, batch, tokens):
    """forward, loss, prefill and teacher-forced decode of the reference."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    out["logits"], out["aux"] = jax.jit(
        lambda p, b: JM.forward(cfg, p, b, remat=False))(params, jb)
    out["loss"] = jax.jit(
        lambda p, b: JM.loss_fn(cfg, p, b, remat=False))(params, jb)
    prefix = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    cache = JM.init_cache(cfg, B, S + prefix + STEPS)
    out["cache0"] = jax.tree_util.tree_map(np.asarray, cache)
    out["prefill"], cache = jax.jit(
        lambda p, b, c: JM.prefill(cfg, p, b, c, remat=False))(
        params, jb, cache)
    out["prefill_cache"] = _leaves(cache)
    dec = jax.jit(lambda p, t, c, pos: JM.decode_step(cfg, p, t, c, pos))
    out["decode"] = []
    for i in range(STEPS):
        logits, cache = dec(params, jnp.asarray(tokens[i]), cache,
                            jnp.int32(S + prefix + i))
        out["decode"].append((logits, _leaves(cache)))
    return out


def _run_port(cfg, model, batch, tokens, cache0):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    out["logits"], out["aux"] = TM.forward(cfg, model, tb)
    out["loss"] = TM.loss_fn(cfg, model, tb)
    prefix = cfg.n_frontend_tokens if cfg.family == "vlm" else 0
    cache = convert.model_cache_from_numpy(cfg, cache0, "cpu")
    out["prefill"], cache = TM.prefill(cfg, model, tb, cache)
    out["prefill_cache"] = _leaves(cache)
    out["decode"] = []
    for i in range(STEPS):
        logits, cache = TM.decode_step(cfg, model,
                                       torch.from_numpy(tokens[i]), cache,
                                       S + prefix + i)
        out["decode"].append((logits, _leaves(cache)))
    return out


def _tokens(cfg):
    rng = np.random.default_rng(1)
    return [rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
            for _ in range(STEPS)]


@pytest.fixture(scope="module", params=ARCH_IDS)
def twins(request):
    cfg = dataclasses.replace(get_reduced(request.param), dtype="float32")
    params = JM.init(cfg, jax.random.PRNGKey(0))
    model = convert.model_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, params), "cpu")
    batch, tokens = _batch(cfg), _tokens(cfg)
    ref = _run_ref(cfg, params, batch, tokens)
    port = _run_port(cfg, model, batch, tokens, ref["cache0"])
    return cfg, ref, port


def test_config_copies_match_reference(twins):
    cfg, _, _ = twins
    assert dataclasses.asdict(t_get_reduced(cfg.name)) == \
        dataclasses.asdict(get_reduced(cfg.name))


def test_forward_matches_reference(twins):
    cfg, ref, port = twins
    assert _share(port["logits"], ref["logits"]) <= TOL_FWD
    np.testing.assert_allclose(float(port["aux"]), float(ref["aux"]),
                               rtol=1e-5, atol=1e-6)


def test_loss_matches_reference(twins):
    _, ref, port = twins
    np.testing.assert_allclose(float(port["loss"]), float(ref["loss"]),
                               rtol=1e-5)


def test_prefill_logits_and_cache_match_reference(twins):
    _, ref, port = twins
    assert _share(port["prefill"], ref["prefill"]) <= TOL
    assert len(port["prefill_cache"]) == len(ref["prefill_cache"])
    for got, want in zip(port["prefill_cache"], ref["prefill_cache"]):
        assert _share(got, want) <= TOL


def test_decode_steps_match_reference(twins):
    _, ref, port = twins
    for (pl, pc), (rl, rc) in zip(port["decode"], ref["decode"]):
        assert _share(pl, rl) <= TOL
        for got, want in zip(pc, rc):
            assert str(got.dtype).split(".")[-1] == str(want.dtype)
            assert _share(got, want) <= TOL


def _outputs(out):
    return [out["logits"], out["prefill"]] + [l for l, _ in out["decode"]]


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bfloat16_within_the_references_own_bf16_error(arch):
    cfg16 = get_reduced(arch)
    assert cfg16.dtype == "bfloat16"
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    p16 = JM.init(cfg16, jax.random.PRNGKey(0))
    p32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), p16)
    batch, tokens = _batch(cfg16), _tokens(cfg16)
    ref16 = _run_ref(cfg16, p16, batch, tokens)
    ref32 = _run_ref(cfg32, p32, batch, tokens)
    model = convert.model_params_from_numpy(
        cfg16, jax.tree_util.tree_map(np.asarray, p16), "cpu")
    port16 = _run_port(cfg16, model, batch, tokens, ref16["cache0"])
    assert port16["logits"].dtype == torch.bfloat16
    for got, own, want in zip(_outputs(port16), _outputs(ref16),
                              _outputs(ref32)):
        assert _share(got, want) <= (BF16_FACTOR * _share(own, want)
                                     + BF16_FLOOR)
