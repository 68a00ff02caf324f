"""The port's LM serving path against the reference's.

``ServingEngine`` (continuous batching), ``RagPipeline`` (catapult
retrieval in front of generation) and the ``launch/serve`` driver, on
reduced configs.  Parameters come from the reference's
``M.init(cfg, PRNGKey(s))`` through ``convert.model_params_from_numpy``;
the retrieval database's graph, LSH planes and bucket tables are the
reference's, carried into the port by ``test_torch_ingest``'s ``hooked``
fixture (both factories' ``_build_engine`` hooked).  Generated tokens
and doc ids must be exactly equal.

The reference's slot clobbering is reproduced in both packages: a decode
call writes every slot's K/V (or advances every slot's SSM state) at one
offset, so requests served together decode other tokens than each served
alone.
"""
from __future__ import annotations

import dataclasses
import re
import sys

import jax
import numpy as np
import pytest

from repro.configs.base import get_reduced
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.rag import RagPipeline as JRagPipeline
from repro_torch import convert
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.serving.engine import Request as TRequest
from repro_torch.serving.engine import ServingEngine as TServingEngine
from repro_torch.serving.rag import RagPipeline as TRagPipeline

from test_torch_ingest import hooked, one_torch_thread  # noqa: F401


def _twin_params(cfg, seed=0):
    params = JM.init(cfg, jax.random.PRNGKey(seed))
    return params, convert.model_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, params), "cpu")


def _f32(arch):
    return dataclasses.replace(get_reduced(arch), dtype="float32")


def _serve(engine_cls, request_cls, cfg, params, prompts, *, slots,
           max_len, max_new, eos_id=-1):
    eng = engine_cls(cfg, params, slots=slots, max_len=max_len,
                     eos_id=eos_id)
    done = eng.run([request_cls(prompt=p, max_new_tokens=max_new)
                    for p in prompts])
    return [(len(r.prompt), r.out.tolist()) for r in done]


@pytest.mark.parametrize("arch", ["gemma-2b", "falcon-mamba-7b"])
def test_serving_engine_tokens_equal_reference(arch):
    cfg = _f32(arch)
    jp, tp = _twin_params(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, n) for n in (6, 6, 5, 7)]
    kw = dict(slots=2, max_len=24, max_new=5, eos_id=1)
    want = _serve(JServingEngine, JRequest, cfg, jp, prompts, **kw)
    got = _serve(TServingEngine, TRequest, cfg, tp, prompts, **kw)
    assert got == want
    assert len(got) == len(prompts)


def test_slot_clobbering_quirk_in_both_packages():
    """Prompts of 6, 9 and 4 tokens, 2 slots, 6 new tokens: served
    together, the 6- and 9-token requests decode other tokens than each
    served alone — in the reference and in the port alike."""
    cfg = _f32("gemma-2b")
    jp, tp = _twin_params(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, n) for n in (6, 9, 4)]
    kw = dict(slots=2, max_len=32, max_new=6)
    out = {}
    for name, eng, req, params in (("ref", JServingEngine, JRequest, jp),
                                   ("port", TServingEngine, TRequest, tp)):
        together = dict(_serve(eng, req, cfg, params, prompts, **kw))
        alone = dict(_serve(eng, req, cfg, params, [p], **kw)[0]
                     for p in prompts)
        out[name] = (together, alone)
        assert sorted(together) == [4, 6, 9]
        assert all(len(t) == 7 for t in together.values())
        assert together[6] != alone[6] and together[9] != alone[9], name
    assert out["port"] == out["ref"]


def _rag_corpus(cfg):
    rng = np.random.default_rng(2)
    return np.stack([
        np.concatenate([np.full(4, 2 + (i % 8)),
                        rng.integers(2, cfg.vocab_size, 4)])
        for i in range(128)]).astype(np.int32)


def test_rag_pipeline_doc_ids_and_tokens_equal_reference(hooked):
    cfg = _f32("gemma-2b")
    jp, tp = _twin_params(cfg, seed=1)
    corpus = _rag_corpus(cfg)
    ref = JRagPipeline.build(cfg, jp, corpus, mode="catapult")
    port = TRagPipeline.build(cfg, tp, corpus, mode="catapult")
    queries = corpus[:4, :6].astype(np.int32)
    for _ in range(2):              # the second pass rides the catapults
        want_out, want_ids, want_stats = ref.answer(queries, k=2,
                                                    max_new_tokens=4)
        got_out, got_ids, got_stats = port.answer(queries, k=2,
                                                  max_new_tokens=4)
        np.testing.assert_array_equal(got_ids, np.asarray(want_ids))
        np.testing.assert_array_equal(got_out, np.asarray(want_out))
        np.testing.assert_array_equal(np.asarray(got_stats.used),
                                      np.asarray(want_stats.used))
    assert got_out.shape == (4, 4) and got_out.dtype == np.int32
    assert float(np.mean(got_stats.used)) > 0.5


def _lines(text):
    return [ln for ln in text.splitlines() if re.match(r"\[serve\] req ", ln)]


@pytest.mark.parametrize("rag", [False, True])
def test_launch_serve_prints_the_references_tokens(rag, hooked, monkeypatch,
                                                   capsys):
    """``python -m repro_torch.launch.serve --arch gemma-2b --reduced
    --device cpu`` with the reference's ``PRNGKey(0)`` parameters
    transplanted in place of the port's own draw.  Both drivers run the
    reduced config in float32 (``get_reduced`` patched alike in both):
    in bfloat16 a near-tie of the greedy argmax parts the RAG answers
    after a few tokens (bf16 is held by ``test_torch_models.py``)."""
    def transplanted(cfg, generator=None, device="cuda"):
        return convert.model_params_from_numpy(
            cfg, jax.tree_util.tree_map(
                np.asarray, JM.init(cfg, jax.random.PRNGKey(0))), device)

    monkeypatch.setattr(TM, "init", transplanted)
    for mod in (jserve, tserve):
        monkeypatch.setattr(mod, "get_reduced", _f32)
    args = ["--arch", "gemma-2b", "--reduced"] + (["--rag"] if rag else [])
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jserve.main()
    want = capsys.readouterr().out
    tserve.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _lines(got) == _lines(want) and len(_lines(got)) == 6
    if rag:
        assert got.splitlines()[-1] == want.splitlines()[-1]
