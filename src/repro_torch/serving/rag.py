"""RAG pipeline: catapult-accelerated retrieval feeding LM generation.

Port of ``repro/serving/rag.py``.  Query embeddings hit the vector
index; retrieved context is prepended to the prompt; the LM decodes.
The retrieval layer is a ``repro_torch.db`` database in any mode/tier,
on the model's device: swapping 'diskann' for 'catapult' (or RAM for
disk) in the ``IndexSpec`` accelerates or re-tiers the retrieval stage
transparently.

Embeddings come from the LM's own token-embedding table (mean-pooled) —
a deliberately simple encoder so the pipeline is self-contained.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import db as catapultdb
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M


@torch.no_grad()
def embed_texts(cfg: ArchConfig, params, token_batches: np.ndarray
                ) -> np.ndarray:
    """(N, S) int tokens -> (N, d_model) mean-pooled f32 embeddings."""
    table = params.embed.table
    toks = torch.as_tensor(np.asarray(token_batches)).long().to(table.device)
    return table[toks].float().mean(dim=1).cpu().numpy()


@dataclasses.dataclass
class RagPipeline:
    cfg: ArchConfig
    params: object
    engine: catapultdb.Database      # the retrieval database (any tier)
    corpus_tokens: np.ndarray        # (N, S_doc) int32 document tokens

    @classmethod
    def build(cls, cfg, params, corpus_tokens, *, mode=None,
              spec: Optional[catapultdb.IndexSpec] = None, seed=None):
        """``mode``/``seed`` are the shorthand spelling, ``spec`` the
        full one — exclusive, so a passed spec can never silently
        outvote an explicitly requested mode.  The database lives on the
        model's device."""
        if spec is not None and (mode is not None or seed is not None):
            raise TypeError("pass either spec= or mode=/seed=, not both")
        vecs = embed_texts(cfg, params, corpus_tokens)
        spec = spec or catapultdb.IndexSpec(mode=mode or "catapult",
                                            degree=16, build_beam=32,
                                            seed=seed or 0)
        db = catapultdb.create(spec, vecs.astype(np.float32),
                               device=params.device)
        return cls(cfg=cfg, params=params, engine=db,
                   corpus_tokens=corpus_tokens)

    def retrieve(self, query_tokens: np.ndarray, k: int = 2,
                 beam_width: int = 8):
        """(B, S_q) queries -> (B, k) doc ids + search stats."""
        qvecs = embed_texts(self.cfg, self.params, query_tokens)
        ids, _, stats = self.engine.search(qvecs, k=k, beam_width=beam_width)
        return ids, stats

    @torch.no_grad()
    def answer(self, query_tokens: np.ndarray, k: int = 2,
               max_new_tokens: int = 8):
        """Retrieve-then-generate.  Returns (generated (B, T), doc ids,
        retrieval stats)."""
        doc_ids, stats = self.retrieve(query_tokens, k=k)
        b = query_tokens.shape[0]
        ctx = self.corpus_tokens[np.maximum(doc_ids, 0)]      # (B, k, S_doc)
        ctx = ctx.reshape(b, -1)
        prompt = np.concatenate([ctx, query_tokens], axis=1).astype(np.int32)

        s = prompt.shape[1]
        dev = self.params.device
        cache = M.init_cache(self.cfg, b, s + max_new_tokens, dev)
        logits, cache = M.prefill(
            self.cfg, self.params,
            {"tokens": torch.as_tensor(prompt).to(dev)}, cache)
        toks = [logits[:, -1:].argmax(-1).to(torch.int32)]
        for i in range(max_new_tokens - 1):
            logits, cache = M.decode_step(self.cfg, self.params, toks[-1],
                                          cache, s + i)
            toks.append(logits[:, -1:].argmax(-1).to(torch.int32))
        return torch.cat(toks, dim=1).cpu().numpy(), doc_ids, stats
