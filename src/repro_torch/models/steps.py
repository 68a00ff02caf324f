"""Serve and eval steps — the units the serving engine and launchers call.

Port of ``repro/models/steps.py``'s inference half:

``make_prefill_step(cfg)`` -> step(params, batch, cache) -> (logits, cache)
``make_decode_step(cfg)``  -> step(params, tokens, cache, pos) ->
                              (logits, cache)
``make_eval_step(cfg)``    -> step(params, batch) -> loss

The steps close over the (frozen) ``ArchConfig`` and run without
autograd.  ``make_train_step`` needs ``optim/`` and the port's backward
pass, and comes with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M


def make_eval_step(cfg: ArchConfig):
    @torch.no_grad()
    def step(params, batch):
        return M.loss_fn(cfg, params, batch)
    return step


def make_prefill_step(cfg: ArchConfig):
    @torch.no_grad()
    def step(params, batch, cache):
        return M.prefill(cfg, params, batch, cache)
    return step


def make_decode_step(cfg: ArchConfig):
    @torch.no_grad()
    def step(params, tokens, cache, pos):
        return M.decode_step(cfg, params, tokens, cache, pos)
    return step
