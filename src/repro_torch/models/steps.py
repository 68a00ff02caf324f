"""Train, eval and serve steps — the units the launchers call.

Port of ``repro/models/steps.py``:

``make_train_step(cfg)``   -> step(model, opt_state, batch) ->
                              (model, opt_state, metrics)
``make_eval_step(cfg)``    -> step(params, batch) -> loss
``make_prefill_step(cfg)`` -> step(params, batch, cache) -> (logits, cache)
``make_decode_step(cfg)``  -> step(params, tokens, cache, pos) ->
                              (logits, cache)

The steps close over the (frozen) ``ArchConfig``.  The train step takes
the loss and every parameter's gradient through autograd (the
reference's ``jax.value_and_grad(M.loss_fn)``, with its remat points),
then ``adamw.update``, which writes the parameters in place; ``metrics``
holds ``loss``, ``grad_norm`` (0-d tensors on the model's device) and
``lr``.  The eval and serve steps run without autograd.

Across ranks (``groups``, ``zero1``: ``launch.train``'s ``RankPlan``)
the loss and its backward run under ``parallel_context(groups)`` (the
models' tensor-parallel collectives, the global mean), then the
gradients are summed over the batch axes by bucketed ``all_reduce``s
(``parallel.all_reduce_buckets``; ``loss_and_grads``), and
``adamw.update`` takes each rank's ZeRO-1 slices.  The serve steps take
the same ``groups``: prefill and decode then run on the rank's slices,
its rows of the batch and its block of the cache (``M.init_cache(...,
mesh=)``), and return its vocab columns of the logits.  The FSDP leaves
(a spec that splits over ``data``: the MoE experts' ``wi``/``wo``) are
left out of those ``all_reduce``s: the layer regathers them with
``gather_from_data``, whose backward reduce-scatters their gradient
over ``data`` already (over ``pod`` too, where there is one, they are
then summed apart), so the buckets would count it ``data`` times.  A
bucketed ``all_reduce``, not a reduce-scatter into the ZeRO-1 slices:
those slices lie along dim 0 of some leaves and along dim 1 of others
(``wo``, the embedding table), so a reduce-scatter would first copy
every gradient into a packed layout, and the backward pass holds every
full gradient anyway.  Replicated leaves (norm gammas, ``final_norm``)
need no reduction over ``model``: their inputs and output gradients are
the same on every model rank, so their gradients are, bit for bit (a
replicated leaf that a rank uses only in part, as mamba2's ``a_log``,
passes ``copy_to_model`` in the model, which sums it).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models import parallel as par
from repro_torch.models.layers import pspecs_from_decl
from repro_torch.optim import adamw


def _fsdp_leaves(model) -> set:
    """The names of ``model``'s parameters whose spec splits over
    ``data`` (the FSDP leaves)."""
    return {name for name, spec in pspecs_from_decl(model).items()
            if any(e == "data" or (isinstance(e, tuple) and "data" in e)
                   for e in spec)}


def loss_and_grads(cfg: ArchConfig, model, batch, *, remat: bool = True,
                   groups: par.Groups | None = None):
    """(the loss, {name: gradient}) of ``model`` on ``batch``; across
    ranks each gradient is the rank's slice's, summed over the batch
    axes."""
    params = dict(model.named_parameters())
    with par.parallel_context(groups):
        loss = M.loss_fn(cfg, model, batch, remat=remat)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
    if groups is not None:
        fsdp = _fsdp_leaves(model)
        par.all_reduce_buckets([g for n, g in grads.items()
                                if n not in fsdp], groups.batch)
        if groups.pod is not None and groups.fsdp is None:
            par.all_reduce_buckets([grads[n] for n in sorted(fsdp)],
                                   groups.pod)
    return loss, grads


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig | None = None,
                    *, remat: bool = True, groups: par.Groups | None = None,
                    zero1: adamw.Zero1 | None = None):
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def step(model, opt_state, batch):
        loss, grads = loss_and_grads(cfg, model, batch, remat=remat,
                                     groups=groups)
        _, opt_state, metrics = adamw.update(
            opt_cfg, grads, opt_state, dict(model.named_parameters()),
            zero1)
        del grads
        return model, opt_state, dict(metrics, loss=loss.detach())

    return step


def make_eval_step(cfg: ArchConfig):
    @torch.no_grad()
    def step(params, batch):
        return M.loss_fn(cfg, params, batch)
    return step


def make_prefill_step(cfg: ArchConfig, *, groups: par.Groups | None = None):
    @torch.no_grad()
    def step(params, batch, cache):
        with par.parallel_context(groups):
            return M.prefill(cfg, params, batch, cache)
    return step


def make_decode_step(cfg: ArchConfig, *, groups: par.Groups | None = None):
    @torch.no_grad()
    def step(params, tokens, cache, pos):
        with par.parallel_context(groups):
            return M.decode_step(cfg, params, tokens, cache, pos)
    return step
