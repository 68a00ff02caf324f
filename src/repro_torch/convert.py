"""Carry the reference package's state across to the port.

The port cannot replay ``jax.random``, so state that the reference drew
from it is transplanted instead of reseeded.  Everything here takes
plain numpy (the caller extracts it from the reference) and returns the
port's state on a given device:

* the catapult layer: LSH hyperplanes + bucket tables in the reference's
  ``buckets.to_arrays`` schema (``ids``/``stamp``/``tag``/``step``),
* the PQ codebook: (M, K, ds) centroids, installed with
  ``VectorSearchEngine._init_aux(vectors, pq_codebook=)`` as the
  reference's disk reopen installs its persisted one,
* the LSH-APG index: hyperplanes + the (2**L, m) bucket table, set as
  the engine's ``_apg``,
* the adapt layer: a telemetry snapshot in the reference's
  ``telemetry_to_arrays`` schema, and a maintainer's counters and gate
  state (``maintainer_counters`` reads them off either package's
  ``CatapultMaintainer``; ``set_maintainer_counters`` installs them),
  so a parity test can hand a reference maintainer's state to the port
  mid-stream,
* an HNSW hierarchy (``core/hnsw.py``): the level-0 graph, each upper
  level's ids and graph, and the entry, as ``HnswIndex`` on a device
  (each level is a Vamana build, which agrees across the packages on
  >= 99% of rows only),
* a language model's parameters (``model_params_from_numpy``): the
  reference's ``M.init`` tree as numpy arrays, its stacked leaves split
  into the port's per-layer blocks, and its decode cache
  (``model_cache_from_numpy``), so decode parity can start from one
  cache; and back (``model_params_to_numpy``),
* an AdamW state (``adamw_state_from_numpy``/``adamw_state_to_numpy``):
  the reference's ``AdamWState`` trees against the port's moments keyed
  by parameter name (``stack_tree``/``unstack_tree`` are the mapping,
  which the training driver's checkpoints use too), so training parity
  starts both packages from one state,
* a training state across ranks: ``rank_slice``/``rank_full`` cut a
  full leaf to a rank's slice under its spec and gather it back
  (collective), ``shard_model``/``model_from_local`` hold a model's
  slices; a gated MLP's ``wi`` and the mamba blocks' ``in_proj`` (and
  mamba2's ``conv_w``) go through their rank layouts on the way
  (``rank_layout``, ``sections_to_rank_layout``), so a rank holds its
  block of each part (gate and up, or x, z, B, C and dt), while
  checkpoints keep the reference's layout,
* the graph needs no helper: pass ``prebuilt=(adjacency, medoid)`` to
  ``repro_torch.db.create``; a filtered graph crosses as
  ``prebuilt=(adjacency, medoid, label_entries)``, with the per-row
  labels as a numpy array (``create(spec, vectors, labels, ...)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.adapt import stats as ts
from repro_torch.core import buckets as bk
from repro_torch.core.catapult import CatapultState
from repro_torch.core.hnsw import HnswIndex
from repro_torch.core.lsh import LSHParams
from repro_torch.core.lsh_apg import LshApgIndex
from repro_torch.core.pq import PQCodebook
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import axis_sizes, local_slice, placements
from repro_torch.models import model as lm
from repro_torch.optim import adamw


def catapult_state_from_numpy(hyperplanes: np.ndarray, bucket_arrays,
                              device="cuda") -> CatapultState:
    """(n_bits, d) hyperplanes + a ``to_arrays`` dict -> CatapultState."""
    device = resolve_device(device)
    h = torch.tensor(np.asarray(hyperplanes, np.float32), device=device)
    return CatapultState(lsh=LSHParams(hyperplanes=h),
                         buckets=bk.from_arrays(bucket_arrays, device))


def pq_codebook_from_numpy(centroids: np.ndarray, device="cuda") -> PQCodebook:
    """(M, K, ds) centroids -> PQCodebook on ``device``."""
    device = resolve_device(device)
    return PQCodebook(centroids=torch.tensor(
        np.asarray(centroids, np.float32), device=device))


def lsh_apg_index_from_numpy(hyperplanes: np.ndarray, table: np.ndarray,
                             device="cuda") -> LshApgIndex:
    """(n_bits, d) hyperplanes + (2**n_bits, m) int32 table -> LshApgIndex."""
    device = resolve_device(device)
    return LshApgIndex(
        lsh=LSHParams(hyperplanes=torch.tensor(
            np.asarray(hyperplanes, np.float32), device=device)),
        table=torch.tensor(np.asarray(table, np.int32), device=device))


def hnsw_index_from_numpy(vectors: np.ndarray, level_ids, level_adj,
                          base_adj: np.ndarray, entry: int,
                          device="cuda") -> HnswIndex:
    """(N, d) vectors, per-level (n_l,) ids and (n_l, R) adjacency, the
    (N, R) level-0 graph and the entry id -> ``HnswIndex`` on ``device``."""
    device = resolve_device(device)

    def up(a, dtype):
        return torch.tensor(np.asarray(a, dtype), device=device)
    return HnswIndex(vectors=up(vectors, np.float32),
                     level_ids=[np.asarray(i, np.int64) for i in level_ids],
                     level_adj=[up(a, np.int32) for a in level_adj],
                     base_adj=up(base_adj, np.int32), entry=int(entry))


def telemetry_from_numpy(arrays, device="cuda",
                         prefix: str = "adapt_") -> ts.TelemetryState:
    """A ``telemetry_to_arrays`` dict (either package's) -> the port's
    ``TelemetryState`` on ``device``, the same bytes."""
    state = ts.telemetry_from_arrays(arrays, prefix, device)
    if state is None:
        raise KeyError(f"no {prefix}* telemetry fields in {sorted(arrays)}")
    return state


# the maintainer's event counters, then its gate machine's state
MAINTAINER_COUNTERS = ("ttl_evicted", "flushed_entries", "drift_flushes",
                       "gate_transitions", "probes", "shadows", "ticks",
                       "consolidations")
_MAINTAINER_STATE = ("_gate_on", "_probing", "_shadow", "_off_batches",
                     "_since_shadow", "_since_tick", "_obs_count")


def maintainer_counters(maintainer) -> dict:
    """Plain ints and bools: a maintainer's counters and gate state."""
    return {name: getattr(maintainer, name)
            for name in MAINTAINER_COUNTERS + _MAINTAINER_STATE}


def set_maintainer_counters(maintainer, counters: dict) -> None:
    """Install ``maintainer_counters`` output on a port maintainer, and
    the engine flags they imply: the persistent gate verdict, and the
    one-batch override a pending shadow (False) or probe (True) arms."""
    for name, value in counters.items():
        setattr(maintainer, name, value)
    maintainer._set_engines(bool(maintainer._gate_on))
    maintainer._set_override(False if maintainer._shadow else
                             True if maintainer._probing else None)


def _tensor(a, device) -> torch.Tensor:
    """A copy of a numpy array (bfloat16 included, as ``ml_dtypes``
    holds it) or of a tensor on ``device``, bit for bit.  Always a copy:
    the caller's buffer (possibly one the reference's runtime owns) is
    never written by the port's in-place cache and parameter updates."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, copy=True)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.tensor(a).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host; bfloat16 as ``ml_dtypes`` holds it
    (the reference's own dtype, imported only when needed)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _stacked_prefixes(cfg) -> tuple:
    """The reference tree's layer-stacked subtrees for ``cfg``: each
    leaf under one has a leading layer axis, row i of which is layer i's
    parameter in the port (``layers.i.attn.wq``)."""
    if cfg.family == "hybrid":
        return (("layers", "mamba"),)
    out = [("layers",)]
    if cfg.family == "moe" and cfg.first_dense_layers:
        out.append(("dense_layers",))
    if cfg.family == "encdec":
        out.append(("enc_layers",))
    return tuple(out)


def stack_tree(named) -> dict:
    """{port name: tensor} (``named_parameters()``, or AdamW moments
    keyed the same way) -> the reference's tree: ``layers.3.attn.wq``
    becomes row 3 of the stacked leaf ``["layers"]["attn"]["wq"]``
    (``torch.stack`` on the tensors' device), every other name a path
    of its own (``models.model.tree_of``)."""
    return lm.tree_of({k: t.detach() for k, t in named.items()},
                      torch.stack)


def unstack_tree(cfg, tree) -> dict:
    """The reverse of ``stack_tree``: the reference's tree (numpy or
    tensor leaves) -> {port name: leaf}, a stacked leaf split into its
    rows (views)."""
    prefixes = _stacked_prefixes(cfg)
    out = {}

    def walk(node, path):
        for key, value in node.items():
            p = path + (key,)
            if isinstance(value, dict):
                walk(value, p)
                continue
            pre = next((q for q in prefixes if p[:len(q)] == q), None)
            if pre is None:
                out[".".join(p)] = value
                continue
            for i in range(value.shape[0]):
                out[".".join(pre + (str(i),) + p[len(pre):])] = value[i]

    walk(tree, ())
    return out


def _tree_to_numpy(tree):
    """Every tensor leaf of a dict tree as numpy (``_numpy``)."""
    if isinstance(tree, dict):
        return {k: _tree_to_numpy(v) for k, v in tree.items()}
    return _numpy(tree)


def load_model_params(model: "lm.Model", tree) -> "lm.Model":
    """Fill ``model``'s parameters, in place, from the reference's
    ``M.init`` tree (numpy or tensor leaves, stacked): every parameter
    exactly once, in its own dtype and shape."""
    params = dict(model.named_parameters())
    src = unstack_tree(model.cfg, tree)
    if sorted(src) != sorted(params):
        raise ValueError(f"the tree names {sorted(set(src) ^ set(params))} "
                         f"that the model does not, or the reverse")
    with torch.no_grad():
        for name, p in params.items():
            t = _tensor(src[name], p.device)
            if t.shape != p.shape or t.dtype != p.dtype:
                raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} "
                                 f"against {tuple(p.shape)} {p.dtype}")
            p.copy_(t)
    return model


def model_params_from_numpy(cfg, tree, device="cuda") -> "lm.Model":
    """The reference's ``M.init(cfg, key)`` tree (numpy leaves) -> the
    port's ``Model`` on ``device``: every stacked leaf's row i goes to
    layer i of the matching ``ModuleList``; every parameter must be
    filled exactly once."""
    return load_model_params(lm.Model(cfg, device), tree)


def model_params_to_numpy(model: "lm.Model") -> dict:
    """The reverse of ``model_params_from_numpy``: the port's parameters
    as the reference's ``M.init`` tree, stacked, as numpy."""
    return _tree_to_numpy(stack_tree(dict(model.named_parameters())))


def adamw_state_from_numpy(cfg, state, device="cuda") -> adamw.AdamWState:
    """The reference's ``AdamWState(mu, nu, step)`` (trees of numpy or
    tensor leaves, stacked) -> the port's, its moments keyed by the
    port's parameter names, on ``device``."""
    device = resolve_device(device)
    return adamw.AdamWState(
        mu={k: _tensor(v, device)
            for k, v in unstack_tree(cfg, state.mu).items()},
        nu={k: _tensor(v, device)
            for k, v in unstack_tree(cfg, state.nu).items()},
        step=int(state.step))


def adamw_state_to_numpy(state: adamw.AdamWState) -> adamw.AdamWState:
    """The reverse: the port's AdamW state as the reference's, stacked,
    as numpy (``step`` an int32 scalar, as ``adamw.init`` makes it)."""
    return adamw.AdamWState(mu=_tree_to_numpy(stack_tree(state.mu)),
                            nu=_tree_to_numpy(stack_tree(state.nu)),
                            step=np.int32(state.step))


def model_cache_from_numpy(cfg, tree, device="cuda") -> dict:
    """A reference decode cache (``M.init_cache`` layout, numpy leaves)
    -> the port's cache dict on ``device``, the same names and bytes."""
    device = resolve_device(device)
    return {k: (model_cache_from_numpy(cfg, v, device)
                if isinstance(v, dict) else _tensor(v, device))
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# a training state across ranks
# --------------------------------------------------------------------------

def sections_to_rank_layout(w: torch.Tensor, sections, model: int,
                            dim: int = -1) -> torch.Tensor:
    """``w`` whose ``dim`` concatenates parts of ``sections`` sizes (each
    cut ``model`` ways) in the rank layout: block ``r`` of ``dim`` cut
    ``model`` ways holds every part's ``r``-th block, in part order.
    (The spec ``P(None, "model")`` of the reference's layout would give
    rank 0 of a gated MLP's ``wi``, ``[gate | up]``, gate columns only;
    GSPMD computes the right function from it, a manual cut must take
    the parts apart.)"""
    parts = w.split(list(sections), dim=dim)
    blocks = [q.chunk(model, dim=dim) for q in parts]
    return torch.cat([b[r] for r in range(model) for b in blocks], dim=dim)


def sections_from_rank_layout(w: torch.Tensor, sections, model: int,
                              dim: int = -1) -> torch.Tensor:
    """The inverse of ``sections_to_rank_layout``."""
    per = [n // model for n in sections]
    ranks = [r.split(per, dim=dim) for r in w.chunk(model, dim=dim)]
    return torch.cat([ranks[r][i] for i in range(len(sections))
                      for r in range(model)], dim=dim)


def _layout_sections(name: str, cfg):
    """(the parts' sizes, or their count where they are equal; the dim)
    of the leaf ``name`` whose rank slice is cut from a rank layout, or
    None: a gated MLP's ``wi`` and mamba1's ``in_proj`` (two halves of
    the last dim: ``[gate | up]``, ``[x | z]``), mamba2's ``in_proj``
    (``[z | x | B | C | dt]``) and its ``conv_w`` rows (``[x | B |
    C]``).  The MoE experts' ``wi`` and the MoE layer's shared/dense
    MLPs (``moe.shared.wi``) keep the reference's layout: the reference
    cuts them contiguously."""
    if name.endswith("mlp.wi"):
        return 2, -1
    if not name.endswith(("mixer.in_proj", "mixer.conv_w")):
        return None
    if cfg is None:
        raise ValueError(f"the rank layout of {name} needs the arch's "
                         f"config")
    if cfg.ssm_variant == "mamba1":
        return (2, -1) if name.endswith("in_proj") else None
    di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    if name.endswith("in_proj"):
        return (di, di, n, n, nh), -1
    return (di, n, n), -2


def rank_layout(name: str, model: int, cfg=None):
    """(to, from) the rank layout of the parameter (or its moments)
    ``name`` (a port name or a stacked path joined by dots) under
    ``model`` ranks, or None where a rank's slice is cut from the
    reference's own layout (``_layout_sections``; ``cfg`` is needed for
    the mamba blocks' leaves)."""
    found = _layout_sections(name, cfg)
    if found is None:
        return None
    parts, dim = found

    def sections(w):
        return parts if isinstance(parts, tuple) else \
            (w.shape[dim] // parts,) * parts
    return (lambda w: sections_to_rank_layout(w, sections(w), model, dim),
            lambda w: sections_from_rank_layout(w, sections(w), model, dim))


def rank_slice(name: str, full: torch.Tensor, spec, mesh,
               cfg=None) -> torch.Tensor:
    """This rank's slice of the full leaf ``name`` under ``spec`` (a
    contiguous copy; no communication)."""
    layout = rank_layout(name, axis_sizes(mesh).get("model", 1), cfg)
    if layout is not None:
        full = layout[0](full)
    return local_slice(full, spec, mesh).clone(
        memory_format=torch.contiguous_format)


def rank_full(name: str, local: torch.Tensor, spec, mesh,
              shape, cfg=None) -> torch.Tensor:
    """The full leaf ``name`` of ``shape`` from every rank's slice under
    ``spec``, in the reference's layout (a collective: every rank of
    ``mesh`` calls it; every rank gets the leaf)."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    stride = torch.empty(shape, device="meta").stride()
    full = DTensor.from_local(local, mesh, placements(spec, mesh, shape),
                              shape=shape, stride=stride).full_tensor()
    layout = rank_layout(name, axis_sizes(mesh).get("model", 1), cfg)
    return full if layout is None else layout[1](full).contiguous()


def _set_params(model: "lm.Model", named: dict) -> None:
    for name, t in named.items():
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        setattr(module, leaf, torch.nn.Parameter(t))


def shard_model(model: "lm.Model", specs: dict, mesh) -> "lm.Model":
    """Keep only this rank's slice of every parameter of ``model``, in
    place (``specs``: {port name: one layer's spec}); returns it."""
    with torch.no_grad():
        _set_params(model, {name: rank_slice(name, p.detach(), specs[name],
                                             mesh, model.cfg)
                            for name, p in model.named_parameters()})
    return model


def model_from_local(cfg, named: dict, device) -> "lm.Model":
    """A ``Model`` whose parameters are ``named`` ({port name: this
    rank's slice}, on any device), moved to ``device``; nothing else is
    allocated."""
    device = resolve_device(device)
    model = lm.Model(cfg, "meta")
    want = sorted(n for n, _ in model.named_parameters())
    if sorted(named) != want:
        raise ValueError(f"the slices name {sorted(set(named) ^ set(want))}"
                         f" that the model does not, or the reverse")
    _set_params(model, {name: _tensor(t, device)
                        for name, t in named.items()})
    model._device = device
    return model
