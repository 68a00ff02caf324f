"""Streaming ingest on the sharded and tiered tiers, and gids in caller
order on every tier: ``repro_torch`` against the reference on the CPU.

The sharded tier takes no ``prebuilt`` graph, so each package builds
its own shards; what depends on row counts alone (ext ids, the
indirection, the transitions, the caller-order gids) is exactly equal,
and the port's streamed recall is within 1 point of its own batch twin.
The world and helpers are ``test_torch_ingest.py``'s.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro import db as jdb
from repro_torch import db as tdb
from repro_torch.core import recall_at_k

from test_torch_ingest import (N, _assert_state, _rows_of, _spec,  # noqa: F401
                               _stream_twins, _twin_create,
                               one_torch_thread, opened, world)


# ------------------------------------------- streaming parity (tentpole)


def test_sharded_streaming_matches_reference_ids_and_recall(world, tmp_path,
                                                            opened):
    """The sharded tier takes no prebuilt graph, so each package builds
    its own: the ext ids, the indirection and the transitions (which
    depend on row counts alone) are exactly equal, and the port's
    streamed recall is within 1 point of its batch twin's."""
    corpus, queries, truth = world
    ref, port = _twin_create("sharded", tmp_path, opened)
    gids = _stream_twins(ref, port, corpus)
    assert port.backend.growths >= 1 and port.n_active == N
    ids = port.search(queries, k=10).ids
    r_stream = recall_at_k(_rows_of(ids, gids, N), truth)
    twin = tdb.create(dataclasses.replace(
        _spec(tdb, "sharded", str(tmp_path / "tw")), ingest=None), corpus,
        device="cpu")
    opened.append(twin)
    r_batch = recall_at_k(twin.search(queries, k=10).ids, truth)
    assert r_stream >= r_batch - 0.01, (r_stream, r_batch)


@pytest.mark.parametrize("tier", ["ram", "disk", "sharded", "tiered"])
def test_upsert_gids_in_caller_order_every_tier(world, tier, tmp_path,
                                                opened):
    """Gids in caller order on every tier, equal to the reference's:
    ``backend._vec_np[gids[i]]`` is the i-th row handed in, before and
    after the cutover (where locality grouping is live)."""
    corpus, _, _ = world
    ref, port = _twin_create(tier, tmp_path, opened)
    batch = corpus[:150]
    g_ref, g = ref.upsert(batch), port.upsert(batch)
    np.testing.assert_array_equal(g, g_ref)
    assert len(set(g.tolist())) == len(batch)
    np.testing.assert_array_equal(port.backend._vec_np[g], batch)
    for lo in range(150, 400, 64):
        np.testing.assert_array_equal(
            port.upsert(corpus[lo: min(lo + 64, 400)]),
            ref.upsert(corpus[lo: min(lo + 64, 400)]))
    assert port.backend.bootstrap_phase == "graph"
    _assert_state(ref, port)
    batch2 = corpus[400:480]
    g2 = port.upsert(batch2)
    np.testing.assert_array_equal(g2, ref.upsert(batch2))
    np.testing.assert_array_equal(port.backend._vec_np[g2], batch2)


def test_sharded_insert_batch_caller_order_contract(world, tmp_path,
                                                    opened):
    """The raw engine contract the facade depends on: a sharded
    ``insert_batch`` spanning shards returns one gid per input row, in
    input order, each pointing at its own vector, as the reference's."""
    corpus, _, _ = world
    kw = dict(tier="sharded", mode="catapult", degree=16, build_beam=32,
              seed=0, n_shards=3, spare_capacity=120)
    ref = jdb.create(jdb.IndexSpec(path=str(tmp_path / "r"), **kw),
                     corpus[:300])
    port = tdb.create(tdb.IndexSpec(path=str(tmp_path / "p"), **kw),
                      corpus[:300], device="cpu")
    opened.extend([ref, port])
    batch = corpus[300:400]
    gids = np.asarray(port.backend.insert_batch(batch), np.int64)
    np.testing.assert_array_equal(
        gids, np.asarray(ref.backend.insert_batch(batch), np.int64))
    off = np.asarray(port.backend.offsets, np.int64)
    which = np.searchsorted(off, gids, side="right") - 1
    assert len(np.unique(which)) > 1
    for i in range(100):
        s = int(which[i])
        np.testing.assert_array_equal(
            port.backend.shards[s]._vec_np[int(gids[i] - off[s])], batch[i])
