"""The port's top-level surface, a twin of ``test_api_surface.py``'s
second half: the documented symbol set (the reference's, plus the port's
``resolve_device``), the shims forwarding by identity, an unknown name
raising, ``import repro_torch`` free of the engine stack, and the
subpackage surfaces the reference has (``core.DiskStore``,
``kernels.ops``/``ref``, the stores' ``flush``/``close``/``open``)."""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np

import repro
import repro_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_top_level_symbol_set_is_the_references_plus_resolve_device():
    assert set(repro_torch.__all__) == set(repro.__all__) | {"resolve_device"}


def test_shims_forward_by_identity():
    from repro_torch.adapt.maintainer import CatapultMaintainer
    from repro_torch.adapt.policy import PolicyConfig
    from repro_torch.core.engine import VectorSearchEngine
    from repro_torch.serving.engine import VectorSearchFrontend
    from repro_torch.store.io_engine import DiskVectorSearchEngine
    from repro_torch.store.sharded_store import ShardedDiskVectorSearchEngine

    import repro_torch.db
    assert repro_torch.db is repro_torch.__getattr__("db")
    assert repro_torch.VectorSearchEngine is VectorSearchEngine
    assert repro_torch.DiskVectorSearchEngine is DiskVectorSearchEngine
    assert (repro_torch.ShardedDiskVectorSearchEngine
            is ShardedDiskVectorSearchEngine)
    assert repro_torch.VectorSearchFrontend is VectorSearchFrontend
    assert repro_torch.CatapultMaintainer is CatapultMaintainer
    assert repro_torch.PolicyConfig is PolicyConfig
    for name in ("create", "open", "sniff", "Database", "IndexSpec",
                 "SearchRequest", "SearchResult", "Caps",
                 "CapabilityError"):
        assert getattr(repro_torch, name) is getattr(repro_torch.db, name)


def test_unknown_top_level_attribute_raises():
    try:
        repro_torch.definitely_not_an_export
    except AttributeError as e:
        assert "definitely_not_an_export" in str(e)
    else:
        raise AssertionError("expected AttributeError")


def test_import_stays_free_of_the_engine_stack():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('repro_torch')))")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120).stdout
    assert out.strip() == "['repro_torch', 'repro_torch.device']"


def test_subpackage_surfaces_match_the_references():
    import repro.core
    import repro.kernels
    import repro_torch.core
    import repro_torch.kernels
    assert set(repro.core.__all__) <= set(repro_torch.core.__all__)
    assert set(repro_torch.kernels.__all__) == set(repro.kernels.__all__)
    from repro_torch.kernels import ops, ref
    assert callable(ops.gather_distance) and callable(ref.gather_distance_ref)


def test_store_durability_methods(tmp_path):
    from repro_torch.core import DiskStore, RamStore
    ram = RamStore.allocate(4, 3, 2)
    ram.flush()
    ram.close()
    path = str(tmp_path / "s.ctpl")
    disk = DiskStore.create(path, capacity=4, dim=3, degree=2)
    disk.vectors[1] = np.arange(3, dtype=np.float32)
    disk.adjacency[1, 0] = 2
    disk.flush(n_active=2, medoid=1)
    disk.close()
    again = DiskStore.open(path, mode="r")
    np.testing.assert_array_equal(again.vectors[1], np.arange(3))
    assert int(again.adjacency[1, 0]) == 2
    assert again.block_store.header.n_active == 2
    assert again.block_store.header.medoid == 1
    again.close()
