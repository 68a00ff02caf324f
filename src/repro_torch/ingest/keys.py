"""Caller-keyed row identity: the key <-> gid map behind
``Database.upsert(vectors, keys=...)`` / ``Database.delete(keys=...)``.

A copy of ``repro/ingest/keys.py``'s ``KeyMap`` (numpy only).  Callers
name rows with their own stable keys (ints or strings, one kind per
database) and never learn graph ids.  True-upsert semantics live one
level up in ``Database.upsert``: when a key already maps to a gid, the
new row is inserted first and the old gid tombstoned after.

Persistence is one npz per database (single store: ``<store>.keys.npz``
beside the block file; sharded/tiered: ``keys.npz`` inside the manifest
directory), in the reference's schema, member for member.  The same
npz carries the bootstrap engine's external-id indirection (``ext2int``,
``ext_tomb``, ``ext_labels``) when the database was born empty (see
``repro_torch.ingest.bootstrap``), so one sidecar restores the whole
ingest state, and either package opens the other's.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np


def ingest_state_path(tier: str, path: str) -> str:
    """Where the ingest-state npz lives for a persisted database."""
    if tier == "disk":
        return path + ".keys.npz"
    return os.path.join(path, "keys.npz")


def ingest_spec_path(tier: str, path: str) -> str:
    """Where the IngestSpec json sidecar lives (single-file tiers and
    the tiered directory; the sharded tier persists it in its manifest
    instead)."""
    if tier == "disk":
        return path + ".ingest.json"
    return os.path.join(path, "ingest.json")


class KeyMap:
    """Mapping from caller keys (all-int or all-str) to assigned gids."""

    def __init__(self) -> None:
        self._fwd: dict = {}
        self._kind: Optional[str] = None     # 'int' | 'str', fixed at 1st use

    def __len__(self) -> int:
        return len(self._fwd)

    def __contains__(self, key) -> bool:
        return self._norm(key) in self._fwd

    def _norm(self, key):
        """Validate + canonicalize one key against the map's kind."""
        if isinstance(key, (bool, np.bool_)):
            raise TypeError(f"keys must be ints or strings, got {key!r}")
        if isinstance(key, (int, np.integer)):
            kind, key = "int", int(key)
        elif isinstance(key, (str, np.str_)):
            kind, key = "str", str(key)
        else:
            raise TypeError(f"keys must be ints or strings, "
                            f"got {type(key).__name__}")
        if self._kind is None:
            self._kind = kind
        elif kind != self._kind:
            raise TypeError(f"this database's keys are {self._kind}s; "
                            f"got a {kind} key {key!r}")
        return key

    def get(self, key) -> int:
        """The gid a key maps to, or -1 when absent."""
        return int(self._fwd.get(self._norm(key), -1))

    def __getitem__(self, key) -> int:
        gid = self.get(key)
        if gid < 0:
            raise KeyError(f"unknown key {key!r}")
        return gid

    def __iter__(self):
        return iter(self._fwd)

    def assign(self, keys, gids: np.ndarray) -> np.ndarray:
        """Point each key at its new gid; returns the PREVIOUS gid per
        key (-1 where the key was new) so the caller can tombstone the
        replaced rows.  Duplicate keys within one batch resolve last-
        write-wins, with the earlier row reported as replaced."""
        gids = np.asarray(gids, np.int64)
        if len(keys) != gids.shape[0]:
            raise ValueError(f"{len(keys)} keys for {gids.shape[0]} rows")
        old = np.full(gids.shape[0], -1, np.int64)
        for i, key in enumerate(keys):
            key = self._norm(key)
            old[i] = self._fwd.get(key, -1)
            self._fwd[key] = int(gids[i])
        return old

    def drop(self, keys) -> np.ndarray:
        """Remove keys; returns their gids.  Unknown keys raise."""
        out = np.empty(len(keys), np.int64)
        for i, key in enumerate(keys):
            key = self._norm(key)
            if key not in self._fwd:
                raise KeyError(f"unknown key {key!r}")
            out[i] = self._fwd.pop(key)
        return out

    # ------------------------------------------------------------- persist
    def to_arrays(self) -> dict:
        if not self._fwd:
            return {"key_kind": np.array("none"),
                    "key_values": np.empty(0, np.int64),
                    "key_gids": np.empty(0, np.int64)}
        values = list(self._fwd.keys())
        gids = np.fromiter(self._fwd.values(), np.int64, len(self._fwd))
        dtype = np.int64 if self._kind == "int" else None   # None = <U auto
        return {"key_kind": np.array(self._kind),
                "key_values": np.asarray(values, dtype),
                "key_gids": gids}

    @classmethod
    def from_arrays(cls, arrays: dict) -> "KeyMap":
        m = cls()
        kind = str(arrays["key_kind"])
        if kind == "none":
            return m
        m._kind = kind
        values = arrays["key_values"]
        gids = np.asarray(arrays["key_gids"], np.int64)
        cast = int if kind == "int" else str
        m._fwd = {cast(v): int(g) for v, g in zip(values, gids)}
        return m


def write_ingest_state(npz_path: str, keymap: Optional[KeyMap],
                       ext2int: Optional[np.ndarray] = None,
                       ext_tomb: Optional[np.ndarray] = None,
                       ext_labels: Optional[np.ndarray] = None) -> None:
    """One atomic-ish npz holding the keymap and (when the database was
    born empty) the bootstrap engine's external-id indirection."""
    arrays = (keymap or KeyMap()).to_arrays()
    if ext2int is not None:
        arrays["ext2int"] = np.asarray(ext2int, np.int64)
        arrays["ext_tomb"] = np.asarray(ext_tomb, bool)
        if ext_labels is not None:
            arrays["ext_labels"] = np.asarray(ext_labels, np.int32)
    tmp = npz_path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, npz_path)


def read_ingest_state(npz_path: str) -> Optional[dict]:
    """The persisted arrays, or None when no ingest state exists."""
    if not os.path.exists(npz_path):
        return None
    with np.load(npz_path, allow_pickle=False) as z:
        return {name: z[name] for name in z.files}
