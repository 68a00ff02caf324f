"""Block-aligned on-disk index layout (DiskANN's SSD node format).

A copy of ``repro/store/layout.py`` (numpy only; the port imports
nothing of the reference package): both packages read and write the
same CTPL v1-v3 files, byte for byte.

DiskANN stores each node's full-precision vector and adjacency row
co-located in one fixed-size block so a single SSD read serves both the
rerank fetch and the traversal expansion.  This module reproduces that
layout with numpy memmaps:

  file := header block (HEADER_SIZE bytes) ++ capacity * node block

  node block (block_size bytes, a multiple of SECTOR):
      [0,              4*dim)              vector, float32 little-endian
      [4*dim,          4*dim + 4*degree)   adjacency row, int32, -1 padded
      [4*dim+4*degree, +4)                 label, int32 (-1 = unlabeled)
      [...,            block_size)         zero padding to sector boundary

The header (see ``StoreHeader``) carries magic/version plus everything
needed to reconstruct the node dtype: capacity, n_active, dim, degree,
block_size, medoid, has_labels.  ``open_store`` refuses unknown magic or
versions — see FORMAT.md for the versioning policy.

Trailing sections (after the last block, dense, in order): the PQ
codebook (v2), the tombstone bitmap and the per-label entry-point table
(v3).  Absent sections have zero size; v1/v2 files read back as "no
tombstones / no labels" because the v3 header fields land in the older
versions' mandatory-zero pad.

Memmap views are the write path too: ``BlockStore.vectors`` /
``.adjacency`` are strided ndarray views into the block file, so the
host-side graph surgery of build/insert mutates disk pages in place and
``flush()`` makes them durable.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

MAGIC = 0x4C505443          # "CTPL" little-endian
VERSION = 3                 # v3 = v2 + tombstone bitmap + label entry table
SECTOR = 512                # alignment quantum of the node blocks
HEADER_SIZE = 4096          # one 4 KiB header page

_HEADER_DTYPE = np.dtype([
    ("magic", "<u4"),
    ("version", "<u4"),
    ("capacity", "<i8"),
    ("n_active", "<i8"),
    ("dim", "<i4"),
    ("degree", "<i4"),
    ("block_size", "<i4"),
    ("medoid", "<i4"),
    ("has_labels", "<i4"),
    # v2 additions, carved from the v1 reserved pad (which was required
    # to be zero — a v1 file therefore reads back as pq_m == pq_k == 0,
    # i.e. "no PQ section", with no special-casing).
    ("pq_m", "<i4"),        # PQ subspaces M; 0 = no codebook persisted
    ("pq_k", "<i4"),        # PQ centroids per subspace K
    # v3 additions, same carve-from-zero-pad trick: a v1/v2 file reads
    # back as has_tombs == n_label_entries == 0 — "no tombstone bitmap /
    # no label entry table" — with no version special-casing.
    ("has_tombs", "<i4"),        # 1 = tombstone bitmap section present
    ("n_label_entries", "<i4"),  # per-label entry points persisted; 0 = none
])


class StoreFormatError(RuntimeError):
    """Bad magic, unsupported version, or size/geometry mismatch."""


@dataclasses.dataclass
class StoreHeader:
    capacity: int
    n_active: int
    dim: int
    degree: int
    block_size: int
    medoid: int = 0
    has_labels: bool = False
    pq_m: int = 0               # 0 = no PQ codebook section
    pq_k: int = 0
    has_tombs: bool = False     # v3: tombstone bitmap section present
    n_label_entries: int = 0    # v3: per-label entry points persisted
    version: int = VERSION      # informational; writes always emit VERSION

    @property
    def pq_bytes(self) -> int:
        """Size of the trailing PQ codebook section (0 when absent)."""
        if self.pq_m <= 0:
            return 0
        return 4 * self.pq_m * self.pq_k * (self.dim // self.pq_m)

    @property
    def tomb_bytes(self) -> int:
        """Size of the tombstone bitmap section: one bit per block."""
        if not self.has_tombs:
            return 0
        return (self.capacity + 7) // 8

    @property
    def label_entry_bytes(self) -> int:
        """Size of the per-label entry-point table (i32 per label)."""
        return 4 * self.n_label_entries

    @property
    def tail_bytes(self) -> int:
        """Total size of every trailing section after the node blocks."""
        return self.pq_bytes + self.tomb_bytes + self.label_entry_bytes

    def to_bytes(self) -> bytes:
        rec = np.zeros(1, _HEADER_DTYPE)
        rec["magic"], rec["version"] = MAGIC, VERSION
        rec["capacity"], rec["n_active"] = self.capacity, self.n_active
        rec["dim"], rec["degree"] = self.dim, self.degree
        rec["block_size"], rec["medoid"] = self.block_size, self.medoid
        rec["has_labels"] = int(self.has_labels)
        rec["pq_m"], rec["pq_k"] = self.pq_m, self.pq_k
        rec["has_tombs"] = int(self.has_tombs)
        rec["n_label_entries"] = self.n_label_entries
        raw = rec.tobytes()
        return raw + b"\x00" * (HEADER_SIZE - len(raw))

    @classmethod
    def from_bytes(cls, raw: bytes) -> "StoreHeader":
        if len(raw) < _HEADER_DTYPE.itemsize:
            raise StoreFormatError("truncated header")
        rec = np.frombuffer(raw[: _HEADER_DTYPE.itemsize], _HEADER_DTYPE)[0]
        if int(rec["magic"]) != MAGIC:
            raise StoreFormatError(f"bad magic {int(rec['magic']):#x}")
        if not 1 <= int(rec["version"]) <= VERSION:
            raise StoreFormatError(
                f"unsupported version {int(rec['version'])} (have {VERSION})")
        return cls(capacity=int(rec["capacity"]), n_active=int(rec["n_active"]),
                   dim=int(rec["dim"]), degree=int(rec["degree"]),
                   block_size=int(rec["block_size"]), medoid=int(rec["medoid"]),
                   has_labels=bool(rec["has_labels"]),
                   pq_m=int(rec["pq_m"]), pq_k=int(rec["pq_k"]),
                   has_tombs=bool(rec["has_tombs"]),
                   n_label_entries=int(rec["n_label_entries"]),
                   version=int(rec["version"]))


def block_size_for(dim: int, degree: int) -> int:
    """Smallest sector multiple holding vector + adjacency + label."""
    payload = 4 * dim + 4 * degree + 4
    return ((payload + SECTOR - 1) // SECTOR) * SECTOR


def node_dtype(dim: int, degree: int, block_size: int) -> np.dtype:
    """Structured dtype of one node block (itemsize == block_size)."""
    return np.dtype({
        "names": ["vec", "adj", "label"],
        "formats": [("<f4", (dim,)), ("<i4", (degree,)), "<i4"],
        "offsets": [0, 4 * dim, 4 * dim + 4 * degree],
        "itemsize": block_size,
    })


class BlockStore:
    """An open block file: header + memmap'd node records."""

    def __init__(self, path: str, header: StoreHeader, mode: str = "r+"):
        self.path = path
        self.header = header
        self.writable = mode != "r"
        self._mm = np.memmap(path, dtype=node_dtype(
            header.dim, header.degree, header.block_size),
            mode=mode, offset=HEADER_SIZE, shape=(header.capacity,))

    # ------------------------------------------------------------- views
    @property
    def vectors(self) -> np.ndarray:      # (capacity, dim) float32 view
        return self._mm["vec"]

    @property
    def adjacency(self) -> np.ndarray:    # (capacity, degree) int32 view
        return self._mm["adj"]

    @property
    def labels(self) -> np.ndarray:       # (capacity,) int32 view
        return self._mm["label"]

    @property
    def capacity(self) -> int:
        return self.header.capacity

    @property
    def n_active(self) -> int:
        return self.header.n_active

    @property
    def medoid(self) -> int:
        return self.header.medoid

    def read_block(self, node: int) -> np.void:
        """One node record — THE unit of disk I/O the cache accounts."""
        if not 0 <= node < self.header.capacity:
            raise IndexError(f"node {node} outside capacity "
                             f"{self.header.capacity}")
        return self._mm[node]

    # ----------------------------------------------------- trailing sections
    # v2/v3 tail layout, immediately after the last node block:
    #     [PQ codebook][tombstone bitmap][label entry table]
    # Sections are dense (no gaps); absent sections have zero size.  Any
    # single-section write rewrites the whole tail, preserving siblings —
    # section sizes shift when an earlier section appears or resizes.

    def _tail_offset(self) -> int:
        return HEADER_SIZE + self.header.capacity * self.header.block_size

    def _read_tail_raw(self) -> tuple[bytes, bytes, bytes]:
        """Raw (pq, tombs, label_entries) section bytes currently on disk."""
        h = self.header
        with open(self.path, "rb") as f:
            f.seek(self._tail_offset())
            raw = f.read(h.tail_bytes)
        if len(raw) != h.tail_bytes:
            raise StoreFormatError("truncated trailing sections")
        p, t = h.pq_bytes, h.pq_bytes + h.tomb_bytes
        return raw[:p], raw[p:t], raw[t:]

    def _write_tail(self, pq: bytes, tombs: bytes, entries: bytes) -> None:
        """Write all three trailing sections and re-stamp the header.

        Callers read the current tail (under the OLD header geometry),
        update the header fields sizing their section, then hand every
        section's bytes here — earlier sections resizing shift the later
        ones, so the whole tail always rewrites together.
        """
        if not self.writable:
            raise StoreFormatError("store opened read-only")
        off = self._tail_offset()
        with open(self.path, "r+b") as f:
            f.seek(off)
            f.write(pq + tombs + entries)
            f.truncate(off + len(pq) + len(tombs) + len(entries))
            f.seek(0)
            f.write(self.header.to_bytes())

    def write_pq(self, centroids: np.ndarray) -> None:
        """Persist the PQ codebook: (M, K, dim/M) float32 after the blocks.

        Build-time persist so ``load()`` reopens with the exact codebook
        the live engine traverses with — byte-identical ADC distances
        even after post-build inserts retrained nothing.
        """
        m, k, ds = centroids.shape
        if m * ds != self.header.dim:
            raise StoreFormatError(
                f"codebook geometry ({m}, {k}, {ds}) inconsistent with "
                f"dim {self.header.dim}")
        raw = np.ascontiguousarray(centroids, np.dtype("<f4")).tobytes()
        _, tombs, entries = self._read_tail_raw()
        self.header.pq_m, self.header.pq_k = m, k
        self._write_tail(raw, tombs, entries)

    def read_pq(self) -> np.ndarray | None:
        """The persisted PQ codebook, or None (v1 file / no PQ section)."""
        h = self.header
        if h.pq_m <= 0:
            return None
        raw, _, _ = self._read_tail_raw()
        return np.frombuffer(raw, np.dtype("<f4")).reshape(
            h.pq_m, h.pq_k, h.dim // h.pq_m).copy()

    def write_tombstones(self, tombstones: np.ndarray) -> None:
        """Persist the tombstone bitmap: one bit per block, LSB-first.

        ``tombstones`` is a (capacity,) bool array; rows ≥ ``n_active``
        (not-yet-inserted) are conventionally True but the bitmap is
        stored verbatim — readers reconstruct whatever was live.
        """
        tombstones = np.asarray(tombstones, bool).ravel()
        if tombstones.size != self.header.capacity:
            raise StoreFormatError(
                f"tombstone bitmap length {tombstones.size} != capacity "
                f"{self.header.capacity}")
        raw = np.packbits(tombstones, bitorder="little").tobytes()
        pq, _, entries = self._read_tail_raw()
        self.header.has_tombs = True
        self._write_tail(pq, raw, entries)

    def read_tombstones(self) -> np.ndarray | None:
        """The persisted tombstone bitmap as (capacity,) bool, or None
        (v1/v2 file / never persisted — caller derives from n_active)."""
        h = self.header
        if not h.has_tombs:
            return None
        _, raw, _ = self._read_tail_raw()
        bits = np.unpackbits(np.frombuffer(raw, np.uint8),
                             bitorder="little")
        return bits[: h.capacity].astype(bool)

    def write_label_entries(self, entries: np.ndarray) -> None:
        """Persist the per-label entry-point table: (n_labels,) int32.

        Entry ``l`` is the node id filtered traversal starts from for
        label ``l`` (FilteredVamana's per-label medoid).
        """
        raw = np.ascontiguousarray(entries, np.dtype("<i4")).tobytes()
        pq, tombs, _ = self._read_tail_raw()
        self.header.n_label_entries = int(np.asarray(entries).size)
        self._write_tail(pq, tombs, raw)

    def read_label_entries(self) -> np.ndarray | None:
        """The persisted label entry table as (n_labels,) int32, or None
        (v1/v2 file / unlabeled store)."""
        h = self.header
        if h.n_label_entries <= 0:
            return None
        _, _, raw = self._read_tail_raw()
        return np.frombuffer(raw, np.dtype("<i4")).astype(np.int32)

    # ------------------------------------------------------------ durability
    def flush(self, n_active: int | None = None, medoid: int | None = None,
              has_labels: bool | None = None) -> None:
        """Persist dirty pages and (optionally) updated header fields."""
        if not self.writable:
            raise StoreFormatError("store opened read-only")
        if n_active is not None:
            self.header.n_active = int(n_active)
        if medoid is not None:
            self.header.medoid = int(medoid)
        if has_labels is not None:
            self.header.has_labels = bool(has_labels)
        self._mm.flush()
        with open(self.path, "r+b") as f:
            f.write(self.header.to_bytes())

    def close(self) -> None:
        del self._mm


def create_store(path: str, capacity: int, dim: int, degree: int,
                 medoid: int = 0, has_labels: bool = False) -> BlockStore:
    """Allocate a zeroed block file and return it opened read-write.

    Adjacency rows and labels start at -1 (empty), vectors at zero.
    """
    bsz = block_size_for(dim, degree)
    header = StoreHeader(capacity=capacity, n_active=0, dim=dim,
                         degree=degree, block_size=bsz, medoid=medoid,
                         has_labels=has_labels)
    with open(path, "wb") as f:
        f.write(header.to_bytes())
        f.truncate(HEADER_SIZE + capacity * bsz)
    store = BlockStore(path, header, mode="r+")
    store.adjacency[:] = -1
    store.labels[:] = -1
    return store


def open_store(path: str, mode: str = "r+") -> BlockStore:
    """Open an existing store; validates magic, version, and file size."""
    with open(path, "rb") as f:
        header = StoreHeader.from_bytes(f.read(HEADER_SIZE))
    expect = (HEADER_SIZE + header.capacity * header.block_size
              + header.tail_bytes)
    actual = os.path.getsize(path)
    if actual != expect:
        raise StoreFormatError(
            f"file size {actual} != header geometry {expect}")
    if header.block_size != block_size_for(header.dim, header.degree):
        raise StoreFormatError("block_size inconsistent with dim/degree")
    return BlockStore(path, header, mode=mode)


def write_store(path: str, vectors: np.ndarray, adjacency: np.ndarray,
                medoid: int, labels: np.ndarray | None = None,
                capacity: int | None = None) -> BlockStore:
    """Persist a built index in one call (build → persist convenience)."""
    n, dim = vectors.shape
    cap = capacity or n
    assert adjacency.shape[0] >= n and cap >= n
    store = create_store(path, capacity=cap, dim=dim,
                         degree=adjacency.shape[1], medoid=medoid,
                         has_labels=labels is not None)
    store.vectors[:n] = vectors
    store.adjacency[:n] = adjacency[:n]
    if labels is not None:
        store.labels[:n] = labels
    store.flush(n_active=n)
    return store
