"""HostRowStore: the padded adjacency in host-RAM shards (out-of-core).

The vectorized engines consume sentinel-padded adjacency rows
(``int32[N+1, D]``, row ``N`` = the all-holes sentinel row). Keeping that
matrix resident in device memory caps the data-graph size at HBM; the
paper's answer (§6) is a *pull* model — tasks query rows on demand from a
distributed store and a local cache absorbs repeats. This module is the
host half of that model for a single machine:

* rows live in **host RAM**, block-partitioned into shards of
  ``rows_per_shard`` rows each (``int32[rps, D]`` numpy arrays). The full
  ``[N+1, D]`` matrix is never materialized as one device array — shards
  are built directly from the per-vertex adjacency lists, one shard at a
  time, so peak transient memory during the build is one shard;
* :meth:`HostRowStore.gather` serves an id batch as a dense ``[K, D]``
  block — the unit the device row cache (``distributed/rowcache.py``)
  moves over PCIe/ICI. Ids ``>= n`` (the sentinel and anything padded)
  round-trip to the sentinel row, mirroring ``DeviceGraph`` gathers;
* :meth:`HostRowStore.set_rows` rewrites individual rows in place — the
  streaming snapshot store advances ``G'_{t-1} -> G'_t`` by patching only
  the touched rows (O(|ΔV|·D) host work per time step).

Shards are a block partition (owner = id // rows_per_shard), the layout
of the reference's multi-device row store, so the same store can back
either the single-host device cache or a multi-host fetch service.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from .storage import DiGraph, Graph, padded_width

DEFAULT_ROWS_PER_SHARD = 4096


class HostRowStore:
    """Sentinel-padded adjacency rows sharded over host RAM.

    Logical shape is ``int32[n + 1, d]``: one row per vertex plus the
    all-sentinel row at index ``n``. Physically the rows live in
    ``ceil((n + 1) / rows_per_shard)`` numpy shards of
    ``rows_per_shard`` rows each (the last shard is short, never padded).
    """

    def __init__(self, shards: List[np.ndarray], n: int,
                 rows_per_shard: int):
        if not shards:
            raise ValueError("need at least one shard")
        self.shards = shards
        self.n = n                          # real vertices; sentinel value
        self.rows_per_shard = rows_per_shard
        self.d = shards[0].shape[1]

    # ------------------------------------------------------------- builders
    @staticmethod
    def from_adj(adj_of: Callable[[int], Sequence[int]], n: int, d: int,
                 rows_per_shard: int = DEFAULT_ROWS_PER_SHARD
                 ) -> "HostRowStore":
        """Build shard by shard from an ``id -> sorted neighbors`` callable.

        ``d`` must already be the final padded width (callers round up to
        their lane multiple). Only one shard is under construction at any
        moment — the full ``[n + 1, d]`` block never exists contiguously.
        """
        rps = max(int(rows_per_shard), 1)
        shards: List[np.ndarray] = []
        for lo in range(0, n + 1, rps):
            hi = min(lo + rps, n + 1)
            shard = np.full((hi - lo, d), n, np.int32)
            for v in range(lo, min(hi, n)):     # row n stays all-sentinel
                a = adj_of(v)
                if len(a) > d:
                    raise ValueError(
                        f"row {v} has {len(a)} entries > padded width {d}")
                shard[v - lo, :len(a)] = a
            shards.append(shard)
        return HostRowStore(shards, n, rps)

    @staticmethod
    def from_graph(graph: Graph, d_max: Optional[int] = None, lane: int = 8,
                   rows_per_shard: int = DEFAULT_ROWS_PER_SHARD
                   ) -> "HostRowStore":
        """Host shards of ``graph``'s undirected padded adjacency.

        Same row semantics as ``DeviceGraph.from_graph`` (``engine_jax``):
        width = max degree (or ``d_max``) rounded up to ``lane``.
        """
        max_len = int(graph.deg.max()) if graph.n else 0
        d = padded_width(max_len, d_max=d_max, lane=lane, strict=True)
        return HostRowStore.from_adj(lambda v: graph.adj[v], graph.n, d,
                                     rows_per_shard=rows_per_shard)

    @staticmethod
    def from_digraph(g: DiGraph, direction: str = "out",
                     d_max: Optional[int] = None, lane: int = 8,
                     rows_per_shard: int = DEFAULT_ROWS_PER_SHARD
                     ) -> "HostRowStore":
        """Host shards of one adjacency direction of a directed graph."""
        sets = g.out if direction == "out" else g.inn
        max_len = max((len(s) for s in sets), default=0)
        d = padded_width(max_len, d_max=d_max, lane=lane, strict=True)
        return HostRowStore.from_adj(lambda v: sorted(sets[v]), g.n, d,
                                     rows_per_shard=rows_per_shard)

    # -------------------------------------------------------------- queries
    @property
    def n_rows(self) -> int:
        """Stored rows including the sentinel row (``n + 1``)."""
        return self.n + 1

    @property
    def nbytes(self) -> int:
        """Host bytes held by the shards."""
        return sum(s.nbytes for s in self.shards)

    def row(self, v: int) -> np.ndarray:
        """One row (a *view* into its shard; copy before mutating)."""
        v = min(max(int(v), 0), self.n)
        return self.shards[v // self.rows_per_shard][v % self.rows_per_shard]

    def gather(self, ids: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        """Dense ``int32[K, d]`` block for ``ids`` (any shape flattened),
        written into ``out`` when one is given (a C-contiguous
        ``int32[K, d]``, e.g. the numpy view of a pinned staging buffer).

        Ids are clipped to ``[0, n]`` — the device gathers' semantics:
        ids ``>= n`` (sentinel / padding) return the sentinel row,
        negative ids clamp to row 0.
        """
        ids = np.clip(np.asarray(ids, np.int64).reshape(-1), 0, self.n)
        if out is None:
            out = np.empty((ids.shape[0], self.d), np.int32)
        shard_of = ids // self.rows_per_shard
        local = ids % self.rows_per_shard
        if ids.size and bool(np.all(shard_of[1:] >= shard_of[:-1])):
            # ascending ids (every cache fetch): each shard's rows are one
            # run of ``out``, copied straight into place
            cut = np.flatnonzero(np.diff(shard_of)) + 1
            for lo, hi in zip(np.r_[0, cut], np.r_[cut, ids.size]):
                np.take(self.shards[shard_of[lo]], local[lo:hi], axis=0,
                        out=out[lo:hi], mode="clip")
            return out
        for s in np.unique(shard_of):
            m = shard_of == s
            out[m] = self.shards[s][local[m]]
        return out

    def set_rows(self, ids: np.ndarray, rows: np.ndarray) -> None:
        """Overwrite rows in place (streaming snapshot advance).

        ``rows`` is ``int32[K, d]`` already sentinel-padded; ids must be
        real vertices (``0 <= id < n`` — the sentinel row is immutable).
        """
        ids = np.asarray(ids, np.int64).reshape(-1)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n):
            raise ValueError("set_rows ids must be real vertices")
        rows = np.asarray(rows, np.int32)
        shard_of = ids // self.rows_per_shard
        local = ids % self.rows_per_shard
        for s in np.unique(shard_of):
            m = shard_of == s
            self.shards[s][local[m]] = rows[m]

    def to_rows(self) -> np.ndarray:
        """The full ``[n + 1, d]`` block (test oracle / compat path only —
        this is exactly the materialization the store exists to avoid)."""
        return np.concatenate(self.shards, axis=0)
