"""DeviceRowCache: bounded device cache over a host row store (paper §6).

Counterpart of ``repro/distributed/rowcache.py``. The paper's workers pull
adjacency rows on demand from a distributed KV store; a local LRU cache
absorbs repeated fetches so communication scales with *distinct cold
rows*, not partial matches. Here host RAM plays the remote store and the
card's memory the local cache:

* a **pinned hot set**: the top-``hot`` ids by degree live on the device
  permanently. Vertices are relabeled ascending by degree at load time
  (``graph/storage.py``), so the hot set is exactly ids ``>= n - hot``;
* an **LRU slab** of ``capacity_rows`` rows (``int32[C, D]`` on the
  device). Per lookup the id batch is deduped (each distinct row crosses
  PCIe at most once per level), misses are gathered from the
  :class:`~repro_torch.graph.hoststore.HostRowStore` as one dense block and
  scattered into LRU slots;
* **double-buffered async prefetch**: :meth:`prefetch` gathers the next
  chunk's predicted rows into one of two pinned host buffers and copies
  them to the device on a side CUDA stream while the current chunk
  computes; the staged block is served (and adopted into the slab) at a
  later lookup. At most two staged blocks exist at a time.

Streams and events. A staged block is written on the side stream and
read on the compute stream: every reader first makes the compute stream
wait on the block's event and marks the block with ``record_stream`` so
the caching allocator cannot hand its memory out early. The host refills
a pinned buffer only after the event of the last copy out of it has
completed. Demand misses cross through a pinned buffer as well (grown to
the largest miss block seen), on the compute stream. On a CPU device the
cache holds plain tensors and uses no stream and no pinned memory.

The LRU bookkeeping lives in numpy arrays instead of the reference's
``OrderedDict``: ``slot_of[id]`` (-1 when not resident) and a touch stamp
per id. Touches happen in the reference's order (ascending ids within a
lookup) and the least recently used resident is the one with the smallest
stamp, so slots, evictions and every counter are the reference's.

Correctness never depends on capacity: a lookup's miss block is consumed
directly, so even ``capacity_rows=0`` serves exact rows; it just
re-fetches every level. Counters follow Fig. 10's axes: queries (rows
requested), cold rows (host->device fetches), bytes moved (demand +
prefetch), per DBQ level.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclass
class CacheStats:
    """Fetch-path accounting. Units: rows are padded adjacency rows
    (``d * 4`` bytes each); levels are DBQ indices within the plan."""

    queries: int = 0          # non-sentinel rows requested (pre-dedup)
    unique_queries: int = 0   # distinct rows requested per lookup, summed
    cold_rows: int = 0        # rows fetched host->device on demand
    prefetch_rows: int = 0    # rows staged ahead by prefetch()
    prefetch_used: int = 0    # staged rows later served from the slab
    hot_hits: int = 0         # rows served from the pinned hot block
    evictions: int = 0
    bytes_demand: int = 0     # demand H2D traffic (cold_rows * row bytes)
    bytes_prefetch: int = 0   # prefetch H2D traffic
    lookups: int = 0
    per_level: Dict[int, List[int]] = field(default_factory=dict)
    # per_level[lvl] = [queries, cold_rows, bytes]

    @property
    def bytes_moved(self) -> int:
        """Total H2D bytes (demand + prefetch)."""
        return self.bytes_demand + self.bytes_prefetch

    @property
    def hit_rate(self) -> float:
        """1 - cold/queries: fraction of requested rows served without a
        host fetch (hot pins, slab hits, within-batch dedup, prefetch)."""
        if self.queries == 0:
            return 0.0
        return 1.0 - self.cold_rows / self.queries

    def level_note(self, lvl: int, queries: int, cold: int,
                   nbytes: int) -> None:
        acc = self.per_level.setdefault(lvl, [0, 0, 0])
        acc[0] += queries
        acc[1] += cold
        acc[2] += nbytes

    def as_dict(self) -> Dict[str, object]:
        return dict(queries=self.queries, unique_queries=self.unique_queries,
                    cold_rows=self.cold_rows,
                    prefetch_rows=self.prefetch_rows,
                    prefetch_used=self.prefetch_used,
                    hot_hits=self.hot_hits, evictions=self.evictions,
                    bytes_moved=self.bytes_moved,
                    bytes_demand=self.bytes_demand,
                    bytes_prefetch=self.bytes_prefetch,
                    hit_rate=self.hit_rate, lookups=self.lookups,
                    per_level={k: list(v)
                               for k, v in sorted(self.per_level.items())})


@dataclass
class _Staged:
    """One prefetched block: its ids (in block order), the device rows,
    and the event recorded after their copy (None on a CPU device)."""

    serial: int
    ids: np.ndarray
    block: torch.Tensor
    event: Optional[torch.cuda.Event]
    consumed_on_compute: bool = False


class DeviceRowCache:
    """Bounded device residency over a :class:`HostRowStore`.

    ``store`` needs ``n``, ``d`` and ``gather(ids, out=None) -> int32[K,
    d]`` (a ``HostRowStore`` or a snapshot row view). Device memory held (worst
    case, all static): ``(capacity_rows + 2 * stage_rows + hot + 1) * d *
    4`` bytes — the LRU slab, the two prefetch staging blocks, the pinned
    hot block and the sentinel row — independent of graph size.
    ``stage_rows`` bounds one staging block (default ``capacity_rows //
    4``). ``device`` is where the rows live (``cuda`` or ``cpu``).
    """

    def __init__(self, store, capacity_rows: int, hot: int = 0,
                 stage_rows: Optional[int] = None, device="cpu"):
        self.store = store
        self.n = store.n
        self.d = store.d
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self.capacity_rows = max(int(capacity_rows), 0)
        self.stage_rows = (self.capacity_rows // 4 if stage_rows is None
                           else max(int(stage_rows), 0))
        self.hot = min(max(int(hot), 0), store.n)
        self.hot_lo = store.n - self.hot   # ids >= hot_lo are pinned
        # pinned block rows are ids [hot_lo, n] — the top-degree set plus
        # the sentinel row, served without touching the slab
        self.hot_rows = torch.from_numpy(
            store.gather(np.arange(self.hot_lo, store.n + 1))).to(self.device)
        self.slab = torch.full((max(self.capacity_rows, 1), self.d), store.n,
                               dtype=torch.int32, device=self.device)
        n1 = store.n + 1
        self._slot_of = np.full(n1, -1, np.int64)        # id -> slab slot
        self._id_of_slot = np.full(max(self.capacity_rows, 1), -1, np.int64)
        self._stamp = np.zeros(n1, np.int64)             # LRU touch order
        self._clock = 0
        self._free: List[int] = list(range(self.capacity_rows))
        self._from_prefetch = np.zeros(n1, bool)  # slab ids that came staged
        # staged rows not yet consumed: id -> (block serial, row in block)
        self._stg_buf = np.full(n1, -1, np.int64)
        self._stg_pos = np.zeros(n1, np.int64)
        self._staged: List[_Staged] = []
        self._serial = 0
        if self._cuda and self.capacity_rows and self.stage_rows:
            self._side = torch.cuda.Stream(self.device)
            self._stage_pinned = [
                torch.empty((self.stage_rows, self.d), dtype=torch.int32,
                            pin_memory=True) for _ in range(2)]
            self._stage_done: List[Optional[torch.cuda.Event]] = [None, None]
        self._demand_pinned: Optional[torch.Tensor] = None
        self._demand_done: Optional[torch.cuda.Event] = None
        self.stats = CacheStats()
        self.lookup_host_s = 0.0   # host seconds spent inside lookup()

    # ----------------------------------------------------------- residency
    @property
    def device_rows(self) -> int:
        """Worst-case rows held on the device (slab + both staging blocks +
        pinned hot + sentinel)."""
        return self.capacity_rows + 2 * self.stage_rows + self.hot + 1

    @property
    def device_bytes(self) -> int:
        return self.device_rows * self.d * 4

    # ------------------------------------------------------- H2D transfers
    def _demand_block(self, ids: np.ndarray) -> torch.Tensor:
        """Rows of ``ids`` on the device, gathered straight into the pinned
        demand buffer and copied on the compute stream (so its readers
        are ordered after it)."""
        if not self._cuda:
            return torch.from_numpy(self.store.gather(ids))
        k = ids.shape[0]
        if self._demand_done is not None:
            self._demand_done.synchronize()   # last copy out of the buffer
        if self._demand_pinned is None or self._demand_pinned.shape[0] < k:
            cap = 1 << max(k - 1, 0).bit_length()
            self._demand_pinned = torch.empty((cap, self.d),
                                              dtype=torch.int32,
                                              pin_memory=True)
        buf = self._demand_pinned[:k]
        self.store.gather(ids, out=buf.numpy())
        out = torch.empty((k, self.d), dtype=torch.int32, device=self.device)
        out.copy_(buf, non_blocking=True)
        self._demand_done = torch.cuda.Event()
        self._demand_done.record(torch.cuda.current_stream(self.device))
        return out

    def _stage_block(self, ids: np.ndarray) -> Tuple[torch.Tensor, object]:
        """Rows of ``ids`` copied to the device on the side stream through
        one of the two pinned staging buffers; returns the block and the
        event recorded after its copy."""
        if not self._cuda:
            return torch.from_numpy(self.store.gather(ids)), None
        i = self._serial % 2
        done = self._stage_done[i]
        if done is not None:
            done.synchronize()      # the last copy out of buffer i is over
        buf = self._stage_pinned[i][:ids.shape[0]]
        self.store.gather(ids, out=buf.numpy())
        with torch.cuda.stream(self._side):
            block = torch.empty((ids.shape[0], self.d), dtype=torch.int32,
                                device=self.device)
            block.copy_(buf, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._side)
        self._stage_done[i] = ev
        return block, ev

    def _read_staged(self, e: _Staged) -> torch.Tensor:
        """``e.block``, safe to read on the compute stream."""
        if e.event is not None and not e.consumed_on_compute:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(e.event)
            e.block.record_stream(compute)
            e.consumed_on_compute = True
        return e.block

    # ------------------------------------------------------------ prefetch
    def prefetch(self, ids: np.ndarray) -> None:
        """Stage rows for a *future* lookup: an async H2D copy of the
        predicted rows that are not already resident. Call right before
        dispatching the current chunk's compute — the copy overlaps it.
        Staged rows are served straight from their staging block (and
        promoted into the slab) the first time a lookup requests them. At
        most two blocks are in flight (a third folds the oldest into the
        slab).
        """
        if self.capacity_rows == 0 or self.stage_rows == 0:
            return
        ids = np.unique(np.clip(np.asarray(ids, np.int64).reshape(-1),
                                0, self.n))
        want = ids[(ids < self.hot_lo) & (self._slot_of[ids] < 0)
                   & (self._stg_buf[ids] < 0)]
        if want.size == 0:
            return
        # one staging buffer's budget — staged blocks are live device
        # memory and are counted in device_rows
        want = want[:self.stage_rows]
        block, ev = self._stage_block(want)
        serial = self._serial
        self._serial += 1
        self._staged.append(_Staged(serial, want, block, ev))
        self._stg_buf[want] = serial
        self._stg_pos[want] = np.arange(want.size)
        self.stats.prefetch_rows += int(want.size)
        self.stats.bytes_prefetch += int(want.size) * self.d * 4
        if len(self._staged) > 2:                  # keep two buffers live
            self._adopt_one()

    def _adopt_one(self) -> None:
        """Fold the oldest staging block's unread rows into the slab."""
        e = self._staged.pop(0)
        live = e.ids[self._stg_buf[e.ids] == e.serial]
        keep_ids, _ = self._alloc_slots(live)
        if keep_ids.size:
            slots = torch.from_numpy(self._slot_of[keep_ids]).to(self.device)
            src = torch.from_numpy(self._stg_pos[keep_ids]).to(self.device)
            self.slab.index_copy_(0, slots,
                                  self._read_staged(e).index_select(0, src))
            self._from_prefetch[keep_ids] = True
        self._stg_buf[live] = -1

    def _drop_drained(self) -> None:
        self._staged = [e for e in self._staged
                        if (self._stg_buf[e.ids] == e.serial).any()]

    # ---------------------------------------------------------- coherence
    def invalidate(self, ids: np.ndarray) -> None:
        """Drop every cached copy of ``ids`` — slab entries, staged rows,
        and pinned hot rows (the hot rows are re-gathered from the
        store). Call after the backing store's rows change **in place**
        (e.g. a host-mode snapshot store's ``end_step`` patches touched
        rows); without it, lookups would keep serving the pre-update
        rows.
        """
        ids = np.unique(np.clip(np.asarray(ids, np.int64).reshape(-1),
                                0, self.n))
        hot_ids = ids[(ids >= self.hot_lo) & (ids < self.n)]
        cold = ids[ids < self.hot_lo]
        res = cold[self._slot_of[cold] >= 0]
        slots = self._slot_of[res]
        self._free.extend(slots.tolist())
        self._id_of_slot[slots] = -1
        self._slot_of[res] = -1
        self._from_prefetch[cold] = False
        self._stg_buf[cold] = -1
        self._drop_drained()
        if hot_ids.size:
            idx = torch.from_numpy(hot_ids - self.hot_lo).to(self.device)
            fresh = torch.from_numpy(self.store.gather(hot_ids))
            self.hot_rows.index_copy_(0, idx, fresh.to(self.device))

    # -------------------------------------------------------------- lookup
    def _alloc_slots(self, ids: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Assign LRU slots to as many of ``ids`` (distinct, none resident)
        as fit; returns the kept ids and their positions within ``ids``.

        The reference takes a free slot while there is one (the end of the
        free list first), else evicts the least recently used resident.
        New rows are touched last, and at most ``capacity_rows`` are kept,
        so no row placed by this call is evicted by it: the victims are
        the oldest residents from before the call, oldest first.
        """
        if self.capacity_rows == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        ids = np.asarray(ids, np.int64)
        # only the tail fits; earlier rows would be evicted unread
        pos = np.arange(max(ids.size - self.capacity_rows, 0), ids.size)
        ids = ids[pos]
        if self._slot_of[ids].max(initial=-1) >= 0:
            raise RuntimeError("_alloc_slots got a resident id")
        k = ids.size
        n_free = min(k, len(self._free))
        slots = np.asarray(self._free[len(self._free) - n_free:][::-1],
                           np.int64)
        del self._free[len(self._free) - n_free:]
        n_evict = k - n_free
        if n_evict:
            occ = self._id_of_slot[self._id_of_slot >= 0]
            st = self._stamp[occ]
            pick = np.argpartition(st, n_evict - 1)[:n_evict]
            victims = occ[pick[np.argsort(st[pick])]]
            slots = np.concatenate([slots, self._slot_of[victims]])
            self._slot_of[victims] = -1
            self._from_prefetch[victims] = False
            self.stats.evictions += n_evict
        self._slot_of[ids] = slots
        self._id_of_slot[slots] = ids
        self._stamp[ids] = self._clock + np.arange(k)
        self._clock += k
        return ids, pos

    def lookup(self, ids: np.ndarray, level: int = 0) -> torch.Tensor:
        """Serve ``rows int32[B, d]`` (a tensor on the cache's device) for
        host ids ``ids``.

        ``level`` tags the plan's DBQ index for per-level accounting. Ids
        are clipped to ``[0, n]`` (ids ``>= n`` return the sentinel row,
        negatives clamp to row 0). Sources, in priority order: pinned hot
        block, LRU slab, staging blocks (prefetched rows — promoted into
        the slab on first use), then a demand host fetch of the remaining
        cold rows. The result is exact regardless of capacity.
        """
        t0 = time.perf_counter()
        dev = self.device
        ids = np.clip(np.asarray(ids, np.int64).reshape(-1), 0, self.n)
        nv = int(np.sum(ids < self.n))
        # -- unique-row resolution: classify each distinct id once
        uniq, inv = np.unique(ids, return_inverse=True)
        hot_m = uniq >= self.hot_lo                 # includes the sentinel
        slot_u = self._slot_of[uniq]
        slab_m = ~hot_m & (slot_u >= 0)
        buf_u = self._stg_buf[uniq]
        stg_m = ~hot_m & ~slab_m & (buf_u >= 0)
        miss_m = ~hot_m & ~slab_m & ~stg_m
        hits = uniq[slab_m]                          # LRU touch, in order
        self._stamp[hits] = self._clock + np.arange(hits.size)
        self._clock += hits.size
        adopted = hits[self._from_prefetch[hits]]   # adopted unread: first
        self.stats.prefetch_used += int(adopted.size)   # touch is now
        self._from_prefetch[adopted] = False
        miss_u = uniq[miss_m]
        # -- demand fetch: one dense host gather, one H2D block
        fresh = None
        if miss_u.size:
            fresh = self._demand_block(miss_u)
            self.stats.bytes_demand += int(miss_u.size) * self.d * 4

        def where(mask: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.flatnonzero(mask)).to(dev)

        # -- assemble the unique rows on the device, then un-dedup
        rows_u = torch.empty((uniq.size, self.d), dtype=torch.int32,
                             device=dev)
        if hot_m.any():
            rows_u.index_copy_(0, where(hot_m), self.hot_rows.index_select(
                0, torch.from_numpy(uniq[hot_m] - self.hot_lo).to(dev)))
        if slab_m.any():
            rows_u.index_copy_(0, where(slab_m), self.slab.index_select(
                0, torch.from_numpy(slot_u[slab_m]).to(dev)))
        for e in self._staged:
            sel = stg_m & (buf_u == e.serial)
            if sel.any():
                src = torch.from_numpy(self._stg_pos[uniq[sel]]).to(dev)
                rows_u.index_copy_(0, where(sel),
                                   self._read_staged(e).index_select(0, src))
        if fresh is not None:
            rows_u.index_copy_(0, where(miss_m), fresh)
        out = rows_u.index_select(0, torch.from_numpy(inv.reshape(-1)).to(dev))
        # -- promote: served staged rows + the miss block enter the slab
        promote = uniq[stg_m]
        self._stg_buf[promote] = -1                 # consumed: unmap them
        self.stats.prefetch_used += int(promote.size)
        self._drop_drained()
        if promote.size or miss_u.size:
            all_ids = np.concatenate([promote, miss_u])
            keep_ids, keep_pos = self._alloc_slots(all_ids)
            if keep_ids.size:
                src_u = np.concatenate([np.flatnonzero(stg_m),
                                        np.flatnonzero(miss_m)])[keep_pos]
                self.slab.index_copy_(
                    0, torch.from_numpy(self._slot_of[keep_ids]).to(dev),
                    rows_u.index_select(0, torch.from_numpy(src_u).to(dev)))
        # -- accounting
        st = self.stats
        st.lookups += 1
        st.queries += nv
        st.unique_queries += int(np.sum(uniq < self.n))
        st.cold_rows += int(miss_u.size)
        st.hot_hits += int(np.sum((ids >= self.hot_lo) & (ids < self.n)))
        st.level_note(level, nv, int(miss_u.size),
                      int(miss_u.size) * self.d * 4)
        self.lookup_host_s += time.perf_counter() - t0
        return out
