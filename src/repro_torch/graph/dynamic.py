"""Dynamic directed data graph storage (paper §5, §6.2).

Counterpart of ``repro/graph/dynamic.py``. Maintains exactly the two
snapshots S-BENU needs — ``G'_{t-1}`` and the current delta sets — using
the paper's two-form value design:

* between steps, a vertex value is ``(in_prev, out_prev)``;
* inside step t, touched vertices additionally carry
  ``(delta_in, delta_out)`` with per-edge flags ``{'+','-'}``.

``get_adj(v, type, direction, op)`` serves the six adjacency kinds of §5.3.1
for either snapshot; ``op='+'`` selects ``G'_t``, ``op='-'`` selects
``G'_{t-1}``, and ``(type='delta', op='*')`` returns the flagged delta set.

Six-adjacency device layout (the vectorized S-BENU substrate)
-------------------------------------------------------------
The begun step becomes six typed/directed padded row blocks —
``{out, in} x {prev, current, delta}`` — each a sentinel-padded
``int32[N+1, D]`` matrix (row ``N`` is the all-holes sentinel row so
gathers with invalid ids are safe):

* ``prev_{out,in}``    rows of ``G'_{t-1}`` — serves ``(either, dir, '-')``;
* ``cur_{out,in}``     rows of ``G'_t``     — serves ``(either, dir, '+')``;
* ``delta_{out,in}``   the touched-vertex delta adjacency, value rows
  paired with ``delta_*_sign`` rows carrying the paper's ± edge flags
  (+1 insert, -1 delete, 0 hole).

The two remaining §5.3.1 kinds are derived lane-wise on the device:
``unaltered = prev`` with entries flagged ``-`` masked out, and
``(delta, dir, ±)`` = the sign-filtered delta value rows. ``prev``/``cur``
blocks of one direction share a width and, on a device, one
``[2(N+1), D]`` buffer, so a per-row snapshot selector (Delta-ENU's
``op``) is one offset gather.

:class:`DeviceSnapshotStore` keeps the resident blocks either on the device
(``storage='device'``, the streaming fast path: ``G'_t`` is derived there
from the touched rows only) or in host-RAM shards (``storage='host'``,
backed by :class:`~repro_torch.graph.hoststore.HostRowStore` — no
persistent device memory between steps, with bounded-device row serving
via :meth:`DeviceSnapshotStore.row_source` + the ``distributed/rowcache``
device cache).

Example (two time steps; ``get_adj`` serves both snapshots)::

    >>> from repro_torch.graph.storage import DiGraph
    >>> from repro_torch.graph.dynamic import SnapshotStore
    >>> g0 = DiGraph.from_edges(4, [(0, 1), (1, 2)])
    >>> st = SnapshotStore(g0)
    >>> st.begin_step([("+", 2, 3), ("-", 0, 1)])
    >>> st.start_vertices()                  # vertices with non-empty dG_out
    [0, 2]
    >>> sorted(st.get_adj(2, "either", "out", "+"))   # G'_t
    [3]
    >>> sorted(st.get_adj(0, "either", "out", "-"))   # G'_{t-1}
    [1]
    >>> st.end_step()
    >>> sorted(st.prev.out[0])               # the merged snapshot
    []
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from .storage import DiGraph, pad_rows

Update = Tuple[str, int, int]  # (op, src, dst)

#: the eight blocks of a six-block snapshot (value/sign pairs for delta)
SNAPSHOT_BLOCKS = ("prev_out", "prev_in", "cur_out", "cur_in", "delta_out",
                   "delta_out_sign", "delta_in", "delta_in_sign")


@dataclass
class DeviceSnapshot:
    """The six padded adjacency blocks of one time step: numpy arrays from
    the host builder, tensors on a device from :class:`DeviceSnapshotStore`
    or ``engine_sbenu_torch.device_put_snapshot``.

    All value blocks are sentinel-padded ``int32[N+1, D]`` with ascending
    valid entries; sign blocks are ``int32[N+1, Dd]`` aligned with
    ``delta_*`` (+1/-1, 0 at holes). ``n`` is the vertex count == sentinel.
    On a device, ``stacked_{out,in}`` is the ``[2(N+1), D]`` buffer whose
    halves are ``prev_*`` and ``cur_*`` (those two are views of it): the
    per-row snapshot selector then reads one offset row of it.
    """

    prev_out: object
    prev_in: object
    cur_out: object
    cur_in: object
    delta_out: object
    delta_out_sign: object
    delta_in: object
    delta_in_sign: object
    n: int
    stacked_out: Optional[torch.Tensor] = None
    stacked_in: Optional[torch.Tensor] = None

    @property
    def d_out(self) -> int:
        return self.prev_out.shape[1]

    @property
    def d_in(self) -> int:
        return self.prev_in.shape[1]

    @property
    def widths(self) -> Tuple[int, ...]:
        """Shape signature of the blocks."""
        return (self.prev_out.shape[1], self.prev_in.shape[1],
                self.delta_out.shape[1], self.delta_in.shape[1])

    def device_bytes(self) -> int:
        """Bytes the step's blocks hold (prev and cur once each)."""
        return sum(int(getattr(self, k).nbytes) for k in SNAPSHOT_BLOCKS)


def _with_sentinel_row(rows: np.ndarray, fill: int) -> np.ndarray:
    return np.concatenate(
        [rows, np.full((1, rows.shape[1]), fill, rows.dtype)], axis=0)


class SnapshotStore:
    """The paper's two-form vertex values for one dynamic graph (§5, §6.2).

    Holds ``prev`` (= G'_{t-1}, a :class:`DiGraph`) plus the begun step's
    delta adjacency dicts ``delta_out/delta_in`` (vertex -> {neighbor:
    '+'|'-'}). One ``begin_step(batch) ... end_step()`` bracket is one
    time step of Algorithm 4; between the two calls every §5.3.1
    adjacency kind of either snapshot is served by :meth:`get_adj`.
    """

    def __init__(self, g0: DiGraph):
        self.n = g0.n
        self.prev = g0.copy()           # G'_{t-1}
        self.delta_out: Dict[int, Dict[int, str]] = {}
        self.delta_in: Dict[int, Dict[int, str]] = {}
        self.t = 0
        self.total_queries = 0
        # mirrors notified on end_step (DeviceSnapshotStore)
        self._mirrors: List["DeviceSnapshotStore"] = []

    # ------------------------------------------------------------ time steps
    def begin_step(self, batch: Sequence[Update]) -> None:
        """Convert Δo_t into delta adjacency sets (Alg. 4 lines 7-9)."""
        self.t += 1
        self.delta_out = {}
        self.delta_in = {}
        seen: Set[Tuple[int, int]] = set()
        for op, a, b in batch:
            if (a, b) in seen:
                raise ValueError(f"edge ({a},{b}) appears twice in batch")
            seen.add((a, b))
            if op == "+" and self.prev.has_edge(a, b):
                raise ValueError(f"inserting existing edge ({a},{b})")
            if op == "-" and not self.prev.has_edge(a, b):
                raise ValueError(f"deleting missing edge ({a},{b})")
            self.delta_out.setdefault(a, {})[b] = op
            self.delta_in.setdefault(b, {})[a] = op

    def end_step(self) -> None:
        """Merge deltas into the stored snapshot (Alg. 4 line 21)."""
        for a, dd in self.delta_out.items():
            for b, op in dd.items():
                if op == "+":
                    self.prev.add_edge(a, b)
                else:
                    self.prev.remove_edge(a, b)
        for m in self._mirrors:
            m.on_host_end_step()
        self.delta_out = {}
        self.delta_in = {}

    # --------------------------------------------------------------- queries
    def start_vertices(self) -> List[int]:
        """Vertices with non-empty ΔΓ_out (Alg. 4 line 10)."""
        return sorted(self.delta_out.keys())

    def delta_adj_out(self, v: int) -> List[Tuple[str, int]]:
        """ΔΓ_out(v) as ``[('+'|'-', neighbor)]`` sorted by neighbor id."""
        dd = self.delta_out.get(v, {})
        return sorted(((op, w) for w, op in dd.items()), key=lambda x: x[1])

    def get_adj(self, v: int, type_: str, direction: str,
                op: str) -> frozenset:
        """Γ^{type,direction}_{G'_?}(v); ``?`` = t if op=='+', t-1 if op=='-'."""
        self.total_queries += 1
        prev = self.prev.out[v] if direction == "out" else self.prev.inn[v]
        dd = (self.delta_out if direction == "out" else self.delta_in
              ).get(v, {})
        inserted = {w for w, o in dd.items() if o == "+"}
        deleted = {w for w, o in dd.items() if o == "-"}
        unaltered = prev - deleted
        if type_ == "unaltered":
            return frozenset(unaltered)
        if type_ == "either":
            if op == "+":     # G'_t
                return frozenset(unaltered | inserted)
            return frozenset(prev)
        if type_ == "delta":
            if op == "+":
                return frozenset(inserted)
            return frozenset(deleted)
        raise ValueError(type_)

    # ------------------------------------------------------ device layout
    def device_snapshot(self, lane: int = 8,
                        d_min: int = 0, delta_d_min: int = 0
                        ) -> DeviceSnapshot:
        """Materialize the begun step as the six padded row blocks (host
        build, from scratch — the simple reference path; the streaming
        engine keeps a :class:`DeviceSnapshotStore` instead, which stays
        resident on the device and advances incrementally).

        ``d_min``/``delta_d_min`` are width floors (rounded up to ``lane``):
        pinning them across time steps keeps the block shapes fixed over a
        stream.
        """
        n = self.n
        sets_by_dir = {"out": self.prev.out, "in": self.prev.inn}
        delta_by_dir = {"out": self.delta_out, "in": self.delta_in}
        blocks: Dict[str, np.ndarray] = {}
        for di in ("out", "in"):
            prev_sets = sets_by_dir[di]
            dd = delta_by_dir[di]
            prev_adj = [np.array(sorted(s), dtype=np.int64)
                        for s in prev_sets]
            cur_adj = list(prev_adj)
            for v, ops in dd.items():
                cur = set(prev_sets[v])
                for w, op in ops.items():
                    (cur.add if op == "+" else cur.discard)(w)
                cur_adj[v] = np.array(sorted(cur), dtype=np.int64)
            # prev/cur share a width so the per-row op selector is a where()
            d = max(max((len(a) for a in prev_adj), default=0),
                    max((len(a) for a in cur_adj), default=0), d_min)
            blocks[f"prev_{di}"] = _with_sentinel_row(
                pad_rows(prev_adj, n, d_max=d, lane=lane), n)
            blocks[f"cur_{di}"] = _with_sentinel_row(
                pad_rows(cur_adj, n, d_max=d, lane=lane), n)
            d_delta = max(max((len(ops) for ops in dd.values()), default=0),
                          delta_d_min)
            dvals = [np.zeros(0, dtype=np.int64)] * n
            dsigns: List[np.ndarray] = [np.zeros(0, dtype=np.int64)] * n
            for v, ops in dd.items():
                ws = sorted(ops)
                dvals[v] = np.array(ws, dtype=np.int64)
                dsigns[v] = np.array([1 if ops[w] == "+" else -1
                                      for w in ws], dtype=np.int64)
            vals = _with_sentinel_row(
                pad_rows(dvals, n, d_max=d_delta, lane=lane), n)
            signs = pad_rows(dsigns, 0, d_max=d_delta, lane=lane)
            # sign holes are 0 (pad_rows fills with its sentinel arg)
            blocks[f"delta_{di}"] = vals
            blocks[f"delta_{di}_sign"] = _with_sentinel_row(signs, 0)
        return DeviceSnapshot(n=n, **blocks)

    # ----------------------------------------------------------- test helpers
    def snapshot(self, which: str) -> DiGraph:
        """Materialize G'_t ('cur') or G'_{t-1} ('prev') — test oracle only."""
        if which == "prev":
            return self.prev.copy()
        g = self.prev.copy()
        for a, dd in self.delta_out.items():
            for b, op in dd.items():
                if op == "+":
                    g.add_edge(a, b)
                else:
                    g.remove_edge(a, b)
        return g


def stream_width_floors(g0: DiGraph, batches: Sequence[Sequence[Update]]
                        ) -> Tuple[int, int]:
    """``(d_min, delta_d_min)`` pinning snapshot widths over a whole known
    update stream, so the resident blocks are built once per stream
    instead of rebuilt whenever a step's max degree or delta degree
    outgrows them."""
    cur = g0.copy()
    d = max(max((len(s) for s in cur.out), default=0),
            max((len(s) for s in cur.inn), default=0))
    dd = 0
    for batch in batches:
        touched_out: Dict[int, int] = {}
        touched_in: Dict[int, int] = {}
        for op, a, b in batch:
            touched_out[a] = touched_out.get(a, 0) + 1
            touched_in[b] = touched_in.get(b, 0) + 1
            if op == "+":
                cur.add_edge(a, b)
            else:
                cur.remove_edge(a, b)
        dd = max(dd, max(touched_out.values(), default=0),
                 max(touched_in.values(), default=0))
        d = max(d, max((len(s) for s in cur.out), default=0),
                max((len(s) for s in cur.inn), default=0))
    return d, dd


def derive_rows(prev: torch.Tensor, tids: torch.Tensor, dvals: torch.Tensor,
                dsigns: torch.Tensor, n: int) -> torch.Tensor:
    """``G'_t`` rows of the touched vertices ``tids``: their ``prev`` rows
    minus the entries flagged ``-`` in their delta rows, merged with the
    entries flagged ``+`` (concat + row sort + cut back to width D; the
    merged row fits by the width guard). Rows stay sorted with tail
    holes. The device twin of ``DeviceSnapshotStore._derive_host``."""
    d = prev.shape[1]
    rows = prev.index_select(0, tids)                # [K, D]
    dv = dvals.index_select(0, tids)                 # [K, Dd]
    ds = dsigns.index_select(0, tids)
    deleted = dv.masked_fill(ds >= 0, n)
    hit = (rows[:, :, None] == deleted[:, None, :]).any(dim=2)
    unalt = rows.masked_fill(hit, n)
    plus = dv.masked_fill(ds <= 0, n)
    return torch.sort(torch.cat([unalt, plus], dim=1), dim=1).values[:, :d]


class DeviceSnapshotStore:
    """Device-resident dual-snapshot row store (the streaming fast path).

    Keeps the ``prev`` blocks resident on the device across time steps and
    advances them incrementally, so per-step host work is O(|ΔE|) instead
    of an O(N) Python rebuild:

    * :meth:`step_snapshot` (store begun): scatter the update batch into
      the delta value/sign buffers (vectorized COO build), then derive
      ``G'_t`` **on the device, touched rows only** (:func:`derive_rows`),
      writing it into the second half of a fresh ``[2(N+1), D]`` buffer
      whose first half is a copy of ``prev``: the stacked block the
      engine's per-row snapshot selector reads, built once per step.
      Per-step device cost is O(|ΔV|·D) plus two O(N·D) copies.
    * end_step (via the :class:`SnapshotStore` mirror hook): the merged
      snapshot IS the cur half, so promotion is buffer adoption
      (``prev <- cur``). Width overflow drops the mirror; the next step
      rebuilds with wider rows.

    Rebuild triggers (all O(N), rare; counted in ``rebuilds``): first use,
    a touched row outgrowing the pinned width, or the host store advancing
    without this mirror (e.g. interpreter steps in between).

    ``storage`` selects where the resident ``prev`` blocks live:

    * ``'device'`` (default): tensors on ``device`` — fastest per step, but
      the dual snapshot must fit the card;
    * ``'host'``: :class:`~repro_torch.graph.hoststore.HostRowStore` shards
      in host RAM, advanced **in place** by patching only the touched rows
      at ``end_step`` (O(|ΔV|·D) host work — no O(N) rebuild, no
      persistent device memory). :meth:`step_snapshot` then materializes
      full numpy blocks for the step (moved to the device by the caller
      and freed after); :meth:`row_source` serves per-row ``prev``/``cur``
      views for the bounded-device cache fetch path
      (``distributed/rowcache.py``).
    """

    def __init__(self, store: SnapshotStore, lane: int = 8,
                 d_min: int = 0, delta_d_min: int = 0,
                 storage: str = "device", device=None):
        from ..core.engine_torch import resolve_device
        if storage not in ("device", "host"):
            raise ValueError(f"storage must be device|host, got {storage!r}")
        self.host = store
        self.n = store.n
        self.storage = storage
        self.device = resolve_device(device)
        self.params = (lane, d_min, delta_d_min, storage, self.device)
        self.lane, self.d_min, self.delta_d_min = lane, d_min, delta_d_min
        # di -> tensor [N+1, D] (device mode) | HostRowStore (host mode)
        self._prev: Optional[Dict[str, object]] = None
        self._d: Dict[str, int] = {}
        self._cur: Dict[str, torch.Tensor] = {}
        # host mode: di -> (touched ids int64[K], merged rows int32[K, D])
        self._cur_host: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self._pending_t: Optional[int] = None
        self.rebuilds = 0
        store._mirrors.append(self)

    @classmethod
    def for_store(cls, store: SnapshotStore, lane: int = 8,
                  d_min: int = 0, delta_d_min: int = 0,
                  storage: str = "device",
                  device=None) -> "DeviceSnapshotStore":
        """Reuse an existing mirror with the same layout parameters."""
        from ..core.engine_torch import resolve_device
        key = (lane, d_min, delta_d_min, storage, resolve_device(device))
        for m in store._mirrors:
            if isinstance(m, cls) and m.params == key:
                return m
        return cls(store, lane=lane, d_min=d_min, delta_d_min=delta_d_min,
                   storage=storage, device=device)

    def _round(self, x: int) -> int:
        return ((max(x, 1) + self.lane - 1) // self.lane) * self.lane

    def _rebuild_prev(self) -> None:
        """Full host build of the resident prev blocks (stream start or
        width overflow); accounts for this step's inserts so cur fits.
        Device mode puts ``[N+1, D]`` tensors on the device; host mode
        builds :class:`HostRowStore` shards (one shard transient at a
        time)."""
        from .hoststore import HostRowStore
        self.rebuilds += 1
        n = self.n
        self._prev = {}
        for di, sets, delta in (("out", self.host.prev.out,
                                 self.host.delta_out),
                                ("in", self.host.prev.inn,
                                 self.host.delta_in)):
            need = max((len(sets[v])
                        + sum(1 for op in ops.values() if op == "+")
                        for v, ops in delta.items()), default=0)
            d = self._round(max(max((len(s) for s in sets), default=0),
                                need, self.d_min))
            if self.storage == "host":
                self._prev[di] = HostRowStore.from_adj(
                    lambda v: sorted(sets[v]), n, d)
            else:
                rows = np.full((n + 1, d), n, np.int32)
                for v, s in enumerate(sets):
                    a = sorted(s)
                    rows[v, :len(a)] = a
                self._prev[di] = torch.from_numpy(rows).to(self.device)
            self._d[di] = d

    def _delta_buffers(self, delta: Dict[int, Dict[int, str]]
                       ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Vectorized COO scatter of one direction's delta dicts into
        fresh value/sign buffers."""
        n = self.n
        items = [(v, w, 1 if op == "+" else -1)
                 for v, ops in delta.items() for w, op in ops.items()]
        if not items:
            dd = self._round(self.delta_d_min)
            return (np.full((n + 1, dd), n, np.int32),
                    np.zeros((n + 1, dd), np.int32), 0)
        arr = np.asarray(items, np.int64)
        arr = arr[np.lexsort((arr[:, 1], arr[:, 0]))]
        src = arr[:, 0]
        gstart = np.flatnonzero(np.r_[True, src[1:] != src[:-1]])
        counts = np.diff(np.r_[gstart, len(src)])
        pos = np.arange(len(src)) - np.repeat(gstart, counts)
        dd = self._round(max(int(counts.max()), self.delta_d_min))
        vals = np.full((n + 1, dd), n, np.int32)
        signs = np.zeros((n + 1, dd), np.int32)
        vals[src, pos] = arr[:, 1]
        signs[src, pos] = arr[:, 2]
        return vals, signs, int(counts.max())

    def _derive_host(self, store, delta: Dict[int, Dict[int, str]]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Host-side merge of the touched rows: ``(tids int64[K],
        merged int32[K, D])`` — G'_t rows for exactly the touched
        vertices, O(|ΔV|·D) work (the numpy twin of :func:`derive_rows`)."""
        n = self.n
        touched = np.asarray(sorted(delta), np.int64)
        if touched.size == 0:
            return touched, np.zeros((0, store.d), np.int32)
        rows = store.gather(touched)
        for i, v in enumerate(touched):
            ops = delta[int(v)]
            cur = {int(x) for x in rows[i] if x != n}
            for w, op in ops.items():
                (cur.add if op == "+" else cur.discard)(w)
            a = sorted(cur)
            rows[i] = n
            rows[i, :len(a)] = a       # fits: step_snapshot width guard
        return touched, rows

    def _ensure_prev_fits(self) -> None:
        """Width guard shared by every per-step entry point: a touched row
        of G'_t outgrowing the pinned width forces a wider rebuild
        (deletes only shrink rows)."""
        st = self.host
        if self._prev is not None:
            for di, sets, delta in (("out", st.prev.out, st.delta_out),
                                    ("in", st.prev.inn, st.delta_in)):
                if any(len(sets[v]) + sum(1 for op in ops.values()
                                          if op == "+") > self._d[di]
                       for v, ops in delta.items()):
                    self._prev = None
                    break
        if self._prev is None:
            self._rebuild_prev()

    def _ensure_step_cur_host(self) -> None:
        """Host mode: derive (and cache) both directions' merged touched
        rows for the begun step, once per step — row_source() and
        step_snapshot() share this state, and setting ``_pending_t``
        makes ``end_step`` patch the shards in place instead of
        discarding them."""
        st = self.host
        self._ensure_prev_fits()
        if self._pending_t == st.t and len(self._cur_host) == 2:
            return
        self._cur_host = {
            di: self._derive_host(self._prev[di], delta)
            for di, delta in (("out", st.delta_out), ("in", st.delta_in))}
        self._pending_t = st.t

    def step_snapshot(self) -> DeviceSnapshot:
        """Six blocks for the host store's begun step: tensors on the
        device with their stacked prev/cur buffers (device mode), numpy
        arrays (host mode)."""
        st = self.host
        if self.storage == "host":
            # host mode: merge touched rows on host (O(|ΔV|·D)), assemble
            # numpy blocks for the step (the bounded-device path serves
            # rows via row_source() instead)
            self._ensure_step_cur_host()
            blocks_h: Dict[str, np.ndarray] = {}
            for di, delta in (("out", st.delta_out), ("in", st.delta_in)):
                vals, signs, _ = self._delta_buffers(delta)
                hs = self._prev[di]
                tids, merged = self._cur_host[di]
                prev_full = hs.to_rows()
                cur_full = prev_full.copy()
                if tids.size:
                    cur_full[tids] = merged
                blocks_h[f"prev_{di}"] = prev_full
                blocks_h[f"cur_{di}"] = cur_full
                blocks_h[f"delta_{di}"] = vals
                blocks_h[f"delta_{di}_sign"] = signs
            return DeviceSnapshot(n=self.n, **blocks_h)
        self._ensure_prev_fits()
        dev, n = self.device, self.n
        blocks: Dict[str, object] = {}
        for di, delta in (("out", st.delta_out), ("in", st.delta_in)):
            vals, signs, _ = self._delta_buffers(delta)
            tvals = torch.from_numpy(vals).to(dev)
            tsigns = torch.from_numpy(signs).to(dev)
            tids = torch.from_numpy(
                np.asarray(sorted(delta), np.int64)).to(dev)
            prev = self._prev[di]
            stacked = torch.empty((2 * (n + 1), prev.shape[1]),
                                  dtype=torch.int32, device=dev)
            stacked[:n + 1].copy_(prev)
            cur = stacked[n + 1:]
            cur.copy_(prev)
            cur.index_copy_(0, tids, derive_rows(prev, tids, tvals, tsigns,
                                                 n))
            self._cur[di] = cur
            blocks[f"stacked_{di}"] = stacked
            blocks[f"prev_{di}"] = stacked[:n + 1]
            blocks[f"cur_{di}"] = cur
            blocks[f"delta_{di}"] = tvals
            blocks[f"delta_{di}_sign"] = tsigns
        self._pending_t = st.t
        return DeviceSnapshot(n=n, **blocks)

    def on_host_end_step(self) -> None:
        """SnapshotStore mirror hook (post-merge): promote cur -> prev.

        Device mode adopts the derived cur halves; host mode patches the
        touched rows back into the host shards in place (O(|ΔV|·D))."""
        st = self.host
        if self._prev is None:
            return
        if self._pending_t != st.t:
            self._prev = None            # store advanced without us
            return
        for di, sets, delta in (("out", st.prev.out, st.delta_out),
                                ("in", st.prev.inn, st.delta_in)):
            if any(len(sets[v]) > self._d[di] for v in delta):
                self._prev = None        # merged row overflows: rebuild
                return
        if self.storage == "host":
            for di in ("out", "in"):
                tids, merged = self._cur_host.get(
                    di, (np.zeros(0, np.int64), None))
                if tids.size:
                    self._prev[di].set_rows(tids, merged)
            self._cur_host = {}
            self._pending_t = None
            return
        for di in ("out", "in"):
            self._prev[di] = self._cur[di]   # promotion is buffer adoption
        self._cur = {}
        self._pending_t = None

    # ------------------------------------------------- bounded row serving
    def row_source(self, direction: str, which: str = "cur"
                   ) -> "SnapshotRowView":
        """A :class:`HostRowStore`-shaped view over one resident block.

        Host mode only (device mode already has the block resident).
        ``which='prev'`` serves G'_{t-1} rows straight from the shards;
        ``which='cur'`` overlays the begun step's merged touched rows.
        Feed the view to ``distributed.rowcache.DeviceRowCache`` to serve
        snapshot rows with bounded device residency.

        Coherence across steps: ``end_step`` patches the backing shards
        **in place**, so a ``DeviceRowCache`` kept alive across steps
        must be told — call ``cache.invalidate(touched_ids)`` after
        ``end_step`` (only ``'prev'`` views are meaningful to keep; a
        ``'cur'`` view's overlay is per-step by construction, so request
        a fresh one via this method each step). A *rebuild* of the
        resident shards (``self.rebuilds`` increments) replaces the
        backing store wholesale — rebuild any long-lived cache when that
        counter changes. The view itself always resolves the mirror's
        current store, so it never serves an orphaned pre-rebuild copy.
        """
        if self.storage != "host":
            raise ValueError("row_source() requires storage='host'")
        if which == "prev":
            self._ensure_prev_fits()
            return SnapshotRowView(self, direction, {})
        if which != "cur":
            raise ValueError(f"which must be prev|cur, got {which!r}")
        # derives once per step (both directions) and marks the step
        # pending, so end_step patches the shards in place
        self._ensure_step_cur_host()
        tids, merged = self._cur_host[direction]
        return SnapshotRowView(
            self, direction,
            {int(v): merged[i] for i, v in enumerate(tids)})


class SnapshotRowView:
    """Read-only ``HostRowStore``-API view over one direction of a
    host-mode :class:`DeviceSnapshotStore`, plus per-step row patches.

    Duck-types the three members ``DeviceRowCache`` needs (``n``, ``d``,
    ``gather``); ``patches`` maps vertex id -> replacement row
    (``int32[d]``, sentinel-padded). The backing shards are resolved
    through the mirror on every access, so a width rebuild swaps in the
    new store here transparently (callers holding a ``DeviceRowCache``
    over the view still need to rebuild it then — the cached row width
    changes; see :meth:`DeviceSnapshotStore.row_source`).
    """

    def __init__(self, mirror: "DeviceSnapshotStore", direction: str,
                 patches: Dict[int, np.ndarray]):
        self.mirror = mirror
        self.direction = direction
        self.patches = patches
        self.n = mirror.n

    @property
    def base(self):
        return self.mirror._prev[self.direction]

    @property
    def d(self) -> int:
        return self.base.d

    def gather(self, ids: np.ndarray,
               out: Optional[np.ndarray] = None) -> np.ndarray:
        """Dense ``int32[K, d]`` rows with patches applied (clip
        semantics and ``out`` as in :meth:`HostRowStore.gather`)."""
        out = self.base.gather(ids, out=out)
        if self.patches:
            flat = np.clip(np.asarray(ids, np.int64).reshape(-1), 0, self.n)
            for i, v in enumerate(flat):
                p = self.patches.get(int(v))
                if p is not None:
                    out[i] = p
        return out
