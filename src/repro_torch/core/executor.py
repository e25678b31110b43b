"""Unified Executor API of the port: one driver, the torch backends.

Counterpart of ``repro/core/executor.py``: the driver half is a copy
(start batching, universe chunks, the §5.2 adaptive task split: an
overflowing chunk is re-chunked into smaller start batches before its
capacities grow, so no match is ever dropped), and the backends are the
port's own::

    ref          pure-Python oracle interpreter         (core/ref_engine.py)
    torch        single-device frontier engine, unfused (core/engine_torch.py)
    torch-gpu    same engine, fused gather+intersect
                 fetch path (csrc/gather_intersect.cu)  (core/engine_torch.py)
    dist         one process per shard over
                 torch.distributed: row store by
                 all_to_all, hot rows replicated        (core/engine_dist.py)
    oocache      out-of-core: host-RAM row shards +
                 bounded device row cache + async
                 prefetch                               (core/engine_ooc.py)
    sbenu        continuous/delta enumeration,
                 interpreted on the host                (core/sbenu.py)
    sbenu-torch  vectorized continuous enumeration      (core/engine_sbenu_torch.py)
    sbenu-dist   the same over the rank-sharded
                 six-block snapshot                     (core/engine_sbenu_dist.py)

``ref`` and ``sbenu`` run on the host. The others run on ``cuda`` unless
given ``device=``; with no device and no card they raise. ``dist`` and
``sbenu-dist`` run in every rank of an initialised process group (NCCL
with one card a rank, gloo with ``device='cpu'``) and raise without one.

    >>> from repro_torch.core.executor import make_executor
    >>> from repro_torch.core.pattern import get_pattern
    >>> from repro_torch.core.plangen import generate_best_plan
    >>> from repro_torch.graph.generate import erdos_renyi
    >>> g = erdos_renyi(30, 60, seed=1)                # 30 vertices
    >>> plan = generate_best_plan(get_pattern("triangle"), g.stats())
    >>> ex = make_executor("torch", device="cpu")
    >>> ex.run(plan, g, batch=8).count == ex.run(plan, g, batch=32).count
    True
"""

from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

import torch

from ..graph.storage import Graph
from .engine_torch import (DeviceGraph, build_enumerator, check_jit_supported,
                           default_caps, resolve_device)
from .instructions import ENU, Plan
from .pattern import Pattern


# --------------------------------------------------------------------------
# Shared frontier-lifecycle helpers (previously copied in every engine)
# --------------------------------------------------------------------------


def ceil_div(a: int, b: int) -> int:
    """``ceil(a / b)`` for non-negative ints (no float detour)."""
    return -(-a // b)


def start_id_batches(n: int, batch: int,
                     sentinel: Optional[int] = None
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(ids int32[batch], valid bool[batch])`` covering ``range(n)``."""
    sent = n if sentinel is None else sentinel
    for s0 in range(0, n, batch):
        ids = np.arange(s0, s0 + batch, dtype=np.int32)
        valid = ids < n
        yield np.where(valid, ids, sent).astype(np.int32), valid


def build_universe_chunks(n: int, width: int,
                          sentinel: Optional[int] = None) -> List[np.ndarray]:
    """Sentinel-padded slices of V(G) for plans with a detached vertex
    (the paper's |V(G)|/θ subtask split for non-adjacent (u_k1, u_k2))."""
    sent = n if sentinel is None else sentinel
    w = min(width, max(n, 1))
    chunks: List[np.ndarray] = []
    for u0 in range(0, n, w):
        c = np.full(w, sent, np.int32)
        hi = min(u0 + w, n)
        c[:hi - u0] = np.arange(u0, hi, dtype=np.int32)
        chunks.append(c)
    return chunks


def split_id_batch(ids: np.ndarray, valid: np.ndarray, granularity: int,
                   sentinel: int
                   ) -> Optional[List[Tuple[np.ndarray, np.ndarray]]]:
    """Split a start batch into two half-shaped batches (§5.2 task split).

    The valid ids are dealt evenly into two arrays of length
    ``ceil(B/2)`` rounded up to ``granularity`` (mesh width for the
    distributed backend). Returns ``None`` when the batch cannot shrink
    further.
    """
    B = ids.shape[0]
    # ceil(B/2) rounded up to granularity: a half always fits its
    # ceil(nv/2) valid ids — no start may ever be truncated away
    half = ceil_div(ceil_div(B, 2), granularity) * granularity if B > 1 else 0
    if half < granularity or half >= B:
        return None
    vids = ids[valid]
    out = []
    for part in (vids[0::2], vids[1::2]):
        a = np.full(half, sentinel, np.int32)
        v = np.zeros(half, bool)
        k = part.shape[0]
        a[:k] = part
        v[:k] = True
        out.append((a, v))
    return out


def plan_enu_count(plan: Plan) -> int:
    """Number of ENU instructions == number of per-level capacities a
    static-engine caps tuple must carry."""
    return sum(1 for ins in plan.instrs if ins.op == ENU)


# --------------------------------------------------------------------------
# Protocol types
# --------------------------------------------------------------------------


@dataclass
class ExecutorConfig:
    """Driver-level policy shared by every backend.

    Units: ``batch`` and ``universe_chunk`` count start vertices /
    universe ids per chunk; ``caps[i]`` counts child-frontier rows at the
    i-th ENU level; ``theta`` counts C2 candidates (the interpreter's
    task-split threshold, paper §6.3).
    """

    batch: int = 256                 # global start-vertex chunk size
    caps: Optional[Sequence[int]] = None   # per-ENU frontier capacities
    universe_chunk: int = 1024       # width of V(G) slices (detached vertex)
    max_retries: int = 6             # capacity-doubling budget per chunk
    adaptive_split: bool = True      # re-chunk before growing capacities
    collect_matches: bool = False
    intersect_impl: str = "auto"
    theta: Optional[int] = None      # interpreter task-split threshold


@dataclass
class ChunkResult:
    """One chunk execution. ``overflow``/``drops`` > 0 invalidates the
    result: the driver discards it and re-chunks or escalates."""

    count: int                       # matches found in the chunk
    overflow: int = 0                # children dropped at some ENU level
    drops: int = 0                   # fetch requests beyond req_cap (dist)
    matches: Optional[np.ndarray] = None   # int32[k, plan.n], valid rows only
    extras: Dict[str, Any] = field(default_factory=dict)


@dataclass
class ExecStats:
    """Driver result: exact totals + overflow/splitting accounting."""

    count: int = 0
    chunks_run: int = 0
    chunks_split: int = 0            # adaptive re-chunk events
    chunks_retried: int = 0          # capacity/request escalations
    drops_seen: int = 0
    matches: Optional[np.ndarray] = None
    extras: Dict[str, Any] = field(default_factory=dict)

    def merge_extras(self, other: Dict[str, Any]) -> None:
        """Accumulate a chunk's extras (values must support ``+``)."""
        for k, v in other.items():
            if k in self.extras:
                self.extras[k] = self.extras[k] + v
            else:
                self.extras[k] = v


class ExecutorBackend(ABC):
    """What an engine must provide: its fetch/intersect/shard specifics.

    The driver owns chunking, retries, and splitting; backends execute one
    fixed-shape chunk at a time and report overflow honestly.
    """

    name: str = "?"
    #: start-batch shapes must be multiples of this (mesh width for SPMD)
    granularity: int = 1
    #: frontier capacities must be multiples of this: the driver rounds
    #: every caps tuple it hands out (initial and escalated) up to it.
    #: SPMD backends set the mesh size — their rebalancer stripes a local
    #: frontier round-robin over the axis, which needs cap % S == 0
    cap_multiple: int = 1
    #: whether the driver may re-chunk this backend's batches
    splittable: bool = True

    @abstractmethod
    def prepare(self, plan: Any, source: Any, config: ExecutorConfig) -> None:
        """Plan preprocessing + device placement. Called once per run."""

    @abstractmethod
    def run_chunk(self, ids: np.ndarray, valid: np.ndarray,
                  universe_chunk: Optional[np.ndarray],
                  caps: Tuple[int, ...]) -> ChunkResult:
        """Execute one fixed-shape chunk of start vertices."""

    def start_batches(self, config: ExecutorConfig
                      ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yield ``(ids int32[batch], valid bool[batch])`` start chunks."""
        yield from start_id_batches(self._n_starts(), config.batch)

    def universe_chunks(self, config: ExecutorConfig
                        ) -> Sequence[Optional[np.ndarray]]:
        """Sentinel-padded V(G) slices (``int32[W]``) for detached-vertex
        plans; ``[None]`` when the plan never consumes V(G)."""
        return [None]

    def initial_caps(self, config: ExecutorConfig) -> Tuple[int, ...]:
        """Per-ENU child-frontier capacities (rows) for the first attempt."""
        return ()

    def grow_caps(self, caps: Tuple[int, ...]) -> Tuple[int, ...]:
        """Escalated capacities once a chunk is unsplittable (default 2x)."""
        return tuple(int(c * 2) for c in caps)

    def escalate_requests(self) -> None:
        """Called when a chunk reported request drops (dist fetch only)."""

    def finalize(self, stats: ExecStats) -> None:
        """Attach backend-specific extras to the driver stats."""

    def _n_starts(self) -> int:
        raise NotImplementedError


# --------------------------------------------------------------------------
# The adaptive task-splitting driver
# --------------------------------------------------------------------------


def drive(backend: ExecutorBackend, plan: Any, source: Any,
          config: ExecutorConfig) -> ExecStats:
    """Run ``plan`` over ``source`` on ``backend`` — exactly.

    A chunk that overflows is never silently truncated: its (partial)
    result is discarded, and the driver re-descends either on two smaller
    sub-chunks (adaptive task splitting — same capacities, smaller
    frontiers) or, once a chunk is a single unsplittable batch, with
    doubled capacities.
    """
    backend.prepare(plan, source, config)
    stats = ExecStats()
    all_matches: List[np.ndarray] = []
    # every caps tuple the driver hands out is rounded up to the backend's
    # cap_multiple (read after prepare(): SPMD backends learn their mesh
    # size there). This is what keeps user-supplied or degree-derived odd
    # capacities from tripping the rebalancer's cap % mesh-size assert.
    mult = max(int(getattr(backend, "cap_multiple", 1)), 1)

    def round_caps(caps: Sequence[int]) -> Tuple[int, ...]:
        return tuple(ceil_div(int(c), mult) * mult for c in caps)

    caps0 = round_caps(backend.initial_caps(config))
    sentinel = getattr(backend, "sentinel", 0)
    for ids, valid in backend.start_batches(config):
        for uni in backend.universe_chunks(config):
            # (ids, valid, caps, escalations) — LIFO work stack
            work: List[Tuple[np.ndarray, np.ndarray, Tuple[int, ...], int]]
            work = [(ids, valid, caps0, 0)]
            while work:
                cids, cvalid, caps, tries = work.pop()
                if not cvalid.any():
                    continue
                res = backend.run_chunk(cids, cvalid, uni, caps)
                stats.chunks_run += 1
                ok = res.overflow == 0 and res.drops == 0
                if ok:
                    stats.count += int(res.count)
                    stats.merge_extras(res.extras)
                    if res.matches is not None:
                        all_matches.append(res.matches)
                    continue
                if res.drops > 0:
                    stats.drops_seen += int(res.drops)
                    backend.escalate_requests()
                halves = None
                if (res.overflow > 0 and config.adaptive_split
                        and backend.splittable):
                    halves = split_id_batch(cids, cvalid,
                                            backend.granularity, sentinel)
                if halves is not None:
                    stats.chunks_split += 1
                    for h_ids, h_valid in halves:
                        work.append((h_ids, h_valid, caps, tries))
                    continue
                if tries >= config.max_retries:
                    raise RuntimeError(
                        f"[{backend.name}] chunk overflowed after "
                        f"{tries} escalations (caps={caps})")
                stats.chunks_retried += 1
                new_caps = round_caps(backend.grow_caps(caps)) \
                    if res.overflow else caps
                work.append((cids, cvalid, new_caps, tries + 1))
    if config.collect_matches:
        stats.matches = (np.concatenate(all_matches, axis=0) if all_matches
                         else np.zeros((0, getattr(plan, "n", 0)), np.int32))
    backend.finalize(stats)
    return stats


class Executor:
    """Facade: ``Executor(backend).run(plan, graph, batch=..., ...)``."""

    def __init__(self, backend: ExecutorBackend):
        self.backend = backend

    def run(self, plan: Any, source: Any,
            config: Optional[ExecutorConfig] = None, **kwargs) -> ExecStats:
        """Enumerate ``plan`` over ``source`` exactly; ``kwargs`` are
        :class:`ExecutorConfig` fields (``batch=``, ``caps=``, ...)."""
        cfg = config if config is not None else ExecutorConfig(**kwargs)
        return drive(self.backend, plan, source, cfg)


# --------------------------------------------------------------------------
# Backend: reference interpreter (pure Python oracle)
# --------------------------------------------------------------------------


class RefBackend(ExecutorBackend):
    """Per-task backtracking interpreter (core/ref_engine.py); the
    correctness oracle, on the host.

    Capacities do not exist here (recursion never overflows), but the
    paper's θ task splitting does: heavy start vertices split into C2
    slices inside :meth:`run_chunk`. On a VCBC plan the count is the
    number of codes reported, as in the reference.
    """

    name = "ref"
    splittable = True

    def __init__(self, db=None, collect: str = "count",
                 pattern: Optional[Pattern] = None):
        self._db = db
        self._collect = collect
        self._given_pattern = pattern
        self.engine = None

    def prepare(self, plan: Plan, source: Graph,
                config: ExecutorConfig) -> None:
        from .ref_engine import RefEngine
        self.plan, self.graph = plan, source
        self.sentinel = source.n
        collect = self._collect
        if config.collect_matches and collect == "count":
            collect = "matches"
        self.engine = RefEngine(plan, self._pattern(plan), source,
                                db=self._db, collect=collect)
        self._theta = config.theta

    def _pattern(self, plan: Plan) -> Pattern:
        if self._given_pattern is not None:
            return self._given_pattern
        from .pattern import get_pattern
        return get_pattern(plan.pattern_name)

    def _n_starts(self) -> int:
        return self.graph.n

    def run_chunk(self, ids, valid, universe_chunk, caps) -> ChunkResult:
        from .ref_engine import tasks_for_starts
        eng = self.engine
        tasks = tasks_for_starts(self.plan, eng.pattern, self.graph,
                                 ids[valid], theta=self._theta)
        m0 = eng.counters.matches
        k0 = len(eng.matches)
        eng.run(tasks=tasks)
        matches = None
        if eng.collect == "matches":
            matches = np.asarray(eng.matches[k0:], np.int32).reshape(
                -1, self.plan.n)
        return ChunkResult(count=eng.counters.matches - m0, matches=matches)

    def finalize(self, stats: ExecStats) -> None:
        c = self.engine.counters
        stats.extras.update(
            dbq=c.dbq, int_=c.int_, trc=c.trc, trc_hits=c.trc_hits,
            enu=c.enu, per_task_work=list(c.per_task_work),
            remote_queries=self.engine.db.remote_queries,
            total_queries=self.engine.db.total_queries)


# --------------------------------------------------------------------------
# Backends: single-device frontier engine
# --------------------------------------------------------------------------


class TorchBackend(ExecutorBackend):
    """Lockstep frontier expansion on one device (core/engine_torch.py).

    The backend alone decides the fetch path: ``torch`` gathers every DBQ
    row set, ``torch-gpu`` (``fused = True``) never materializes the
    single-use ones, whose consuming INT probes the adjacency rows
    directly (csrc/gather_intersect.cu). ``gather_intersect_impl`` picks
    the fused op's impl (auto | cuda | ref/chunked/binary).
    """

    name = "torch"
    fused = False

    def __init__(self, device=None, compaction: str = "cumsum",
                 gather_intersect_impl: str = "auto"):
        self.device = resolve_device(device)
        self._compaction = compaction
        self._gi_impl = gather_intersect_impl

    def prepare(self, plan: Plan, source: Graph,
                config: ExecutorConfig) -> None:
        t0 = time.perf_counter()
        self.plan, self.graph = plan, source
        self.dg = DeviceGraph.from_graph(source, self.device)
        self.fetch = self.dg.local_fetch()
        self.sentinel = self.dg.n
        self.has_universe = check_jit_supported(plan)
        self._caps0 = tuple(config.caps) if config.caps is not None else \
            tuple(default_caps(plan, config.batch, self.dg.d))
        self._collect = config.collect_matches
        self._intersect = config.intersect_impl
        self._runners: Dict[Tuple[int, ...], Callable] = {}
        self._level_acc: Optional[np.ndarray] = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prepare_s = time.perf_counter() - t0

    def _n_starts(self) -> int:
        return self.graph.n

    def universe_chunks(self, config: ExecutorConfig):
        if not self.has_universe:
            return [None]
        return build_universe_chunks(self.graph.n, config.universe_chunk)

    def initial_caps(self, config: ExecutorConfig) -> Tuple[int, ...]:
        return self._caps0

    def _runner(self, caps: Tuple[int, ...]) -> Callable:
        if caps not in self._runners:
            self._runners[caps] = build_enumerator(
                self.plan, self.sentinel, caps, self.fetch,
                collect_matches=self._collect,
                intersect_impl=self._intersect,
                compaction=self._compaction,
                fused_rows=self.dg.rows if self.fused else None,
                gather_intersect_impl=self._gi_impl)
        return self._runners[caps]

    def run_chunk(self, ids, valid, universe_chunk, caps) -> ChunkResult:
        dev = self.device
        args = [torch.from_numpy(ids).to(dev), torch.from_numpy(valid).to(dev)]
        if universe_chunk is not None:
            args.append(torch.from_numpy(universe_chunk).to(dev))
        res = self._runner(tuple(caps))(*args)
        # one device->host read per chunk: count, overflow, level sizes
        head = torch.stack([res.count, res.overflow, *res.level_sizes])
        count, ov, *levels = head.cpu().tolist()
        matches = None
        if self._collect and ov == 0 and res.matches is not None:
            matches = res.matches[res.matches_valid].cpu().numpy()
        if ov == 0 and levels:
            # accepted chunks only: frontier occupancy per ENU level
            lv = np.asarray(levels, np.int64)
            self._level_acc = (lv if self._level_acc is None
                               else self._level_acc + lv)
        return ChunkResult(count=count, overflow=ov, matches=matches)

    def finalize(self, stats: ExecStats) -> None:
        stats.extras.update(
            level_sizes=(self._level_acc if self._level_acc is not None
                         else np.zeros(0, np.int64)),
            fused_fetch=self.fused,
            prepare_s=self._prepare_s)   # padding + copy of the rows


class TorchGpuBackend(TorchBackend):
    """``torch`` with the fused gather+intersect fetch path. Counts and
    match sets are bit-equal to ``torch``."""

    name = "torch-gpu"
    fused = True


# --------------------------------------------------------------------------
# Backend: one process per shard over torch.distributed
# --------------------------------------------------------------------------


def gather_to_all(group, row: torch.Tensor) -> torch.Tensor:
    """``[S, *row.shape]``: every rank's ``row``, in rank order, on every
    rank (one all_gather)."""
    import torch.distributed as dist
    rows = [torch.empty_like(row) for _ in range(dist.get_world_size(group))]
    dist.all_gather(rows, row, group=group)
    return torch.stack(rows)


class DistBackend(ExecutorBackend):
    """SPMD frontier engine with the distributed row store
    (core/engine_dist.py): this process is one rank of ``group`` (the
    initialised world by default; raises when there is none).

    Every rank walks the same global start batches (a multiple of S) and
    runs its own ``B/S`` slice; one all_gather per chunk hands every rank
    the per-rank counts, overflow, drops, cold rows and level sizes, so
    every rank returns the same :class:`ChunkResult` and the driver takes
    the same decisions everywhere. The device is ``cuda:<local rank>``
    (NCCL) unless ``device=`` says otherwise; a device the group's backend
    cannot carry raises.
    """

    name = "dist"

    def __init__(self, group=None, hot: int = 0, rebalance: bool = False,
                 req_cap: Optional[int] = None, device=None):
        resolve_device(device)           # no card and no device: raise
        self._group_arg = group
        self._device_arg = device
        self._hot = hot
        self._rebalance = rebalance
        self._req_cap0 = req_cap

    def prepare(self, plan: Plan, source: Graph,
                config: ExecutorConfig) -> None:
        import torch.distributed as dist
        from ..distributed.rowstore import build_row_shards
        from .engine_dist import enumeration_mesh, rank_device
        t0 = time.perf_counter()
        self.plan, self.graph = plan, source
        self.group = enumeration_mesh(self._group_arg)
        self.device = rank_device(self.group, self._device_arg)
        self.S = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.granularity = self.S
        self.cap_multiple = self.S       # rebalancer stripes (driver rounds)
        self.shard, self.hot_rows, self.spec = build_row_shards(
            source, self.S, self.rank, hot=self._hot, device=self.device)
        self.sentinel = self.spec.n
        self.has_universe = check_jit_supported(plan)
        batch_per_shard = max(config.batch // self.S, 1)
        caps = list(config.caps) if config.caps is not None else \
            default_caps(plan, batch_per_shard, self.spec.d)
        self._caps0 = tuple(ceil_div(c, self.S) * self.S for c in caps)
        self.req_cap = self._req_cap0 if self._req_cap0 is not None else \
            max(64, 2 * batch_per_shard // self.S)
        self._intersect = config.intersect_impl
        self._uni = [torch.from_numpy(c).to(self.device)
                     for c in build_universe_chunks(
                         source.n, config.universe_chunk)] \
            if self.has_universe else [None]
        self._steps: Dict[Tuple[Tuple[int, ...], int], Callable] = {}
        self._per_shard = np.zeros(self.S, np.int64)
        self._level_acc: Optional[np.ndarray] = None
        self._cold = 0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prepare_s = time.perf_counter() - t0

    def _n_starts(self) -> int:
        return self.graph.n

    def start_batches(self, config: ExecutorConfig):
        yield from start_id_batches(self.graph.n,
                                    ceil_div(config.batch, self.S) * self.S)

    def universe_chunks(self, config: ExecutorConfig):
        return self._uni

    def initial_caps(self, config: ExecutorConfig) -> Tuple[int, ...]:
        return self._caps0

    def escalate_requests(self) -> None:
        self.req_cap *= 2

    def _step(self, caps: Tuple[int, ...], req_cap: int) -> Callable:
        key = (caps, req_cap)
        if key not in self._steps:
            from .engine_dist import build_distributed_step
            self._steps[key] = build_distributed_step(
                self.plan, self.spec, self.group, caps, req_cap,
                rebalance=self._rebalance, intersect_impl=self._intersect)
        return self._steps[key]

    def run_chunk(self, ids, valid, universe_chunk, caps) -> ChunkResult:
        w = ids.shape[0] // self.S
        mine = slice(self.rank * w, (self.rank + 1) * w)
        starts = torch.from_numpy(ids[mine]).to(self.device)
        starts_valid = torch.from_numpy(valid[mine]).to(self.device)
        count, overflow, cold, drops, levels = self._step(
            tuple(caps), self.req_cap)(self.shard, self.hot_rows, starts,
                                       starts_valid, universe_chunk)
        # one gather, one device->host read: [S, 4 + levels] on every rank
        table = gather_to_all(self.group, torch.stack(
            [count, overflow, cold, drops, *levels])).cpu().numpy()
        ov, dr = int(table[:, 1].sum()), int(table[:, 3].sum())
        if ov or dr:
            return ChunkResult(count=0, overflow=ov, drops=dr)
        self._per_shard += table[:, 0]
        self._cold += int(table[:, 2].sum())
        lv = table[:, 4:].T
        self._level_acc = lv if self._level_acc is None \
            else self._level_acc + lv
        return ChunkResult(count=int(table[:, 0].sum()))

    def finalize(self, stats: ExecStats) -> None:
        stats.extras.update(
            per_shard_counts=self._per_shard,
            per_shard_level_sizes=(
                self._level_acc if self._level_acc is not None
                else np.zeros((0, self.S), np.int64)),
            cold_rows_fetched=self._cold,
            req_cap=self.req_cap,
            prepare_s=self._prepare_s)   # the rank's rows to the device


# --------------------------------------------------------------------------
# Backend: out-of-core fetch path (host-RAM shards + device row cache)
# --------------------------------------------------------------------------


class OocBackend(ExecutorBackend):
    """Out-of-core frontier enumeration (core/engine_ooc.py, paper §6).

    The padded adjacency lives in host-RAM shards
    (:class:`~repro_torch.graph.hoststore.HostRowStore`); device memory
    holds a bounded row cache
    (:class:`~repro_torch.distributed.rowcache.DeviceRowCache`:
    ``cache_rows`` LRU slots + the top-``hot``-by-degree rows pinned).
    Every DBQ level dedups its id batch and pulls only the cold rows from
    the host, and the next chunk's start rows are prefetched (pinned
    staging buffers, a side CUDA stream) while the current chunk computes.

    Sizing: ``cache_rows``/``hot``/``stage_rows`` count rows (``D * 4``
    bytes each); when omitted, ``cache_rows``/``hot`` default to
    ``cache_frac`` / ``hot_frac`` of the graph's N rows and
    ``stage_rows`` to ``cache_rows // 4`` per staging block. Worst-case
    device residency is ``cache_rows + 2 * stage_rows + hot + 1`` rows
    (slab + both staging blocks + pinned hot + sentinel), independent of
    graph size.
    """

    name = "oocache"
    splittable = True

    def __init__(self, cache_rows: Optional[int] = None,
                 cache_frac: float = 0.15,
                 hot: Optional[int] = None, hot_frac: float = 0.05,
                 prefetch: bool = True, stage_rows: Optional[int] = None,
                 rows_per_shard: int = 4096,
                 compaction: str = "cumsum", device=None):
        self.device = resolve_device(device)
        self._cache_rows = cache_rows
        self._cache_frac = cache_frac
        self._hot = hot
        self._hot_frac = hot_frac
        self._prefetch = prefetch
        self._stage_rows = stage_rows
        self._rows_per_shard = rows_per_shard
        self._compaction = compaction
        self.cache = None
        self.store = None

    def prepare(self, plan: Plan, source: Graph,
                config: ExecutorConfig) -> None:
        from ..distributed.rowcache import DeviceRowCache
        from ..graph.hoststore import HostRowStore
        from .engine_ooc import OocEngine
        t0 = time.perf_counter()
        self.plan, self.graph = plan, source
        n = source.n
        self.sentinel = n
        self.store = HostRowStore.from_graph(
            source, rows_per_shard=self._rows_per_shard)
        cap = self._cache_rows if self._cache_rows is not None else \
            max(1, int(n * self._cache_frac))
        hot = self._hot if self._hot is not None else \
            max(0, int(n * self._hot_frac))
        self.cache = DeviceRowCache(self.store, cap, hot=hot,
                                    stage_rows=self._stage_rows,
                                    device=self.device)
        self.has_universe = check_jit_supported(plan)
        self._caps0 = tuple(config.caps) if config.caps is not None else \
            tuple(default_caps(plan, config.batch, self.store.d))
        self.engine = OocEngine(plan, self.cache,
                                collect_matches=config.collect_matches,
                                intersect_impl=config.intersect_impl,
                                compaction=self._compaction)
        self._level_acc: Optional[np.ndarray] = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prepare_s = time.perf_counter() - t0

    def _n_starts(self) -> int:
        return self.graph.n

    def start_batches(self, config: ExecutorConfig):
        """Yield start batches, prefetching batch ``k + 1``'s rows right
        before handing batch ``k`` to the driver: the async H2D copy
        overlaps batch ``k``'s compute (double buffering)."""
        batches = list(start_id_batches(self.graph.n, config.batch))
        for k, (ids, valid) in enumerate(batches):
            if self._prefetch and k + 1 < len(batches):
                nxt_ids, nxt_valid = batches[k + 1]
                self.cache.prefetch(nxt_ids[nxt_valid])
            yield ids, valid

    def universe_chunks(self, config: ExecutorConfig):
        if not self.has_universe:
            return [None]
        return build_universe_chunks(self.graph.n, config.universe_chunk)

    def initial_caps(self, config: ExecutorConfig) -> Tuple[int, ...]:
        return self._caps0

    def run_chunk(self, ids, valid, universe_chunk, caps) -> ChunkResult:
        res = self.engine.run_chunk(ids, valid, universe_chunk, caps)
        if res.overflow == 0 and res.level_sizes:
            lv = np.asarray(res.level_sizes, np.int64)
            self._level_acc = (lv if self._level_acc is None
                               else self._level_acc + lv)
        return ChunkResult(count=res.count, overflow=res.overflow,
                           matches=res.matches)

    def finalize(self, stats: ExecStats) -> None:
        stats.extras.update(
            cache=self.cache.stats.as_dict(),
            cache_capacity_rows=self.cache.capacity_rows,
            cache_hot_rows=self.cache.hot,
            device_resident_rows=self.cache.device_rows,
            device_resident_bytes=self.cache.device_bytes,
            host_store_bytes=self.store.nbytes,
            host_store_shards=len(self.store.shards),
            level_sizes=(self._level_acc if self._level_acc is not None
                         else np.zeros(0, np.int64)),
            lookup_host_s=self.cache.lookup_host_s,
            prepare_s=self._prepare_s)  # host shards + the cache's blocks


# --------------------------------------------------------------------------
# Backend: S-BENU continuous enumeration (delta tasks on a SnapshotStore)
# --------------------------------------------------------------------------


class SBenuBackend(ExecutorBackend):
    """Delta enumeration over a SnapshotStore (core/sbenu.py), interpreted
    on the host.

    Start vertices are the batch's update endpoints; heavy tasks θ-split on
    their delta adjacency list. Source = a begun SnapshotStore; plan = the
    list of incremental plans for every ΔP_i.
    """

    name = "sbenu"
    splittable = True

    def __init__(self, pattern: Pattern, cache_capacity: Optional[int] = None,
                 collect: str = "matches"):
        self._pattern = pattern
        self._cache_capacity = cache_capacity
        self._collect = collect
        self.engine = None

    def prepare(self, plans: Sequence[Plan], source,
                config: ExecutorConfig) -> None:
        from .sbenu import SBenuRefEngine
        self.store = source
        self.sentinel = -1
        self._starts = np.asarray(sorted(source.start_vertices()), np.int32)
        self.engine = SBenuRefEngine(plans, self._pattern, source,
                                     collect=self._collect,
                                     cache_capacity=self._cache_capacity)
        self._theta = config.theta

    def start_batches(self, config: ExecutorConfig):
        n = self._starts.shape[0]
        for s0 in range(0, max(n, 1), config.batch):
            ids = self._starts[s0:s0 + config.batch]
            if ids.shape[0] == 0:
                return
            yield ids, np.ones(ids.shape[0], bool)

    def run_chunk(self, ids, valid, universe_chunk, caps) -> ChunkResult:
        eng = self.engine
        c0 = eng.counters.matches_plus + eng.counters.matches_minus
        eng.run_starts(ids[valid], theta=self._theta)
        c1 = eng.counters.matches_plus + eng.counters.matches_minus
        return ChunkResult(count=c1 - c0)

    def finalize(self, stats: ExecStats) -> None:
        stats.extras.update(
            delta_plus=set(self.engine.delta_plus),
            delta_minus=set(self.engine.delta_minus),
            counters=self.engine.counters)


# --------------------------------------------------------------------------
# Backend: vectorized S-BENU (delta-frontier engine over the six-block
# device snapshot)
# --------------------------------------------------------------------------


class SBenuTorchBackend(ExecutorBackend):
    """Lockstep delta-frontier enumeration (core/engine_sbenu_torch.py).

    ``plan`` is the list of incremental plans (one per ΔP_i); ``source`` is
    a *begun* SnapshotStore. Start batches cover the touched-vertex set of
    the update batch (vertices with non-empty ΔΓ_out), never all of V(G);
    every plan runs over each chunk, and a chunk whose total overflow is
    non-zero is discarded whole and re-split by the shared driver.

    ``snapshot_storage='device'`` keeps the prev blocks on the card across
    steps; ``'host'`` keeps them in host-RAM shards advanced in place and
    moves the step's blocks to the card for the step.
    """

    name = "sbenu-torch"
    splittable = True

    def __init__(self, collect: str = "matches", lane: int = 8,
                 d_min: int = 0, delta_d_min: int = 0,
                 compaction: str = "cumsum",
                 snapshot_storage: str = "device", device=None):
        self.device = resolve_device(device)
        self._collect_mode = collect
        self._lane = lane
        self._d_min = d_min
        self._delta_d_min = delta_d_min
        self._compaction = compaction
        self._snapshot_storage = snapshot_storage
        # runners outlive prepare(): a backend reused across time steps
        # (run_timestep(backend=...)) builds them once per stream
        self._runners: Dict[Tuple, Callable] = {}

    def prepare(self, plans: Sequence[Plan], source,
                config: ExecutorConfig) -> None:
        from ..graph.dynamic import DeviceSnapshotStore
        from .engine_sbenu_torch import (device_put_snapshot,
                                         plan_level_count,
                                         sbenu_level_fanouts)
        self.plans = list(plans)
        # the runner cache keys on plan identity: a *different* plan list
        # invalidates it; self.plans keeps the current ones alive
        plan_ids = tuple(id(p) for p in self.plans)
        if getattr(self, "_cached_plan_ids", None) != plan_ids:
            self._runners.clear()
            self._cached_plan_ids = plan_ids
        self.store = source
        self.sentinel = source.n
        self._starts = np.asarray(sorted(source.start_vertices()), np.int32)
        self.dstore = DeviceSnapshotStore.for_store(
            source, lane=self._lane, d_min=self._d_min,
            delta_d_min=self._delta_d_min,
            storage=self._snapshot_storage, device=self.device)
        self.snap = device_put_snapshot(self.dstore.step_snapshot(),
                                        self.device)
        # the Delta-ENU level has an exact bound: the worst chunk's total
        # delta-edge count (each start emits exactly its delta row)
        degs = np.array([len(source.delta_adj_out(int(v)))
                         for v in self._starts], np.int64)
        B = config.batch
        denu_cap = int(max((degs[s0:s0 + B].sum()
                            for s0 in range(0, len(degs), B)), default=B))
        denu_cap = max(denu_cap, B, 8)
        # round up to a power of two: steps with similar churn share one
        # caps tuple (and one runner)
        denu_cap = 1 << (denu_cap - 1).bit_length()
        # average degree drives fan-out levels (single-adjacency ENUs)
        avg_deg = max(1, round(source.prev.m / max(source.n, 1)))
        # one caps tuple for the whole chunk: per-plan slices, concatenated
        self._offsets: List[Tuple[int, int]] = []
        caps: List[int] = []
        for plan in self.plans:
            n_lv = plan_level_count(plan)
            if config.caps is not None:
                c = list(config.caps)[:n_lv]
                c += [c[-1]] * (n_lv - len(c))
            else:
                # contraction levels keep the exact Delta-ENU bound; a
                # fan-out level scales by ~avg degree. The driver
                # re-splits the heavy tail.
                c, cur = [], denu_cap
                for fans in sbenu_level_fanouts(plan):
                    if fans:
                        cur = min(cur * 2 * avg_deg, 1 << 22)
                        cur = 1 << (cur - 1).bit_length()
                    c.append(cur)
            self._offsets.append((len(caps), len(caps) + len(c)))
            caps.extend(c)
        self._caps0 = tuple(caps)
        self._collect = config.collect_matches or \
            self._collect_mode == "matches"
        self._intersect = config.intersect_impl
        self._plus: List[Tuple[int, ...]] = []
        self._minus: List[Tuple[int, ...]] = []
        self._count_plus = 0
        self._count_minus = 0
        self._level_acc: Optional[np.ndarray] = None

    def _n_starts(self) -> int:
        return self._starts.shape[0]

    def start_batches(self, config: ExecutorConfig):
        n, B = self._starts.shape[0], config.batch
        for s0 in range(0, n, B):
            chunk = self._starts[s0:s0 + B]
            ids = np.full(B, self.sentinel, np.int32)
            ids[:chunk.shape[0]] = chunk
            valid = np.zeros(B, bool)
            valid[:chunk.shape[0]] = True
            yield ids, valid

    def initial_caps(self, config: ExecutorConfig) -> Tuple[int, ...]:
        return self._caps0

    def _runner(self, B: int, caps: Tuple[int, ...]) -> Callable:
        key = (self._cached_plan_ids, B, caps, self._collect,
               self._intersect)
        if key not in self._runners:
            from .engine_sbenu_torch import build_sbenu_multi_enumerator
            caps_list = [tuple(caps[lo:hi]) for lo, hi in self._offsets]
            self._runners[key] = build_sbenu_multi_enumerator(
                self.plans, self.sentinel, caps_list,
                collect_matches=self._collect,
                intersect_impl=self._intersect,
                compaction=self._compaction)
        return self._runners[key]

    def run_chunk(self, ids, valid, universe_chunk, caps) -> ChunkResult:
        dev = self.device
        res = self._runner(ids.shape[0], tuple(caps))(
            self.snap, torch.from_numpy(ids).to(dev),
            torch.from_numpy(valid).to(dev))
        # one device->host read per chunk: counts, overflow, level sizes
        cp, cm, ov, *levels = torch.stack(
            [res.count_plus, res.count_minus, res.overflow,
             *res.level_sizes]).cpu().tolist()
        if ov:
            # discard the whole chunk; the driver re-splits or grows
            return ChunkResult(count=0, overflow=ov)
        if self._collect and res.matches is not None:
            mv = res.matches_valid
            rows = res.matches[mv].cpu().numpy()
            ops = res.match_ops[mv].cpu().numpy()
            for row, o in zip(rows, ops):
                (self._plus if o > 0 else self._minus).append(
                    tuple(int(x) for x in row))
        lv = np.asarray(levels, np.int64)
        self._level_acc = lv if self._level_acc is None \
            else self._level_acc + lv
        self._count_plus += cp
        self._count_minus += cm
        return ChunkResult(count=cp + cm)

    def finalize(self, stats: ExecStats) -> None:
        from .sbenu import SBenuCounters
        ctr = SBenuCounters(matches_plus=self._count_plus,
                            matches_minus=self._count_minus)
        stats.extras.update(
            delta_plus=set(self._plus), delta_minus=set(self._minus),
            counters=ctr,
            level_sizes=(self._level_acc if self._level_acc is not None
                         else np.zeros(0, np.int64)),
            snapshot_device_bytes=self.snap.device_bytes(),
            rebuilds=self.dstore.rebuilds)


# --------------------------------------------------------------------------
# Backend: distributed S-BENU (one process per shard of the six-block
# snapshot)
# --------------------------------------------------------------------------


class SBenuDistBackend(ExecutorBackend):
    """SPMD delta-frontier engine (core/engine_sbenu_dist.py): this process
    is one rank of ``group`` (the initialised world by default).

    The six-block snapshot is row-block partitioned over the ranks and
    stays resident across time steps
    (:class:`~repro_torch.graph.dynamic.ShardedDeviceSnapshotStore`);
    typed DBQs are request/response all_to_alls against the owning rank
    with the top-``hot`` rows replicated. Every rank walks the same global
    start batches (``granularity = S``) and runs its ``B/S`` slice; the
    per-rank ΔR_t^± counts, overflow, drops, cold rows and level sizes
    (and the collected match rows) are gathered to every rank, so every
    rank reports the same result. Frontier capacities are per rank, kept
    divisible by S through the driver's ``cap_multiple`` contract (the
    rebalancer's stripe exchange needs it).
    """

    name = "sbenu-dist"
    splittable = True

    def __init__(self, collect: str = "matches", lane: int = 8,
                 d_min: int = 0, delta_d_min: int = 0,
                 compaction: str = "cumsum", group=None, hot: int = 0,
                 rebalance: bool = False, req_cap: Optional[int] = None,
                 device=None):
        resolve_device(device)           # no card and no device: raise
        self._collect_mode = collect
        self._lane = lane
        self._d_min = d_min
        self._delta_d_min = delta_d_min
        self._compaction = compaction
        self._group_arg = group
        self._device_arg = device
        self._hot = hot
        self._rebalance = rebalance
        self._req_cap0 = req_cap
        # steps outlive prepare(): a backend reused across time steps
        # (run_timestep(backend=...)) builds them once per stream
        self._runners: Dict[Tuple, Callable] = {}

    def prepare(self, plans: Sequence[Plan], source,
                config: ExecutorConfig) -> None:
        import torch.distributed as dist
        from ..graph.dynamic import ShardedDeviceSnapshotStore
        from .engine_dist import enumeration_mesh, rank_device
        from .engine_sbenu_dist import BLOCK_ORDER
        from .engine_sbenu_torch import plan_level_count, sbenu_level_fanouts
        self.plans = list(plans)
        plan_ids = tuple(id(p) for p in self.plans)
        if getattr(self, "_cached_plan_ids", None) != plan_ids:
            self._runners.clear()
            self._cached_plan_ids = plan_ids
        self.group = enumeration_mesh(self._group_arg)
        self.device = rank_device(self.group, self._device_arg)
        self.S = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.granularity = self.S
        self.cap_multiple = self.S
        self.store = source
        self.sentinel = source.n
        self._starts = np.asarray(sorted(source.start_vertices()), np.int32)
        self.dstore = ShardedDeviceSnapshotStore.for_store(
            source, self.group, lane=self._lane, d_min=self._d_min,
            delta_d_min=self._delta_d_min, hot=self._hot,
            device=self.device)
        blocks, hot_blocks, self.spec = self.dstore.step_sharded()
        self._block_args = tuple(blocks[k] for k in BLOCK_ORDER) + \
            tuple(hot_blocks[k] for k in BLOCK_ORDER)
        self._widths = tuple(int(blocks[k].shape[1]) for k in BLOCK_ORDER)
        # global batch: a multiple of S so every rank gets an equal slice
        self._B = ceil_div(max(config.batch, self.S), self.S) * self.S
        w = self._B // self.S
        # per-rank Delta-ENU bound: each start emits exactly its delta
        # row, and a rank owns a contiguous w-slice of the chunk — the
        # worst slice's delta-edge total bounds the local first level
        degs = np.array([len(source.delta_adj_out(int(v)))
                         for v in self._starts], np.int64)
        denu_cap = w
        for s0 in range(0, len(degs), self._B):
            chunk = degs[s0:s0 + self._B]
            for k in range(self.S):
                denu_cap = max(denu_cap, int(chunk[k * w:(k + 1) * w].sum()))
        denu_cap = max(denu_cap, 8)
        denu_cap = 1 << (denu_cap - 1).bit_length()
        avg_deg = max(1, round(source.prev.m / max(source.n, 1)))
        # one caps tuple for the whole chunk: per-plan slices, concatenated
        # (the driver rounds each entry up to cap_multiple = S)
        self._offsets: List[Tuple[int, int]] = []
        caps: List[int] = []
        for plan in self.plans:
            n_lv = plan_level_count(plan)
            if config.caps is not None:
                c = list(config.caps)[:n_lv]
                c += [c[-1]] * (n_lv - len(c))
            else:
                c, cur = [], denu_cap
                for fans in sbenu_level_fanouts(plan):
                    if fans:
                        cur = min(cur * 2 * avg_deg, 1 << 22)
                        cur = 1 << (cur - 1).bit_length()
                    c.append(cur)
            self._offsets.append((len(caps), len(caps) + len(c)))
            caps.extend(c)
        self._caps0 = tuple(caps)
        # per-peer request budget: ~2x the worst per-owner distinct-id load
        # of a frontier level, bounded so the [S, R, D] exchange buffers
        # stay modest — a heavy level that still drops escalates (2x) and
        # the chunk retries, which is exact
        self.req_cap = self._req_cap0 if self._req_cap0 is not None else \
            max(64, min(2 * max(self._caps0) // self.S, 8192))
        self._collect = config.collect_matches or \
            self._collect_mode == "matches"
        self._intersect = config.intersect_impl
        self._plus: List[Tuple[int, ...]] = []
        self._minus: List[Tuple[int, ...]] = []
        self._count_plus = 0
        self._count_minus = 0
        self._per_shard = np.zeros(self.S, np.int64)
        self._level_acc: Optional[np.ndarray] = None
        self._cold = 0

    def _n_starts(self) -> int:
        return self._starts.shape[0]

    def start_batches(self, config: ExecutorConfig):
        n, B = self._starts.shape[0], self._B
        for s0 in range(0, n, B):
            chunk = self._starts[s0:s0 + B]
            ids = np.full(B, self.sentinel, np.int32)
            ids[:chunk.shape[0]] = chunk
            valid = np.zeros(B, bool)
            valid[:chunk.shape[0]] = True
            yield ids, valid

    def initial_caps(self, config: ExecutorConfig) -> Tuple[int, ...]:
        return self._caps0

    def escalate_requests(self) -> None:
        self.req_cap *= 2

    def _runner(self, caps: Tuple[int, ...]) -> Callable:
        key = (self._cached_plan_ids, caps, self.req_cap, self._widths,
               self._collect, self._intersect)
        if key not in self._runners:
            from .engine_sbenu_dist import build_sbenu_dist_step
            caps_list = [tuple(caps[lo:hi]) for lo, hi in self._offsets]
            self._runners[key] = build_sbenu_dist_step(
                self.plans, self.sentinel, self.spec, self.group, caps_list,
                self.req_cap, rebalance=self._rebalance,
                collect_matches=self._collect,
                intersect_impl=self._intersect,
                compaction=self._compaction)
        return self._runners[key]

    def run_chunk(self, ids, valid, universe_chunk, caps) -> ChunkResult:
        w = ids.shape[0] // self.S
        mine = slice(self.rank * w, (self.rank + 1) * w)
        out = self._runner(tuple(caps))(
            *self._block_args, torch.from_numpy(ids[mine]).to(self.device),
            torch.from_numpy(valid[mine]).to(self.device))
        cp, cm, ov, cold, drops, levels = out[:6]
        # one gather, one device->host read: [S, 5 + levels] on every rank
        table = gather_to_all(self.group, torch.stack(
            [cp, cm, ov, cold, drops, *levels])).cpu().numpy()
        ov, dr = int(table[:, 2].sum()), int(table[:, 4].sum())
        if ov or dr:
            # discard the whole chunk on every rank; the driver re-splits
            # (granularity S) or escalates caps / request budgets
            return ChunkResult(count=0, overflow=ov, drops=dr)
        cps, cms = table[:, 0], table[:, 1]
        self._per_shard += cps + cms
        self._cold += int(table[:, 3].sum())
        lv = table[:, 5:].T
        self._level_acc = lv if self._level_acc is None \
            else self._level_acc + lv
        if self._collect:
            m, mo, mv = out[6:]
            # the match rows of every rank, in rank order, on every rank
            rows = gather_to_all(self.group, torch.cat(
                [m, mo[:, None], mv[:, None].to(m.dtype)], dim=1))
            rows = rows.reshape(-1, rows.shape[-1]).cpu().numpy()
            rows = rows[rows[:, -1] != 0]
            for row in rows:
                (self._plus if row[-2] > 0 else self._minus).append(
                    tuple(int(x) for x in row[:-2]))
        self._count_plus += int(cps.sum())
        self._count_minus += int(cms.sum())
        return ChunkResult(count=int(cps.sum() + cms.sum()))

    def finalize(self, stats: ExecStats) -> None:
        from .sbenu import SBenuCounters
        ctr = SBenuCounters(matches_plus=self._count_plus,
                            matches_minus=self._count_minus)
        stats.extras.update(
            delta_plus=set(self._plus), delta_minus=set(self._minus),
            counters=ctr, per_shard_counts=self._per_shard,
            per_shard_level_sizes=(
                self._level_acc if self._level_acc is not None
                else np.zeros((0, self.S), np.int64)),
            cold_rows_fetched=self._cold, req_cap=self.req_cap,
            snapshot_device_bytes=sum(int(b.nbytes)
                                      for b in self._block_args),
            rebuilds=self.dstore.rebuilds)


BACKENDS = {
    "ref": RefBackend,
    "torch": TorchBackend,
    "torch-gpu": TorchGpuBackend,
    "dist": DistBackend,
    "oocache": OocBackend,
    "sbenu": SBenuBackend,
    "sbenu-torch": SBenuTorchBackend,
    "sbenu-dist": SBenuDistBackend,
}


def make_executor(engine: str, **backend_kwargs) -> Executor:
    """``make_executor('torch-gpu').run(plan, graph, batch=256)``."""
    try:
        cls = BACKENDS[engine]
    except KeyError:
        raise ValueError(
            f"unknown engine {engine!r}; choose from {sorted(BACKENDS)}")
    return Executor(cls(**backend_kwargs))
