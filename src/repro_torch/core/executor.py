"""Unified Executor API of the port: one driver, the torch backends.

Counterpart of ``repro/core/executor.py``: the driver half is a copy
(start batching, universe chunks, the §5.2 adaptive task split: an
overflowing chunk is re-chunked into smaller start batches before its
capacities grow, so no match is ever dropped), and the backends are the
port's own::

    torch      single-device frontier engine, unfused   (core/engine_torch.py)
    torch-gpu  same engine, fused gather+intersect
               fetch path (csrc/gather_intersect.cu)    (core/engine_torch.py)

Both run on ``cuda`` unless given ``device=``; with no device and no card
they raise.

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
    i-th ENU level.
    """

    batch: int = 256                 # global start-vertex chunk size
    caps: Optional[Sequence[int]] = None   # per-ENU frontier capacities
    universe_chunk: int = 1024       # width of V(G) slices (detached vertex)
    max_retries: int = 6             # capacity-doubling budget per chunk
    adaptive_split: bool = True      # re-chunk before growing capacities
    collect_matches: bool = False
    intersect_impl: str = "auto"


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


BACKENDS = {
    "torch": TorchBackend,
    "torch-gpu": TorchGpuBackend,
}


def make_executor(engine: str, **backend_kwargs) -> Executor:
    """``make_executor('torch-gpu').run(plan, graph, batch=256)``."""
    try:
        cls = BACKENDS[engine]
    except KeyError:
        raise ValueError(
            f"unknown engine {engine!r}; choose from {sorted(BACKENDS)}")
    return Executor(cls(**backend_kwargs))
