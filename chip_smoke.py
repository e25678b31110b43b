#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's widths and B >= 65,536 rows: bit-equal (tolerance 0, the
   values are int32 set members), with each kernel's time beside the plain
   version's and the bound (least time at the card's memory bandwidth);
3. mid-size exactness on ``powerlaw(20_000, 8)``: ``torch``, ``torch-gpu``
   and the plain versions forced by explicit impl give identical counts and
   frontier sizes (and, for the house, match sets); one run with tiny
   capacities forces the adaptive split;
4. the main path at full size: triangle over every start vertex of
   ``powerlaw(1_000_000, 8)`` (padded rows ``[1_000_001, 3968]`` int32 on
   the card) through ``torch`` and ``torch-gpu``; both counts must equal an
   independent triangle count computed here from the host CSR with plain
   torch ops (no engine, no kernel). Each kernel's launch counter is set
   to 0 just before and read just after, and must be > 0.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. It exits non-zero with no
result when there is no CUDA device or no ``src/repro_torch`` beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
# HBM bandwidth by card name (NVIDIA data sheets); the bound of a
# memory-bound kernel is its bytes over this rate
BANDWIDTH = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
             ("H100", 3.35e12))
FULL_N, FULL_BATCH, FULL_CAPS = 1_000_000, 4096, (65536, 16384)
MID_N, MID_BATCH, MID_CAPS = 20_000, 64, (8192, 16384, 32768, 65536)


def log(*args) -> None:
    print(*args, flush=True)


def card_bandwidth(name: str) -> float:
    for key, bw in BANDWIDTH:
        if key in name:
            return bw
    raise RuntimeError(f"no memory bandwidth known for card {name!r}")


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch
    fn()                                            # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Phase 2 inputs: random valid padded sets, made on the card from a seed
# ---------------------------------------------------------------------------


def padded_sets(gen, rows: int, width: int, n: int, hole_p: float,
                tail: bool):
    """int32[rows, width] valid padded sets over [0, n): ascending valid
    entries, duplicates turned into holes, then holes punched at random
    (``tail=False``: anywhere; ``tail=True``: only a random-length tail, as
    in adjacency rows). About 1% of the rows are all holes."""
    import torch
    dev = gen.device
    v = torch.randint(0, n, (rows, width), generator=gen, device=dev,
                      dtype=torch.int32).sort(dim=1).values
    dup = torch.zeros_like(v, dtype=torch.bool)
    dup[:, 1:] = v[:, 1:] == v[:, :-1]
    v.masked_fill_(dup, n)
    if tail:
        v = v.sort(dim=1).values                    # holes to the tail
        keep = torch.randint(0, width + 1, (rows, 1), generator=gen,
                             device=dev)
        lane = torch.arange(width, device=dev)[None, :]
        v.masked_fill_(lane >= keep, n)
    else:
        holes = torch.rand((rows, width), generator=gen, device=dev) < hole_p
        v.masked_fill_(holes, n)
    empty = torch.rand((rows,), generator=gen, device=dev) < 0.01
    v[empty] = n
    return v.contiguous()


def punch(gen, sets, n: int, p: float):
    """Holes punched at random into ``sets`` (a subset stays a padded set)."""
    import torch
    holes = torch.rand(sets.shape, generator=gen, device=sets.device) < p
    return sets.masked_fill(holes, n).contiguous()


def plain_rows(fn, rows: int, width_product: int):
    """Run a plain [r, Da, Db]-compare version over row chunks that keep
    the compare near 2 GB; returns the concatenated result."""
    import torch
    step = max(1, (2 << 30) // max(width_product, 1))
    return torch.cat([fn(lo, min(lo + step, rows))
                      for lo in range(0, rows, step)])


def phase_kernels(dev, bandwidth: float) -> dict:
    import torch
    from repro_torch.kernels import gather_intersect as gi
    from repro_torch.kernels import ref
    from repro_torch.kernels import sorted_intersect as si

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    B, n = 65536, 65536
    out = {}

    # -- sorted_intersect: a with holes anywhere, b a punched subset of a
    # superset of a's values (so rows overlap), widths equal and mixed
    worst = 0
    for Da, Db in ((3968, 3968), (640, 640), (3968, 640), (640, 3968)):
        base = padded_sets(gen, B, max(Da, Db), n, 0.0, tail=False)
        a = punch(gen, base[:, :Da], n, 0.3)
        b = punch(gen, base[:, -Db:] if Db < Da else base[:, :Db], n, 0.4)
        got = si.sorted_intersect_cuda(a, b, n)
        want = plain_rows(lambda lo, hi: ref.sorted_intersect(
            a[lo:hi], b[lo:hi], n), B, Da * Db)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        same = torch.equal(got, want)
        kept = int((got != n).sum())
        log(f"  sorted_intersect B={B} Da={Da} Db={Db}: bit-equal={same} "
            f"max_abs_err={err} kept={kept}")
        if not same or kept == 0:
            raise RuntimeError(f"sorted_intersect disagrees with its plain "
                               f"version at Da={Da} Db={Db}")
        worst = max(worst, err)
        if (Da, Db) == (3968, 3968):
            ms = cuda_time_ms(lambda: si.sorted_intersect_cuda(a, b, n), 10)
            plain_ms = cuda_time_ms(lambda: plain_rows(
                lambda lo, hi: ref.sorted_intersect(a[lo:hi], b[lo:hi], n),
                B, Da * Db), 1)
            nbytes = B * (Da + Db) * 4 + B * Da * 4
            out["sorted_intersect"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=nbytes / bandwidth * 1e3,
                shape=f"B={B} Da={Da} Db={Db}")
        del a, b, base, got, want
    out["sorted_intersect"]["max_abs_err"] = worst

    # -- gather_intersect: adjacency rows ascending with tail holes, row N
    # all holes; ids with duplicates, sentinel, out-of-range and negative
    # values; cand half drawn from the addressed row, half independent
    worst = 0
    for Dc, D in ((3968, 3968), (640, 640)):
        adj = padded_sets(gen, n + 1, D, n, 0.0, tail=True)
        adj[n] = n
        ids = torch.randint(0, n, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        ids[:512] = ids[0]                          # duplicates
        ids[512:1024] = n                           # sentinel
        ids[1024:1280] = n + 7                      # out of range
        ids[1280:1536] = 2**31 - 1
        ids[1536:1792] = -5
        ids = ids[torch.randperm(B, generator=gen, device=dev)].contiguous()
        rows = adj.index_select(0, ids.clamp(0, n))
        own = punch(gen, rows[:, :Dc] if Dc <= D else rows, n, 0.3)
        other = padded_sets(gen, B, Dc, n, 0.3, tail=False)
        pick = torch.rand((B, 1), generator=gen, device=dev) < 0.5
        cand = torch.where(pick, own, other).contiguous()
        del rows, own, other
        got = gi.gather_intersect_cuda(ids, cand, adj, n)

        def plain(lo, hi):
            r = adj.index_select(0, ids[lo:hi].clamp(0, n))
            return ref.sorted_intersect(cand[lo:hi], r, n)

        want = plain_rows(plain, B, Dc * D)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        same = torch.equal(got, want)
        kept = int((got != n).sum())
        log(f"  gather_intersect B={B} Dc={Dc} D={D}: bit-equal={same} "
            f"max_abs_err={err} kept={kept}")
        if not same or kept == 0:
            raise RuntimeError(f"gather_intersect disagrees with its plain "
                               f"version at Dc={Dc} D={D}")
        worst = max(worst, err)
        if (Dc, D) == (3968, 3968):
            ms = cuda_time_ms(
                lambda: gi.gather_intersect_cuda(ids, cand, adj, n), 10)
            plain_ms = cuda_time_ms(lambda: plain_rows(plain, B, Dc * D), 1)
            # distinct rows the clipped ids address, each read once
            # (negative ids read row 0; row n is never read)
            rows = ids.clamp(0, n).unique()
            n_valid = int((rows < n).sum())
            nbytes = B * Dc * 4 * 2 + B * 4 + n_valid * D * 4
            out["gather_intersect"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=nbytes / bandwidth * 1e3,
                shape=f"B={B} Dc={Dc} D={D}")
        del adj, ids, cand, got, want
    out["gather_intersect"]["max_abs_err"] = worst
    for name, r in out.items():
        log(f"  {name} ({r['shape']}): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.4f} ms "
            f"(memory)")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The independent triangle count (host CSR, plain torch ops)
# ---------------------------------------------------------------------------


def independent_triangles(graph, dev) -> int:
    """Triangles u < v < w by a sorted edge-key lookup of every 2-path
    u -> v -> w along edges oriented from low to high id."""
    import numpy as np
    import torch
    n = graph.n
    deg = np.asarray(graph.deg, np.int64)
    col = torch.from_numpy(np.concatenate(graph.adj).astype(np.int64))
    row = torch.repeat_interleave(torch.arange(n), torch.from_numpy(deg))
    up = col > row
    src, dst = row[up].to(dev), col[up].to(dev)     # sorted by (src, dst)
    keys = src * n + dst
    outdeg = torch.bincount(src, minlength=n)
    start = torch.cumsum(outdeg, 0) - outdeg
    total = 0
    step = 1 << 20
    for lo in range(0, src.shape[0], step):
        u, v = src[lo:lo + step], dst[lo:lo + step]
        c = outdeg[v]
        e = torch.repeat_interleave(torch.arange(u.shape[0], device=dev), c)
        first = torch.cumsum(c, 0) - c
        k = torch.arange(e.shape[0], device=dev) - first[e]
        w = dst[start[v[e]] + k]
        q = u[e] * n + w
        pos = torch.searchsorted(keys, q).clamp(max=keys.shape[0] - 1)
        total += int((keys[pos] == q).sum())
    return total


# ---------------------------------------------------------------------------
# Phases 3 and 4: the port's Executor API
# ---------------------------------------------------------------------------


def run_backend(engine, plan, graph, dev, **cfg):
    from repro_torch.core.executor import make_executor
    from repro_torch.kernels import gather_intersect as gi
    from repro_torch.kernels import sorted_intersect as si
    import torch
    impl = cfg.pop("plain", None)
    kwargs = {"gather_intersect_impl": impl} if impl else {}
    ex = make_executor(engine, device=dev, **kwargs)
    if impl:
        cfg["intersect_impl"] = impl
    si.launches = gi.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = ex.run(plan, graph, **cfg)
    torch.cuda.synchronize()
    st.extras["wall_s"] = time.perf_counter() - t0
    st.extras["launches"] = {"sorted_intersect": si.launches,
                             "gather_intersect": gi.launches}
    st.extras["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return st


def describe(tag, st) -> str:
    lv = st.extras["level_sizes"].tolist()
    return (f"  {tag}: matches {st.count}, wall {st.extras['wall_s']:.3f} s "
            f"(set-up {st.extras['prepare_s']:.3f} s), "
            f"chunks run/split/retried {st.chunks_run}/{st.chunks_split}/"
            f"{st.chunks_retried}, levels {lv}, launches "
            f"{st.extras['launches']}, peak "
            f"{st.extras['peak_bytes'] / 2**30:.2f} GiB")


def phase_mid(dev) -> None:
    import numpy as np
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.plangen import generate_best_plan
    from repro_torch.graph.generate import powerlaw
    t0 = time.perf_counter()
    g = powerlaw(MID_N, 8, seed=SEED)
    log(f"  powerlaw({MID_N}, 8): {g.m} edges, max degree {g.deg.max()}, "
        f"{time.perf_counter() - t0:.1f} s")
    tri = independent_triangles(g, dev)
    for pname in ("triangle", "square", "clique4", "house"):
        plan = generate_best_plan(get_pattern(pname), g.stats())
        collect = pname == "house"
        cfg = dict(batch=MID_BATCH, caps=MID_CAPS[:len(
            [i for i in plan.instrs if i.op == "ENU"])],
            collect_matches=collect)
        runs = {"torch": run_backend("torch", plan, g, dev, **cfg),
                "torch-gpu": run_backend("torch-gpu", plan, g, dev, **cfg),
                "plain": run_backend("torch-gpu", plan, g, dev,
                                     plain="chunked", **cfg)}
        for tag, st in runs.items():
            log(describe(f"{pname:8s} {tag:9s}", st))
        base = runs["plain"]
        for tag, st in runs.items():
            if st.count != base.count or \
                    st.extras["level_sizes"].tolist() != \
                    base.extras["level_sizes"].tolist():
                raise RuntimeError(f"{pname}: {tag} disagrees with plain")
            # same chunks in the same order, bit-equal compaction: the
            # collected match arrays agree row for row
            if collect and not np.array_equal(st.matches, base.matches):
                raise RuntimeError(f"{pname}: {tag} match set differs")
        if runs["torch"].extras["launches"]["sorted_intersect"] == 0:
            raise RuntimeError(f"{pname}: torch never launched a kernel")
        if pname == "triangle" and base.count != tri:
            raise RuntimeError(f"triangle {base.count} != independent {tri}")
    plan = generate_best_plan(get_pattern("triangle"), g.stats())
    st = run_backend("torch-gpu", plan, g, dev, batch=MID_BATCH,
                     caps=(128, 32), max_retries=12)
    log(describe("triangle tiny caps", st))
    if st.count != tri or st.chunks_split == 0:
        raise RuntimeError("forced-overflow triangle run is not exact/split")
    log(f"  mid-size exact: triangle == independent count {tri}")


def phase_full(dev) -> dict:
    import torch
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.plangen import generate_best_plan
    from repro_torch.graph.generate import powerlaw
    t0 = time.perf_counter()
    g = powerlaw(FULL_N, 8, seed=SEED)
    log(f"  powerlaw({FULL_N}, 8): {g.m} edges, max degree {g.deg.max()}, "
        f"generated in {time.perf_counter() - t0:.1f} s (host)")
    t0 = time.perf_counter()
    want = independent_triangles(g, dev)
    torch.cuda.synchronize()
    log(f"  independent triangle count {want} "
        f"({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()
    plan = generate_best_plan(get_pattern("triangle"), g.stats())
    launches = {"sorted_intersect": 0, "gather_intersect": 0}
    for engine in ("torch", "torch-gpu"):
        st = run_backend(engine, plan, g, dev, batch=FULL_BATCH,
                         caps=FULL_CAPS)
        log(describe(f"triangle {engine:9s}", st)
            + f" (batch {FULL_BATCH}, caps {FULL_CAPS}, all {g.n} starts)")
        if st.count != want:
            raise RuntimeError(f"{engine}: {st.count} triangles, "
                               f"independent count {want}")
        for k, v in st.extras["launches"].items():
            launches[k] += v
        torch.cuda.empty_cache()
    for k, v in launches.items():
        if v == 0:
            raise RuntimeError(f"the main path never launched {k}")
    return launches


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py needs the repository around it "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card only",
              file=sys.stderr)
        return 1
    for var in [v for v in os.environ if v.startswith("REPRO_TORCH_")]:
        del os.environ[var]                       # no impl overrides
    dev = torch.device("cuda", 0)
    from repro_torch.kernels import build

    log("phase 1: build")
    t0 = time.perf_counter()
    built = build.build()
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.nvcc_path()})")
    for name, text in build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  [{name}] {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    bandwidth = card_bandwidth(kind)
    log(f"  card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; bound at {bandwidth / 1e12:.2f} TB/s")

    log("phase 2: kernels vs plain versions on the card")
    kern = phase_kernels(dev, bandwidth)
    log("phase 3: mid-size exactness")
    phase_mid(dev)
    log("phase 4: full size (main path)")
    launches = phase_full(dev)

    sources = {"sorted_intersect": ("src/repro_torch/csrc/sorted_intersect.cu",
                                    "src/repro/kernels/sorted_intersect.py:50"),
               "gather_intersect": ("src/repro_torch/csrc/gather_intersect.cu",
                                    "src/repro/kernels/gather_intersect.py:77")}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": kern[name]["max_abs_err"],
                "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"],
                "bound_ms": kern[name]["bound_ms"], "bound_by": "bytes",
                "library_ms": None}
               for name, (src, replaces) in sources.items()]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
