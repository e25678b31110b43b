"""Time this checkout's rmsnorm kernel against another checkout's, on one
CUDA card, in one process.

    git archive <commit> src/repro_torch | tar -x -C build/other
    python -m repro_torch.launch.rmsnorm_ab --other build/other/src

The other checkout's ``repro_torch`` is loaded beside this one under
another name (the port's imports are relative) and builds its kernel into
its own ``build/``. At the prefill rows [16384, 896] and the decode rows
[4, 896] bf16, each of ``--pairs`` rounds times both sides and
``F.rms_norm``, in an order that alternates from round to round:

* device ms per launch: one replay of a CUDA graph of 40 launches that
  rotate over four input sets (117 MB at the prefill rows, more than the
  L2), / 40;
* host µs per call of ``ops.rmsnorm`` (``F.rms_norm`` for the library),
  host clock over 200 (prefill) or 2000 (decode) calls.

Prints every round, the median and the quartiles of each, and last one
JSON object of the medians.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from ..kernels import ops, ref

LAUNCHES = 40
SHAPES = ((16384, 896, 200), (4, 896, 2000))


def load_other(src: Path):
    """``src``'s ``repro_torch.kernels.ops`` under the name
    ``repro_torch_other``."""
    pkg = src / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "repro_torch_other", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules["repro_torch_other"] = module
    spec.loader.exec_module(module)
    return importlib.import_module("repro_torch_other.kernels.ops")


def graph_ms(fn, sets):
    """A callable giving device ms per call of ``fn(*args)``, args rotating
    over ``sets``: one replay of a captured CUDA graph of LAUNCHES calls
    (each output kept, so every call writes its own buffer) between CUDA
    events, after one warm-up replay. No host time is in the window."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                    # warm-up off the graph
        fn(*sets[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(*sets[i % len(sets)]) for i in range(LAUNCHES)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def replay() -> float:
        graph.replay()
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / LAUNCHES
    replay.outs = outs
    return replay


def host_us(fn, calls: int) -> float:
    """Host µs per call of ``fn()`` over ``calls`` calls, host clock, no
    synchronisation inside the window."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def quartiles(v):
    q = statistics.quantiles(v, n=4)
    return [q[0], statistics.median(v), q[2]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="a src directory holding another repro_torch")
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rmsnorm_ab needs a CUDA card")
    other = load_other(args.other.resolve())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    sides = {"other": other.rmsnorm, "this": ops.rmsnorm,
             "F.rms_norm": lambda x, g, eps: F.rms_norm(x, x.shape[-1:],
                                                        g, eps)}
    summary = {}
    for rows, d, calls in SHAPES:
        sets = [(torch.randn((rows, d), generator=gen, device=dev).bfloat16(),
                 torch.randn((d,), generator=gen, device=dev).bfloat16())
                for _ in range(4)]
        x, g = sets[0]
        want = ref.rmsnorm(x, g, 1e-6)
        for name, fn in sides.items():          # all agree before timing
            err = (fn(x, g, 1e-6).float() - want.float()).abs().max()
            print(f"[{rows}, {d}] {name}: max_abs_err {float(err):.3g}")
        graphs = {k: graph_ms(lambda x, g, fn=fn: fn(x, g, 1e-6), sets)
                  for k, fn in sides.items()}
        got = {k: {"device_ms": [], "host_us": []} for k in sides}
        for r in range(args.pairs):
            order = list(sides) if r % 2 == 0 else list(sides)[::-1]
            for k in order:
                got[k]["device_ms"].append(graphs[k]())
                got[k]["host_us"].append(
                    host_us(lambda fn=sides[k]: fn(x, g, 1e-6), calls))
        for k, metrics in got.items():
            for m, v in metrics.items():
                q = quartiles(v)
                print(f"[{rows}, {d}] bf16 {k} {m}: rounds "
                      f"{[round(t, 5) for t in v]}; quartiles "
                      f"{[round(t, 5) for t in q]}")
                summary[f"{rows}x{d} {k} {m}"] = q[1]
        del graphs, sets
        torch.cuda.empty_cache()
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
