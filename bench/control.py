"""The control of the correctness check: the check has to fail it.

The configurations promise an exact count. The control is the plain
reference put in the program's place with that promise broken the way
a faster program might break it: a sampled estimate, which counts the
copies whose start vertex falls in a random half of the vertices (drawn
from the run's seed) and doubles the total. It runs through the whole of
``harness.run``: set-up, the window's loop, the reference and the judge.

    python3 bench/control.py --workload gap-urand18.q1 --seeds 1 2 3

prints one line a seed with the numbers compared and ``correct``, which
must read false. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class _Stats:
    count: int
    chunks_run: int = 1
    chunks_split: int = 0
    chunks_retried: int = 0
    extras: Dict[str, Any] = field(default_factory=dict)


class SampledCount:
    """An executor that answers a query by the sampled estimate."""

    def __init__(self, csr, pattern: str, seed: int, device):
        import numpy as np
        from bench.reference.counts import count
        half = np.random.default_rng(seed).random(csr.n) < 0.5
        self.value = 2 * count(pattern, csr, device=device, starts=half)
        self.backend = object()

    def run(self, plan, graph, **config) -> _Stats:
        return _Stats(count=self.value)


def run_control(cell: str, seed: int, device, seconds: float = 1.0,
                spec_path: Path = ROOT / "BENCHMARK.json") -> dict:
    """``harness.run`` of ``cell`` with the control in the program's
    place."""
    from bench import harness
    import repro_torch.core.executor as ex
    made = {}
    real_graph, real_make = harness.make_graph, ex.make_executor

    def make_graph(config, s, dev):
        made["csr"], graph = real_graph(config, s, dev)
        return made["csr"], graph

    def make_executor(engine, device=None, **kw):
        w = harness.cell_spec(json.loads(Path(spec_path).read_text()), cell)
        traffic = harness.load_json(Path(spec_path).resolve().parent,
                                    "traffic", w["traffic"])
        return SampledCount(made["csr"], traffic["pattern"], seed, device)

    harness.make_graph, ex.make_executor = make_graph, make_executor
    try:
        return harness.run(cell, seed, seconds, False, device,
                           spec_path=spec_path)
    finally:
        harness.make_graph, ex.make_executor = real_graph, real_make


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        out = run_control(args.workload, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
