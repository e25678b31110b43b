"""Run one benchmark cell once: ``python3 bench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` from the checkout's root.

Prints the result as one JSON line, last on standard output, and each
number the correctness check compared beside its limit, last on
standard error. Exits with another code than 0, and prints no result,
without as many CUDA devices as the cell asks for.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
