"""The benchmark's tests: on the CPU at tiny sizes (the plain versions of
the kernels), and on the card where a test is marked ``cuda``.

    python -m pytest -q bench/tests             # from the repo's root
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: the tiny cell: each configuration under ``bench/configs`` at 2^8
#: vertices, each traffic at 64 starts a chunk, and the benchmark's cell
#: over them, reporting every per-layer metric the benchmark has
TINY_SCALE, TINY_BATCH = 8, 64
TINY_CELL = "gap-urand18.q1-tiny"


def tiny_copy(dest: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``bench/`` under ``dest`` with a
    tiny twin ``<name>-tiny`` of each configuration and traffic, and the
    cell ``TINY_CELL`` over them. Returns the copy's ``BENCHMARK.json``."""
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for kind, key, size in (("configs", "scale", TINY_SCALE),
                            ("traffic", "batch", TINY_BATCH)):
        for f in list((dest / "bench" / kind).glob("*.json")):
            data = json.loads(f.read_text())
            data[key] = size
            (f.parent / f"{f.stem}-tiny.json").write_text(json.dumps(data))
    spec["workloads"].append({"name": TINY_CELL,
                              "config": "gap-urand18-tiny",
                              "traffic": "q1-tiny", "chips": 1,
                              "why": "tiny"})
    for m in spec["per_layer"]:
        m["workloads"].append(TINY_CELL)
    path = dest / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return path


@pytest.fixture(scope="session")
def tiny_spec(tmp_path_factory) -> Path:
    return tiny_copy(tmp_path_factory.mktemp("bench"))
