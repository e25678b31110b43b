"""Nothing the benchmark runs loads JAX or the JAX package, and the
plain reference takes nothing of the program."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import TINY_CELL

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def modules():
    """Every module of ``bench/`` that a run or the control executes."""
    return sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_names_compare_whole(tmp_path):
    """``repro_torch`` is the port and passes; ``repro`` does not."""
    p = tmp_path / "probe.py"
    p.write_text("import repro_torch.core\nfrom repro_torch import kernels\n")
    assert top_level_imports(p) == {"repro_torch"}
    p.write_text("from repro.core import executor\n")
    assert top_level_imports(p) & FORBIDDEN == {"repro"}


def test_reference_takes_nothing_of_the_program():
    ref = BENCH / "reference"
    for path in ref.rglob("*.py"):
        names = top_level_imports(path)
        assert "repro_torch" not in names and "bench" not in names, path
        assert names <= {"__future__", "typing", "numpy", "torch"}, path


def test_a_run_loads_no_jax(tiny_spec):
    """A whole run on the CPU in a fresh process: afterwards
    ``sys.modules`` holds nothing of JAX or the JAX package."""
    root = BENCH.parent
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(root)!r}, {str(root / 'src')!r}]\n"
        "from bench.harness import run, loaded_forbidden\n"
        f"out = run({TINY_CELL!r}, 3, 0.1, True, 'cpu', "
        f"spec_path={str(tiny_spec)!r})\n"
        "print(json.dumps([out['correct'], loaded_forbidden()]))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    correct, bad = json.loads(res.stdout.strip().splitlines()[-1])
    assert correct and bad == []
