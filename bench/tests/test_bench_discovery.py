"""A configuration, a cell and a metric are added by adding files and
entries: the harness lists and runs them with no edit to a file that is
already there."""

import hashlib
import json
import shutil
import subprocess
import sys

from conftest import ROOT, tiny_copy

DUMMY_METRIC = '''"""A dummy metric: the queries the window completed."""

LAYER, UNIT, SOURCE, MOVES = "driver", "queries", "program_counter", \\
    "query_s"


def read(run):
    return float(len(run.queries))
'''


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench").rglob("*")) if p.is_file()}


def test_added_files_are_found_and_run(tmp_path):
    spec_path = tiny_copy(tmp_path)
    before = digests(tmp_path)
    bench = tmp_path / "bench"
    config = json.loads((bench / "configs" / "gap-urand18.json").read_text())
    config.update(name="dummy-er", scale=7, degree=6, structure_seed=4)
    (bench / "configs" / "dummy-er.json").write_text(json.dumps(config))
    (bench / "traffic" / "dummy-q1.json").write_text(json.dumps(
        {"pattern": "q1", "batch": 32, "clients": 1, "loop": "closed"}))
    (bench / "metrics" / "dummy.queries_done.py").write_text(DUMMY_METRIC)
    spec = json.loads(spec_path.read_text())
    spec["workloads"].append({"name": "dummy-er.q1", "config": "dummy-er",
                              "traffic": "dummy-q1", "chips": 1,
                              "why": "a dummy cell"})
    spec["per_layer"].append({"name": "dummy.queries_done",
                              "unit": "queries", "better": "higher",
                              "source": "program_counter", "layer": "driver",
                              "moves": "query_s",
                              "workloads": ["dummy-er.q1"]})
    spec_path.write_text(json.dumps(spec))
    after = digests(tmp_path)
    assert all(after[k] == v for k, v in before.items())

    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from bench.harness import catalog, run\n"
        f"spec = {str(spec_path)!r}\n"
        "cat = catalog(spec)\n"
        "print(json.dumps({\n"
        "  'listed': sorted(cat['dummy-er.q1']['metrics']),\n"
        "  'trace': run('dummy-er.q1', 9, 0.05, True, 'cpu',\n"
        "               spec_path=spec),\n"
        "  'plain': run('dummy-er.q1', 9, 0.05, False, 'cpu',\n"
        "               spec_path=spec)}))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert "dummy.queries_done" in out["listed"]
    assert "query_s" in out["listed"]
    assert out["trace"]["correct"] and out["plain"]["correct"]
    got = out["trace"]["metrics"]["dummy.queries_done"]
    assert got["unit"] == "queries" and got["value"] >= 1
    assert set(out["plain"]["metrics"]) == {"query_s", "setup_s"}


def test_catalog_names_every_file():
    from bench.harness import catalog
    cat = catalog()
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(cat) == {w["name"] for w in spec["workloads"]}
    for cell in cat.values():
        assert cell["config"].is_file() and cell["traffic"].is_file()
        assert all(p.is_file() for p in cell["metrics"].values())


def test_missing_file_is_named(tmp_path):
    spec_path = tiny_copy(tmp_path)
    shutil.rmtree(tmp_path / "bench" / "metrics")
    from bench.harness import catalog
    try:
        catalog(spec_path)
    except FileNotFoundError as e:
        assert "metrics" in str(e)
    else:
        raise AssertionError("a missing metric reader went unnoticed")
