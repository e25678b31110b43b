"""The port's planner, graph generators and package boundary vs the JAX
package, on CPU. Every comparison is exact."""

import dataclasses
import glob
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.engine_jax import classify_fusable_dbqs as jax_classify
from repro.core.engine_jax import default_caps as jax_default_caps
from repro.core.pattern import get_pattern as jax_get_pattern
from repro.core.plangen import generate_best_plan as jax_best_plan
from repro.graph import generate as jax_generate
from repro.graph.storage import pad_rows as jax_pad_rows

import repro_torch
from repro_torch.convert import plan_from_fields
from repro_torch.core.engine_torch import classify_fusable_dbqs, default_caps
from repro_torch.core.executor import make_executor
from repro_torch.core.pattern import get_pattern
from repro_torch.core.plangen import generate_best_plan
from repro_torch.graph import generate
from repro_torch.graph.storage import pad_rows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (generator, args, seed): the graphs of tests/test_conformance.py and the
# VCBC graph of tests/test_engines.py
GRAPHS = {"er": ("erdos_renyi", (64, 256), 11),
          "pl": ("powerlaw", (64, 4), 12),
          "pl50": ("powerlaw", (50, 4), 2)}
PATTERNS = ["triangle", "square", "clique4", "house", "path5", "cycle5"]
PLAN_CASES = ([(p, g, False) for p in PATTERNS for g in ("er", "pl")]
              + [(p, "pl50", True)
                 for p in ("triangle", "chordal-square", "house")])


def both_graphs(gname):
    fn, args, seed = GRAPHS[gname]
    return (getattr(jax_generate, fn)(*args, seed=seed),
            getattr(generate, fn)(*args, seed=seed))


@pytest.mark.parametrize("pname,gname,vcbc", PLAN_CASES)
def test_best_plan_equals_reference(pname, gname, vcbc):
    jg, tg = both_graphs(gname)
    jplan = jax_best_plan(jax_get_pattern(pname), jg.stats(), vcbc=vcbc)
    plan = generate_best_plan(get_pattern(pname), tg.stats(), vcbc=vcbc)
    assert plan.pretty() == jplan.pretty()
    assert plan == plan_from_fields(dataclasses.asdict(jplan))
    assert classify_fusable_dbqs(plan) == jax_classify(jplan)
    for batch, d in ((32, 128), (256, 640), (4096, 3968)):
        assert default_caps(plan, batch, d) == \
            jax_default_caps(jplan, batch, d)


@pytest.mark.parametrize("fn,args,seed", [
    ("erdos_renyi", (64, 256), 11), ("powerlaw", (64, 4), 12),
    ("erdos_renyi", (300, 1200), 3), ("powerlaw", (500, 8), 0)])
def test_generators_and_padding_equal_reference(fn, args, seed):
    jg = getattr(jax_generate, fn)(*args, seed=seed)
    tg = getattr(generate, fn)(*args, seed=seed)
    assert tg.n == jg.n and tg.m == jg.m
    np.testing.assert_array_equal(tg.deg, jg.deg)
    np.testing.assert_array_equal(tg.relabel, jg.relabel)
    for a, b in zip(tg.adj, jg.adj):
        np.testing.assert_array_equal(a, b)
    for want, got in zip(jg.padded_adjacency(lane=128),
                         tg.padded_adjacency(lane=128)):
        np.testing.assert_array_equal(want, got)


def test_pad_rows_truncation_guard_matches_reference():
    adj = [np.arange(5), np.arange(2)]
    for fn in (pad_rows, jax_pad_rows):
        with pytest.raises(ValueError, match="truncated"):
            fn(adj, 9, d_max=3, lane=1)
    with pytest.warns(RuntimeWarning):
        got = pad_rows(adj, 9, d_max=3, lane=1, on_overflow="clamp")
    with pytest.warns(RuntimeWarning):
        want = jax_pad_rows(adj, 9, d_max=3, lane=1, on_overflow="clamp")
    np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------
# The package boundary: no jax, nothing of repro
# --------------------------------------------------------------------------

FORBIDDEN = re.compile(
    r"^\s*(?:import\s+jax\b|from\s+jax\b|import\s+repro\b|from\s+repro[.\s])",
    re.MULTILINE)


def test_forbidden_import_regex():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "from repro.core import plangen", "import repro",
                 "    from repro import kernels"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x",
                 "from .kernels import ops", "import jaxlib_free"):
        assert not FORBIDDEN.search(line), line


def test_sources_import_neither_jax_nor_repro():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "src",
                                                  "repro_torch")):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    examples = sorted(glob.glob(os.path.join(ROOT, "examples",
                                             "*_torch.py")))
    assert [os.path.basename(p) for p in examples] == [
        "continuous_enum_torch.py", "motif_features_torch.py",
        "quickstart_torch.py", "train_lm_torch.py"]
    paths += examples
    assert len(paths) > 10
    for sub in ("layers", "models", "configs"):
        assert any(os.sep + sub + os.sep in p for p in paths), sub
    for mod in ("core/ref_engine.py", "core/baseline_join.py",
                "core/engine_dist.py", "core/engine_sbenu_dist.py",
                "distributed/rowstore.py", "layers/moe.py",
                "configs/granite_moe_3b_a800m.py",
                "configs/deepseek_v2_lite_16b.py", "models/gnn.py",
                "models/gnn_dist.py", "configs/gin_tu.py", "configs/pna.py",
                "configs/egnn.py", "configs/meshgraphnet.py"):
        assert any(p.endswith(os.sep + mod.replace("/", os.sep))
                   for p in paths), mod
    for p in paths:
        with open(p) as fh:
            hit = FORBIDDEN.search(fh.read())
        assert hit is None, (p, hit and hit.group(0))


def test_importing_the_port_loads_neither_jax_nor_repro():
    mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke, json, os, subprocess, time, pathlib, torch\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for mod in ("launch.enumerate", "launch.serve", "launch.serve_ab",
                "core.engine_torch",
                "layers.attention", "layers.common", "layers.mlp",
                "layers.rope", "layers.moe", "models.transformer",
                "configs.qwen2_0_5b", "configs.qwen2_5_3b",
                "configs.phi4_mini_3_8b", "configs.granite_moe_3b_a800m",
                "configs.deepseek_v2_lite_16b", "models.gnn",
                "models.gnn_dist", "configs.gin_tu", "configs.pna",
                "configs.egnn", "configs.meshgraphnet",
                "kernels.flash_attention", "kernels.rmsnorm"):
        assert f"repro_torch.{mod}" in mods


def test_entry_points_without_a_device_raise_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for engine in ("torch", "torch-gpu"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_executor(engine)
    from repro_torch.launch.enumerate import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--pattern", "triangle", "--n", "20", "--edges", "40"])
    assert make_executor("torch", device="cpu").backend.device.type == "cpu"
