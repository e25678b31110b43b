"""The benchmark on the card at tiny sizes: the reference agrees with
itself on the CPU, a traced run is correct and reads the device, the
control fails. Each test skips where no card is present.

    python -m pytest -q -m cuda bench/tests/test_bench_cuda.py
"""

import json

import pytest

from bench import harness
from bench.control import run_control
from bench.graphgen import make_graph
from bench.reference.counts import count
from conftest import TINY_CELL

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("scale", [12, 15])
def test_reference_card_equals_cpu(card, scale):
    csr = make_graph({"graph_model": "uniform_random", "scale": scale,
                      "degree": 16, "structure_seed": 1}, 3)
    assert count("q1", csr, device=card) == count("q1", csr)


def test_traced_run_on_card(card, tiny_spec):
    """Every per-layer metric the cell lists is read."""
    out = harness.run(TINY_CELL, 2**33 + 3, 0.5, True, card,
                      spec_path=tiny_spec)
    assert out["correct"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    spec = json.loads(tiny_spec.read_text())
    assert set(out["metrics"]) == {
        m["name"] for m in harness.metrics_of(spec, TINY_CELL, True)}


def test_control_fails_on_card(card, tiny_spec):
    out = run_control(TINY_CELL, 5, card, seconds=0.01,
                      spec_path=tiny_spec)
    assert not out["correct"]
