"""The correctness check fails its control and every fault the cells can
have, driven through a whole run on the CPU at tiny sizes (the look for
a card skipped)."""

import numpy as np
import pytest

from bench import harness
from bench.control import run_control
from conftest import TINY_CELL


@pytest.mark.parametrize("seed", [2**33 + 1, 5])
def test_sound_run_is_correct(seed, tiny_spec):
    out = harness.run(TINY_CELL, seed, 0.05, False, "cpu",
                      spec_path=tiny_spec)
    assert out["correct"] and out["failed"] == 0
    assert out["checks"]["count_gap"] == {"value": 0, "limit": 0}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(seed, tiny_spec):
    """The sampled estimate (half the starts, doubled) reads a gap on
    every seed."""
    out = run_control(TINY_CELL, seed, "cpu", seconds=0.01,
                      spec_path=tiny_spec)
    assert not out["correct"]
    assert out["checks"]["count_gap"]["value"] > 0


def _state_unchanged(real):
    """The chunk returns without doing its work."""
    def run_chunk(self, ids, valid, uni, caps):
        from repro_torch.core.executor import ChunkResult
        return ChunkResult(count=0)
    return run_chunk


def _answer_altered(real):
    """One more match where the count of vertex 0's chunk is produced."""
    def run_chunk(self, ids, valid, uni, caps):
        res = real(self, ids, valid, uni, caps)
        if res.overflow == 0 and (ids[valid] == 0).any():
            res.count += 1
        return res
    return run_chunk


def _half_left_out(real):
    """Every other start batch dropped, the rest's count doubled."""
    def run_chunk(self, ids, valid, uni, caps):
        res = real(self, ids, valid, uni, caps)
        res.count *= 2
        return res
    return run_chunk


@pytest.mark.parametrize("fault", [_state_unchanged, _answer_altered,
                                   _half_left_out])
def test_fault_is_not_correct(fault, tiny_spec, monkeypatch):
    from repro_torch.core import executor as ex
    monkeypatch.setattr(ex.TorchBackend, "run_chunk",
                        fault(ex.TorchBackend.run_chunk))
    if fault is _half_left_out:
        real = ex.start_id_batches

        def every_other(n, batch, sentinel=None):
            for k, b in enumerate(real(n, batch, sentinel)):
                if k % 2 == 0:
                    yield b
        monkeypatch.setattr(ex, "start_id_batches", every_other)
    out = harness.run(TINY_CELL, 7, 0.05, False, "cpu", spec_path=tiny_spec)
    assert not out["correct"]
    assert out["checks"]["count_gap"]["value"] > 0


def test_judge():
    ok, checks = harness.judge([5, 5], 5, 5)
    assert ok and checks["count_gap"]["value"] == 0
    ok, checks = harness.judge([5, 6], 5, 5)
    assert not ok and checks["count_gap"] == {"value": 1, "limit": 0}
    assert not harness.judge([5], 4, 5)[0]
    assert np.isfinite(checks["warmup_count_gap"]["value"])
