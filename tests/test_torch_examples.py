"""The port's examples against the JAX package's, on the CPU.

``examples/quickstart_torch.py``, ``continuous_enum_torch.py`` and
``train_lm_torch.py`` import only ``repro_torch`` and run with
``--device cpu`` here:

* quickstart: the chordal-square match count on ``powerlaw(500, 4,
  seed=0)`` equals the JAX engine's on the same graph and plan (and the
  brute force, which the example checks itself);
* continuous_enum: each step's ΔR⁺ and ΔR⁻ sizes and DBQ count equal
  ``examples/continuous_enum.py``'s run (the JAX package's interpreter)
  on the same stream;
* train_lm: the ``qwen2-micro`` parameter count equals the JAX config's
  ``n_params``, the loss falls over a few steps, and a second run in the
  same checkpoint directory resumes after the latest checkpoint.
"""

import importlib.util
import os

import jax.numpy as jnp
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_count_equals_jax(capsys):
    from repro.core.engine_jax import enumerate_graph
    from repro.core.pattern import get_pattern
    from repro.core.plangen import generate_best_plan
    from repro.graph.generate import powerlaw
    got = _example("quickstart_torch").main(["--device", "cpu"])
    g = powerlaw(n=500, m_per_node=4, seed=0)
    plan = generate_best_plan(get_pattern("chordal-square"), g.stats())
    want = enumerate_graph(plan, g, batch=128)["count"]
    assert got == want > 0
    assert f"brute-force check: {want} — OK" in capsys.readouterr().out


def test_continuous_enum_steps_equal_jax():
    from repro.core.estimate import GraphStats
    from repro.core.pattern import get_pattern
    from repro.core.sbenu import generate_best_sbenu_plans, run_timestep
    from repro.graph.dynamic import SnapshotStore
    from repro.graph.generate import edge_stream
    got = _example("continuous_enum_torch").main(["--device", "cpu"])
    p = get_pattern("q3'")
    g0, batches = edge_stream(n=150, m_init=900, steps=5, batch=60, seed=1)
    store = SnapshotStore(g0)
    plans = generate_best_sbenu_plans(p, GraphStats(150, 900,
                                                    delta_edges=60))
    want = []
    for batch in batches:
        dp, dm, ctr = run_timestep(p, plans, store, batch)
        want.append((len(dp), len(dm), ctr.dbq))
    assert got == want
    assert sum(a + b for a, b, _ in want) > 0


def test_train_lm_params_loss_and_resume(tmp_path):
    import jax
    from repro.models.transformer import LMConfig, init_params
    mod = _example("train_lm_torch")
    jcfg = LMConfig(name="qwen2-micro", n_layers=4, d_model=256, n_heads=8,
                    n_kv_heads=2, d_head=32, d_ff=1024, vocab=4096,
                    qkv_bias=True, tie_embeddings=True, dtype=jnp.float32,
                    remat=False)
    assert mod.CFG.n_params == jcfg.n_params
    # the tensors themselves too (n_params leaves out the QKV biases)
    leaves = jax.tree.leaves(jax.eval_shape(
        lambda k: init_params(k, jcfg), jax.random.PRNGKey(0)))
    model = mod.init_params(mod.CFG, seed=0, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == \
        sum(x.size for x in leaves)
    args = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "4",
            "--log-every", "1", "--seq", "32", "--batch", "4",
            "--device", "cpu"]
    first = mod.main(["8"] + args)
    assert first["step"] == list(range(1, 9))
    assert first["loss"][-1] < first["loss"][0]
    assert sorted(os.listdir(tmp_path)) == ["ckpt-00000004",
                                            "ckpt-00000008"]
    again = mod.main(["12"] + args)
    assert again["step"] == list(range(9, 13))        # resumed at step 8
    assert again["loss"][-1] < first["loss"][0]


@pytest.mark.parametrize("name", ["quickstart_torch", "continuous_enum_torch",
                                  "train_lm_torch"])
def test_example_without_a_card_raises(name, tmp_path):
    """Without ``--device`` an example runs on the card, and raises when
    there is none (no fallback to the CPU)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    args = ["--ckpt-dir", str(tmp_path)] if name == "train_lm_torch" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(args)
    assert not os.listdir(tmp_path)
