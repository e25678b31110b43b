"""The port's recsys family (BST) against the JAX package, on CPU.

The JAX package's BST init (with seeded noise on the layernorm gains and
biases and the MLP biases, which it initialises to 1 and 0) is carried
across by ``bst_state_dict_from_numpy``; the port's ``bst_scores``,
``bst_serve``, ``bst_loss`` with every gradient, one AdamW step and
``bst_retrieval`` must equal ``repro.models.bst`` at the smoke config in
f32, within 1e-5 (sums in another order; the gradients and the AdamW
step at 1e-4 and 1e-6 as the LM training tests hold theirs). The
EmbeddingBag functions and the MLP tower equal ``repro.layers`` in each
mode, pads and weights included, at 1e-6. The serve and train CLIs run
their recsys branches on the CPU.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.layers import embedding_bag as jeb
from repro.layers import mlp as jmlp
from repro.models import bst as jbst
from repro.train import optimizer as jopt

from repro_torch.configs import get_config
from repro_torch.configs.bst import SHAPES
from repro_torch.convert import bst_state_dict_from_numpy
from repro_torch.data.pipelines import RecsysStream
from repro_torch.layers import embedding_bag as teb
from repro_torch.layers.mlp import MLP
from repro_torch.models import bst as tbst
from repro_torch.train import optimizer as topt
from repro_torch.train.optimizer import AdamWState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
OPT = dict(lr=1e-2, warmup_steps=1, decay_steps=50, weight_decay=0.1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the test files run in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_params():
    cfg = jax_get_config("bst").smoke().model_cfg
    params = _np(jbst.init_bst_params(jax.random.PRNGKey(3), cfg))
    rng = np.random.default_rng(5)
    for owner, names in ((params["blocks"], ("ln1_g", "ln1_b", "ln2_g",
                                             "ln2_b")),
                         (params["mlp"], [k for k in params["mlp"]
                                          if k.startswith("b")])):
        for name in names:
            a = owner[name]
            owner[name] = (a + 0.2 * rng.normal(size=a.shape)
                           ).astype(a.dtype)
    return params, cfg


def _model():
    params, _ = _jax_params()
    cfg = get_config("bst").smoke().model_cfg
    model = tbst.BST(cfg, torch.Generator().manual_seed(0))
    model.load_state_dict(bst_state_dict_from_numpy(params, cfg))
    return model


def _batch(b=16, step=0):
    cfg = get_config("bst").smoke().model_cfg
    np_batch = RecsysStream(cfg.n_items, cfg.n_user_feats, cfg.seq_len,
                            cfg.user_feat_len, b, seed=1).batch(step)
    # ids past either end of the tables: the reference clips them
    np_batch["hist"][0, :3] = [-5, cfg.n_items, cfg.n_items + 7]
    tb = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    return tb, {k: jnp.asarray(v) for k, v in np_batch.items()}


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("pad_id", [None, 0])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_equals_jax(mode, pad_id, weighted):
    rng = np.random.default_rng(11)
    table = rng.normal(size=(40, 6)).astype(np.float32)
    ids = rng.integers(-3, 44, size=30).astype(np.int32)
    ids[[2, 5, 6, 20]] = 0                        # pads, when pad_id == 0
    seg = np.sort(rng.integers(0, 9, size=30)).astype(np.int32)
    seg[seg == 4] = 5                             # an empty bag
    w = rng.uniform(0.5, 2.0, size=30).astype(np.float32) if weighted \
        else None
    want = jeb.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                             jnp.asarray(seg), 9, mode=mode, pad_id=pad_id,
                             weights=None if w is None else jnp.asarray(w))
    got = teb.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            torch.from_numpy(seg), 9, mode=mode,
                            pad_id=pad_id,
                            weights=None if w is None else
                            torch.from_numpy(w))
    assert got.shape == (9, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("last", [3, -1])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_drops_out_of_range_segments_as_jax(mode, last):
    """A row whose segment id lies outside [0, num_segments) is dropped,
    as jax.ops.segment_* drops it (the padding convention of the GNN
    scatters), in every mode."""
    table = np.arange(40, dtype=np.float32).reshape(10, 4)
    ids = np.array([1, 2, 3, 0, 5, 6], np.int32)
    seg = np.array([0, 0, 1, 1, 2, last], np.int32)
    want = jeb.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                             jnp.asarray(seg), 3, mode=mode, pad_id=0)
    got = teb.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            torch.from_numpy(seg), 3, mode=mode, pad_id=0)
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("pad_id", [None, 0])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_fixed_and_lookup_equal_jax(mode, pad_id):
    rng = np.random.default_rng(12)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    ids = rng.integers(-4, 55, size=(5, 7)).astype(np.int32)
    ids[1] = 0                                    # a bag of pads only
    ids[2, 3:] = 0
    jt, tt = jnp.asarray(table), torch.from_numpy(table)
    np.testing.assert_allclose(
        teb.embedding_bag_fixed(tt, torch.from_numpy(ids), mode=mode,
                                pad_id=pad_id).numpy(),
        np.asarray(jeb.embedding_bag_fixed(jt, jnp.asarray(ids), mode=mode,
                                           pad_id=pad_id)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        teb.embedding_lookup(tt, torch.from_numpy(ids), pad_id).numpy(),
        np.asarray(jeb.embedding_lookup(jt, jnp.asarray(ids), pad_id)))


@pytest.mark.parametrize("final_act", [False, True])
def test_mlp_tower_equals_jax(final_act):
    sizes = [12, 16, 8, 3]
    jp = _np(jmlp.mlp_params(jax.random.PRNGKey(0), sizes, jnp.float32))
    rng = np.random.default_rng(2)
    jp = {k: (v + 0.3 * rng.normal(size=v.shape)).astype(np.float32)
          for k, v in jp.items()}
    mlp = MLP(sizes, torch.float32, torch.Generator().manual_seed(0))
    assert sorted(dict(mlp.named_parameters())) == sorted(jp)
    mlp.load_state_dict({k: torch.from_numpy(v) for k, v in jp.items()})
    x = rng.normal(size=(4, 5, 12)).astype(np.float32)
    want = jmlp.mlp_apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                          final_act=final_act)
    got = mlp(torch.from_numpy(x), final_act=final_act)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def test_config_layout_and_sizes_equal_jax():
    jcfg = jax_get_config("bst").model_cfg
    tcfg = get_config("bst").model_cfg
    for f in dataclasses.fields(tcfg):
        if f.name != "dtype":
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.n_params == jcfg.n_params
    assert get_config("bst").family == "recsys"
    scfg = get_config("bst").smoke().model_cfg
    assert scfg.n_params == jax_get_config("bst").smoke().model_cfg.n_params
    model = tbst.init_bst_params(scfg, seed=0, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == scfg.n_params
    params, _ = _jax_params()
    assert sorted(bst_state_dict_from_numpy(params, scfg)) == \
        sorted(model.state_dict())
    jshapes = jax_get_config("bst").shapes
    assert {k: s.dims for k, s in jshapes.items()} == SHAPES


def test_scores_and_serve_equal_jax():
    params, jcfg = _jax_params()
    model = _model()
    tb, jb = _batch()
    jp = jax.tree.map(jnp.asarray, params)
    with torch.no_grad():
        got = tbst.bst_scores(model, tb["hist"], tb["target"],
                              tb["user_feats"])
        served = tbst.bst_serve(model, tb)
    want = jbst.bst_scores(jp, jb["hist"], jb["target"], jb["user_feats"],
                           jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(served.numpy(),
                               np.asarray(jbst.bst_serve(jp, jb, jcfg)),
                               **TOL)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    params, jcfg = _jax_params()
    _, jb = _batch()
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jbst.bst_loss(p, jb, jcfg), has_aux=True)(
            jax.tree.map(jnp.asarray, params))
    return float(loss), float(metrics["acc"]), _np(grads)


def test_loss_and_every_gradient_equal_jax():
    _, jcfg = _jax_params()
    model = _model()
    tb, _ = _batch()
    loss, metrics = tbst.bst_loss(model, tb)
    loss.backward()
    want_loss, want_acc, jgrads = _jax_loss_and_grads()
    np.testing.assert_allclose(loss.item(), want_loss, **TOL)
    assert float(metrics["acc"]) == want_acc
    want = bst_state_dict_from_numpy(jgrads, jcfg)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   **GRAD_TOL, err_msg=name)


def test_one_adamw_step_equals_jax():
    """One AdamW step on the reference's gradients from a fresh state: the
    decay mask follows the reference's stacked leaves (a block's layernorm
    gains are decayed, the MLP's biases are not)."""
    params, jcfg = _jax_params()
    _, _, jgrads = _jax_loss_and_grads()
    jp = jax.tree.map(jnp.asarray, params)
    want_p, want_s, want_m = jopt.adamw_update(
        jopt.AdamWConfig(**OPT), jax.tree.map(jnp.asarray, jgrads),
        jopt.adamw_init(jp), jp)
    tparams = bst_state_dict_from_numpy(params, jcfg)
    mask = tbst.bst_decay_mask(tparams)
    assert mask["blocks.0.ln1_g"] and not mask["mlp.b0"] and \
        mask["item_emb"]
    got_p, got_s, got_m = topt.adamw_update(
        topt.AdamWConfig(**OPT), bst_state_dict_from_numpy(jgrads, jcfg),
        topt.adamw_init(tparams), tparams, mask)
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-5)
    for got, want in ((got_p, want_p), (got_s.m, want_s.m),
                      (got_s.v, want_s.v)):
        want = bst_state_dict_from_numpy(_np(want), jcfg)
        for name, t in got.items():
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    assert isinstance(got_s, AdamWState) and int(got_s.step) == 1


@pytest.mark.parametrize("chunk", [None, 100])
def test_retrieval_equals_jax(chunk):
    params, jcfg = _jax_params()
    model = _model()
    tb, jb = _batch(b=1, step=4)
    cand = np.random.default_rng(9).integers(0, jcfg.n_items, 512)
    cand = cand.astype(np.int32)
    want = jbst.bst_retrieval(jax.tree.map(jnp.asarray, params), jb["hist"],
                              jb["user_feats"], jnp.asarray(cand), jcfg)
    with torch.no_grad():
        got = tbst.bst_retrieval(model, tb["hist"], tb["user_feats"],
                                 torch.from_numpy(cand), chunk=chunk)
    assert got.shape == (512,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------


def test_serve_cli_recsys_branch(capsys):
    from repro_torch.launch.serve import main
    scores = main(["--arch", "bst", "--smoke", "--device", "cpu",
                   "--batch", "32", "--decode-steps", "3"])
    out = capsys.readouterr().out
    assert "3 batches of 32:" in out and "req/s); mean CTR" in out
    assert scores.shape == (32,) and bool(((scores > 0) &
                                           (scores < 1)).all())


def test_train_cli_recsys_branch_lowers_the_loss(capsys):
    from repro_torch.launch.train import main
    hist = main(["--arch", "bst", "--smoke", "--device", "cpu", "--steps",
                 "30", "--batch", "64", "--lr", "3e-3"])
    out = capsys.readouterr().out
    assert "final loss:" in out
    assert hist["loss"][-1] < hist["loss"][0]


def test_recsys_modules_import_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        "for m in ('repro_torch.models.bst', 'repro_torch.configs.bst',\n"
        "          'repro_torch.layers.embedding_bag',\n"
        "          'repro_torch.launch.serve', 'repro_torch.launch.train'):\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
