"""The port's LM training slice against the JAX package, on CPU.

Loss and gradients: the JAX package's init (with seeded noise on the QKV
biases and norm gains, which it initialises to 0 and 1) is carried across
(``lm_state_dict_from_numpy``); ``loss_fn``, its aux loss and every
parameter's gradient of the port (plain versions, remat on and off; the
MoE models through the layer's gather-based backward) must equal
``jax.value_and_grad(repro.models.transformer.loss_fn)`` with blockwise
attention (the Pallas kernel cannot take MLA) and the jnp rmsnorm (the
Pallas kernels have no VJP), at 2e-4 as ``tests/test_torch_lm.py`` holds
the forward. One AdamW step from a state
carried by ``adamw_state_from_numpy`` equals the reference's: f32 at 1e-6,
bf16 within one bf16 ulp. The data streams and graph batches are
bit-equal. Checkpoint/restart mirrors ``tests/test_train.py``. The int8
all-reduce runs on 2 gloo ranks (subprocesses under a time limit, marked
``slow``) against the reference's ``compressed_psum`` under ``jax.vmap``.
"""

import dataclasses
import functools
import os
import re
import signal
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import pipelines as jpipe
from repro.distributed.compression import compressed_psum as jax_psum
from repro.graph import batch as jbatch
from repro.graph import generate as jgen
from repro.layers import common as jcommon
from repro.models import transformer as jtf
from repro.train import optimizer as jopt

from repro_torch.configs import get_config
from repro_torch.convert import (adamw_state_from_numpy,
                                 lm_state_dict_from_numpy)
from repro_torch.data import pipelines as tpipe
from repro_torch.graph import batch as tbatch
from repro_torch.graph import generate as tgen
from repro_torch.layers import common as tcommon
from repro_torch.models import transformer as ttf
from repro_torch.train import optimizer as topt
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import TrainLoopConfig, run_training

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen2-0.5b", "qwen2.5-3b", "phi4-mini-3.8b",
         "granite-moe-3b-a800m", "deepseek-v2-lite-16b"]
TOL = dict(rtol=2e-4, atol=2e-4)
OPT = dict(lr=1e-2, warmup_steps=1, decay_steps=50, weight_decay=0.1)


@pytest.fixture(autouse=True)
def _jnp_rmsnorm(monkeypatch):
    monkeypatch.setenv("REPRO_RMSNORM_IMPL", "ref")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test files run in parallel workers on one host, where torch's
    CPU thread pool, spinning on every core, slows these small tensor ops
    by tens of times; this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, dtype=jnp.float32):
    """The reference's init with noisy biases and gains, as numpy."""
    jcfg = dataclasses.replace(jax_get_config(arch).smoke().model_cfg,
                               dtype=dtype)
    params = _np(jtf.init_params(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(len(arch))
    stacks = [params[k] for k in ("dense_layers", "moe_layers")
              if k in params]
    for name in ("bq", "bk", "bv"):
        if name in stacks[0]["attn"]:
            a = stacks[0]["attn"][name]
            stacks[0]["attn"][name] = (a + 0.3 * rng.normal(size=a.shape)
                                       ).astype(a.dtype)
    gains = [(stacks[0], "norm1"), (stacks[0], "norm2"),
             (params, "final_norm")]
    gains += [(st, name) for st in stacks[1:] for name in ("norm1", "norm2")]
    gains += [(st["attn"], "norm_ckv") for st in stacks
              if "norm_ckv" in st["attn"]]
    for owner, name in gains:
        a = owner[name]
        owner[name] = (a + 0.2 * rng.normal(size=a.shape)).astype(a.dtype)
    return params, jcfg


def _batch(vocab, seed=0):
    return tpipe.LMStream(vocab=vocab, seq_len=16, global_batch=2,
                          seed=seed).batch(3)


# --------------------------------------------------------------------------
# cross entropy, layernorm, loss and gradients
# --------------------------------------------------------------------------


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_softmax_cross_entropy_equals_jax(z_loss):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    want = jcommon.softmax_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels), z_loss)
    got = tcommon.softmax_cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(labels), z_loss)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_layernorm_equals_jax():
    rng = np.random.default_rng(1)
    x, g, b = (rng.normal(size=s).astype(np.float32) * 2
               for s in ((4, 5, 24), (24,), (24,)))
    want = jcommon.layernorm(*map(jnp.asarray, (x, g, b)))
    got = tcommon.layernorm(*map(torch.from_numpy, (x, g, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch):
    """The reference's loss and gradients (its smoke config, no remat:
    ``jax.checkpoint`` recomputes the same values)."""
    params, jcfg = _jax_params(arch)
    b = {k: jnp.asarray(v) for k, v in _batch(jcfg.vocab).items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jtf.loss_fn(p, b, jcfg, attn_impl="blockwise"),
        has_aux=True)(jax.tree.map(jnp.asarray, params))
    return (float(loss), float(metrics["ce"]), float(metrics["aux"]),
            _np(grads))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_equal_jax(arch, remat):
    params, _ = _jax_params(arch)
    tcfg = dataclasses.replace(get_config(arch).smoke().model_cfg,
                               remat=remat)
    model = ttf.Transformer(tcfg, torch.Generator().manual_seed(0))
    model.load_state_dict(lm_state_dict_from_numpy(params, tcfg))
    batch = {k: torch.from_numpy(v).long()
             for k, v in _batch(tcfg.vocab).items()}
    loss, metrics = ttf.loss_fn(model, batch)
    loss.backward()
    want_loss, want_ce, want_aux, jgrads = _jax_loss_and_grads(arch)
    np.testing.assert_allclose(loss.item(), want_loss, **TOL)
    np.testing.assert_allclose(metrics["ce"].item(), want_ce, **TOL)
    np.testing.assert_allclose(metrics["aux"].item(), want_aux, **TOL)
    assert (want_aux > 0) == tcfg.moe
    want = lm_state_dict_from_numpy(jgrads, tcfg)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------


def test_cosine_lr_equals_jax():
    cfg = dict(lr=3e-3, warmup_steps=10, decay_steps=40, min_lr_ratio=0.1)
    jcfg, tcfg = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    for step in range(51):
        want = jopt.cosine_lr(jcfg, jnp.asarray(step, jnp.int32))
        got = topt.cosine_lr(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-12, err_msg=str(step))


def test_decay_follows_the_reference_leaf_layout():
    """The Transformer's ``decay_mask`` equals the reference's
    ``ndim >= 2`` on its own leaf: each port tensor is filled with its
    reference leaf's ndim. Without the mask, AdamW's default (``ndim >= 2``
    on the port's tensors) would leave the 1-D Block tensors undecayed."""
    params, jcfg = _jax_params("qwen2-0.5b")
    ndims = jax.tree.map(lambda a: np.full(a.shape, a.ndim, np.float32),
                         params)
    tcfg = get_config("qwen2-0.5b").smoke().model_cfg
    decayed = {"norm1.weight", "norm2.weight", "attn.bq", "attn.bk",
               "attn.bv"}
    sd = lm_state_dict_from_numpy(ndims, tcfg)
    mask = ttf.decay_mask(sd)
    model = ttf.init_params(tcfg, seed=0, device="cpu")
    assert mask == ttf.decay_mask(dict(model.named_parameters()))
    for name, t in sd.items():
        want = int(t.flatten()[0]) >= 2
        assert mask[name] == want, name
        if name.split(".", 2)[-1] in decayed:
            assert t.ndim == 1 and want, name     # 1-D here, stacked there
    assert not mask["final_norm.weight"]


def _bf16_ulp(x):
    mag = np.maximum(np.abs(x.astype(np.float32)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("grads", ["random", "zero"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_adamw_step_equals_jax(dtype, grads):
    """From the reference's state after one step (carried by
    ``adamw_state_from_numpy``), a second step on the same gradients
    gives the same parameters and moments. With zero gradients the step
    is weight decay alone, so a Block's norm gain or QKV bias that escaped
    decay would stay put here and move in the reference."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    params, jcfg = _jax_params("qwen2-0.5b", jdt)
    tcfg = dataclasses.replace(get_config("qwen2-0.5b").smoke().model_cfg,
                               dtype=getattr(torch, dtype))
    rng = np.random.default_rng(7)

    def draw():
        if grads == "zero":
            return jax.tree.map(jnp.zeros_like, params)
        return jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape) * 0.5, a.dtype), params)

    jcfg_opt = jopt.AdamWConfig(**OPT)
    jp = jax.tree.map(jnp.asarray, params)
    jp, state, _ = jopt.adamw_update(jcfg_opt, draw(), jopt.adamw_init(jp),
                                     jp)
    g2 = draw()
    tparams = lm_state_dict_from_numpy(_np(jp), tcfg)
    tstate = adamw_state_from_numpy(np.asarray(state.step), _np(state.m),
                                    _np(state.v), tcfg)
    tgrads = lm_state_dict_from_numpy(_np(g2), tcfg)
    before = {n: t.clone() for n, t in tparams.items()}
    want_p, want_s, want_m = jopt.adamw_update(jcfg_opt, g2, state, jp)
    got_p, got_s, got_m = topt.adamw_update(topt.AdamWConfig(**OPT), tgrads,
                                            tstate, tparams,
                                            ttf.decay_mask(tparams))
    assert int(got_s.step) == int(want_s.step) == 2
    np.testing.assert_allclose(float(got_m["lr"]), float(want_m["lr"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-5,
                               atol=1e-12)
    for key, want, got in (("params", want_p, got_p), ("m", want_s.m,
                                                       got_s.m),
                           ("v", want_s.v, got_s.v)):
        want = lm_state_dict_from_numpy(_np(want), tcfg)
        for name, t in got.items():
            w = want[name].float().numpy()
            err = np.abs(t.float().numpy() - w)
            if key == "params" and dtype == "bfloat16":
                assert t.dtype == torch.bfloat16
                assert (err <= _bf16_ulp(w)).all(), (name, err.max())
            else:
                assert t.dtype == torch.float32 or key == "params"
                np.testing.assert_allclose(t.float().numpy(), w, rtol=1e-6,
                                           atol=1e-6, err_msg=f"{key} {name}")
    if grads == "zero" and dtype == "float32":
        moved = {n for n, t in got_p.items()
                 if not torch.equal(t, before[n])}
        assert "layers.0.norm1.weight" in moved and \
            "layers.1.attn.bq" in moved
        # final_norm is a [D] leaf in the reference too: never decayed
        assert "final_norm.weight" not in moved


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------


def _assert_arrays_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_lm_and_recsys_streams_and_process_slice_are_bit_equal():
    for step in (0, 7):
        kw = dict(vocab=512, seq_len=33, global_batch=4, seed=3)
        _assert_arrays_equal(tpipe.LMStream(**kw).batch(step),
                             jpipe.LMStream(**kw).batch(step))
        kw = dict(n_items=1000, n_user_feats=50, seq_len=12,
                  user_feat_len=6, global_batch=8, seed=2)
        want = jpipe.RecsysStream(**kw).batch(step)
        _assert_arrays_equal(tpipe.RecsysStream(**kw).batch(step), want)
        for proc in range(4):
            _assert_arrays_equal(tpipe.process_slice(want, proc, 4),
                                 jpipe.process_slice(want, proc, 4))


def _graph_batches(mod):
    return {"full": mod.synthetic_full_graph(200, 600, 8, 5, seed=4),
            "mesh": mod.synthetic_mesh(150, 500, 6, 3, seed=5),
            "molecules": mod.synthetic_molecules(6, 9, 12, 7, 3, seed=6)}


def test_graph_batches_and_full_graph_data_are_bit_equal():
    got, want = _graph_batches(tbatch), _graph_batches(jbatch)
    for key in want:
        _assert_arrays_equal(got[key].as_arrays(), want[key].as_arrays())
        assert (got[key].n_nodes, got[key].n_graphs) == \
            (want[key].n_nodes, want[key].n_graphs)
        _assert_arrays_equal(tpipe.FullGraphData(got[key])(3),
                             jpipe.FullGraphData(want[key])(3))


def test_minibatch_graph_stream_and_sampler_are_bit_equal():
    rng = np.random.default_rng(8)
    n = 300
    feats = rng.normal(size=(n, 5)).astype(np.float32)
    labels = rng.integers(0, 4, size=n).astype(np.int32)
    kw = dict(feats=feats, labels=labels, batch_nodes=16, fanouts=(3, 2),
              n_max=200, e_max=400, seed=9)
    tg, jg = tgen.powerlaw(n, 4, seed=2), jgen.powerlaw(n, 4, seed=2)
    for step in (0, 5):
        _assert_arrays_equal(
            tpipe.MinibatchGraphStream(graph=tg, **kw).batch(step),
            jpipe.MinibatchGraphStream(graph=jg, **kw).batch(step))
    ts, js = (m.NeighborSampler(g, (4, 3), seed=1)
              for m, g in ((tbatch, tg), (jbatch, jg)))
    assert ts.capacity(10) == js.capacity(10)
    (tb, tids), (jb, jids) = (s.sample(np.arange(10)) for s in (ts, js))
    np.testing.assert_array_equal(tids, jids)
    _assert_arrays_equal(tb.as_arrays(), jb.as_arrays())


# --------------------------------------------------------------------------
# checkpoint and loop (mirrors tests/test_train.py)
# --------------------------------------------------------------------------

CFG = ttf.LMConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                   n_kv_heads=2, d_head=16, d_ff=128, vocab=512,
                   dtype=torch.float32, remat=False)


def _setup():
    stream = tpipe.LMStream(vocab=512, seq_len=32, global_batch=8)
    opt = topt.AdamWConfig(lr=1e-3, warmup_steps=5, decay_steps=40)
    init_fn = lambda: ttf.init_params(CFG, seed=0, device="cpu")
    return stream, opt, init_fn, ttf.loss_fn


def test_restart_after_failure_is_bit_exact(tmp_path):
    stream, opt, init_fn, lfn = _setup()
    loop = dict(steps=25, ckpt_every=5, log_every=5)
    ck = CheckpointManager(str(tmp_path / "a"), keep=2)
    with pytest.raises(RuntimeError, match="injected failure"):
        run_training(lfn, init_fn, stream.batch, opt,
                     TrainLoopConfig(**loop, fail_at_step=15), ckpt=ck,
                     device="cpu")
    assert ck.latest_step() == 15
    h1 = run_training(lfn, init_fn, stream.batch, opt,
                      TrainLoopConfig(**loop), ckpt=ck, device="cpu")
    h2 = run_training(lfn, init_fn, stream.batch, opt,
                      TrainLoopConfig(**loop),
                      ckpt=CheckpointManager(str(tmp_path / "b"), keep=2),
                      device="cpu")
    assert h1["step"][0] == 16 and h1["loss"][-1] == h2["loss"][-1]
    s1, s2 = h1["final_state"], h2["final_state"]
    for (n1, a), (n2, b) in zip(s1["params"].state_dict().items(),
                                s2["params"].state_dict().items()):
        assert n1 == n2 and torch.equal(a, b), n1
    for field in ("m", "v"):
        for name, a in getattr(s1["opt"], field).items():
            assert torch.equal(a, getattr(s2["opt"], field)[name])
    assert int(s1["opt"].step) == int(s2["opt"].step) == 25


def test_keep_k_retention(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.arange(4.0)}
    for step in (1, 2, 3, 4, 5):
        ck.save(step, state)
    assert ck.list_steps() == [4, 5]


def test_restore_shape_mismatch_rejected(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, {"w": torch.zeros((4, 4))})
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(1, {"w": torch.zeros((8, 4))})


def test_atomicity_no_partial_checkpoint(tmp_path):
    """A tmp dir left over from a crash is never listed as a checkpoint."""
    ck = CheckpointManager(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), ".tmp-7"))
    assert ck.list_steps() == []
    ck.save(7, {"w": torch.zeros(3)})
    assert ck.list_steps() == [7]


def test_bf16_state_round_trips_bit_for_bit(tmp_path):
    """numpy has no bfloat16: the bits go through int16 and come back
    exact, onto the device the caller names."""
    ck = CheckpointManager(str(tmp_path))
    model = ttf.init_params(dataclasses.replace(CFG, dtype=torch.bfloat16),
                            seed=3, device="cpu")
    state = {"params": model,
             "opt": topt.adamw_init(dict(model.named_parameters()))}
    ck.save(2, state)
    fresh = ttf.init_params(dataclasses.replace(CFG, dtype=torch.bfloat16),
                            seed=4, device="cpu")
    back = ck.restore(2, {"params": fresh, "opt": topt.adamw_init(
        dict(fresh.named_parameters()))}, device="cpu")
    for (n, a), b in zip(model.state_dict().items(),
                         back["params"].state_dict().values()):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b), n
    with pytest.raises(ValueError, match="dtype mismatch"):
        ck.restore(2, {"params": ttf.init_params(CFG, device="cpu"),
                       "opt": back["opt"]})


def test_training_reduces_loss():
    stream, opt, init_fn, lfn = _setup()
    h = run_training(lfn, init_fn, stream.batch, opt,
                     TrainLoopConfig(steps=40, ckpt_every=1000,
                                     log_every=10), device="cpu")
    assert h["loss"][-1] < h["loss"][0] * 0.8


def test_entry_points_without_a_device_raise_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stream, opt, init_fn, lfn = _setup()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(lfn, init_fn, stream.batch, opt, TrainLoopConfig(1))
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "gin-tu", "--smoke", "--steps", "1"])
    hist = main(["--arch", "bst", "--smoke", "--device", "cpu", "--steps",
                 "2", "--batch", "8"])
    assert len(hist["loss"]) == 2 and all(map(np.isfinite, hist["loss"]))


def test_train_cli_lowers_the_loss():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "20"], env=env, capture_output=True,
        text=True, timeout=300, check=True).stdout
    m = re.search(r"final loss: (\d+\.\d+) \(first: (\d+\.\d+)\)", out)
    assert m, out
    assert float(m.group(1)) < float(m.group(2))
    assert len(re.findall(r"^step +\d+ loss \d+\.\d+", out, re.M)) == 20


# --------------------------------------------------------------------------
# int8 compressed all-reduce and manual data parallel: 2 gloo ranks
# --------------------------------------------------------------------------

RANK_CODE = """
import json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.distributed.compression import (compressed_psum,
                                                 plain_psum_mean)
from repro_torch.data.pipelines import LMStream
from repro_torch.models import transformer as ttf
from repro_torch.train import optimizer as topt
from repro_torch.train.loop import TrainLoopConfig, run_training

rank, out = int(sys.argv[1]), sys.argv[2]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + out + "/store",
                        rank=rank, world_size=2)
grads = np.load(out + "/grads.npz")
res = {}
err = None
for step in range(2):
    tree = {k: torch.from_numpy(grads[f"{k}.{step}"][rank])
            for k in ("a", "b")}
    red, err = compressed_psum(tree, None, err)
    for k in tree:
        res[f"sum.{k}.{step}"] = red[k].numpy()
        res[f"err.{k}.{step}"] = err[k].numpy()
res.update({f"mean.{k}": v.numpy()
            for k, v in plain_psum_mean(tree).items()})
cfg = ttf.LMConfig(name="tiny", n_layers=2, d_model=32, n_heads=4,
                   n_kv_heads=2, d_head=8, d_ff=64, vocab=128,
                   dtype=torch.float32, remat=False)
stream = LMStream(vocab=128, seq_len=16, global_batch=4)
for mode in ("int8", "plain"):
    h = run_training(ttf.loss_fn, lambda: ttf.init_params(cfg, 0, "cpu"),
                     stream.batch, topt.AdamWConfig(lr=1e-3, warmup_steps=1),
                     TrainLoopConfig(steps=3, log_every=1,
                                     grad_compression=mode),
                     group=dist.group.WORLD, device="cpu")
    res[f"{mode}.loss"] = np.array(h["loss"])
    for n, p in h["final_state"]["params"].named_parameters():
        res[f"{mode}.{n}"] = p.detach().numpy()
np.savez(out + f"/rank{rank}.npz", **res)
dist.barrier()
dist.destroy_process_group()
"""


def _finish(proc: subprocess.Popen, timeout: float) -> str:
    """Wait for ``proc``; on timeout kill it and fail."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        pytest.fail(f"timed out after {timeout} s")
    assert proc.returncode == 0, err[-3000:]
    return out


@pytest.mark.slow
def test_compressed_psum_and_manual_dp_on_two_ranks(tmp_path):
    """2 gloo ranks: ``compressed_psum`` over two steps of error feedback
    equals the reference's under ``jax.vmap(axis_name="dp")`` (payload sum,
    common scale, error state); ``plain_psum_mean`` is the mean. The
    manual-DP loop: with the plain mean the 2 ranks' steps equal one
    process on the whole batch, and with int8 both ranks hold the same
    finite parameters."""
    rng = np.random.default_rng(11)
    grads = {f"{k}.{s}": (rng.normal(size=(2,) + shape) * 0.1
                          ).astype(np.float32)
             for k, shape in (("a", (6, 7)), ("b", (13,))) for s in range(2)}
    np.savez(tmp_path / "grads.npz", **grads)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(RANK_CODE), str(r),
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
        for r in range(2)]

    fn = jax.vmap(lambda t, e: jax_psum(t, "dp", e), axis_name="dp")
    err = {k: jnp.zeros((2,) + grads[f"{k}.0"].shape[1:]) for k in "ab"}
    want = {}
    for step in range(2):
        red, err = fn({k: jnp.asarray(grads[f"{k}.{step}"]) for k in "ab"},
                      err)
        for k in "ab":
            want[f"sum.{k}.{step}"] = np.asarray(red[k])
            want[f"err.{k}.{step}"] = np.asarray(err[k])

    for p in procs:
        _finish(p, 300)
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for r in range(2):
        for key, w in want.items():
            np.testing.assert_allclose(got[r][key], w[r], rtol=1e-6,
                                       atol=1e-7, err_msg=f"{key} rank {r}")
        for k in "ab":
            np.testing.assert_allclose(got[r][f"mean.{k}"],
                                       grads[f"{k}.1"].mean(0), rtol=1e-6)
    # manual DP: the ranks agree; the plain mean equals the full batch
    names = [k for k in got[0] if k.startswith(("int8.", "plain."))]
    for k in names:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
        assert np.isfinite(got[0][k]).all(), k
    cfg = ttf.LMConfig(name="tiny", n_layers=2, d_model=32, n_heads=4,
                       n_kv_heads=2, d_head=8, d_ff=64, vocab=128,
                       dtype=torch.float32, remat=False)
    h = run_training(ttf.loss_fn, lambda: ttf.init_params(cfg, 0, "cpu"),
                     tpipe.LMStream(vocab=128, seq_len=16,
                                    global_batch=4).batch,
                     topt.AdamWConfig(lr=1e-3, warmup_steps=1),
                     TrainLoopConfig(steps=3, log_every=1), device="cpu")
    np.testing.assert_allclose(got[0]["plain.loss"], h["loss"], rtol=1e-5)
    for n, p in h["final_state"]["params"].named_parameters():
        np.testing.assert_allclose(got[0][f"plain.{n}"],
                                   p.detach().numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=n)


NEW_MODULES = ("data.pipelines", "graph.batch", "train.optimizer",
               "train.checkpoint", "train.loop", "distributed.compression",
               "launch.train")


def test_new_modules_import_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {[f'repro_torch.{m}' for m in NEW_MODULES]!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
