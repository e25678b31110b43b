"""The port's LM serving path against the JAX package, on CPU.

For each LM smoke config (f32: the dense GQA qwen2, qwen2.5 and
phi4-mini, granite's MoE and deepseek's MoE with MLA), the JAX package's
init is carried across (``lm_state_dict_from_numpy``) after seeded noise
is added to the QKV biases and norm gains, MLA's latent norm among them
(JAX initialises them to 0 and 1, so a dropped bias or gain would
otherwise pass). The JAX side runs its Pallas kernels in interpret mode
(``attn_impl="interpret"``, ``REPRO_RMSNORM_IMPL=interpret``), except
deepseek's attention, which runs ``"blockwise"``: the Pallas flash kernel
takes one head width for q, k and v, and MLA's v is narrower. The port
runs its plain versions. Tolerance 2e-4, as tests/test_models.py holds
decode against the full forward; greedy tokens must be equal. The MoE
aux loss and ``loss_fn`` (cross entropy + aux) are held to it too.
"""

import dataclasses
import functools
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jtf

from repro_torch.configs import get_config, list_archs
from repro_torch.convert import lm_state_dict_from_numpy
from repro_torch.launch.serve import serve_loop
from repro_torch.layers.moe import MoE, no_drops
from repro_torch.models import transformer as ttf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen2-0.5b", "qwen2.5-3b", "phi4-mini-3.8b",
         "granite-moe-3b-a800m", "deepseek-v2-lite-16b"]
#: the JAX package's attention impl per arch (MLA cannot take Pallas)
JAX_ATTN = {arch: "interpret" for arch in ARCHS}
JAX_ATTN["deepseek-v2-lite-16b"] = "blockwise"
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True)
def _interpret_rmsnorm(monkeypatch):
    monkeypatch.setenv("REPRO_RMSNORM_IMPL", "interpret")


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(jax params, port model, cfg pair) with noisy biases and gains."""
    jcfg = jax_get_config(arch).smoke().model_cfg
    tcfg = get_config(arch).smoke().model_cfg
    params = jax.tree.map(np.asarray,
                          jtf.init_params(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(len(arch))
    noisy = [(params, "final_norm", 0.2)]
    for stack_name in ("dense_layers", "moe_layers"):
        stack = params.get(stack_name)
        if stack is None:
            continue
        noisy += [(stack["attn"], name, 0.3) for name in ("bq", "bk", "bv")]
        noisy += [(stack, "norm1", 0.2), (stack, "norm2", 0.2),
                  (stack["attn"], "norm_ckv", 0.2)]
    for owner, name, scale in noisy:
        if name in owner:
            a = owner[name]
            owner[name] = (a + scale * rng.normal(size=a.shape)
                           ).astype(a.dtype)
    model = ttf.Transformer(tcfg, torch.Generator().manual_seed(0))
    model.load_state_dict(lm_state_dict_from_numpy(params, tcfg))
    return jax.tree.map(jnp.asarray, params), model, jcfg, tcfg


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t))


def _jax_stacked_caches(jcaches):
    """The reference's per-stack caches as one [L, ...] stack per key, the
    dense prefix first (the port's ``layers.{i}`` order)."""
    stacks = [jcaches[s] for s in ("dense_layers", "moe_layers")
              if s in jcaches]
    return {k: np.concatenate([np.atleast_1d(np.asarray(st[k]))
                               for st in stacks]) for k in stacks[0]}


@functools.lru_cache(maxsize=None)
def _jax_decode(arch):
    jcfg = _pair(arch)[2]
    return jax.jit(lambda p, c, t, pos: jtf.decode_step(p, c, t, pos, jcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_jax(arch):
    jp, model, jcfg, tcfg = _pair(arch)
    toks = _tokens(tcfg, 2, 32)
    want, want_aux, _ = jtf.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                                    attn_impl=JAX_ATTN[arch])
    with torch.inference_mode():
        got, aux, caches = ttf.forward(model, torch.from_numpy(toks))
        # a dense model's blocks compute no aux: the module returns None
        # and ``forward`` its zero
        assert (model(torch.from_numpy(toks))[1] is None) == (not tcfg.moe)
    assert got.shape == (2, 32, tcfg.vocab) and caches is None
    assert aux.dtype == torch.float32
    if tcfg.moe:
        assert float(aux) > 0.0
    else:
        assert float(aux) == 0.0 == float(want_aux)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_equals_jax(arch):
    """``loss_fn`` = cross entropy + the MoE aux loss, each as the
    reference's."""
    jp, model, jcfg, tcfg = _pair(arch)
    toks, labels = _tokens(tcfg, 2, 16, seed=5), _tokens(tcfg, 2, 16, seed=6)
    want, wparts = jtf.loss_fn(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                                    "labels": jnp.asarray(labels,
                                                          jnp.int32)},
                               jcfg, attn_impl=JAX_ATTN[arch])
    with torch.no_grad():
        got, parts = ttf.loss_fn(model, {"tokens": torch.from_numpy(toks),
                                         "labels": torch.from_numpy(labels)})
    assert torch.equal(got, parts["ce"] + parts["aux"])
    for g, w in ((got, want), (parts["ce"], wparts["ce"]),
                 (parts["aux"], wparts["aux"])):
        np.testing.assert_allclose(float(g), float(w), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_equals_jax(arch):
    jp, model, jcfg, tcfg = _pair(arch)
    toks = _tokens(tcfg, 3, 16, seed=1)
    want = jtf.prefill_step(jp, jnp.asarray(toks, jnp.int32), jcfg,
                            attn_impl=JAX_ATTN[arch])
    got = ttf.prefill_step(model, torch.from_numpy(toks))
    assert got.shape == (3, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_caches_equal_jax(arch):
    jp, model, jcfg, tcfg = _pair(arch)
    b, steps, s_max = 2, 8, 12
    toks = _tokens(tcfg, b, steps, seed=2)
    jcaches = jtf.init_caches(jcfg, b, s_max)
    caches = ttf.init_caches(tcfg, b, s_max, device="cpu")
    for i in range(steps):
        want, jcaches = _jax_decode(arch)(
            jp, jcaches, jnp.asarray(toks[:, i:i + 1], jnp.int32),
            jnp.asarray(i, jnp.int32))
        got, caches = ttf.decode_step(model, caches,
                                      torch.from_numpy(toks[:, i:i + 1]), i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jstack = _jax_stacked_caches(jcaches)
    keys = ("c_kv", "k_rope") if tcfg.attn_kind == "mla" else ("k", "v")
    assert sorted(jstack) == sorted(keys + ("length",))
    for key in keys:
        np.testing.assert_allclose(
            torch.stack([c[key] for c in caches]).numpy(),
            np.asarray(jstack[key]), **TOL)
    assert [c["length"] for c in caches] == \
        np.asarray(jstack["length"]).tolist() == [steps] * tcfg.n_layers
    with pytest.raises(ValueError, match="KV cache full"):
        for i in range(steps, s_max + 1):
            ttf.decode_step(model, caches, torch.from_numpy(toks[:, :1]), i)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_greedy_tokens_equal_jax(arch):
    """The serve loop (prompt 4 token by token, then 8 greedy steps) picks
    the same tokens, and its decode logits after the prompt equal
    prefill_step's on the same prompt. For an MoE model the last check
    runs with no drops (:func:`no_drops`): a decode step of B tokens gets
    ``cap = 1`` at the config's capacity factor, a prefill of B * P
    tokens more, so the two route differently there."""
    jp, model, jcfg, tcfg = _pair(arch)
    b, pl, steps = 2, 4, 8
    prompt = _tokens(tcfg, b, pl, seed=3)

    jcaches = jtf.init_caches(jcfg, b, pl + steps)
    for i in range(pl):
        jlog, jcaches = _jax_decode(arch)(
            jp, jcaches, jnp.asarray(prompt[:, i:i + 1], jnp.int32),
            jnp.asarray(i, jnp.int32))
    want = []
    for i in range(steps):
        tok = jnp.argmax(jlog, axis=-1)[:, None].astype(jnp.int32)
        want.append(np.asarray(tok)[:, 0])
        jlog, jcaches = _jax_decode(arch)(jp, jcaches, tok,
                                          jnp.asarray(pl + i, jnp.int32))

    tp = torch.from_numpy(prompt)
    out = serve_loop(model, tp, steps, pl + steps)
    np.testing.assert_array_equal(out["tokens"].numpy(), np.stack(want, 1))
    with no_drops(model):
        after_prompt = serve_loop(model, tp, 1, pl + 1)["logits"][pl - 1]
        np.testing.assert_allclose(after_prompt.numpy(),
                                   ttf.prefill_step(model, tp).numpy(),
                                   **TOL)
    if not tcfg.moe:
        np.testing.assert_allclose(after_prompt.numpy(),
                                   out["logits"][pl - 1].numpy(), **TOL)
    forced = serve_loop(model, tp, steps, pl + steps, forced=out["tokens"])
    assert torch.equal(forced["logits"], out["logits"])


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_moe_models_differentiate_on_the_cpu(arch):
    """loss_fn's backward reaches every parameter of an MoE model on the
    CPU (the router through the gates and the aux loss), finite."""
    _, model, _, tcfg = _pair(arch)
    toks = torch.from_numpy(_tokens(tcfg, 2, 16, seed=7))
    model.zero_grad()
    loss, _ = ttf.loss_fn(model, {"tokens": toks, "labels": toks})
    loss.backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), \
            name
    assert all(float(m.router.grad.abs().sum()) > 0
               for m in model.modules() if isinstance(m, MoE))
    model.zero_grad(set_to_none=True)


def test_serve_cli_prints_the_reference_line_forms():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    args = ["--smoke", "--batch", "2", "--prompt-len", "4",
            "--decode-steps", "6"]
    forms = [r"prefill 4 \+ decode 6 x batch 2: \d+\.\d\ds \(\d+ tok/s\)",
             r"sample: \[(\d+, ){5}\d+\]"]

    def lines(cmd):
        out = subprocess.run([sys.executable, "-m", *cmd, *args], env=env,
                             capture_output=True, text=True, timeout=120,
                             check=True).stdout.splitlines()
        assert len(out) == 2, out
        for line, form in zip(out, forms):
            assert re.fullmatch(form, line), (line, form)
        return out

    lines(["repro.launch.serve"])
    lines(["repro_torch.launch.serve", "--device", "cpu"])


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for full in (True, False):
        jspec, tspec = jax_get_config(arch), get_config(arch)
        if not full:
            jspec, tspec = jspec.smoke(), tspec.smoke()
        assert (tspec.name, tspec.family, tspec.source) == \
            (jspec.name, jspec.family, jspec.source)
        jd = dataclasses.asdict(jspec.model_cfg)
        td = dataclasses.asdict(tspec.model_cfg)
        assert jd.keys() == td.keys()
        for key in jd:
            if key == "dtype":
                assert str(td[key]).removeprefix("torch.") == \
                    jnp.dtype(jd[key]).name
            else:
                assert td[key] == jd[key], key
        assert tspec.model_cfg.n_params == jspec.model_cfg.n_params
    assert get_config("qwen2-0.5b").model_cfg.n_params == 494_005_120
    assert get_config("granite-moe-3b-a800m").model_cfg.n_params == \
        3_298_793_472
    assert get_config("deepseek-v2-lite-16b").model_cfg.n_params == \
        15_706_470_400


def test_unported_archs_and_configs_raise():
    """Every assigned architecture is ported: BST (a recsys config) and the
    four GNNs too, and ``benu`` (the dry-run's BENU cells) returns its
    spec with the reference's shapes. The MoE and MLA models train with no
    guard left: the training CLI runs them, at a cut depth with
    ``--layers``."""
    gnns = ["gin-tu", "pna", "egnn", "meshgraphnet"]
    assert sorted(list_archs()) == sorted(ARCHS + ["bst"] + gnns + ["benu"])
    assert get_config("bst").family == "recsys"
    for arch in gnns:
        assert get_config(arch).family == "gnn"
    from repro.configs import get_config as jget_config
    benu, jbenu = get_config("benu"), jget_config("benu")
    assert benu.family == "benu"
    assert {k: (s.kind, s.dims) for k, s in benu.shapes.items()} == \
        {k: (s.kind, s.dims) for k, s in jbenu.shapes.items()}
    assert not hasattr(ttf, "check_trainable")
    from repro_torch.launch.train import main
    for arch in ("granite-moe-3b-a800m", "deepseek-v2-lite-16b"):
        hist = main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--steps", "2", "--seq", "8", "--batch", "2",
                     "--layers", "2"])
        assert len(hist["loss"]) == 2
        assert all(np.isfinite(x) for x in hist["loss"])
        assert hist["final_state"]["params"].cfg.n_layers == 2
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("nope")


def test_serve_entry_points_without_a_device_raise_when_no_card(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-0.5b").smoke().model_cfg
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.init_caches(cfg, 1, 8)
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--smoke"])
    assert ttf.init_params(cfg, device="cpu").embed.device.type == "cpu"
