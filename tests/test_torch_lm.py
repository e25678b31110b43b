"""The port's LM serving path against the JAX package, on CPU.

For each dense GQA smoke config (qwen2, qwen2.5, phi4-mini; f32), the
JAX package's init is carried across (``lm_state_dict_from_numpy``)
after seeded noise is added to the QKV biases and norm gains (JAX
initialises them to 0 and 1, so a dropped bias or gain would otherwise
pass). The JAX side runs its Pallas kernels in interpret mode
(``attn_impl="interpret"``, ``REPRO_RMSNORM_IMPL=interpret``); the port
runs its plain versions. Tolerance 2e-4, as tests/test_models.py holds
decode against the full forward; greedy tokens must be equal.
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
from repro_torch.models import transformer as ttf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["qwen2-0.5b", "qwen2.5-3b", "phi4-mini-3.8b"]
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
    stack = params["dense_layers"]
    for name in ("bq", "bk", "bv"):
        if name in stack["attn"]:
            a = stack["attn"][name]
            stack["attn"][name] = (a + 0.3 * rng.normal(size=a.shape)
                                   ).astype(a.dtype)
    for owner, name in ((stack, "norm1"), (stack, "norm2"),
                        (params, "final_norm")):
        a = owner[name]
        owner[name] = (a + 0.2 * rng.normal(size=a.shape)).astype(a.dtype)
    model = ttf.Transformer(tcfg, torch.Generator().manual_seed(0))
    model.load_state_dict(lm_state_dict_from_numpy(params, tcfg))
    return jax.tree.map(jnp.asarray, params), model, jcfg, tcfg


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t))


@functools.lru_cache(maxsize=None)
def _jax_decode(arch):
    jcfg = _pair(arch)[2]
    return jax.jit(lambda p, c, t, pos: jtf.decode_step(p, c, t, pos, jcfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_jax(arch):
    jp, model, jcfg, tcfg = _pair(arch)
    toks = _tokens(tcfg, 2, 32)
    want, _, _ = jtf.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                             attn_impl="interpret")
    with torch.inference_mode():
        got, aux, caches = ttf.forward(model, torch.from_numpy(toks))
    assert got.shape == (2, 32, tcfg.vocab) and caches is None
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_equals_jax(arch):
    jp, model, jcfg, tcfg = _pair(arch)
    toks = _tokens(tcfg, 3, 16, seed=1)
    want = jtf.prefill_step(jp, jnp.asarray(toks, jnp.int32), jcfg,
                            attn_impl="interpret")
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
    jstack = jcaches["dense_layers"]
    for key in ("k", "v"):
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
    prefill_step's on the same prompt."""
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
    np.testing.assert_allclose(out["logits"][pl - 1].numpy(),
                               ttf.prefill_step(model, tp).numpy(), **TOL)
    np.testing.assert_array_equal(out["tokens"].numpy(), np.stack(want, 1))
    forced = serve_loop(model, tp, steps, pl + steps, forced=out["tokens"])
    assert torch.equal(forced["logits"], out["logits"])


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


def test_unported_archs_and_configs_raise():
    assert sorted(list_archs()) == sorted(ARCHS)
    for arch in ("granite-moe-3b-a800m", "deepseek-v2-lite-16b", "bst"):
        with pytest.raises(NotImplementedError, match="slice"):
            get_config(arch)
    cfg = dataclasses.replace(get_config("qwen2-0.5b").smoke().model_cfg,
                              moe=True)
    with pytest.raises(NotImplementedError, match="MoE/MLA slice"):
        ttf.Transformer(cfg, torch.Generator())
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
