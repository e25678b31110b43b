"""The port's GNN family against the JAX package, on CPU.

The JAX package's ``init_gnn_params`` (with seeded noise on the
LayerNorm gains and biases, the MLP biases and GIN's ``eps``, which it
initialises to 1 and 0) is carried across by
``gnn_state_dict_from_numpy``; the port's message-passing primitives,
``gnn_forward``, ``gnn_loss`` with every gradient and one AdamW step must
equal ``repro.models.gnn`` on each smoke config, padded edges and masked
nodes included. Tolerances, f32: outputs and losses ``rtol 1e-5, atol
1e-5``; gradients ``rtol 1e-4`` with ``atol 1e-5 x max|g|`` of the
tensor. PNA's f32 results are held at ``atol 1e-4 x max|out|`` and
``1e-3 x max|g|``: its std's ``sqrt(var + 1e-8)`` meets ``var = sq -
mean^2 ~ 0`` and scales the rounding of that difference by up to 5,000,
so on these batches each side's f32 gradients are themselves up to
3.6e-4 x max|g| from the same code in f64 (its outputs 3.8e-5 x
max|out|). PNA is therefore also held in f64 (``jax.enable_x64``), where
only the f32 cross entropy rounds: gradients at ``1e-5 x max|g|``. The
config layout, the train CLI's ``gnn`` branch, ``enumerate_graph``,
``edge_index_from_graph``, ``toy_graph_fig1`` and the motif-feature
example are held to the reference too.
"""

import dataclasses
import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.graph.batch import synthetic_full_graph as jax_full_graph
from repro.graph.batch import synthetic_mesh as jax_mesh
from repro.graph.batch import synthetic_molecules as jax_molecules
from repro.models import gnn as jgnn
from repro.train import optimizer as jopt

from repro_torch.configs import get_config
from repro_torch.convert import gnn_state_dict_from_numpy
from repro_torch.models import gnn as tgnn
from repro_torch.train import optimizer as topt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("gin-tu", "pna", "egnn", "meshgraphnet")
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 1e-4
GRAD_ATOL = {"gin": 1e-5, "pna": 1e-3, "egnn": 1e-5, "mgn": 1e-5}
OUT_ATOL = {"pna": 1e-4}          # x max|out|; else TOL
OPT = dict(lr=1e-2, warmup_steps=1, decay_steps=50, weight_decay=0.1)
# the reference's n_params per shape (repro.models.gnn.GNNConfig.n_params)
N_PARAMS = {
    "gin-tu": (142_796, 91_822, 60_084, 51_783),
    "pna": (457_582, 397_841, 360_647, 350_927),
    "egnn": (217_035, 166_061, 134_323, 126_022),
    "meshgraphnet": (1_969_795, 1_863_427, 1_799_171, 1_788_419),
}
SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the test files run in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, shape="full", f64=False):
    """(JAX config, port config) of ``arch``'s smoke spec at ``shape``."""
    jcfg = jax_get_config(arch).smoke().model_cfg_for(shape)
    tcfg = get_config(arch).smoke().model_cfg_for(shape)
    if f64:
        jcfg = dataclasses.replace(jcfg, dtype=jnp.float64)
        tcfg = dataclasses.replace(tcfg, dtype=torch.float64)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_params(arch, shape="full", f64=False):
    jcfg, _ = _cfgs(arch, shape)
    params = _np(jgnn.init_gnn_params(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(5)

    def noisy(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                noisy(v)
            elif not k.startswith("w"):
                tree[k] = (v + 0.2 * rng.normal(size=v.shape)).astype(v.dtype)

    noisy(params)
    if f64:
        params = jax.tree.map(lambda a: a.astype(np.float64), params)
    return params


@functools.lru_cache(maxsize=None)
def _batch(arch, shape="full", in_degree_one=False):
    """The smoke batch of ``arch`` at ``shape`` as numpy: 64 nodes and 256
    edges (``mol``: 8 molecules of 10 nodes), the last 16 edges padded
    with ``n``, three nodes masked out of the encoder and two out of the
    loss. ``in_degree_one``: nodes 56..63 each receive exactly one edge."""
    jcfg, _ = _cfgs(arch, shape)
    if shape == "mol":
        b = jax_molecules(8, 10, 20, jcfg.d_feat, jcfg.n_out,
                          seed=6).as_arrays()
    elif jcfg.task == "node_reg":
        b = jax_mesh(64, 256, jcfg.d_feat, jcfg.d_edge, seed=6).as_arrays()
    else:
        b = jax_full_graph(64, 128, jcfg.d_feat, jcfg.n_out,
                           seed=6).as_arrays()
    b = {k: np.array(v) for k, v in b.items()}
    n = b["x"].shape[0]
    if in_degree_one:
        rng = np.random.default_rng(7)
        s_, t_ = rng.integers(0, 56, (2, 112))
        b["edge_src"] = np.concatenate([s_, t_, np.arange(8),
                                        np.full(16, n)]).astype(np.int32)
        b["edge_dst"] = np.concatenate([t_, s_, np.arange(56, 64),
                                        np.full(16, n)]).astype(np.int32)
    b["edge_src"][-16:] = n
    b["edge_dst"][-16:] = n
    b["node_mask"][[3, 9, 11]] = False
    b["loss_mask"][[1, 4]] = False
    return b


def _model(arch, shape="full", f64=False):
    _, tcfg = _cfgs(arch, shape, f64)
    model = tgnn.GNN(tcfg, torch.Generator().manual_seed(0))
    model.load_state_dict(gnn_state_dict_from_numpy(
        _jax_params(arch, shape, f64), tcfg))
    return model


def _tb(b, f64=False):
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    if f64:
        out["x"] = out["x"].double()
    return out


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(arch, shape="full", in_degree_one=False, f64=False):
    jcfg, _ = _cfgs(arch, shape, f64)
    b = _batch(arch, shape, in_degree_one)

    def run():
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        if f64:
            jb["x"] = jb["x"].astype(jnp.float64)
        params = jax.tree.map(jnp.asarray, _jax_params(arch, shape, f64))
        out = jgnn.gnn_forward(params, jb, jcfg)
        (loss, aux), grads = jax.value_and_grad(
            lambda p: jgnn.gnn_loss(p, jb, jcfg), has_aux=True)(params)
        return np.asarray(out), _np(aux), _np(grads)

    if f64:
        with jax.enable_x64(True):
            return run()
    return run()


def _grads(model):
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters()}


def _assert_grads(got, want_tree, tcfg, atol_frac):
    want = gnn_state_dict_from_numpy(want_tree, tcfg)
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = want[name].double().numpy()
        np.testing.assert_allclose(
            g.double().numpy(), w, rtol=GRAD_RTOL,
            atol=atol_frac * max(float(np.abs(w).max()), 1e-30),
            err_msg=name)


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------


def _primitive_inputs():
    """n = 10 nodes; 40 edges with padded entries (n), an out-of-range
    and a negative index (clipped, as the reference clips), empty
    segments (8, 9 get nothing) and exact ties in every segment."""
    rng = np.random.default_rng(1)
    n = 10
    idx = rng.integers(0, 8, 40).astype(np.int32)
    idx[[3, 17, 30]] = n
    idx[5], idx[6] = n + 4, -2
    h = rng.normal(size=(n, 5)).astype(np.float32)
    msg = rng.normal(size=(40, 5)).astype(np.float32)
    msg[20:30] = np.round(msg[20:30])          # ties inside segments
    msg[31] = msg[32] = 2.5
    emask = rng.random(40) < 0.8
    return n, idx, h, msg, emask


@pytest.mark.parametrize("sorted_idx", [False, True])
@pytest.mark.parametrize("prim", ["gather_src", "scatter_sum", "scatter_max",
                                  "scatter_min", "in_degree"])
def test_primitive_and_its_gradient_equal_jax(prim, sorted_idx):
    n, idx, h, msg, emask = _primitive_inputs()
    if sorted_idx:
        perm = np.argsort(np.clip(idx, 0, n), kind="stable")
        idx, msg, emask = idx[perm], msg[perm], emask[perm]
    x = h if prim == "gather_src" else msg
    cot_shape = (40, 5) if prim == "gather_src" else \
        ((n,) if prim == "in_degree" else (n, 5))
    cot = np.random.default_rng(2).normal(size=cot_shape).astype(np.float32)
    jf = {"gather_src": lambda a: jgnn.gather_src(a, jnp.asarray(idx), n),
          "scatter_sum": lambda a: jgnn.scatter_sum(a, jnp.asarray(idx), n),
          "scatter_max": lambda a: jgnn.scatter_max(a, jnp.asarray(idx), n),
          "scatter_min": lambda a: jgnn.scatter_min(a, jnp.asarray(idx), n),
          "in_degree": lambda a: jgnn.in_degree(jnp.asarray(idx), n,
                                                jnp.asarray(emask))}[prim]
    want, vjp = jax.vjp(jf, jnp.asarray(x))
    seg = tgnn.Segments(torch.from_numpy(idx), n, presorted=sorted_idx) \
        if sorted_idx else torch.from_numpy(idx)
    tx = torch.from_numpy(x).requires_grad_()
    tf = {"gather_src": lambda a: tgnn.gather_src(a, seg, n),
          "scatter_sum": lambda a: tgnn.scatter_sum(a, seg, n),
          "scatter_max": lambda a: tgnn.scatter_max(a, seg, n),
          "scatter_min": lambda a: tgnn.scatter_min(a, seg, n),
          "in_degree": lambda a: tgnn.in_degree(seg, n,
                                                torch.from_numpy(emask))}[prim]
    got = tf(tx)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    if prim == "in_degree":
        return
    got.backward(torch.from_numpy(cot))
    (want_g,) = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g), **TOL)
    if prim in ("scatter_max", "scatter_min"):
        # the ties are there, and the empty segments are 0
        assert np.all(np.asarray(want)[8:] == 0)
        share = tx.grad.numpy()[np.clip(idx, 0, n) < n]
        assert np.any((share != 0) & (np.abs(share) < np.abs(cot).max()))


def test_graph_index_sorts_once_and_drops_edges_into_n():
    src = torch.tensor([2, 0, 5, 1, 1, 5, 3])
    dst = torch.tensor([1, 5, 0, 1, 3, 5, 0])
    ix = tgnn.graph_index(src, dst, 5)
    assert ix.keep.tolist() == [2, 6, 0, 3, 4]
    assert ix.dst.idx.tolist() == [0, 0, 1, 1, 3]
    assert ix.dst.ptr.tolist() == [0, 2, 4, 4, 5, 5]
    assert ix.src.idx.tolist() == [5, 3, 2, 1, 1]
    assert ix.emask.tolist() == [False, True, True, True, True]
    assert ix.src.order.tolist() == [3, 4, 2, 1, 0] and ix.src.n_valid == 4


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape,in_degree_one", [
    ("gin-tu", "full", False), ("gin-tu", "mol", False),
    ("pna", "full", False), ("pna", "full", True),
    ("egnn", "full", False), ("meshgraphnet", "full", False)])
def test_forward_loss_and_every_gradient_equal_jax(arch, shape,
                                                   in_degree_one):
    want_out, want_aux, want_grads = _jax_loss_and_grads(arch, shape,
                                                         in_degree_one)
    model = _model(arch, shape)
    b = _tb(_batch(arch, shape, in_degree_one))
    _, tcfg = _cfgs(arch, shape)
    with torch.no_grad():
        out = tgnn.gnn_forward(model, b)
    tol = dict(TOL, atol=OUT_ATOL[tcfg.kind] * np.abs(want_out).max()) \
        if tcfg.kind in OUT_ATOL else TOL
    np.testing.assert_allclose(out.numpy(), want_out, **tol)
    loss, aux = tgnn.gnn_loss(model, b)
    loss.backward()
    for k, v in want_aux.items():
        np.testing.assert_allclose(float(aux[k].detach()), float(v), **TOL)
    _assert_grads(_grads(model), want_grads, tcfg, GRAD_ATOL[tcfg.kind])
    if shape == "mol":
        assert out.shape == (8, tcfg.n_out)
    if in_degree_one:
        deg = tgnn.in_degree(b["edge_dst"], 64, b["edge_src"] < 64)
        assert torch.all(deg[56:] == 1)


@pytest.mark.parametrize("in_degree_one", [False, True])
def test_pna_gradients_equal_jax_in_f64(in_degree_one):
    """In f64 both sides are exact but for the f32 cross entropy, and PNA
    is held tightly, nodes of in-degree 1 included: there ``sq - mean^2``
    is exactly 0, the tie of ``maximum(., 0)``. (Its 1/2 : 1/2 split
    multiplies ``d(sq - mean^2)/dm``, which is 0 at such a tie, so
    ``clamp`` would pass too.)"""
    _, _, want_grads = _jax_loss_and_grads("pna", "full", in_degree_one,
                                           f64=True)
    model = _model("pna", f64=True)
    loss, _ = tgnn.gnn_loss(model, _tb(_batch("pna", "full", in_degree_one),
                                       f64=True))
    loss.backward()
    _, tcfg = _cfgs("pna", f64=True)
    _assert_grads(_grads(model), want_grads, tcfg, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch):
    b = _tb(_batch(arch))
    runs = []
    for remat in (False, True):
        model = _model(arch)
        model.cfg = dataclasses.replace(model.cfg, remat=remat)
        loss, _ = tgnn.gnn_loss(model, b)
        loss.backward()
        runs.append((loss.detach(), _grads(model)))
    assert torch.equal(runs[0][0], runs[1][0])
    for name, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_one_adamw_step_equals_jax(arch):
    """One AdamW step on the reference's gradients from a fresh state: the
    decay mask follows the reference's stacked leaves (each layer's
    LayerNorm gains and MLP biases are decayed, ``eps`` and the encoder's
    and decoder's biases are not)."""
    params = _jax_params(arch)
    jcfg, tcfg = _cfgs(arch)
    _, _, jgrads = _jax_loss_and_grads(arch)
    jp = jax.tree.map(jnp.asarray, params)
    want_p, want_s, want_m = jopt.adamw_update(
        jopt.AdamWConfig(**OPT), jax.tree.map(jnp.asarray, jgrads),
        jopt.adamw_init(jp), jp)
    tparams = gnn_state_dict_from_numpy(params, tcfg)
    mask = tgnn.gnn_decay_mask(tparams)
    tower = next(iter(tgnn.layer_towers(tcfg)))
    assert mask[f"layers.1.{tower}.b0"] and mask[f"layers.0.{tower}.w0"]
    assert not mask["enc.b0"] and not mask["dec.b1"] and mask["dec.w0"]
    if arch == "gin-tu":
        assert mask["layers.0.ln.g"] and not mask["layers.1.eps"]
    got_p, got_s, got_m = topt.adamw_update(
        topt.AdamWConfig(**OPT), gnn_state_dict_from_numpy(jgrads, tcfg),
        topt.adamw_init(tparams), tparams, mask)
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=1e-5)
    for got, want in ((got_p, want_p), (got_s.m, want_s.m),
                      (got_s.v, want_s.v)):
        want = gnn_state_dict_from_numpy(_np(want), tcfg)
        for name, t in got.items():
            np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    assert int(got_s.step) == int(want_s.step) == 1


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_layout_and_sizes_equal_jax(arch):
    spec, jspec = get_config(arch), jax_get_config(arch)
    assert spec.family == jspec.family == "gnn"
    assert tuple(spec.shapes) == tuple(jspec.shapes) == SHAPES
    for shape, want in zip(SHAPES, N_PARAMS[arch]):
        cfg, jcfg = spec.model_cfg_for(shape), jspec.model_cfg_for(shape)
        assert cfg.n_params == jcfg.n_params == want, shape
        assert spec.shapes[shape].dims == jspec.shapes[shape].dims
        assert spec.shapes[shape].kind == jspec.shapes[shape].kind
        for f in ("kind", "n_layers", "d_hidden", "d_feat", "n_out", "task",
                  "d_edge", "remat"):
            assert getattr(cfg, f) == getattr(jcfg, f), f
    for sshape in jspec.smoke().shapes:
        cfg = spec.smoke().model_cfg_for(sshape)
        model = tgnn.init_gnn_params(cfg, seed=0, device="cpu")
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        want = {k: tuple(v.shape) for k, v in gnn_state_dict_from_numpy(
            _np(jgnn.init_gnn_params(jax.random.PRNGKey(0),
                                     jspec.smoke().model_cfg_for(sshape))),
            cfg).items()}
        assert got == want
        assert sum(p.numel() for p in model.parameters()) == cfg.n_params


# --------------------------------------------------------------------------
# the CLI, enumerate_graph, the graph helpers and the motif example
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_gnn_branch_lowers_the_loss(arch, capsys):
    from repro_torch.launch.train import main
    hist = main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                 "20"])
    out = capsys.readouterr().out
    assert "final loss:" in out
    assert hist["loss"][-1] < hist["loss"][0]


def test_graph_helpers_equal_reference():
    from repro.graph.generate import powerlaw as jax_powerlaw
    from repro.graph.generate import toy_graph_fig1 as jax_toy
    from repro.graph.storage import edge_index_from_graph as jax_edges
    from repro_torch.graph.generate import powerlaw, toy_graph_fig1
    from repro_torch.graph.storage import edge_index_from_graph
    for mine, ref in ((toy_graph_fig1(), jax_toy()),
                      (powerlaw(300, 4, seed=7), jax_powerlaw(300, 4,
                                                              seed=7))):
        got, want = edge_index_from_graph(mine), jax_edges(ref)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert (mine.n, mine.m) == (ref.n, ref.m)


def _jax_counts(g):
    from repro.core.engine_jax import enumerate_graph as jax_enumerate
    from repro.core.pattern import get_pattern as jax_pattern
    from repro.core.plangen import generate_best_plan as jax_plan
    feats = np.zeros((g.n, 2), np.float32)
    results = []
    for j, pname in enumerate(("triangle", "square")):
        res = jax_enumerate(jax_plan(jax_pattern(pname), g.stats()), g,
                            batch=64, collect_matches=True)
        for match in res["matches"]:
            for v in match:
                feats[v, j] += 1.0
        results.append(res)
    return feats, results


def test_enumerate_graph_equals_jax():
    from repro.graph.generate import powerlaw as jax_powerlaw
    from repro_torch.core.engine_torch import enumerate_graph
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.plangen import generate_best_plan
    from repro_torch.graph.generate import powerlaw
    g = powerlaw(300, 4, seed=7)
    _, want = _jax_counts(jax_powerlaw(300, 4, seed=7))
    for pname, w in zip(("triangle", "square"), want):
        plan = generate_best_plan(get_pattern(pname), g.stats())
        got = enumerate_graph(plan, g, batch=64, collect_matches=True,
                              device="cpu")
        assert got["count"] == w["count"] > 0
        assert (got["chunks_retried"], got["chunks_split"]) == \
            (w["chunks_retried"], w["chunks_split"])
        assert sorted(map(tuple, got["matches"].tolist())) == \
            sorted(map(tuple, np.asarray(w["matches"]).tolist()))
        assert enumerate_graph(plan, g, batch=64, device="cpu").keys() == \
            {"count", "chunks_retried", "chunks_split"}


def test_motif_example_counts_equal_jax_and_its_loss_falls(capsys):
    from repro.graph.generate import powerlaw as jax_powerlaw
    spec = importlib.util.spec_from_file_location(
        "motif_features_torch",
        os.path.join(ROOT, "examples", "motif_features_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    counts, hist = mod.main(["--device", "cpu"])
    want, _ = _jax_counts(jax_powerlaw(300, 4, seed=7))
    np.testing.assert_array_equal(counts, want)
    assert counts.sum() > 0
    assert hist["loss"][-1] < hist["loss"][0]
    out = capsys.readouterr().out
    assert (f"triangles total={int(want[:, 0].sum())}, squares "
            f"total={int(want[:, 1].sum())}") in out


def test_gnn_modules_import_neither_jax_nor_repro():
    example = os.path.join(ROOT, "examples", "motif_features_torch.py")
    code = (
        "import importlib, runpy, sys\n"
        "for m in ('repro_torch.models.gnn', 'repro_torch.models.gnn_dist',"
        " 'repro_torch.configs.gin_tu', 'repro_torch.configs.pna',"
        " 'repro_torch.configs.egnn', 'repro_torch.configs.meshgraphnet',"
        " 'repro_torch.launch.train'):\n"
        "    importlib.import_module(m)\n"
        f"runpy.run_path({example!r}, run_name='x')\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
