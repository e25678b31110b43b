"""The port's dry-run registry and layouts against the JAX package's.

``repro_torch.configs`` (cells, shapes, input specs, per-shape configs,
BENU's config) and ``repro_torch.launch.shardings`` (every parameter's,
optimizer state's, cache's and batch's spec, rank 0's shard and the
per-device argument bytes) against ``repro.configs`` and
``repro.launch.shardings`` at both production meshes. The reference's
side takes its parameter shapes from ``jax.eval_shape`` and its mesh as a
``jax.sharding.AbstractMesh`` (no devices); the port's from fake tensors.
Specs are compared exactly; shapes and bytes exactly.

The reference stacks each block's leaves into one ``[L, ...]`` leaf; the
port keeps a tensor per layer (``convert.py``'s names). Where the
reference's spec leaves the stack dim unsharded, the port's spec of each
layer is the rest of it. Where ``sanitize`` or the ZeRO-1 rule puts an
axis on the stack dim itself, the port puts the same axes on another dim:
those leaves are held to the same axes, and every mesh to the same
per-device bytes.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import all_cells as jall_cells
from repro.configs import get_config as jget_config
from repro.launch import shardings as jsh
from repro_torch.configs import ASSIGNED, all_cells, get_config, list_archs
from repro_torch.launch import shardings as sh

DTYPES = {jnp.float32: torch.float32, jnp.int32: torch.int32,
          jnp.bool_: torch.bool, jnp.bfloat16: torch.bfloat16}
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}
LMS = [a for a in ASSIGNED if get_config(a).family == "lm"]
GNNS = [a for a in ASSIGNED if get_config(a).family == "gnn"]


def _dtype(jdt) -> torch.dtype:
    return DTYPES[jnp.dtype(jdt).type]


def _mesh(multi_pod):
    shape, axes = MESHES[multi_pod]
    return AbstractMesh(shape, axes), dict(zip(axes, shape))


def _flat(tree):
    """``{dotted name: leaf}`` of a reference pytree."""
    return {".".join(jsh._key_names(p)): leaf for p, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def _port_names(ref_name: str, n_dense: int, n_layers: int):
    """The port's state_dict keys of a reference leaf, and whether the
    leaf is a layer stack (``convert.lm_state_dict_from_numpy``'s map)."""
    head, _, rest = ref_name.partition(".")
    if head in ("dense_layers", "moe_layers"):
        rest = {"norm1": "norm1.weight", "norm2": "norm2.weight"}.get(rest,
                                                                     rest)
        layers = range(n_dense) if head == "dense_layers" \
            else range(n_dense, n_layers)
        return [f"layers.{i}.{rest}" for i in layers], True
    if head in ("blocks", "layers"):                 # BST, GNN stacks
        n = n_layers
        return [f"{head}.{i}.{rest}" for i in range(n)], True
    return [{"final_norm": "final_norm.weight"}.get(ref_name, ref_name)], False


def _norm(spec):
    """A spec with each one-axis tuple written as the axis (``P`` writes
    ``("data",)`` as ``"data"``; both name the same layout)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _local(shape, spec, ms):
    return sh.local_shape(tuple(shape), tuple(spec), ms)


def _axes(spec):
    return sorted(a for e in spec if e is not None
                  for a in ((e,) if isinstance(e, str) else e))


def _nbytes(shape, dtype_bytes):
    return math.prod(shape) * dtype_bytes


def _check_tree(ref_specs, ref_shapes, port_specs, port_shapes, ms,
                n_dense, n_layers, elem):
    """Every reference leaf's spec against its port tensors' (see the
    module's docstring); returns the per-device bytes of both sides."""
    jflat, sflat = _flat(ref_specs), _flat(ref_shapes)
    ref_bytes = port_bytes = 0
    seen = set()
    for name, jspec in jflat.items():
        jspec = _norm(jspec)
        jshape = sflat[name].shape
        jlocal = _local(jshape, jspec, ms)
        ref_bytes += _nbytes(jlocal, elem(name))
        names, stacked = _port_names(name, n_dense, n_layers)
        for pname in names:
            assert pname in port_specs, (name, pname)
            seen.add(pname)
            pspec = _norm(port_specs[pname])
            pshape = tuple(port_shapes[pname].shape)
            plocal = _local(pshape, pspec, ms)
            port_bytes += _nbytes(plocal, elem(name))
            if not stacked:
                assert pspec == jspec, name
                assert plocal == jlocal, name
            elif len(jspec) and jspec[0] is None:
                assert pspec == jspec[1:], (name, pspec, jspec)
                assert plocal == jlocal[1:], name
            else:                       # an axis on the stack dim
                assert _axes(pspec) == _axes(jspec), (name, pspec, jspec)
    assert seen == set(port_specs), set(port_specs) - seen
    return ref_bytes, port_bytes


# --------------------------------------------------------------------------
# The registry
# --------------------------------------------------------------------------


def test_cells_equal_the_reference():
    """``all_cells`` with and without BENU, ``list_archs`` and
    ``ASSIGNED`` equal the reference's, list for list."""
    from repro.configs import ASSIGNED as JASSIGNED
    from repro.configs import list_archs as jlist_archs
    assert all_cells(include_benu=True) == jall_cells(include_benu=True)
    assert all_cells() == jall_cells()
    assert len(all_cells(include_benu=True)) == 42 and len(all_cells()) == 40
    assert list_archs() == jlist_archs() and ASSIGNED == JASSIGNED
    assert list_archs(include_benu=False) == jlist_archs(include_benu=False)


def _cfg_fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name == "dtype":
            v = str(v).replace("torch.", "").replace("<class 'jax.numpy.",
                                                     "").rstrip("'>")
        out[f.name] = v
    return out


@pytest.mark.parametrize("arch,shape", jall_cells(include_benu=True))
def test_cell_shapes_inputs_and_configs(arch, shape):
    """Kind, dims, every input's name, shape and dtype, and the per-shape
    config equal the reference's (the port's GNNConfig leaves out
    ``shard_nodes`` and ``mlp_layers``, which the reference's layout
    reads and nothing else)."""
    spec, jspec = get_config(arch), jget_config(arch)
    sp, jsp = spec.shapes[shape], jspec.shapes[shape]
    assert (sp.name, sp.kind, sp.dims) == (jsp.name, jsp.kind, jsp.dims)
    got, want = spec.input_specs(shape), jspec.input_specs(shape)
    assert list(got) == list(want)
    for k, t in got.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == want[k].shape, k
        assert t.dtype == _dtype(want[k].dtype), k
    cfg, jcfg = _cfg_fields(spec.model_cfg_for(shape)), \
        _cfg_fields(jspec.model_cfg_for(shape))
    for k in set(jcfg) - set(cfg):
        assert k in ("shard_nodes", "mlp_layers"), k
    assert {k: v for k, v in jcfg.items() if k in cfg} == cfg
    assert (spec.family, spec.source, spec.applicability) == \
        (jspec.family, jspec.source, jspec.applicability)


def test_benu_config_and_smoke_equal_the_reference():
    from repro.configs.benu import BenuEnumConfig as JCfg
    from repro_torch.configs.benu import BenuEnumConfig
    for cfg, jcfg in ((BenuEnumConfig(), JCfg()),
                      (get_config("benu").smoke().model_cfg,
                       jget_config("benu").smoke().model_cfg)):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for s, js in zip(get_config("benu").smoke().shapes.values(),
                     jget_config("benu").smoke().shapes.values()):
        assert (s.kind, s.dims) == (js.kind, js.dims)


# --------------------------------------------------------------------------
# Parameter, optimizer, cache and batch layouts
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lm_shapes(arch):
    from repro.models.transformer import init_params as jinit
    from repro_torch.models.transformer import init_params
    cfg, jcfg = get_config(arch).model_cfg, jget_config(arch).model_cfg
    jshapes = jax.eval_shape(functools.partial(jinit, cfg=jcfg),
                             jax.random.PRNGKey(0))
    with FakeTensorMode():
        model = init_params(cfg, device="cpu")
        shapes = {k: torch.empty(p.shape, dtype=p.dtype, device="meta")
                  for k, p in model.named_parameters()}
    return cfg, jshapes, shapes


def _elem_of(jshapes):
    flat = _flat(jshapes)
    return lambda name: jnp.dtype(flat[name].dtype).itemsize


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("mode", ["fsdp", "zero1", "fsdp2d"])
@pytest.mark.parametrize("arch", LMS)
def test_lm_param_and_opt_specs(arch, mode, multi_pod):
    """Each LM parameter's spec and rank 0's shard, per sharding mode, at
    both production meshes, equal the reference's (module docstring);
    the optimizer state's too; the per-device bytes of both equal."""
    from repro.train.optimizer import adamw_init
    cfg, jshapes, shapes = _lm_shapes(arch)
    jmesh, ms = _mesh(multi_pod)
    if mode == "zero1":
        jp, p = jsh.zero1_param_specs(jshapes), sh.zero1_param_specs(shapes)
    elif mode == "fsdp2d":
        jp = jsh.fsdp2d_param_specs(jshapes, jmesh, multi_pod)
        p = sh.fsdp2d_param_specs(shapes, ms, multi_pod)
    else:
        jp, p = jsh.lm_param_specs(jshapes), sh.lm_param_specs(shapes)
    jp_s, p_s = jsh.sanitize(jp, jshapes, jmesh), sh.sanitize(p, shapes, ms)
    n_dense = cfg.first_dense_layers if cfg.moe else cfg.n_layers
    elem = _elem_of(jshapes)
    rb, pb = _check_tree(jp_s, jshapes, p_s, shapes, ms, n_dense,
                         cfg.n_layers, elem)
    assert rb == pb
    if mode == "zero1":
        jo = jsh.zero1_opt_specs(jp, jshapes, jmesh).m
        o = sh.zero1_opt_specs(p, shapes, ms)["m"]
    else:
        jo, o = jsh.opt_state_specs(jp).m, sh.opt_state_specs(p)["m"]
    jo_s, o_s = jsh.sanitize(jo, jshapes, jmesh), sh.sanitize(o, shapes, ms)
    joshapes = jax.eval_shape(adamw_init, jshapes).m
    rb, pb = _check_tree(jo_s, joshapes, o_s, shapes, ms, n_dense,
                         cfg.n_layers, lambda n: 4)
    assert rb == pb


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", LMS)
def test_cache_specs(arch, shape, multi_pod):
    """KV caches: each layer's spec is the reference's stacked spec
    without its stack dim; rank 0's shard and the bytes equal."""
    from repro.models.transformer import init_caches as jinit_caches
    from repro_torch.models.transformer import init_caches
    cfg, jcfg = get_config(arch).model_cfg, jget_config(arch).model_cfg
    d = get_config(arch).shapes[shape].dims
    long_ctx = shape == "long_500k"
    jmesh, ms = _mesh(multi_pod)
    jc = jax.eval_shape(functools.partial(jinit_caches, jcfg, d["batch"],
                                          d["seq"]))
    jspecs = jsh.sanitize(jsh.cache_specs(jc, multi_pod, long_ctx), jc,
                          jmesh)
    caches = init_caches(cfg, d["batch"], d["seq"], device="meta")
    specs = sh.cache_specs(caches, multi_pod, long_ctx)
    n_dense = cfg.first_dense_layers if cfg.moe else cfg.n_layers
    ref_bytes = port_bytes = 0
    for stack, layers in (("dense_layers", range(n_dense)),
                          ("moe_layers", range(n_dense, cfg.n_layers))):
        for leaf, jspec in (jspecs.get(stack) or {}).items():
            if leaf == "length":
                continue
            jspec, jshape = _norm(jspec), jc[stack][leaf].shape
            ref_bytes += _nbytes(_local(jshape, jspec, ms), 2)
            for i in layers:
                s = sh.sanitize(specs[i], caches[i], ms)[leaf]
                assert _norm(s) == jspec[1:], (leaf, s, jspec)
                local = _local(caches[i][leaf].shape, s, ms)
                assert local == _local(jshape, jspec, ms)[1:]
                port_bytes += _nbytes(local, 2)
    assert ref_bytes == port_bytes > 0


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["bst"] + GNNS)
def test_bst_and_gnn_param_specs(arch, multi_pod):
    """BST's row-sharded tables and widest MLP matmul, the GNNs'
    replicated parameters (at each of their cells' configs): the same
    specs, shards and bytes as the reference's."""
    jmesh, ms = _mesh(multi_pod)
    spec, jspec = get_config(arch), jget_config(arch)
    if arch == "bst":
        from repro.models.bst import init_bst_params as jinit
        from repro_torch.models.bst import init_bst_params as init
        cfgs = [(spec.model_cfg, jspec.model_cfg)]
        rule, jrule = sh.bst_param_specs, jsh.bst_param_specs
        n = spec.model_cfg.n_blocks
    else:
        from repro.models.gnn import init_gnn_params as jinit
        from repro_torch.models.gnn import init_gnn_params as init
        cfgs = [(spec.model_cfg_for(s), jspec.model_cfg_for(s))
                for s in spec.shapes]
        rule, jrule = sh.gnn_param_specs, jsh.gnn_param_specs
        n = spec.model_cfg.n_layers
    for cfg, jcfg in cfgs:
        jshapes = jax.eval_shape(functools.partial(jinit, cfg=jcfg),
                                 jax.random.PRNGKey(0))
        with FakeTensorMode():
            model = init(cfg, device="cpu")
            shapes = {k: torch.empty(p.shape, dtype=p.dtype, device="meta")
                      for k, p in model.named_parameters()}
        jp = jsh.sanitize(jrule(jshapes), jshapes, jmesh)
        p = sh.sanitize(rule(shapes), shapes, ms)
        if arch != "bst":
            # GIN's eps is an [L] leaf there and a 0-d tensor a layer here
            jp = {k: v for k, v in _flat(jp).items()}
        rb, pb = _check_tree(jp, jshapes, p, shapes, ms, 0, n,
                             _elem_of(jshapes))
        assert rb == pb


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", jall_cells(include_benu=True))
def test_batch_specs(arch, shape, multi_pod):
    """Every cell's batch specs, sanitized at the mesh, and rank 0's
    shards equal the reference's."""
    jmesh, ms = _mesh(multi_pod)
    spec, jspec = get_config(arch), jget_config(arch)
    kind = spec.shapes[shape].kind
    ispecs, jispecs = spec.input_specs(shape), jspec.input_specs(shape)
    got = sh.sanitize(sh.batch_specs(spec.family, kind, ispecs, multi_pod),
                      ispecs, ms)
    want = jsh.sanitize(jsh.batch_specs(jspec.family, kind, jispecs,
                                        multi_pod), jispecs, jmesh)
    assert set(got) == set(want)
    for k in got:
        assert _norm(got[k]) == _norm(want[k]), k
        assert _local(ispecs[k].shape, got[k], ms) == \
            _local(jispecs[k].shape, tuple(want[k]), ms)


def test_snapshot_specs_and_sanitize_cases():
    """The sharded snapshot's specs; sanitize drops an axis that does not
    divide and re-homes it (granite's vocab 49155 over 16 ranks; 40
    experts over 16 move "model" to the FFN dim), as the reference's."""
    for axis in ("shard", ("data", "model")):
        assert {k: _norm(v) for k, v in
                jsh.sbenu_snapshot_specs(axis).items()} == \
            {k: _norm(v) for k, v in sh.sbenu_snapshot_specs(axis).items()}
    ms = {"data": 16, "model": 16}
    jmesh, _ = _mesh(False)
    for spec, shape in ((("model", "data"), (49155, 1536)),
                        (("model", "data", None), (40, 1536, 512)),
                        ((("data", "model"),), (100,)),
                        ((None, ("data", "model")), (512, 4096))):
        want = jsh.sanitize({"x": jax.sharding.PartitionSpec(*spec)},
                            {"x": jax.ShapeDtypeStruct(shape, jnp.float32)},
                            jmesh)["x"]
        assert _norm(sh.sanitize_one(spec, shape, ms)) == _norm(want)


def test_placements_and_local_shape():
    """A spec's DTensor placements (mesh-dim order for a dim over several
    axes; a size-1 mesh dim replicates) and rank 0's shard."""
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 1)
    assert sh.placements((("pod", "data"), "model"), Mesh()) == \
        [Shard(0), Shard(0), Replicate()]
    assert sh.placements((None, "data"), Mesh()) == \
        [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="order"):
        sh.placements(((("data", "pod")),), Mesh())
    ms = {"pod": 2, "data": 16, "model": 16}
    assert sh.local_shape((64, 4096, 7), (("pod", "data"), "model", None),
                          ms) == (2, 256, 7)
    with pytest.raises(ValueError, match="divisible"):
        sh.local_shape((10,), ("model",), ms)
