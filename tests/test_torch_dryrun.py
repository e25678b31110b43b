"""The port's dry-run tooling against the JAX package's, on the CPU.

* ``launch/op_analysis``: the collective wire model and ``Totals`` equal
  ``repro.launch.hlo_analysis`` on the same (kind, bytes, group size)
  cases (tests/test_launch.py's all-reduce over 2 and all-gather over 8,
  and each other kind); tolerance 0.
* Per-device flops of one smoke cell per family and kind on a (1, 1)
  mesh, held against ``hlo_analysis.analyze`` of the reference's cell
  compiled on one CPU device. Tolerance 0, but for BST: the backward of
  its MLP's last layer (width 1) is a matmul with a contraction of size
  1, which XLA rewrites as a multiply and the HLO count therefore leaves
  out: 2 x batch x width flops (1,024 at the smoke config).
* The fake world: a (2, 2) mesh with ``ShardCtx`` (collectives counted,
  argument bytes = the sum of rank 0's shards), and its refusal beside
  an initialised process group.
* The kernel ops: fake implementations against the plain versions
  (shape, dtype), flop formulas and byte counts against ``kernels/cost``
  (exact), and the DTensor sharding rules.
* The CLI: ``OK`` lines and JSON reports with the reference's keys.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.launch import hlo_analysis as jhlo
from repro_torch.configs import get_config
from repro_torch.kernels import cost, library, ref
from repro_torch.launch import op_analysis as oa
from repro_torch.launch.dryrun import analyze_cell
from repro_torch.launch.mesh import fake_world, make_mesh

ROOT = Path(__file__).resolve().parents[1]
#: the top-level keys of the reference's report (repro/launch/dryrun.py)
REPORT_KEYS = {"arch", "shape", "mesh", "n_chips", "lower_s", "compile_s",
               "memory_analysis", "cost_analysis", "collectives",
               "collectives_wire", "roofline", "sharding_mode", "meta"}

_HLO = """
HloModule one, is_scheduled=true

ENTRY %main (a: f32[{n},16]) -> f32[{r},16] {{
  %a = f32[{n},16]{{1,0}} parameter(0)
  ROOT %c = f32[{r},16]{{1,0}} {op}(%a), \
replica_groups=[{ng},{g}]<=[{w}], channel_id=1{extra}
}}
"""


@pytest.mark.parametrize("kind,rows,group", [
    ("all-reduce", 8, 2), ("all-gather", 64, 8), ("reduce-scatter", 4, 4),
    ("all-to-all", 32, 16), ("collective-permute", 8, 2)])
def test_wire_model_matches_hlo_analysis(kind, rows, group):
    """One collective with a result of ``rows x 16`` f32 on a group of
    ``group``: operand bytes, wire bytes and the count equal the
    reference's ring model (tolerance 0)."""
    n = {"all-gather": rows // group, "reduce-scatter": rows * group}.get(
        kind, rows)
    extra = ", dimensions={0}" if kind in ("all-gather", "reduce-scatter",
                                           "all-to-all") else ""
    text = _HLO.format(n=n, r=rows, op=kind, ng=max(1, 16 // group),
                       g=group, w=16 if group < 16 else group, extra=extra)
    want = jhlo.analyze(text)
    got = oa.Totals()
    got.add_collective(kind, rows * 16 * 4, group)
    assert want.coll_count == got.coll_count == 1
    assert got.coll_operand_bytes == want.coll_operand_bytes
    assert got.coll_wire_bytes == want.coll_wire_bytes
    assert got.coll_wire_total == want.coll_wire_total
    assert set(vars(jhlo.Totals())) <= set(vars(got))


@pytest.mark.parametrize("group", [2, 4, 16])
def test_reduce_scatter_and_all_gather_move_an_all_reduces_wire(group):
    """The ring model's identity that lets the sharded cells' wire be
    held to the reference's in total, not by kind: a reduce-scatter of
    ``B`` bytes to ``B / g`` a rank, then an all-gather back to ``B``,
    move exactly the wire of one all-reduce of ``B`` (both sides' model:
    the port's ``collective_bytes`` and the reference's HLO count)."""
    nbytes = group * 64 * 16 * 4
    rs_then_ag = oa.Totals()
    rs_then_ag.add_collective("reduce-scatter", nbytes / group, group)
    rs_then_ag.add_collective("all-gather", nbytes, group)
    ar = oa.Totals()
    ar.add_collective("all-reduce", nbytes, group)
    assert rs_then_ag.coll_wire_total == ar.coll_wire_total \
        == 2 * nbytes * (group - 1) / group
    rows = group * 64
    ref = {kind: jhlo.analyze(_HLO.format(
        n=n, r=r, op=kind, ng=max(1, 16 // group), g=group,
        w=16 if group < 16 else group,
        extra="" if kind == "all-reduce" else ", dimensions={0}"))
        for kind, n, r in (("reduce-scatter", rows, rows // group),
                           ("all-gather", rows // group, rows),
                           ("all-reduce", rows, rows))}
    assert ref["reduce-scatter"].coll_wire_total + \
        ref["all-gather"].coll_wire_total == ref["all-reduce"].coll_wire_total \
        == ar.coll_wire_total


SMOKE_CELLS = [("qwen2-0.5b", "train"), ("qwen2-0.5b", "decode"),
               ("granite-moe-3b-a800m", "train"), ("gin-tu", "full"),
               ("gin-tu", "mol"), ("pna", "full"), ("bst", "train"),
               ("benu", "enum_128m")]


def _reference_flops(arch: str, shape: str) -> float:
    from jax.sharding import Mesh
    from repro.configs import get_config as jget_config
    from repro.launch import steps
    spec = jget_config(arch).smoke()
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    build = {"lm": steps._lm_cell, "gnn": steps._gnn_cell,
             "recsys": steps._rec_cell, "benu": steps._benu_cell}
    cell = build[spec.family](spec, shape, mesh, False)
    return jhlo.analyze(cell.lower().compile().as_text()).flops


@pytest.mark.parametrize("arch,shape", SMOKE_CELLS)
def test_smoke_cell_flops_match_the_reference(arch, shape):
    """Per-device flops of the smoke cell on a (1, 1) mesh (the port's
    plain versions on the CPU) equal the reference's compiled cell's
    (tolerance 0; BST: the module docstring's size-1 contraction)."""
    rep = analyze_cell(arch, shape, device="cpu", mesh_shape=(1, 1),
                       spec=get_config(arch).smoke())
    got = rep["cost_analysis"]["flops_per_chip"]
    want = _reference_flops(arch, shape)
    gap = 0
    if arch == "bst":
        cfg = get_config(arch).smoke().model_cfg
        gap = 2 * get_config(arch).smoke().shapes[shape].dims["batch"] \
            * cfg.mlp_sizes[-1]
    assert got - want == gap, (got, want)
    if arch == "benu":
        assert got == 0                       # dots only: BENU has none
    assert set(rep) >= REPORT_KEYS
    assert rep["roofline"]["dominant"] in ("compute", "memory", "collective")


def _local_bytes(t) -> int:
    t = getattr(t, "_local_tensor", t)
    return t.numel() * t.element_size()


def test_fake_world_lm_train_on_a_2x2_mesh():
    """qwen2's smoke train cell on a (2, 2) fake world with ShardCtx:
    all-reduce and all-gather bytes are counted, and the argument bytes
    are the sum of rank 0's shards of the parameters, the optimizer state
    and the batch, as the specs lay them out (tolerance 0)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.steps import build_cell
    spec = get_config("qwen2-0.5b").smoke()
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        ms = sh.mesh_shape(mesh)
        with FakeTensorMode(), implicit_replication():
            cell = build_cell("qwen2-0.5b", "train", mesh, spec=spec)
            params = dict(cell.modules[0].named_parameters())
            want = 0
            for k, p in params.items():
                n = math.prod(sh.local_shape(p.shape, cell.specs["params"][k],
                                             ms))
                want += n * p.element_size()
                for part in ("m", "v"):
                    want += 4 * math.prod(sh.local_shape(
                        p.shape, cell.specs["opt"][part][k], ms))
            ispecs = spec.input_specs("train")
            want += 4                                  # the step counter
            want += sum(4 * math.prod(sh.local_shape(
                v.shape, cell.specs["batch"][k], ms))
                for k, v in ispecs.items())
            counter = oa.OpCounter()
            assert counter.track(cell.arguments()) == want
            assert sum(_local_bytes(t) for t in cell.arguments()) == want
            with counter:
                cell.fn(*cell.args)
    tot = counter.totals
    assert tot.coll_operand_bytes["all-reduce"] > 0
    assert tot.coll_operand_bytes["all-gather"] > 0
    assert tot.flops > 0 and tot.peak_bytes > want


def test_fake_world_refuses_an_initialised_group(tmp_path):
    """The fake world never opens beside another process group (a gloo
    world here), and it leaves none behind."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialised"):
            with fake_world(4):
                pass
    finally:
        dist.destroy_process_group()
    with fake_world(256):
        from repro_torch.launch.mesh import make_production_mesh
        mesh = make_production_mesh()
        assert mesh.shape == (16, 16)
        assert mesh.mesh_dim_names == ("data", "model")
        with pytest.raises(RuntimeError, match="512 ranks"):
            make_production_mesh(multi_pod=True)
    assert not dist.is_initialized()


def test_mesh_axes_equal_the_reference():
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh
    for mp in (False, True):
        assert mesh.dp_axes(mp) == jmesh.dp_axes(mp)
        assert mesh.flat_axes(mp) == jmesh.flat_axes(mp)


# --------------------------------------------------------------------------
# The kernel ops
# --------------------------------------------------------------------------


def _op_cases():
    """(op, its arguments, the plain version's outputs) at small shapes."""
    g = torch.Generator().manual_seed(0)

    def rnd(*s):
        return torch.randn(s, generator=g)
    q, k, v = rnd(2, 4, 9, 16), rnd(2, 2, 9, 16), rnd(2, 2, 9, 8)
    out, lse = ref.flash_attention(q, k, v, causal=True, return_lse=True)
    x, gam = rnd(6, 24), rnd(24)
    n = 50
    a = torch.sort(torch.randint(0, n, (5, 7), generator=g)).values.int()
    b = torch.sort(torch.randint(0, n, (5, 11), generator=g)).values.int()
    adj = torch.sort(torch.randint(0, n, (n + 1, 6), generator=g)).values
    adj = adj.int()
    ids = torch.randint(0, n, (5,), generator=g).int()
    s = 16 ** -0.5
    return {
        "flash_attention": ((q, k, v, True, s), (out,)),
        "flash_attention_lse": ((q, k, v, True, s), (out, lse)),
        "flash_attention_bwd": ((q, k, v, out, lse, rnd(2, 4, 9, 8), True, s),
                                ref.flash_attention_backward(
                                    q, k, v, out, lse, rnd(2, 4, 9, 8),
                                    True, s)),
        "rmsnorm": ((x, gam, 1e-6), (ref.rmsnorm(x, gam),)),
        "rmsnorm_bwd": ((x, gam, rnd(6, 24), 1e-6),
                        ref.rmsnorm_backward(x, gam, rnd(6, 24))),
        "sorted_intersect": ((a, b, n), (ref.sorted_intersect(a, b, n),)),
        "gather_intersect": ((ids, a, adj, n), (ref.sorted_intersect(
            a, adj[ids.long()], n),)),
    }


KERNEL_OPS = ("flash_attention", "flash_attention_bwd", "flash_attention_lse",
              "gather_intersect", "rmsnorm", "rmsnorm_bwd", "sorted_intersect")


def test_every_kernel_entry_point_is_an_op():
    library.register_rules()
    assert sorted(library.BYTES) == sorted(KERNEL_OPS)


@pytest.mark.parametrize("name", KERNEL_OPS)
def test_kernel_op_fake_impl_flops_and_bytes(name):
    """Each kernel op: its fake implementation gives the plain version's
    output shapes and dtypes; its registered flop formula (read by
    ``torch.utils.flop_counter``) and the op counter's bytes equal
    ``kernels/cost.py``'s (tolerance 0)."""
    from torch.utils.flop_counter import FlopCounterMode
    args, want = _op_cases()[name]
    library.register_rules()
    with FakeTensorMode(allow_non_fake_inputs=True) as fm:
        fargs = [fm.from_tensor(t) if isinstance(t, torch.Tensor) else t
                 for t in args]
        with FlopCounterMode(display=False) as fc:
            got = library.op(name)(*fargs)
        counter = oa.OpCounter()
        with counter:
            library.op(name)(*fargs)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    if name.startswith("flash"):
        q, k, v = args[:3]
        b, hq, tq, dqk = q.shape
        fn = cost.flash_bwd_flops if name.endswith("bwd") \
            else cost.flash_flops
        flops = fn(b, hq, tq, k.shape[2], dqk, v.shape[3], True)
        assert flops == cost.visible_pairs(tq, k.shape[2], True) * b * hq \
            * 2 * ((3 * dqk + 2 * v.shape[3]) if name.endswith("bwd")
                   else (dqk + v.shape[3]))
    else:
        flops = 0                                  # no products
    assert fc.get_total_flops() == counter.totals.flops == flops
    assert counter.totals.hbm_bytes == library.BYTES[name](*args)
    assert counter.totals.coll_count == 0


def test_kernel_bytes_equal_cost():
    """The byte counts registered for the ops are kernels/cost.py's."""
    cases = _op_cases()
    q, k, v = cases["flash_attention"][0][:3]
    assert library.BYTES["flash_attention"](*cases["flash_attention"][0]) \
        == cost.flash_bytes(2, 4, 2, 9, 9, 16, 8, 4)
    assert library.BYTES["flash_attention_lse"](
        *cases["flash_attention_lse"][0]) == \
        cost.flash_bytes(2, 4, 2, 9, 9, 16, 8, 4, with_lse=True)
    assert library.BYTES["rmsnorm"](*cases["rmsnorm"][0]) == \
        cost.rmsnorm_bytes(6, 24, 4) == (2 * 6 * 24 + 24) * 4
    assert library.BYTES["sorted_intersect"](*cases["sorted_intersect"][0]) \
        == cost.sorted_intersect_bytes(5, 7, 11) == 4 * (5 * 18 + 5 * 7)
    assert cost.gather_intersect_bytes(5, 7, 6, n_valid=2) == \
        4 * (2 * 5 * 7 + 5 + 2 * 6)
    for tq in (1, 7, 128):
        assert cost.visible_pairs(tq, tq, True) == tq * (tq + 1) // 2


def test_kernel_sharding_rules():
    """The ops on DTensors over a (2, 2) fake world: flash attention runs
    on batch and heads (kv heads that a mesh dim does not divide pull the
    q heads whole), RMSNorm and the intersects on rows, with dgamma a
    partial sum; the local shapes are the rule's."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.launch.steps import _dtensor
    library.register_rules()
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        with FakeTensorMode():
            def dt(shape, spec, dtype=torch.float32):
                return _dtensor(shape, dtype, spec, mesh, "cpu")
            q = dt((4, 8, 16, 32), ("data", "model"))
            k = dt((4, 2, 16, 32), ("data", "model"))
            out = library.op("flash_attention")(q, k, k, True, 0.1)
            assert tuple(out.placements) == (Shard(0), Shard(1))
            assert tuple(out.to_local().shape) == (2, 4, 16, 32)
            k1 = dt((4, 1, 16, 32), ("data",))
            out = library.op("flash_attention")(q, k1, k1, True, 0.1)
            assert tuple(out.placements) == (Shard(0), Replicate())
            x = dt((8, 16), ("data", "model"))
            gam = dt((16,), (None,))
            y = library.op("rmsnorm")(x, gam, 1e-6)
            assert tuple(y.placements)[0] == Shard(0)
            dx, dg = library.op("rmsnorm_bwd")(x, gam, x, 1e-6)
            assert isinstance(dg.placements[0], Partial)
            a = dt((8, 6), ("data",), torch.int32)
            s = library.op("sorted_intersect")(a, a, 9)
            assert tuple(s.placements) == (Shard(0), Replicate())


# --------------------------------------------------------------------------
# The CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", [("gin-tu", "molecule"),
                                        ("benu", "enum_128m")])
def test_cli_writes_a_report(tmp_path, arch, shape):
    """``python -m repro_torch.launch.dryrun --device cpu`` prints ``OK``
    and writes ``<arch>__<shape>__pod.json`` with the reference's keys
    and ``roofline.dominant``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--device", "cpu", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert f"OK   {arch}__{shape}__pod" in res.stdout
    rep = json.loads((tmp_path / f"{arch}__{shape}__pod.json").read_text())
    assert set(rep) >= REPORT_KEYS
    assert rep["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rep["n_chips"] == 256 and rep["device"] == "cpu"
    assert rep["memory_analysis"]["argument_bytes"] > 0


def test_cuda_without_a_card_raises(tmp_path):
    """``--device cuda`` (the default) needs a card: no fallback to the
    CPU; the CLI reports the cell as failed and exits non-zero."""
    from repro_torch.launch import dryrun
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        analyze_cell("gin-tu", "molecule", device="cuda")
    assert dryrun.main(["--arch", "gin-tu", "--shape", "molecule",
                        "--out", str(tmp_path)]) == 1
    assert not list(tmp_path.iterdir())
