"""Per-device dry-run of every (architecture x shape) cell.

Counterpart of ``repro/launch/dryrun.py``: the reference lowers and
compiles each cell on a forced 512-device mesh and reads the compiled
HLO; the port traces rank 0's program (``launch/steps.py``) on fake
tensors over a fake world of 256 (or 512) ranks (``launch/mesh.py``) and
counts what it dispatches (``launch/op_analysis.py``). Nothing is
allocated on a card and nothing is launched.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k
    python -m repro_torch.launch.dryrun --arch benu --shape enum_128m \\
        --multi-pod
    python -m repro_torch.launch.dryrun --all [--include-benu] \\
        [--multi-pod] [--out results/dryrun_torch]
    python -m repro_torch.launch.dryrun --cells qwen2-0.5b:decode_32k \\
        bst:retrieval_cand

``--device cuda`` (the default) puts the fake tensors on the card's
device, so the traced path is the kernel path (each kernel one op at its
``kernels/cost.py`` count); without a card it raises. ``--device cpu``
traces the plain versions instead.

Per cell it writes ``<out>/<arch>__<shape>__<pod|multipod>.json``:
    memory_analysis   bytes per device: arguments (rank 0's shards),
                      outputs, temp (peak live beyond the arguments) and
                      the peak of live tensor bytes
    cost_analysis     flops and HBM bytes per device (op_analysis)
    collectives       operand bytes by kind and their count
    collectives_wire  the ring model's wire bytes by kind
    roofline          compute / memory / collective seconds at the H100
                      SXM5's data-sheet peaks, the dominant term, the
                      model flops and their share of the counted flops
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Dict, Optional, Sequence

import torch

from ..kernels.cost import BANDWIDTH, NVLINK_H100, PEAK_BF16, card_rate

# H100 SXM5 data-sheet peaks (not measurements), per card
PEAK_FLOPS_BF16 = card_rate(PEAK_BF16, "H100")      # FLOP/s, dense bf16
HBM_BW = card_rate(BANDWIDTH, "H100")               # B/s
LINK_BW = NVLINK_H100                               # B/s per direction


def _local_bytes(obj) -> int:
    """Bytes of the storages of the tensors in ``obj`` (rank 0's shards
    of DTensors), each storage once."""
    from .steps import tensors_of
    seen, total = set(), 0
    for t in tensors_of(obj):
        t = getattr(t, "_local_tensor", t)
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def analyze_cell(arch: str, shape: str, multi_pod: bool = False,
                 sharding_mode: str = "fsdp", device: str = "cuda",
                 mesh_shape: Optional[Sequence[int]] = None,
                 spec=None) -> Dict:
    """The cell's report. ``mesh_shape`` (with its axes named as the
    production mesh's) replaces the production mesh, and ``spec`` the
    registry's arch (the tests' small meshes and smoke configs, a cut
    depth: :func:`cut_depth`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from .mesh import PROD_AXES, PROD_SHAPE, fake_world, make_mesh
    from .op_analysis import OpCounter
    from .steps import build_cell

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card; pass --device "
                           "cpu to trace the plain versions")
    shp = tuple(mesh_shape or PROD_SHAPE[multi_pod])
    axes = PROD_AXES[len(shp) == 3]
    n_dev = math.prod(shp)
    with fake_world(n_dev):
        mesh = make_mesh(shp, axes, device)
        t0 = time.time()
        with FakeTensorMode(), implicit_replication():
            cell = build_cell(arch, shape, mesh, multi_pod=multi_pod,
                              sharding_mode=sharding_mode, device=device,
                              spec=spec)
            t_build = time.time() - t0
            counter = OpCounter()
            arg_bytes = counter.track(cell.arguments())
            t0 = time.time()
            with counter:
                out = cell.fn(*cell.args)
            t_trace = time.time() - t0
            out_bytes = _local_bytes(out)
            del out
        tot = counter.totals

    t_compute = tot.flops / PEAK_FLOPS_BF16
    t_memory = tot.hbm_bytes / HBM_BW
    t_collective = tot.coll_wire_total / LINK_BW
    dom = max((("compute", t_compute), ("memory", t_memory),
               ("collective", t_collective)), key=lambda kv: kv[1])[0]
    meta = cell.meta
    dims = meta.get("dims", {})
    tokens = 0
    if meta["family"] == "lm":
        tokens = dims["batch"] if meta["kind"] in (
            "lm_decode", "lm_long_decode") else dims["seq"] * dims["batch"]
    model_flops = 0.0
    if meta["family"] == "lm":
        mult = 6 if meta["kind"] == "lm_train" else 2
        model_flops = mult * meta["n_active_params"] * tokens
    useful = model_flops / (tot.flops * n_dev) if tot.flops > 0 else 0.0
    coll = {k: int(v) for k, v in tot.coll_operand_bytes.items()}
    coll["count"] = tot.coll_count
    return {
        "arch": arch, "shape": shape,
        "mesh": "x".join(map(str, shp)) + " " + ",".join(axes),
        "n_chips": n_dev, "device": device,
        # the counterparts of the reference's lowering and compile: building
        # the cell's program and tracing it
        "lower_s": round(t_build, 2), "compile_s": round(t_trace, 2),
        "memory_analysis": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "generated_code_bytes": 0,                  # eager: none
            "temp_bytes": max(0, int(tot.peak_bytes) - arg_bytes),
            "peak_bytes_per_device": int(tot.peak_bytes),
        },
        "cost_analysis": {"flops_per_chip": tot.flops,
                          "bytes_per_chip": tot.hbm_bytes,
                          "flops_by_op": tot.flops_by_op,
                          "kernel_bytes_by_op": tot.bytes_by_op},
        "collectives": coll,
        "collectives_wire": {k: int(v)
                             for k, v in tot.coll_wire_bytes.items()},
        "roofline": {
            "compute_s": t_compute, "memory_s": t_memory,
            "collective_s": t_collective, "dominant": dom,
            "model_flops": model_flops,
            "useful_flops_ratio": useful,
            "peaks": {"bf16_flops": PEAK_FLOPS_BF16, "hbm_bytes_s": HBM_BW,
                      "link_bytes_s": LINK_BW,
                      "source": "H100 SXM5 data sheet"},
        },
        "sharding_mode": sharding_mode,
        "meta": {k: v for k, v in meta.items() if k != "plan"},
    }


def cut_depth(spec, layers: int):
    """The LM ``spec`` at its first ``layers`` layers (the per-layer terms
    of its report scale with them)."""
    import dataclasses
    if spec.family != "lm":
        raise ValueError(f"--layers cuts an LM's depth; {spec.name} is "
                         f"{spec.family}")
    return dataclasses.replace(spec, model_cfg=dataclasses.replace(
        spec.model_cfg, n_layers=layers))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cells", nargs="+", metavar="ARCH:SHAPE",
                    help="a list of cells")
    ap.add_argument("--include-benu", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--sharding-mode", default="fsdp",
                    choices=["fsdp", "zero1", "fsdp2d"],
                    help="LM train-cell parameter layout (see "
                         "launch/shardings.py)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--layers", type=int, default=None,
                    help="LM cells: trace the first N layers only")
    args = ap.parse_args(argv)

    from ..configs import all_cells, get_config
    if args.all:
        cells = all_cells(include_benu=args.include_benu)
    elif args.cells:
        cells = [tuple(c.split(":", 1)) for c in args.cells]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, --cells or --all")
    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, shape in cells:
        tag = "multipod" if args.multi_pod else "pod"
        name = f"{arch.replace('/', '_')}__{shape}__{tag}"
        try:
            spec = None if args.layers is None else \
                cut_depth(get_config(arch), args.layers)
            rep = analyze_cell(arch, shape, args.multi_pod,
                               sharding_mode=args.sharding_mode,
                               device=args.device, spec=spec)
            if args.layers is not None:
                rep["layers"] = args.layers
            with open(os.path.join(args.out, name + ".json"), "w") as f:
                json.dump(rep, f, indent=1)
            r = rep["roofline"]
            gib = rep["memory_analysis"]["peak_bytes_per_device"] / 2**30
            print(f"OK   {name}: trace {rep['compile_s']}s "
                  f"mem/dev {gib:.2f}GiB "
                  f"compute {r['compute_s'] * 1e3:.2f}ms "
                  f"memory {r['memory_s'] * 1e3:.2f}ms "
                  f"coll {r['collective_s'] * 1e3:.2f}ms -> {r['dominant']}",
                  flush=True)
        except Exception as e:  # noqa: BLE001 (report and continue)
            failures.append(name)
            print(f"FAIL {name}: {type(e).__name__}: {str(e)[:300]}",
                  flush=True)
    if failures:
        print(f"{len(failures)} cells failed: {failures}", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
