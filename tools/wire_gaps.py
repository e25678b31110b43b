"""The dry-run's known collective-wire departures from the reference's
programs, by cause, at a mesh of the caller's choosing.

``tests/test_torch_dryrun_mesh.py`` holds each cell's total wire bytes a
device to the reference's compiled program on meshes of four, less one
formula per cause (``wire_causes``). This script evaluates those formulas
for the full-size cells on the production meshes, where the reference's
256- and 512-device programs are not compiled: a cause that was read
from XLA's partition of a smoke mesh prints as not known. A multi-pod
mesh is taken as one data axis of pod x data ranks.

``--smoke`` prints instead, for each smoke cell of the test on its mesh
of four, the port's and the reference's total wire bytes a device, their
ratio and what the causes leave (about a minute: the reference compiles
in one subprocess on four forced host devices, as the test's fixture
does).

Usage (CPU; the parameters are fake tensors):
    PYTHONPATH=src:tests python tools/wire_gaps.py
    PYTHONPATH=src:tests python tools/wire_gaps.py --cells \\
        qwen2-0.5b:train_4k --meshes 16x16
    PYTHONPATH=src:tests python tools/wire_gaps.py --smoke
"""

from __future__ import annotations

import argparse
import math

CELLS = ("qwen2-0.5b:train_4k", "granite-moe-3b-a800m:train_4k",
         "qwen2-0.5b:decode_32k", "gin-tu:full_graph_sm",
         "pna:full_graph_sm", "bst:train_batch")
MESHES = ("16x16", "32x16")


def smoke() -> None:
    """The test's cells: port and reference totals, and the causes'."""
    import json
    import os
    import subprocess
    import sys
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import analyze_cell
    from test_torch_dryrun_mesh import CELLS as SMOKE, _REFERENCE, _key, \
        wire_causes
    arg = json.dumps([[a, s, list(m)] for a, s, m in SMOKE])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.argv[1:] = ["
         + repr(arg) + "]\n" + _REFERENCE], env=env, check=True,
        capture_output=True, text=True).stdout
    ref = json.loads(out.strip().splitlines()[-1])
    for arch, shape, ms in SMOKE:
        spec = get_config(arch).smoke()
        rep = analyze_cell(arch, shape, device="cpu", mesh_shape=ms,
                           spec=spec)
        port = sum(rep["collectives_wire"].values())
        want = sum(ref[_key(arch, shape, ms)]["wire"].values())
        each = wire_causes(spec, shape, ms, rep["meta"].get(
            "microbatches", 1))
        causes = sum(each.values())
        print(f"{_key(arch, shape, ms)}: port {port:.0f} B, reference "
              f"{want:.0f} B, port / reference {port / want:.3f}; causes "
              f"{causes:.0f} B, left {port - want - causes:.0f} B",
              flush=True)
        for cause, v in each.items():
            print(f"    {cause}: {v:.0f} B")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="+", default=CELLS)
    ap.add_argument("--meshes", nargs="+", default=MESHES,
                    help="data x model; 32x16 stands for 2 x 16 x 16")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    if args.smoke:
        smoke()
        return 0
    from repro_torch.configs import get_config
    from test_torch_dryrun_mesh import wire_causes
    for cell in args.cells:
        arch, shape = cell.split(":")
        spec = get_config(arch)
        for m in args.meshes:
            ms = tuple(int(x) for x in m.split("x"))
            dims = spec.shapes[shape].dims
            mb = max(1, min(int(dims.get("microbatches", 4)),
                            dims.get("batch", 1) // ms[0]))
            causes = wire_causes(spec, shape, ms, mb)
            for cause, v in causes.items():
                size = "not known" if math.isnan(v) else f"{v:.6g} B"
                print(f"{cell} {m}: {cause}: {size}")
            if not causes:
                print(f"{cell} {m}: no cause")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
