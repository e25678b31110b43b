"""Production meshes over a fake world.

Counterpart of ``repro/launch/mesh.py``. Single pod: 16 x 16 = 256 ranks,
axes ("data", "model"). Multi-pod: 2 x 16 x 16 = 512 ranks, axes ("pod",
"data", "model"); "pod" is the outer pure-DP axis (gradients all-reduce
over it, parameters stay replicated pod to pod).

The dry-run has no 256 cards: it opens torch's single-process ``fake``
process group (``torch.testing._internal.distributed.fake_pg``) as rank
0 of the world, so collectives are recorded by the dispatcher and return
at once, and builds a ``DeviceMesh`` over it. :func:`fake_world` refuses
to start while another process group is initialised (a gloo world of the
tests, an NCCL world of the card), and closes the fake world on exit.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Sequence, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PROD_SHAPE = {False: (16, 16), True: (2, 16, 16)}
PROD_AXES = {False: ("data", "model"), True: ("pod", "data", "model")}


@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """A fake process group of ``world_size`` ranks, this process rank 0,
    for the length of the context. Raises when a process group is
    already initialised or the fake backend is missing."""
    if dist.is_initialized():
        raise RuntimeError(
            "a process group is already initialised "
            f"(backend {dist.get_backend()!r}); the fake world of the "
            "dry-run must not share a process with it")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("torch's fake process group is not available "
                           "in this build; the dry-run needs it") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: str = "cpu") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    world, which must have exactly ``prod(shape)`` ranks."""
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"need a world of {n} ranks for the mesh "
                           f"{tuple(shape)}, have {have} (open one with "
                           "fake_world)")
    return init_device_mesh(device, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "cpu") -> DeviceMesh:
    return make_mesh(PROD_SHAPE[multi_pod], PROD_AXES[multi_pod], device)


def dp_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def flat_axes(multi_pod: bool) -> Tuple[str, ...]:
    """All mesh axes flattened (edge-sharding, candidate-sharding, BENU)."""
    return ("pod", "data", "model") if multi_pod else ("data", "model")
