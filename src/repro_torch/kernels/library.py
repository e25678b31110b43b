"""The kernels as dispatcher ops: ``torch.ops.repro_torch.*``.

Each hand-written kernel entry point is a ``torch.library`` op of the
``repro_torch`` namespace, so that torch's machinery sees it as one
operation: ``FakeTensorMode`` runs its fake (shape) implementation
instead of a launch, ``torch.utils.flop_counter`` reads its flop formula
(:mod:`repro_torch.kernels.cost`), and DTensor reads its sharding rule
(flash attention over batch and heads, RMSNorm and the intersects over
rows). The CUDA implementation of each op is the ctypes launch of its
wrapper module; the ops have no CPU implementation (a CPU tensor takes
the plain version in ``kernels/ops.py``).

The ops are bound through ``torch.library.Library(...).define / impl``,
not ``torch.library.custom_op``, whose Python wrapper costs tens of
microseconds a call on the serving path. Even so the dispatcher boxes a
call to a Python kernel (8–15 µs a call on the card's host), so a wrapper
launches directly when nothing could intercept the op
(:func:`direct`: plain tensors, no dispatch mode), which keeps the eager
path's host cost; a fake tensor, a DTensor or a mode (``FakeTensorMode``,
the flop and op counters) always goes through the op. :func:`define`
registers one op with its CUDA and fake implementations;
:func:`register_rules` adds the flop formulas and the sharding rules at
first use (they import ``torch.distributed.tensor``).
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch

NAMESPACE = "repro_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")

#: op name -> bytes of one call from its arguments and output (the op
#: analysis counts a kernel op's traffic by it)
BYTES: Dict[str, Callable] = {}
#: op name -> flops of one call, ``f(*args, out=...)`` on tensors
FLOPS: Dict[str, Callable] = {}
_SHARDING: Dict[str, Callable] = {}


def define(name: str, schema: str, cuda: Callable, fake: Callable,
           nbytes: Callable, flops: Optional[Callable] = None,
           sharding: Optional[Callable] = None):
    """Define ``repro_torch::name`` with ``schema`` and register its CUDA
    implementation, its fake implementation, its byte and flop counts
    (0 flops when ``flops`` is None) and its DTensor sharding rule.
    Returns the op's default overload."""
    LIB.define(f"{name}{schema}")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    BYTES[name] = nbytes
    FLOPS[name] = flops or (lambda *a, **k: 0)
    if sharding is not None:
        _SHARDING[name] = sharding
    return getattr(getattr(torch.ops, NAMESPACE), name).default


_dispatch_modes = torch._C._len_torch_dispatch_stack


def direct(*tensors: torch.Tensor) -> bool:
    """Whether a call on ``tensors`` may launch without the dispatcher:
    every one a plain ``torch.Tensor`` and no dispatch mode active (the
    launch then checks the tensors itself; this test runs on every call
    of the eager path, so it is kept to a loop over types)."""
    if _dispatch_modes():
        return False
    for t in tensors:
        if type(t) is not torch.Tensor:
            return False
    return True


def op(name: str):
    return getattr(getattr(torch.ops, NAMESPACE), name).default


@functools.lru_cache(maxsize=None)
def register_rules() -> None:
    """Register the flop formulas with ``torch.utils.flop_counter`` and
    the sharding rules with DTensor, once. The dry-run calls this before
    it traces."""
    from torch.distributed.tensor.experimental import register_sharding
    from torch.utils.flop_counter import register_flop_formula
    from . import flash_attention, gather_intersect, rmsnorm, \
        sorted_intersect  # noqa: F401 (they define the ops)

    for name, fn in FLOPS.items():
        def formula(*args, out_val=None, _fn=fn, **kwargs):
            return _fn(*args, out=out_val, **kwargs)
        register_flop_formula(getattr(getattr(torch.ops, NAMESPACE), name),
                              get_raw=True)(formula)
    for name, rule in _SHARDING.items():
        register_sharding(op(name))(rule)
