"""Kernel impl resolution for the ops of ``kernels/``.

Counterpart of ``repro/kernels/dispatch.py`` with the same resolution
order: an explicit ``impl=`` argument always wins; ``auto`` consults the
op's environment override (``REPRO_TORCH_<OP>_IMPL``); otherwise the
default for the tensor's ``device.type`` applies. The
``REPRO_TORCH_`` prefix keeps the JAX package's ``REPRO_<OP>_IMPL``
overrides from reaching the port.

The CUDA wrappers pick their own launch shape, so there is no tile table.

    >>> import os
    >>> from repro_torch.kernels import dispatch
    >>> _ = os.environ.pop("REPRO_TORCH_INTERSECT_IMPL", None)
    >>> dispatch.resolve_impl("intersect", "auto", platform="cuda")
    'cuda'
    >>> dispatch.resolve_impl("intersect", "auto", platform="cpu", width=64)
    'ref'
    >>> dispatch.resolve_impl("intersect", "auto", platform="cpu",
    ...                       width=1024)                  # wide rows: O(D)
    'chunked'
"""

from __future__ import annotations

import os
from typing import Optional

ENV_PREFIX = "REPRO_TORCH_"

#: the ops of ``kernels/ops.py``; both accept the same impls and defaults
OPS = ("intersect", "gather_intersect")
IMPLS = ("cuda", "ref", "chunked", "binary")


def _normalize(op: str, impl: str) -> str:
    if impl != "auto" and impl not in IMPLS:
        raise ValueError(f"{op}: unknown impl {impl!r}; choose from "
                         f"{('auto',) + IMPLS}")
    return impl


def _default(platform: str, width: Optional[int]) -> str:
    if platform == "cuda":
        return "cuda"
    # CPU, wide rows: the O(D)-memory chunked loop; narrow: the dense probe
    return "chunked" if (width or 0) > 512 else "ref"


def resolve_impl(op: str, impl: str = "auto", *, platform: str,
                 width: Optional[int] = None) -> str:
    """Resolve ``impl`` for ``op``: explicit > env override > default.

    The env override is ``REPRO_TORCH_<OP>_IMPL``. ``platform`` is the
    operand tensor's ``device.type``; ``width`` feeds the CPU default
    (the O(D)-memory chunked loop on wide rows).
    """
    if op not in OPS:
        raise ValueError(f"unknown kernel op {op!r}; known: {list(OPS)}")
    impl = _normalize(op, impl)
    if impl != "auto":
        return impl
    env_val = os.environ.get(f"{ENV_PREFIX}{op.upper()}_IMPL", "").strip()
    if env_val and _normalize(op, env_val) != "auto":
        return env_val
    return _default(platform, width)


def fused_fetch_enabled(default: bool = False) -> bool:
    """Whether the engine fuses DBQ gathers into the intersect kernel.

    ``REPRO_TORCH_FUSED_FETCH`` forces it on (``1``/``on``/``true``/``yes``)
    or off (``0``/``off``/``false``/``no``); unset, ``default`` applies
    (True for the ``torch-gpu`` backend, False for ``torch``).
    """
    val = os.environ.get(f"{ENV_PREFIX}FUSED_FETCH", "").strip().lower()
    if val in ("1", "on", "true", "yes"):
        return True
    if val in ("0", "off", "false", "no"):
        return False
    return default
