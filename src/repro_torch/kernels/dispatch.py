"""Kernel impl resolution for the ops of ``kernels/``.

Counterpart of ``repro/kernels/dispatch.py`` with the same resolution
order: an explicit ``impl=`` argument always wins; ``auto`` consults the
op's environment override (``REPRO_TORCH_<OP>_IMPL``); otherwise the
default for the tensor's ``device.type`` applies: the hand-written kernel
(``cuda``) on a CUDA tensor, a plain version on the CPU. The
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
    >>> _ = os.environ.pop("REPRO_TORCH_RMSNORM_IMPL", None)
    >>> dispatch.resolve_impl("rmsnorm", "auto", platform="cpu")
    'ref'
"""

from __future__ import annotations

import os
from typing import Optional

ENV_PREFIX = "REPRO_TORCH_"

#: the padded-set ops, whose CPU default depends on the row width
SET_OPS = ("intersect", "gather_intersect")
#: the ops of ``kernels/ops.py`` and the impls each accepts
IMPLS = {
    **{op: ("cuda", "ref", "chunked", "binary") for op in SET_OPS},
    "flash_attention": ("cuda", "ref"),
    "rmsnorm": ("cuda", "ref"),
}
OPS = tuple(IMPLS)


def _normalize(op: str, impl: str) -> str:
    if impl != "auto" and impl not in IMPLS[op]:
        raise ValueError(f"{op}: unknown impl {impl!r}; choose from "
                         f"{('auto',) + IMPLS[op]}")
    return impl


def _default(op: str, platform: str, width: Optional[int]) -> str:
    if platform == "cuda":
        return "cuda"
    # CPU, wide padded-set rows: the O(D)-memory chunked loop
    if op in SET_OPS and (width or 0) > 512:
        return "chunked"
    return "ref"


def resolve_impl(op: str, impl: str = "auto", *, platform: str,
                 width: Optional[int] = None) -> str:
    """Resolve ``impl`` for ``op``: explicit > env override > default.

    The env override is ``REPRO_TORCH_<OP>_IMPL``. ``platform`` is the
    operand tensor's ``device.type``; ``width`` feeds the CPU default of
    the intersect ops (the O(D)-memory chunked loop on wide rows).
    """
    if op not in IMPLS:
        raise ValueError(f"unknown kernel op {op!r}; known: {list(OPS)}")
    impl = _normalize(op, impl)
    if impl != "auto":
        return impl
    env_val = os.environ.get(f"{ENV_PREFIX}{op.upper()}_IMPL", "").strip()
    if env_val and _normalize(op, env_val) != "auto":
        return env_val
    return _default(op, platform, width)
