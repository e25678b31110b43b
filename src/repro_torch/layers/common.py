"""Shared layer utilities: init helpers, RMSNorm, swish.

Counterpart of ``repro/layers/common.py``. Its ``ShardCtx`` is a no-op
without a mesh and is left out until the multi-device slice; layernorm
and the cross entropy come with the training slice. Init draws from an
explicit ``torch.Generator`` on the parameter's device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..kernels import ops as kops


def dense_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.float32,
               scale: Optional[float] = None) -> torch.Tensor:
    """LeCun-normal (fan-in) init, drawn in f32 on ``gen``'s device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(tuple(shape), generator=gen, device=gen.device)
            * s).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (torch.randn(tuple(shape), generator=gen, device=gen.device)
            * 0.02).to(dtype)


def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6,
            impl: str = "auto") -> torch.Tensor:
    return kops.rmsnorm(x, gamma, eps=eps, impl=impl)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


class RMSNorm(nn.Module):
    """RMSNorm over the last axis with gain ``weight`` (init 1)."""

    def __init__(self, d: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor, impl: str = "auto") -> torch.Tensor:
        return rmsnorm(x, self.weight, self.eps, impl=impl)
