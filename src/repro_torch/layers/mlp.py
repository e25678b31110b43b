"""Dense FFN blocks: SwiGLU (LLaMA-style gated) MLP and the plain tower.

Counterpart of ``repro/layers/mlp.py``: :class:`SwiGLU` of
``swiglu_params`` / ``swiglu``, :class:`MLP` of ``mlp_params`` /
``mlp_apply`` (the recsys and GNN towers; EGNN's silu towers pass
``act``). Weights keep the reference's ``[in, out]`` layout (``x @ w``)
and names, so the JAX package's arrays carry across as they are.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import dense_init, swish


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 gen: torch.Generator):
        super().__init__()
        self.w_gate = nn.Parameter(dense_init(gen, (d_model, d_ff), dtype))
        self.w_up = nn.Parameter(dense_init(gen, (d_model, d_ff), dtype))
        self.w_down = nn.Parameter(dense_init(gen, (d_ff, d_model), dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = swish(x @ self.w_gate) * (x @ self.w_up)
        return h @ self.w_down


class MLP(nn.Module):
    """Plain tower over ``sizes = [in, h1, ..., out]``: ``w{i} [a, b]``
    (LeCun-normal) and ``b{i} [b]`` (init 0), the reference's names.
    ``forward`` applies ``act`` (ReLU unless given, as the reference's
    ``mlp_apply``) after every layer but the last, and after the last too
    with ``final_act``."""

    def __init__(self, sizes: Sequence[int], dtype: torch.dtype,
                 gen: torch.Generator):
        super().__init__()
        self.n_layers = len(sizes) - 1
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            setattr(self, f"w{i}", nn.Parameter(dense_init(gen, (a, b),
                                                           dtype)))
            setattr(self, f"b{i}", nn.Parameter(torch.zeros(
                b, dtype=dtype, device=gen.device)))

    def forward(self, x: torch.Tensor, final_act: bool = False,
                act: Callable[[torch.Tensor], torch.Tensor] = F.relu
                ) -> torch.Tensor:
        for i in range(self.n_layers):
            x = x @ getattr(self, f"w{i}") + getattr(self, f"b{i}")
            if i < self.n_layers - 1 or final_act:
                x = act(x)
        return x
