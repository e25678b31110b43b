"""Dense FFN block: SwiGLU (LLaMA-style gated) MLP.

Counterpart of ``swiglu_params`` / ``swiglu`` in ``repro/layers/mlp.py``;
``mlp_params`` / ``mlp_apply`` come with the GNN/recsys slice. Weights
keep the reference's ``[in, out]`` layout (``x @ w``), so the JAX
package's arrays carry across as they are.
"""

from __future__ import annotations

import torch
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
