"""Rotary position embeddings (RoPE), NeoX halves.

Counterpart of ``repro/layers/rope.py``. MLA (decoupled RoPE) rotates
only the ``rope`` slice of each head, by calling :func:`apply_rope` on it.
"""

from __future__ import annotations

import torch


def rope_freqs(d: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """Inverse frequencies [d/2] (f32)."""
    return 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=device) / d))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate pairs. x: [..., T, H, d] (or [..., T, d]); positions: [..., T].

    Pairing convention: (x[..., :d/2], x[..., d/2:]) halves (NeoX style).
    Angles come from f32 positions, the rotation is in f32 and the result
    is cast back to x's dtype.
    """
    d = x.shape[-1]
    inv = rope_freqs(d, theta, device=x.device)              # [d/2]
    ang = positions[..., None].to(torch.float32) * inv       # [..., T, d/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.ndim == ang.ndim + 1:                               # head axis
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
