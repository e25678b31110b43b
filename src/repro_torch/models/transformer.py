"""Decoder-only transformer LM: the dense GQA architectures of the port.

Counterpart of ``repro/models/transformer.py`` for the dense GQA models
(qwen2-0.5b, qwen2.5-3b, phi4-mini-3.8b). MoE and MLA configs (granite,
deepseek) raise ``NotImplementedError``: they come with the MoE/MLA slice.

Layers run as a Python loop over a ``ModuleList`` (the reference scans
stacked parameters; ``repro_torch.convert.lm_state_dict_from_numpy``
splits its ``[L, ...]`` leaves per layer). Step functions:

    forward        tokens [B, T] -> (logits [B, T, V], aux, caches)
    prefill_step   full-sequence causal forward through the flash kernel;
                   the head is applied to the last position only
    decode_step    one token with the KV cache (written in place)

Every entry point takes ``attn_impl`` / ``norm_impl`` (auto | cuda | ref)
for the flash and RMSNorm ops: ``auto`` launches the hand-written
kernels on a CUDA tensor and runs the plain versions on the CPU.

    >>> import torch
    >>> from repro_torch.configs import get_config
    >>> from repro_torch.models.transformer import init_params, prefill_step
    >>> cfg = get_config("qwen2-0.5b").smoke().model_cfg
    >>> model = init_params(cfg, seed=0, device="cpu")
    >>> prefill_step(model, torch.zeros((2, 8), dtype=torch.long)).shape
    torch.Size([2, 512])
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from ..core.engine_torch import resolve_device
from ..layers.attention import GQAAttention, init_gqa_cache
from ..layers.common import RMSNorm, dense_init, embed_init
from ..layers.mlp import SwiGLU


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    attn_kind: str = "gqa"              # gqa | mla
    # MLA
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0          # leading dense layers (DeepSeek: 1)
    capacity_factor: float = 1.25
    dtype: Any = torch.bfloat16
    remat: bool = True

    @property
    def n_params(self) -> int:
        """Total parameter count."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        if self.attn_kind == "mla":
            attn = (d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.n_heads
                    * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        else:
            attn = d * self.d_head * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * self.d_head * d
        if self.moe:
            ffn_moe = (d * self.n_experts + 3 * self.n_experts * d
                       * self.moe_d_ff + 3 * d * self.moe_d_ff
                       * self.n_shared)
            ffn_dense = 3 * d * self.d_ff
            ffn = (ffn_moe * (L - self.first_dense_layers)
                   + ffn_dense * self.first_dense_layers) / L
        else:
            ffn = 3 * d * self.d_ff
        emb = V * d * (1 if self.tie_embeddings else 2)
        return int(L * (attn + ffn + 2 * d) + emb + d)

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of routed + shared)."""
        if not self.moe:
            return self.n_params
        d, L = self.d_model, self.n_layers
        if self.attn_kind == "mla":
            attn = (d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                    + d * (self.kv_lora_rank + self.qk_rope_dim)
                    + self.kv_lora_rank * self.n_heads
                    * (self.qk_nope_dim + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        else:
            attn = d * self.d_head * (self.n_heads + 2 * self.n_kv_heads) \
                + self.n_heads * self.d_head * d
        ffn_act = (d * self.n_experts
                   + 3 * self.top_k * d * self.moe_d_ff
                   + 3 * d * self.moe_d_ff * self.n_shared)
        ffn_dense = 3 * d * self.d_ff
        ffn = (ffn_act * (L - self.first_dense_layers)
               + ffn_dense * self.first_dense_layers) / L
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(L * (attn + ffn + 2 * d) + emb + d)


def _check_supported(cfg: LMConfig) -> None:
    if cfg.moe or cfg.attn_kind == "mla":
        raise NotImplementedError(
            f"{cfg.name}: MoE and MLA models come with the MoE/MLA slice of "
            "the port; this one runs dense GQA models only")


class Block(nn.Module):
    """Pre-norm block: ``x + attn(norm1(x))``, then ``+ ffn(norm2(x))``."""

    def __init__(self, cfg: LMConfig, gen: torch.Generator):
        super().__init__()
        dev = gen.device
        self.attn = GQAAttention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.d_head, cfg.qkv_bias, cfg.dtype, gen,
                                 cfg.rope_theta)
        self.ffn = SwiGLU(cfg.d_model, cfg.d_ff, cfg.dtype, gen)
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, dev)
        self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, dev)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Dict] = None, attn_impl: str = "auto",
                norm_impl: str = "auto") -> torch.Tensor:
        h, _ = self.attn(self.norm1(x, impl=norm_impl), positions,
                         cache=cache, attn_impl=attn_impl)
        x = x + h
        return x + self.ffn(self.norm2(x, impl=norm_impl))


class Transformer(nn.Module):
    """Token embedding, ``n_layers`` blocks, final RMSNorm and the head
    (the embedding's transpose when tied, else ``lm_head [D, V]``).
    Parameters are drawn from ``gen`` on its device, in ``cfg.dtype``;
    biases start at 0 and norm gains at 1, as in the reference."""

    def __init__(self, cfg: LMConfig, gen: torch.Generator):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(embed_init(gen, (cfg.vocab, cfg.d_model),
                                             cfg.dtype))
        self.layers = nn.ModuleList(Block(cfg, gen)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype,
                                  gen.device)
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(
            dense_init(gen, (cfg.d_model, cfg.vocab), cfg.dtype))

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                caches: Optional[List[Dict]] = None,
                attn_impl: str = "auto", norm_impl: str = "auto",
                last_only: bool = False) -> torch.Tensor:
        """tokens [B, T] -> logits [B, T, V] (``[B, 1, V]`` with
        ``last_only``: the head on the last position alone, which is all
        ``logits[:, -1]`` depends on)."""
        b, t = tokens.shape
        if positions is None:
            positions = torch.arange(t, device=tokens.device).expand(b, t)
        x = self.embed[tokens].to(self.cfg.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x, positions, None if caches is None else caches[i],
                      attn_impl=attn_impl, norm_impl=norm_impl)
        if last_only:
            x = x[:, -1:].contiguous()          # the norm kernel's layout
        x = self.final_norm(x, impl=norm_impl)
        head = self.embed.T if self.lm_head is None else self.lm_head
        return x @ head


def init_params(cfg: LMConfig, seed: int = 0, device=None) -> Transformer:
    """A :class:`Transformer` drawn from ``torch.Generator(device)`` seeded
    with ``seed``, on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Transformer(cfg, gen)


def forward(model: Transformer, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[List[Dict]] = None, attn_impl: str = "auto",
            norm_impl: str = "auto"
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[List[Dict]]]:
    """tokens [B, T] -> (logits [B, T, V], aux_loss, caches), as the
    reference; aux is 0 for a dense model."""
    logits = model(tokens, positions, caches, attn_impl=attn_impl,
                   norm_impl=norm_impl)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return logits, aux, caches


def init_caches(cfg: LMConfig, b: int, s_max: int, device=None
                ) -> List[Dict]:
    """One ``{k, v, length}`` cache per layer, ``[B, s_max, Hkv, dh]``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    return [init_gqa_cache(b, s_max, cfg.n_kv_heads, cfg.d_head, cfg.dtype,
                           dev) for _ in range(cfg.n_layers)]


@torch.inference_mode()
def decode_step(model: Transformer, caches: List[Dict],
                tokens: torch.Tensor, position: int,
                norm_impl: str = "auto"
                ) -> Tuple[torch.Tensor, List[Dict]]:
    """One-token decode: tokens [B, 1], ``position`` feeds RoPE (the cache
    length). Returns (logits [B, V], the caches, written in place)."""
    b = tokens.shape[0]
    positions = torch.full((b, 1), position, dtype=torch.long,
                           device=tokens.device)
    logits = model(tokens, positions, caches, norm_impl=norm_impl)
    return logits[:, -1], caches


@torch.inference_mode()
def prefill_step(model: Transformer, tokens: torch.Tensor,
                 attn_impl: str = "auto", norm_impl: str = "auto"
                 ) -> torch.Tensor:
    """Prefill forward: tokens [B, T] -> last-position logits [B, V] (cache
    population elided, as in the reference's step)."""
    return model(tokens, attn_impl=attn_impl, norm_impl=norm_impl,
                 last_only=True)[:, -1]
