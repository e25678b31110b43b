"""Decoder-only transformer LM covering the five LM architectures.

Counterpart of ``repro/models/transformer.py``:

    phi4-mini-3.8b      dense, GQA(24/8)
    qwen2-0.5b          dense, GQA(14/2), QKV bias
    qwen2.5-3b          dense, GQA(16/2), QKV bias
    deepseek-v2-lite    MoE (64 routed top-6 + 2 shared), MLA, 1 dense layer
    granite-moe-3b      MoE (40 routed top-8), GQA(24/8)

Layers run as a Python loop over one ``ModuleList``, ``layers.{i}``: the
``first_dense_layers`` dense blocks of an MoE model first, then its MoE
blocks (the reference scans two stacks of parameters, ``dense_layers``
and ``moe_layers``; ``repro_torch.convert.lm_state_dict_from_numpy``
splits their ``[L, ...]`` leaves per layer, the dense prefix first).
Step functions:

    forward        tokens [B, T] -> (logits [B, T, V], aux, caches); aux
                   is the MoE layers' summed load-balance loss
    loss_fn        mean next-token cross entropy + aux of a batch (training,
                   every model: MLA through the flash backward at q/k 192
                   and v 128, MoE through the layer's gather-based
                   backward)
    decay_mask     which parameters AdamW decays (the reference's layout)
    prefill_step   full-sequence causal forward through the flash kernel;
                   the head is applied to the last position only
    decode_step    one token with the KV cache (written in place)

Under autograd with ``cfg.remat`` each ``Block`` runs under
``torch.utils.checkpoint`` (non-reentrant): its activations are not kept
but recomputed in the backward, the counterpart of the reference's
``jax.checkpoint(..., nothing_saveable)`` per scanned layer. The
recompute runs the block's flash and RMSNorm forwards a second time.

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
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from torch.utils.checkpoint import checkpoint

from ..core.engine_torch import resolve_device
from ..layers.attention import (GQAAttention, MLAAttention, init_gqa_cache,
                                init_mla_cache)
from ..layers.common import (NO_SHARD, RMSNorm, ShardCtx, _is_dtensor,
                             dense_init, embed_init, softmax_cross_entropy)
from ..layers.embedding_bag import lookup_sharded
from ..layers.mlp import SwiGLU
from ..layers.moe import MoE


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


class Block(nn.Module):
    """Pre-norm block: ``x + attn(norm1(x))``, then ``+ ffn(norm2(x))``;
    attention is MLA or GQA by ``cfg.attn_kind`` and the FFN an
    :class:`~repro_torch.layers.moe.MoE` (``moe_layer``) or a SwiGLU."""

    def __init__(self, cfg: LMConfig, gen: torch.Generator,
                 moe_layer: bool = False):
        super().__init__()
        dev = gen.device
        if cfg.attn_kind == "mla":
            self.attn = MLAAttention(cfg.d_model, cfg.n_heads,
                                     cfg.kv_lora_rank, cfg.qk_nope_dim,
                                     cfg.qk_rope_dim, cfg.v_head_dim,
                                     cfg.dtype, gen, cfg.rope_theta)
        else:
            self.attn = GQAAttention(cfg.d_model, cfg.n_heads,
                                     cfg.n_kv_heads, cfg.d_head,
                                     cfg.qkv_bias, cfg.dtype, gen,
                                     cfg.rope_theta)
        self.moe = moe_layer
        self.ffn = MoE(cfg.d_model, cfg.n_experts, cfg.moe_d_ff,
                       cfg.n_shared, cfg.top_k, cfg.capacity_factor,
                       cfg.dtype, gen) if moe_layer else \
            SwiGLU(cfg.d_model, cfg.d_ff, cfg.dtype, gen)
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, dev)
        self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype, dev)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[Dict] = None, attn_impl: str = "auto",
                norm_impl: str = "auto", ctx: ShardCtx = NO_SHARD
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> (x [B, T, D], the block's aux loss; None for a dense FFN, so
        a dense block launches nothing for it)."""
        h, _ = self.attn(self.norm1(x, impl=norm_impl), positions,
                         cache=cache, attn_impl=attn_impl,
                         norm_impl=norm_impl, ctx=ctx)
        x = x + h
        hin = self.norm2(x, impl=norm_impl)
        if self.moe:
            h, aux = self.ffn(hin, ctx)
            return x + h, aux
        return x + self.ffn(hin, ctx), None


class Transformer(nn.Module):
    """Token embedding, ``n_layers`` blocks, final RMSNorm and the head
    (the embedding's transpose when tied, else ``lm_head [D, V]``).
    Parameters are drawn from ``gen`` on its device, in ``cfg.dtype``;
    biases start at 0 and norm gains at 1, as in the reference."""

    def __init__(self, cfg: LMConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed_init(gen, (cfg.vocab, cfg.d_model),
                                             cfg.dtype))
        n_dense = cfg.first_dense_layers if cfg.moe else cfg.n_layers
        self.layers = nn.ModuleList(Block(cfg, gen, moe_layer=i >= n_dense)
                                    for i in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, cfg.dtype,
                                  gen.device)
        self.lm_head = None if cfg.tie_embeddings else nn.Parameter(
            dense_init(gen, (cfg.d_model, cfg.vocab), cfg.dtype))

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                caches: Optional[List[Dict]] = None,
                attn_impl: str = "auto", norm_impl: str = "auto",
                last_only: bool = False, ctx: ShardCtx = NO_SHARD
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """tokens [B, T] -> (logits [B, T, V], aux: the MoE layers' summed
        load-balance loss, f32, or None for a dense model). ``last_only``
        gives ``[B, 1, V]``: the head on the last position alone, which is
        all ``logits[:, -1]`` depends on."""
        b, t = tokens.shape
        if positions is None:
            positions = torch.arange(t, device=tokens.device).expand(b, t)
        emb = self.embed[tokens] if ctx.mesh is None else \
            lookup_sharded(self.embed, tokens.long())
        x = ctx.shard(emb.to(self.cfg.dtype), ctx.dp, None, None)
        remat = self.cfg.remat and caches is None and torch.is_grad_enabled()
        aux = None
        for i, layer in enumerate(self.layers):
            if remat:
                x, a = checkpoint(layer, x, positions, None, attn_impl,
                                  norm_impl, ctx, use_reentrant=False)
            else:
                x, a = layer(x, positions,
                             None if caches is None else caches[i],
                             attn_impl=attn_impl, norm_impl=norm_impl,
                             ctx=ctx)
            if a is not None:
                aux = a if aux is None else aux + a
        if last_only:
            x = x[:, -1:].contiguous()          # the norm kernel's layout
        x = self.final_norm(x, impl=norm_impl)
        if ctx.mesh is not None and _is_dtensor(x):
            return _head_sharded(x, self.embed if self.lm_head is None
                                 else self.lm_head, self.lm_head is None,
                                 ctx), aux
        head = self.embed.T if self.lm_head is None else self.lm_head
        return x @ head, aux


def _head_sharded(x: torch.Tensor, w: torch.Tensor, tied: bool,
                  ctx: ShardCtx) -> torch.Tensor:
    """The logits ``x @ w`` (``w.T`` when ``tied``: the embedding ``[V,
    D]``) over a mesh, on local shards: x's rows over ``dp``, the weight
    gathered whole over ``dp`` and laid over ``tp`` on its vocab when
    ``tp`` divides it (else whole), the logits then ``[rows, vocab]``
    blocks. Every gradient's layout is stated: the weight's is a partial
    sum over the dp dims (each rank's rows) in the layout it was taken
    in, so both gradients of a tied embedding (this and the lookup's)
    reach the parameter in its own placements and add there; x's is a
    partial sum over tp when the vocab is split."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    from ..launch.shardings import mesh_shape, placements, sanitize_one
    mesh = ctx.mesh
    x = ctx.shard(x, ctx.dp, None, None)
    vdim = 0 if tied else 1
    spec = [None, None]
    spec[vdim] = ctx.tp
    want = placements(sanitize_one(tuple(spec), w.shape, mesh_shape(mesh),
                                   rehome=False), mesh)
    split = [isinstance(p, Shard) for p in want]
    wl = w.redistribute(mesh, want).to_local(grad_placements=[
        Partial() if isinstance(px, Shard) else pw
        for px, pw in zip(x.placements, want)])
    xl = x.to_local(grad_placements=[
        Partial() if sp else px for px, sp in zip(x.placements, split)])
    yl = xl @ (wl.T if tied else wl)
    return DTensor.from_local(yl, mesh, [
        Shard(2) if sp else px for px, sp in zip(x.placements, split)],
        run_check=False)


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
            norm_impl: str = "auto", ctx: ShardCtx = NO_SHARD
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[List[Dict]]]:
    """tokens [B, T] -> (logits [B, T, V], aux_loss, caches), as the
    reference; aux (f32) is the MoE layers' summed load-balance loss, 0
    for a dense model."""
    logits, aux = model(tokens, positions, caches, attn_impl=attn_impl,
                        norm_impl=norm_impl, ctx=ctx)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return logits, aux, caches


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor],
            attn_impl: str = "auto", norm_impl: str = "auto",
            ctx: ShardCtx = NO_SHARD
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss of a batch ``{tokens [B, T], labels [B, T]}`` on the
    model's device: ``(ce + aux, {"ce": ce, "aux": aux})`` with ``ce``
    the mean softmax cross entropy of the logits, as the reference's
    ``loss_fn``. Call it with autograd on (not under ``inference_mode``):
    the kernels then run with their backward kernels."""
    logits, aux, _ = forward(model, batch["tokens"], attn_impl=attn_impl,
                             norm_impl=norm_impl, ctx=ctx)
    ce = softmax_cross_entropy(logits, batch["labels"])
    return ce + aux, {"ce": ce, "aux": aux}


def decay_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """Which of the named parameters AdamW decays: the reference's rule,
    ``ndim >= 2``, taken on the reference's own leaf. The reference stacks
    each ``Block`` parameter into one ``[L, ...]`` leaf
    (``convert.lm_state_dict_from_numpy`` splits it per layer), so a
    ``layers.<i>.`` tensor has one dimension more there: its 1-D norm
    gains and QKV biases are decayed. ``embed`` and ``lm_head`` are
    decayed, ``final_norm`` (a ``[D]`` leaf there too) is not."""
    return {name: t.ndim + name.startswith("layers.") >= 2
            for name, t in params.items()}


def init_caches(cfg: LMConfig, b: int, s_max: int, device=None
                ) -> List[Dict]:
    """One cache per layer: GQA ``{k, v, length}`` of ``[B, s_max, Hkv,
    dh]``, or MLA ``{c_kv, k_rope, length}`` of ``[B, s_max, r]`` and
    ``[B, s_max, rope]``."""
    dev = resolve_device(device)
    if cfg.attn_kind == "mla":
        return [init_mla_cache(b, s_max, cfg.kv_lora_rank, cfg.qk_rope_dim,
                               cfg.dtype, dev) for _ in range(cfg.n_layers)]
    return [init_gqa_cache(b, s_max, cfg.n_kv_heads, cfg.d_head, cfg.dtype,
                           dev) for _ in range(cfg.n_layers)]


@torch.inference_mode()
def decode_step(model: Transformer, caches: List[Dict],
                tokens: torch.Tensor, position: int,
                norm_impl: str = "auto", ctx: ShardCtx = NO_SHARD
                ) -> Tuple[torch.Tensor, List[Dict]]:
    """One-token decode: tokens [B, 1], ``position`` feeds RoPE (the cache
    length). Returns (logits [B, V], the caches, written in place)."""
    b = tokens.shape[0]
    positions = torch.full((b, 1), position, dtype=torch.long,
                           device=tokens.device)
    logits, _ = model(tokens, positions, caches, norm_impl=norm_impl,
                      ctx=ctx)
    return logits[:, -1], caches


@torch.inference_mode()
def prefill_step(model: Transformer, tokens: torch.Tensor,
                 attn_impl: str = "auto", norm_impl: str = "auto",
                 ctx: ShardCtx = NO_SHARD) -> torch.Tensor:
    """Prefill forward: tokens [B, T] -> last-position logits [B, V] (cache
    population elided, as in the reference's step)."""
    return model(tokens, attn_impl=attn_impl, norm_impl=norm_impl,
                 last_only=True, ctx=ctx)[0][:, -1]
