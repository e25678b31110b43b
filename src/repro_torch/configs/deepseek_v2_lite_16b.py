"""deepseek-v2-lite-16b [moe] — arXiv:2405.04434 (hf).

27L d_model=2048 16H, MLA kv_lora=512 (qk_nope=128, qk_rope=64, v=128),
vocab=102400, MoE d_ff=1408, 2 shared + 64 routed top-6, first layer dense
(d_ff=10944). (V2-Lite is 64 routed + 2 shared; the 160 routed experts of
the assignment block's note belong to the full V2.)
"""

import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_shapes, lm_smoke_shapes

CONFIG = LMConfig(
    name="deepseek-v2-lite-16b",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=10944, vocab=102400, rope_theta=10000.0,
    tie_embeddings=False, attn_kind="mla",
    kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    moe=True, n_experts=64, n_shared=2, top_k=6, moe_d_ff=1408,
    first_dense_layers=1, dtype=torch.bfloat16)


def _smoke() -> ArchSpec:
    cfg = LMConfig(name="dsv2-smoke", n_layers=3, d_model=128, n_heads=4,
                   n_kv_heads=4, d_head=32, d_ff=256, vocab=512,
                   attn_kind="mla", kv_lora_rank=64, qk_nope_dim=32,
                   qk_rope_dim=16, v_head_dim=32,
                   moe=True, n_experts=8, n_shared=2, top_k=2, moe_d_ff=64,
                   first_dense_layers=1, dtype=torch.float32, remat=False)
    return ArchSpec(
        name="deepseek-v2-lite-16b/smoke", family="lm", model_cfg=cfg,
        shapes=lm_smoke_shapes())


SPEC = ArchSpec(
    name="deepseek-v2-lite-16b", family="lm", model_cfg=CONFIG,
    shapes=lm_shapes(), source="arXiv:2405.04434; hf",
    applicability=("BENU inapplicable; MoE experts sharded over the model "
                   "axis (EP), MLA compressed KV cache in decode"),
    smoke_builder=_smoke)
