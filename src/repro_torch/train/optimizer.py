"""AdamW + schedules over named parameters.

Counterpart of ``repro/train/optimizer.py``. Parameters are a dict
``name -> tensor`` (``dict(model.named_parameters())``); the optimizer
state keeps f32 ``m`` and ``v`` beside them, under the same names, and an
int32 step counter. The update is computed in f32 and cast once to each
parameter's dtype, as the reference's; unlike the reference, which
returns new arrays, the parameters and ``m``/``v`` are updated in place
(no second copy of the model and its state on the device).

Weight decay: the reference decays a leaf when ``ndim >= 2``, and that
is the default here, on each tensor. A model whose tensors are laid out
otherwise than the reference's leaves passes its own ``{name: bool}``
mask (``decay=`` here, ``decay_mask=`` to the loop), computed once from
its named parameters: the Transformer's
:func:`~repro_torch.models.transformer.decay_mask` decays its 1-D
``Block`` norm gains and QKV biases, which the reference stacks into
``[L, ...]`` leaves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor                # int32 scalar
    m: Params                         # f32, by parameter name
    v: Params


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``cfg.lr``, then a cosine down to
    ``min_lr_ratio * lr``; in f32, from an integer ``step`` tensor."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the f32 sum of squares over every tensor (in the dict's
    order; the reference sums its leaves in its tree's order)."""
    total = None
    for x in tree.values():
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(tree: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    """Scale every tensor by ``min(1, max_norm / (norm + 1e-9))`` in f32,
    cast back to its dtype; returns (clipped, norm)."""
    g = global_norm(tree)
    scale = torch.clamp(max_norm / (g + 1e-9), max=1.0)
    return {k: (x.float() * scale).to(x.dtype) for k, x in tree.items()}, g


def adamw_init(params: Params) -> AdamWState:
    """Zero f32 moments beside each parameter, on its device; step 0."""
    dev = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()},
        v={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()})


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Params, state: AdamWState,
                 params: Params, decay: Optional[Mapping[str, bool]] = None
                 ) -> Tuple[Params, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step with global-norm clipping and the cosine schedule.
    ``decay`` says by name which parameters are decayed (default: those
    with ``ndim >= 2``, the reference's rule). Updates ``params`` and the
    moments in place and returns ``(params, new state, {"lr",
    "grad_norm"})``."""
    if decay is None:
        decay = {k: p.ndim >= 2 for k, p in params.items()}
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    stepf = step.float()
    b1c = 1 - cfg.b1 ** stepf
    b2c = 1 - cfg.b2 ** stepf
    for name, p in params.items():
        gf = grads[name].float()
        m, v = state.m[name], state.v[name]
        m2 = cfg.b1 * m + (1 - cfg.b1) * gf
        v2 = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
        if decay[name]:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(m2)
        v.copy_(v2)
    return params, AdamWState(step=step, m=state.m, v=state.v), \
        {"lr": lr, "grad_norm": gnorm}


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    reduce_grads: Optional[Callable[[Params], Params]] = None,
                    decay: Optional[Mapping[str, bool]] = None):
    """``loss_fn(model, batch) -> (loss, metrics)``. Returns
    ``step(model, opt_state, batch) -> (model, opt_state', metrics)``:
    forward and backward (``loss.backward()``), ``reduce_grads`` on the
    gradients by name when given (the data-parallel reduction), then
    :func:`adamw_update` with the ``decay`` mask, which updates the model
    in place."""

    def step(model, opt_state: AdamWState, batch):
        model.zero_grad(set_to_none=True)
        loss, metrics = loss_fn(model, batch)
        loss.backward()
        params = dict(model.named_parameters())
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        if reduce_grads is not None:
            grads = reduce_grads(grads)
        model.zero_grad(set_to_none=True)
        _, new_state, opt_metrics = adamw_update(opt_cfg, grads, opt_state,
                                                 params, decay)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        metrics["loss_total"] = loss.detach()
        return model, new_state, metrics

    return step
