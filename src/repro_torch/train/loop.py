"""Training loop with checkpoint/restart, failure injection and optional
manual data-parallel gradient compression.

Counterpart of ``repro/train/loop.py``. Two modes:

* one process (default): each step runs the whole global batch.
* manual data parallel (a ``group`` and ``grad_compression`` given): one
  process per rank of a ``torch.distributed`` group; each rank runs its
  :func:`~repro_torch.data.pipelines.process_slice` of the global batch,
  and the gradients are reduced across ranks by
  :func:`~repro_torch.distributed.compression.compressed_psum` (``int8``,
  with error feedback carried in the state) or by the uncompressed
  :func:`~repro_torch.distributed.compression.plain_psum_mean` (any other
  value), before every rank takes the same AdamW step. The reference runs
  this mode under ``shard_map`` over a mesh axis.

Fault tolerance: the loop checkpoints every ``ckpt_every`` steps through
:class:`~repro_torch.train.checkpoint.CheckpointManager` and starts from
``restore_or_init``; data is a pure function of the step, so killing the
process at any step and rerunning the same command resumes bit for bit
when the step itself is deterministic (on the card:
``torch.use_deterministic_algorithms(True)``; the port's kernels use no
atomics).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.engine_torch import resolve_device
from ..data.pipelines import process_slice
from ..distributed.compression import compressed_psum, plain_psum_mean
from .checkpoint import CheckpointManager
from .optimizer import AdamWConfig, adamw_init, make_train_step


@dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_every: int = 25
    log_every: int = 10
    fail_at_step: Optional[int] = None        # failure injection (tests)
    grad_compression: Optional[str] = None    # None | "int8" (manual DP)


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                           torch.Tensor]:
    """A numpy batch as tensors on ``device`` (integer ids as int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.array(v, order="C"))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        out[k] = t.to(device)
    return out


def run_training(loss_fn: Callable,
                 init_fn: Callable[[], Any],
                 batch_fn: Callable[[int], Dict[str, np.ndarray]],
                 opt_cfg: AdamWConfig,
                 loop_cfg: TrainLoopConfig,
                 ckpt: Optional[CheckpointManager] = None,
                 group=None,
                 device=None,
                 decay_mask: Optional[Callable[[Dict[str, torch.Tensor]],
                                               Dict[str, bool]]] = None
                 ) -> Dict[str, list]:
    """Generic driver, used by ``launch/train.py`` and the restart tests.

    ``loss_fn(model, batch) -> (loss, metrics)``; ``init_fn()`` returns
    the model (an ``nn.Module``) on ``device``; ``batch_fn(step)`` the
    global numpy batch. ``decay_mask(named parameters) -> {name: bool}``
    says once which parameters AdamW decays (default: ``ndim >= 2``).
    ``device`` defaults to the CUDA card (raises without one). Returns
    the metric history (host floats) and ``final_state``.
    """
    dev = resolve_device(device)
    use_manual_dp = loop_cfg.grad_compression is not None and \
        group is not None

    def init_state():
        model = init_fn()
        state = {"params": model,
                 "opt": adamw_init(dict(model.named_parameters()))}
        if use_manual_dp:
            state["err"] = {k: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device)
                            for k, p in model.named_parameters()}
        return state

    start_step = 0
    if ckpt is not None:
        state, start_step = ckpt.restore_or_init(init_state, dev)
    else:
        state = init_state()

    reduce_grads = None
    if use_manual_dp:
        rank, world = dist.get_rank(group), dist.get_world_size(group)

        def reduce_grads(grads):
            if loop_cfg.grad_compression == "int8":
                grads, state["err"] = compressed_psum(grads, group,
                                                      state["err"])
                return grads
            return plain_psum_mean(grads, group)

    decay = None if decay_mask is None else \
        decay_mask(dict(state["params"].named_parameters()))
    step_fn = make_train_step(loss_fn, opt_cfg, reduce_grads, decay)

    history: Dict[str, list] = {"step": [], "loss": []}
    t0 = time.time()
    for step in range(start_step, loop_cfg.steps):
        if loop_cfg.fail_at_step is not None and step == loop_cfg.fail_at_step:
            raise RuntimeError(f"injected failure at step {step}")
        batch = batch_fn(step)
        if use_manual_dp:
            batch = process_slice(batch, rank, world)
        model, opt, metrics = step_fn(state["params"], state["opt"],
                                      to_device(batch, dev))
        state["opt"] = opt
        if use_manual_dp:
            loss = metrics["loss_total"].reshape(1).clone()
            dist.all_reduce(loss, group=group)
            metrics["loss_total"] = loss[0] / world
        if ckpt is not None and (step + 1) % loop_cfg.ckpt_every == 0:
            ckpt.save(step + 1, state)
        if (step + 1) % loop_cfg.log_every == 0 or step == start_step:
            loss = float(metrics["loss_total"])
            history["step"].append(step + 1)
            history["loss"].append(loss)
            print(f"step {step + 1:5d} loss {loss:.4f} "
                  f"({(time.time() - t0):.1f}s)")
    history["final_state"] = state     # type: ignore
    return history
