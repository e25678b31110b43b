"""End-to-end training launcher of the port (LM and recsys families).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        [--smoke] --steps 200 --seq 256 --batch 16 [--lr 1e-3] \\
        [--ckpt-dir DIR --ckpt-every 50] [--grad-compression int8] \\
        [--layers N] [--device cpu]

Counterpart of ``repro.launch.train`` for the ``lm`` and ``recsys``
families: random weights from seed 0, the synthetic ``LMStream`` (BST:
``RecsysStream`` of ``--batch`` rows, ``bst_loss``), AdamW with a warm-up
of a twentieth of the steps and a cosine to ``--steps``. On the card
the steps run under ``torch.use_deterministic_algorithms(True)``.
Checkpoint/restart: rerunning the same command with ``--ckpt-dir``
resumes from the latest checkpoint. As in the reference's CLI, which passes no mesh,
``--grad-compression`` reaches the loop but changes nothing in this one
process: the manual data-parallel branch needs ``run_training`` called
with a process group in every rank. Runs on the card unless ``--device
cpu`` is given, and raises without one. Every LM trains, the MoE and
MLA models (granite-moe-3b-a800m, deepseek-v2-lite-16b) among them.
``--layers N`` keeps the first N layers of an LM (its dense prefix
first): deepseek-v2-lite-16b's 15.7 B parameters take 12 bytes each in
training (bf16 weights and gradients, f32 AdamW moments), 188 GB, so on
one 80 GB card it trains at ``--layers 4`` (the dense layer and three
MoE layers; see PERF.md). The GNN family comes with a later slice.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", choices=["int8"], default=None)
    ap.add_argument("--layers", type=int, default=None,
                    help="LMs: train the first N layers only")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "when there is none)")
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..core.engine_torch import resolve_device
    from ..data.pipelines import LMStream, RecsysStream
    from ..train.checkpoint import CheckpointManager
    from ..train.loop import TrainLoopConfig, run_training
    from ..train.optimizer import AdamWConfig

    spec = get_config(args.arch)
    if args.smoke:
        spec = spec.smoke()
    cfg = spec.model_cfg
    if spec.family == "gnn":
        raise NotImplementedError("the GNN family comes with the GNN slice "
                                  "of the port")
    if spec.family not in ("lm", "recsys"):
        raise SystemExit(f"family {spec.family}: use launch/enumerate.py")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # a resumed run repeats the uninterrupted one bit for bit only if
        # every step is deterministic; cuBLAS is with a fixed workspace,
        # set before its first use in this process
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)

    if spec.family == "lm":
        from ..models.transformer import decay_mask, init_params, loss_fn
        if args.layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        stream = LMStream(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
        init_fn = lambda: init_params(cfg, seed=0, device=dev)
    else:
        from ..models.bst import (bst_decay_mask as decay_mask,
                                  bst_loss as loss_fn, init_bst_params)
        stream = RecsysStream(n_items=cfg.n_items,
                              n_user_feats=cfg.n_user_feats,
                              seq_len=cfg.seq_len,
                              user_feat_len=cfg.user_feat_len,
                              global_batch=args.batch)
        init_fn = lambda: init_bst_params(cfg, seed=0, device=dev)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                      decay_steps=args.steps)
    hist = run_training(
        loss_fn, init_fn, stream.batch, opt,
        TrainLoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                        log_every=max(args.steps // 20, 1),
                        grad_compression=args.grad_compression),
        ckpt=ckpt, device=dev, decay_mask=decay_mask)
    print(f"final loss: {hist['loss'][-1]:.4f} "
          f"(first: {hist['loss'][0]:.4f})")
    return hist


if __name__ == "__main__":
    main()
