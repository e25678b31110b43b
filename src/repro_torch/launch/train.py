"""End-to-end training launcher of the port (LM family).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        [--smoke] --steps 200 --seq 256 --batch 16 [--lr 1e-3] \\
        [--ckpt-dir DIR --ckpt-every 50] [--grad-compression int8] \\
        [--device cpu]

Counterpart of ``repro.launch.train`` for the ``lm`` family: random
weights from seed 0, the synthetic ``LMStream``, AdamW with a warm-up of
a twentieth of the steps and a cosine to ``--steps``. Checkpoint/restart:
rerunning the same command with ``--ckpt-dir`` resumes from the latest
checkpoint. As in the reference's CLI, which passes no mesh,
``--grad-compression`` reaches the loop but changes nothing in this one
process: the manual data-parallel branch needs ``run_training`` called
with a process group in every rank. Runs on the card unless ``--device
cpu`` is given, and raises without one. The MoE and MLA models
(granite-moe-3b-a800m, deepseek-v2-lite-16b) train on the CPU only: on
the card they raise ``NotImplementedError`` until the MoE/MLA training
slice. The recsys and GNN families come with later slices.
"""

from __future__ import annotations

import argparse


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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "when there is none)")
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..core.engine_torch import resolve_device
    from ..data.pipelines import LMStream
    from ..train.checkpoint import CheckpointManager
    from ..train.loop import TrainLoopConfig, run_training
    from ..train.optimizer import AdamWConfig

    spec = get_config(args.arch)
    if args.smoke:
        spec = spec.smoke()
    cfg = spec.model_cfg
    if spec.family == "recsys":
        raise NotImplementedError("the recsys (BST) family comes with the "
                                  "recsys slice of the port")
    if spec.family == "gnn":
        raise NotImplementedError("the GNN family comes with the GNN slice "
                                  "of the port")
    if spec.family != "lm":
        raise SystemExit(f"family {spec.family}: use launch/enumerate.py")
    dev = resolve_device(args.device)

    from ..models.transformer import (check_trainable, decay_mask,
                                      init_params, loss_fn)
    check_trainable(cfg, dev)
    stream = LMStream(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                      decay_steps=args.steps)
    hist = run_training(
        loss_fn, lambda: init_params(cfg, seed=0, device=dev), stream.batch,
        opt,
        TrainLoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                        log_every=max(args.steps // 20, 1),
                        grad_compression=args.grad_compression),
        ckpt=ckpt, device=dev, decay_mask=decay_mask)
    print(f"final loss: {hist['loss'][-1]:.4f} "
          f"(first: {hist['loss'][0]:.4f})")
    return hist


if __name__ == "__main__":
    main()
