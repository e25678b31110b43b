"""End-to-end LM training with checkpoint/restart, on the port.

Counterpart of ``examples/train_lm.py`` that imports only ``repro_torch``:
the reduced qwen2-family config ``qwen2-micro`` (the full 0.5B trains
through ``repro_torch.launch.train``, the same pieces) for a few hundred
steps on the synthetic compressible token stream, checkpointing every 50
steps into ``--ckpt-dir``. Re-running the script with the same directory
resumes from its last checkpoint. On the card unless ``--device cpu``.

    PYTHONPATH=src python examples/train_lm_torch.py [steps] \\
        [--ckpt-dir DIR] [--device cpu]
"""

import argparse
import os

import torch

from repro_torch.core.engine_torch import resolve_device
from repro_torch.data.pipelines import LMStream
from repro_torch.models.transformer import (LMConfig, decay_mask,
                                            init_params, loss_fn)
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.optimizer import AdamWConfig

CFG = LMConfig(name="qwen2-micro", n_layers=4, d_model=256, n_heads=8,
               n_kv_heads=2, d_head=32, d_ff=1024, vocab=4096,
               qkv_bias=True, tie_embeddings=True, dtype=torch.float32,
               remat=False)
CKPT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "train_lm_ckpt")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("steps", type=int, nargs="?", default=200)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR,
                    help="checkpoints (a rerun with the same directory "
                         "resumes from its latest)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "when there is none)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"model: {CFG.n_params / 1e6:.1f}M params")

    stream = LMStream(vocab=CFG.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    ckpt = CheckpointManager(args.ckpt_dir, keep=2)
    hist = run_training(
        loss_fn, lambda: init_params(CFG, seed=0, device=dev),
        stream.batch,
        AdamWConfig(lr=6e-4, warmup_steps=20, decay_steps=args.steps),
        TrainLoopConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                        log_every=args.log_every),
        ckpt=ckpt, device=dev, decay_mask=decay_mask)
    if hist["loss"]:
        print(f"loss: {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f} "
              f"(checkpoints in {args.ckpt_dir})")
    else:
        print(f"nothing to do: {args.ckpt_dir} holds step {args.steps}")
    return hist


if __name__ == "__main__":
    main()
