"""Serving launcher of the port: batched LM decode with a KV cache, or
batched CTR scoring (BST).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        [--smoke] --batch 4 --prompt-len 16 --decode-steps 32 \\
        --cache-len 128 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch bst \\
        [--smoke] --batch 512 --decode-steps 32 [--device cpu]

``--arch`` takes the five LMs (qwen2-0.5b, qwen2.5-3b, phi4-mini-3.8b and
the MoE models granite-moe-3b-a800m (GQA) and deepseek-v2-lite-16b
(MLA)) and the recsys model bst.

Counterpart of ``repro.launch.serve``. LMs: random weights from seed 0, a
random prompt, token-by-token prefill through ``decode_step`` (exercising
the cache), then greedy decode; the same ``prefill … tok/s`` and
``sample:`` lines. BST: random weights from seed 0 and
``--decode-steps`` batches of ``--batch`` rows of ``RecsysStream``
scored by ``bst_serve``; the same ``req/s`` and ``mean CTR`` line. Runs
on the card unless ``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch


def serve_loop(model, prompt: torch.Tensor, decode_steps: int,
               cache_len: int, norm_impl: str = "auto",
               forced: Optional[torch.Tensor] = None) -> Dict:
    """The serve loop: prefill ``prompt`` [B, P] token by token through
    ``decode_step``, then ``decode_steps`` greedy steps. With ``forced``
    [B, decode_steps] the decode steps feed those tokens instead of the
    argmax (teacher forcing). Returns ``tokens`` (the argmax after each
    prompt-final and decode step but the last, [B, decode_steps]),
    ``logits`` (every step's, [P + decode_steps, B, V]) and ``seconds``
    (host clock, synchronised on a card)."""
    from ..models.transformer import decode_step, init_caches
    dev = prompt.device
    b, pl = prompt.shape
    caches = init_caches(model.cfg, b, cache_len, device=dev)
    step_logits, generated = [], []
    with torch.inference_mode():
        t0 = time.time()
        for i in range(pl):
            logits, caches = decode_step(model, caches, prompt[:, i:i + 1],
                                         i, norm_impl=norm_impl)
            step_logits.append(logits)
        for i in range(decode_steps):
            tok = logits.argmax(dim=-1)[:, None]
            generated.append(tok[:, 0])
            if forced is not None:
                tok = forced[:, i:i + 1]
            logits, caches = decode_step(model, caches, tok, pl + i,
                                         norm_impl=norm_impl)
            step_logits.append(logits)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.time() - t0
    return {"tokens": torch.stack(generated, 1),
            "logits": torch.stack(step_logits), "seconds": seconds}


def serve_recsys(cfg, batch: int, steps: int, dev):
    """The BST serving loop: ``steps`` batches of ``batch`` rows of
    ``RecsysStream`` (made on the host, moved to ``dev``) scored by
    ``bst_serve`` on weights from seed 0. Returns the last batch's CTRs
    and the loop's seconds (host clock, synchronised on a card)."""
    from ..data.pipelines import RecsysStream
    from ..models.bst import bst_serve, init_bst_params
    from ..train.loop import to_device
    model = init_bst_params(cfg, seed=0, device=dev)
    stream = RecsysStream(cfg.n_items, cfg.n_user_feats, cfg.seq_len,
                          cfg.user_feat_len, batch)
    with torch.inference_mode():
        t0 = time.time()
        for i in range(steps):
            scores = bst_serve(model, to_device(stream.batch(i), dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.time() - t0
    return scores, seconds


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "when there is none)")
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..core.engine_torch import resolve_device
    from ..models.transformer import init_params
    spec = get_config(args.arch)
    if args.smoke:
        spec = spec.smoke()
    cfg = spec.model_cfg
    dev = resolve_device(args.device)

    if spec.family == "recsys":
        scores, dt = serve_recsys(cfg, args.batch, args.decode_steps, dev)
        print(f"{args.decode_steps} batches of {args.batch}: {dt:.2f}s "
              f"({args.decode_steps * args.batch / dt:.0f} req/s); "
              f"mean CTR {float(scores.mean()):.3f}")
        return scores

    rng = np.random.default_rng(0)
    model = init_params(cfg, seed=0, device=dev)
    b, pl = args.batch, args.prompt_len
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, pl)).astype(np.int64)).to(dev)
    out = serve_loop(model, prompt, args.decode_steps, args.cache_len)
    dt = out["seconds"]
    toks = b * (pl + args.decode_steps)
    print(f"prefill {pl} + decode {args.decode_steps} x batch {b}: "
          f"{dt:.2f}s ({toks / dt:.0f} tok/s)")
    print("sample:", out["tokens"][0][:16].tolist())


if __name__ == "__main__":
    main()
