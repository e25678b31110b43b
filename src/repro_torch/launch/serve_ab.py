"""Time this checkout's LM serving path against another checkout's, on one
CUDA card, in one process.

    git archive <commit> src/repro_torch | tar -x -C build/other
    python -m repro_torch.launch.serve_ab --other build/other/src

The other checkout's ``repro_torch`` is loaded beside this one under
another name (``rmsnorm_ab.load_other``) and builds its kernels into its
own ``build/``. Each side draws ``--arch`` (default qwen2-0.5b, bf16) from
``--seed`` on the card, so both hold the same weights. Each of ``--rounds``
rounds measures both sides, in an order that alternates from round to
round (other, this, this, other, ...):

* prefill tok/s: ``prefill_step`` at 4 x 4096 tokens with the kernels,
  host clock around a synchronised call, the median of ``--prefills``;
* serve-loop tok/s: ``serve_loop`` at batch 4, prompt 16, 32 greedy
  steps, cache 128 (the serve CLI's defaults), (16 + 32) x 4 tokens over
  its synchronised host seconds.

Before the rounds it prints each side's device kernels in one prefill and
in one decode step (``torch.profiler``), and how far this side's prefill
logits are from the other's. Prints every round, the medians, and last one
JSON object of the medians.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import time
from pathlib import Path

import torch

from .rmsnorm_ab import load_other

BATCH, SEQ = 4, 4096
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, SERVE_CACHE = 4, 16, 32, 128


def device_kernels(fn) -> int:
    """The device kernels one call of ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def prefill_seconds(prefill, model, tokens) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prefill(model, tokens)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="a src directory holding another repro_torch")
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--prefills", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("serve_ab needs a CUDA card")
    load_other(args.other.resolve())
    dev = torch.device("cuda", 0)
    sides = {}
    for side, pkg in (("other", "repro_torch_other"),
                      ("this", __package__.split(".")[0])):
        configs = importlib.import_module(f"{pkg}.configs")
        tf = importlib.import_module(f"{pkg}.models.transformer")
        serve = importlib.import_module(f"{pkg}.launch.serve")
        cfg = configs.get_config(args.arch).model_cfg
        sides[side] = (tf.init_params(cfg, seed=args.seed, device=dev),
                       tf.prefill_step, tf.decode_step, tf.init_caches,
                       serve.serve_loop)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    vocab = sides["this"][0].cfg.vocab
    tokens = torch.randint(0, vocab, (BATCH, SEQ), generator=gen, device=dev)
    prompt = torch.randint(0, vocab, (SERVE_BATCH, SERVE_PROMPT),
                           generator=gen, device=dev)

    logits = {}
    for side, (model, prefill, decode, init_caches, loop) in sides.items():
        logits[side] = prefill(model, tokens)
        caches = init_caches(model.cfg, SERVE_BATCH, SERVE_CACHE, device=dev)
        n_pre = device_kernels(lambda: prefill(model, tokens))
        n_dec = device_kernels(lambda: decode(model, caches, prompt[:, :1],
                                              0))
        print(f"{side}: {n_pre} device kernels a prefill, {n_dec} a decode "
              "step")
        loop(model, prompt, 2, SERVE_CACHE)                 # warm-up
    diff = float((logits["this"].float() - logits["other"].float())
                 .abs().max())
    print(f"prefill logits, this vs other: max_abs_diff {diff:.4g}")

    got = {k: {"prefill_tok_s": [], "serve_tok_s": []} for k in sides}
    for r in range(args.rounds):
        order = list(sides) if r % 2 == 0 else list(sides)[::-1]
        for side in order:
            model, prefill, _, _, loop = sides[side]
            secs = statistics.median(prefill_seconds(prefill, model, tokens)
                                     for _ in range(args.prefills))
            got[side]["prefill_tok_s"].append(BATCH * SEQ / secs)
            out = loop(model, prompt, SERVE_STEPS, SERVE_CACHE)
            got[side]["serve_tok_s"].append(
                SERVE_BATCH * (SERVE_PROMPT + SERVE_STEPS) / out["seconds"])
    summary = {}
    for side, metrics in got.items():
        for m, v in metrics.items():
            print(f"{args.arch} {side} {m}: rounds {[round(t, 1) for t in v]}"
                  f", median {statistics.median(v):.1f}")
            summary[f"{side} {m}"] = statistics.median(v)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
