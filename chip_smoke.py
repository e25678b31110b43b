#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's widths and B >= 65,536 rows: bit-equal (tolerance 0, the
   values are int32 set members), with each kernel's time beside the plain
   version's and the bound (least time at the card's memory bandwidth);
3. mid-size exactness on ``powerlaw(10_000, 8)``: ``torch``, ``torch-gpu``
   and (for the triangle and the 4-clique) the plain versions forced by
   explicit impl give identical counts and frontier sizes (and, for the
   house, match sets); one run with tiny capacities forces the adaptive
   split;
4. the main path at full size: triangle over every start vertex of
   ``powerlaw(1_000_000, 8)`` (padded rows ``[1_000_001, 3968]`` int32 on
   the card) through ``torch`` and ``torch-gpu``; both counts must equal an
   independent triangle count computed here from the host CSR with plain
   torch ops (no engine, no kernel). Each kernel's launch counter is set
   to 0 just before and read just after, and must be > 0;
5. the LM serving path at full width: qwen2-0.5b (bf16, random weights
   from a seeded generator on the card): ``prefill_step`` at 4 x 4096
   tokens with the kernels and with the plain versions, and the serve
   loop (batch 4, prompt 16, decode 32, cache 128), re-run teacher-forced
   with the plain versions; logits must agree within twice the bf16
   floor measured against the same weights in f32 (``LM_TOL_FLOORS``),
   and the launch counts must be 24 flash_attention and 49 rmsnorm per
   prefill forward, 0 and 49 per decode step. ``torch.profiler`` gives
   the device's busy share and its kernels by time for one prefill and a
   short serve loop;
6. out-of-core B-BENU (``oocache``: host row shards, a device row cache of
   12% of the rows plus 4% pinned hot rows): on phase 3's graph it equals
   the ``torch`` runs (counts, frontier sizes, the house match array), at
   zero capacity and under tiny caps; on phase 4's graph the triangle
   over all starts equals the independent count with prefetch on and off,
   the device holding under a quarter of the rows; cache counters, host
   seconds in ``lookup`` and (for the second run) the profiled busy share
   are printed;
7. streaming S-BENU: on a mid-size ``edge_stream`` (``SB_MID``) every step
   of ``sbenu-torch`` (device and host snapshot storage), the ``sbenu``
   interpreter and a tiny-caps run that splits equals the brute snapshot
   diff on five patterns; on the full stream (``SB_FULL``, widths pinned)
   every step of q1' equals an independent directed-3-cycle count from
   the edge keys (``cycle_trace``: sum((A A) o A^T), per reported match as
   fixed at mid size) and q2' on the kernel equals q2' on the binary
   probe, with one snapshot rebuild over the stream;
8. the multi-device engines over one NCCL process group of world size 1
   (one card; NCCL takes one rank a card), set up in this process through
   a file store in a temporary directory and destroyed at the end. 8a,
   before phase 7 (phase 4's graph is dropped there): ``dist`` over all
   starts of phase 4's graph, rebalanced, with no hot rows and with 4%
   of the rows replicated, equals the independent count and phase 4's
   level sizes (the second run profiled); on phase 3's graph the join
   baseline and ``dist`` equal phase 3's triangle and square counts, the
   join's shuffled bytes printed beside ``dist``'s cold rows x D x 4.
   8b, after phase 7: ``sbenu-dist`` on phase 7's full stream (the same
   G_0, batches, widths and plans) equals phase 7's q1' independent
   count and q2' ``sbenu-torch`` counts on every step, with one sharded
   snapshot build;
9. LM training at full width, right after phase 5, under
   ``torch.use_deterministic_algorithms(True)`` for torch's own ops
   (``CUBLAS_WORKSPACE_CONFIG`` is set at start-up for it): qwen2-0.5b in
   bf16 with remat, ``LMStream`` 4 x 4096 tokens a step, AdamW on the
   card. One step from the seeded weights with the kernels, one with the
   plain versions (``impl="ref"``) and one with the plain versions on the
   same weights in f32: the kernels' loss and grad norm must be within
   ``LM_TOL_FLOORS`` x the plain bf16 step's distance from the f32 one in
   the same quantity, each parameter's gradient (the L2 distance of that
   tensor alone) within ``LM_TOL_FLOORS`` x the plain bf16 step's
   distance from the f32 one in that tensor, and the updated parameters
   of each group (attention, MLP, norms, embedding) within
   ``LM_TOL_FLOORS`` x the group's distance from the f32 step's rounded
   to bf16; the kernel step
   launches exactly 48 flash forwards (24 + 24 recomputed by remat), 24
   flash backwards, 97 rmsnorm forwards (49 + 48) and 49 rmsnorm
   backwards, and the plain step none. Then ``run_training`` for
   ``TRAIN_STEPS`` steps with a checkpoint every ``TRAIN_CKPT_EVERY``
   (checkpoints under ``build/``, removed after), and a run that fails at
   step ``TRAIN_CKPT_EVERY`` and resumes from its checkpoint: the resumed
   steps' losses, the final parameters and AdamW moments must equal the
   uninterrupted run's bit for bit, every loss finite, the launches
   ``TRAIN_STEPS`` x a step's. It prints tokens/s of timed steps after the
   first, the peak device memory and a profiled step's busy share;
10. MoE and MLA serving at full width, after phase 9 and before the
   enumeration phases, one model at a time (freed after): granite-moe-
   3b-a800m (GQA 24/8, 40 experts top-8) and deepseek-v2-lite-16b (MLA,
   64 experts top-6 + 2 shared, a dense first layer), bf16 from seed 0 on
   the card. ``prefill_step`` at 4 x 4096 with the kernels (twice: the
   same bits) and with the plain versions; logits within
   ``LM_TOL_FLOORS`` x the plain bf16 run's distance from the same
   weights in f32 (granite: an f32 copy of the model; deepseek: block by
   block, ``prefill_f32_by_layer``), with the routing flips (tokens whose
   top-k expert set differs) between kernels and plain and between plain
   and f32 logged; exactly L flash_attention launches and 2L + 1 (GQA) or
   3L + 1 (MLA: its latent norm too) rmsnorm launches a prefill, 0 and
   the same a decode step, all rmsnorm launches on the register body;
   the device time of a prefill by kind of kernel and one MoE layer's
   stages (router, dispatch, gather, expert products, combine, shared);
   the serve loop as phase 5's, teacher-forced with the plain versions;
   decode after the prompt == ``prefill_step`` with ``capacity_factor =
   E / k`` (no drops: at the config's factor a 4-token decode step has
   one slot an expert);
11. MoE and MLA training at full width, after phase 10, under
   ``torch.use_deterministic_algorithms(True)``, on ``LMStream`` 4 x
   4096, one model at a time: granite-moe-3b-a800m at
   ``MOE_TRAIN_LAYERS`` layers (all 32) and deepseek-v2-lite-16b cut to
   its dense first layer and three MoE layers, bf16 with remat. A step's
   loss, grad norm and every gradient with the kernels against the plain
   versions, within ``LM_TOL_FLOORS`` x the plain bf16 step's distance
   from the same weights in f32 (phase 9's yardstick, tensor by tensor),
   all three on the kernel step's routing (``routing_fixed`` replays it,
   recomputing the gates from each run's probabilities; the tokens whose
   own top-k differs are logged as flips); the kernel step repeated gives
   the same bits and launches exactly 2L flash forwards, L flash
   backwards, 2nL + 1 rmsnorm forwards and nL + 1 backwards (n = 2 norms
   a layer, 3 with MLA's latent norm). Then ``MOE_TRAIN_STEPS`` AdamW
   steps with a checkpoint and a failed-and-resumed run that must equal
   the uninterrupted one bit for bit (at ``MOE_RESTART_LAYERS``: 4 and 2
   layers, checkpoints of ~4 and ~10 GiB), ``MOE_TIMED_STEPS`` steps at
   full depth from seed 0 (tok/s, peak memory; the loss must fall) and a
   profiled step (busy share, device time by kind of kernel, the flash
   backward's share);
12. BST (recsys) at full width (10^6 items), after phase 11: the serve
   CLI's loop at 512 and 262,144 rows a batch (req/s), retrieval of one
   user against 10^6 candidates in chunks sized from the bytes reckoned
   in the run, training at 65,536 rows a step under deterministic
   algorithms (a repeated step bit-equal, the loss falling, a checkpoint
   and a failed-and-resumed run bit-exact, rows/s, a profiled step); the
   CTRs, the retrieval logits, the loss and every gradient within
   ``BST_TOL`` of an f64 CPU run of the same weights on
   ``BST_CHECK_ROWS`` rows and candidates. BST runs no kernel of the
   port (attention at d_head 4 stays plain matrix products, as in the
   JAX package);
13. the GNN family at full width, last, inside phase 8's NCCL world of
   one, under deterministic algorithms (``phase_gnn``): gin-tu, pna,
   egnn and meshgraphnet at ``full_graph_sm`` and ``molecule`` (a step's
   loss and every gradient against an f64 CPU run of the same weights,
   within ``GNN_TOL`` or twice the f32 CPU run's own distance; then
   ``GNN_STEPS`` AdamW steps, the loss falling) and at ``minibatch_lg``
   (blocks of the ported ``MinibatchGraphStream``), each with s per step,
   nodes and edges per second, peak memory and a profiled step (busy
   share, the scatters' share); gin-tu's checkpoint restart bit-exact;
   ``launch/train.py --arch gin-tu``; ``gnn_dist`` on the NCCL rank equal
   to ``gnn_loss`` at ``full_graph_sm``, then gin-tu at ``ogb_products``
   (2,449,408 nodes, 123,718,280 edges) in bf16 with remat, the bytes of
   the three archs that do not fit logged; ``examples/
   motif_features_torch.py`` on the card, its per-vertex motif counts
   equal to a CPU run's. The GNNs run no kernel of the port (their
   segment sums are plain PyTorch, as they are plain jnp in the JAX
   package);
13b. the other examples on the card, as a user runs them
   (``phase_examples``): ``quickstart_torch.py`` (the match count equal
   to the brute force), ``continuous_enum_torch.py`` (each step's ΔR⁺
   and ΔR⁻ equal to the snapshot diff and to the interpreter) and
   ``train_lm_torch.py`` (the loss falling, a rerun resuming after the
   last checkpoint);
14. the dry-run tooling (``phase_dryrun``): each kernel op at its phase-2
   shape, its fake implementation's shape, dtype and strides equal to the
   launched kernel's, a launch through the dispatcher bit-equal to the
   ctypes launch, host µs a call of the ctypes launch, the dispatcher op
   and the wrapper; one qwen2-0.5b training step at phase 9's shape on
   a (1, 1) mesh (DTensor parameters, the model under a ``ShardCtx``:
   the program the dry-run traces) against the same step without a mesh,
   its loss and every gradient within ``LM_TOL_FLOORS`` x the no-mesh
   bf16 step's distance from its f32 one; ``launch/op_analysis.OpCounter``
   on that step (the flops split into kernel ops and matmuls, their
   ratio to 6·N·tokens plus the causal attention, the TFLOP/s of a step
   timed outside the counter), and one rmsnorm call's bytes and one flash
   call's flops as counted, equal to ``kernels/cost.py``'s; and
   ``launch/dryrun.py`` on ``DRYRUN_RUNS`` (five subprocesses side by
   side, so that their fake worlds never meet this process's NCCL world:
   the cells over the 16 x 16 mesh, and qwen2-0.5b's and granite's
   train_4k, each alone, over 16 x 16 and 2 x 16 x 16), fake
   tensors on the card's device, every cell ``OK`` with its per-device
   GiB, the three roofline terms, the dominant one and the collective
   wire bytes a device by kind (the ring model's, as the reference
   counts them) printed. They run
   beside phase 4's graph generation (host set-up, not a measurement of
   the port), which phase 4 waits on before its first timed run, so no
   timed run of the script shares the host with them.

Phase 1 also counts the HGMMA (``wgmma``) instructions in the SASS of
both flash libraries, forward and backward (``cuobjdump``), and fails if
either has none, or if any instantiation of the forward's bf16 body
(``flash_bf16_kernel<NBQK, NBV>``, MLA's (3, 2) among them) has none.
Phase 2 also holds the flash kernel at MLA's widths (q and k 192, v 128,
deepseek's prefill shape; the layer's views; f32 at ``MLA_F32_SEQ``),
and at the launcher's other unequal width pairs ((128, 64), (64, 128),
(192, 64): every other bf16 body and f32 tile), against its plain version
and times it beside its bound and
``F.scaled_dot_product_attention``, naming the backends that take
``Ev != E`` (``phase_mla_flash``). Phase 2 times
``sorted_intersect`` on b with holes anywhere and on b with holes only in
its tail, and also holds rmsnorm and flash_attention against their plain
versions (rmsnorm: 1e-5 in f32, one bf16 ulp of the output in bf16, on
both of its bodies: the widths of the dense configs, each width phase
10's models run (1536, 2048 and MLA's latent 512) at the prefill and the
decode rows, an odd width and a misaligned view; flash: 2e-5 with f32
inputs, 2e-2 abs with bf16 inputs against the f32 plain result, on
contiguous tensors and on ``[B, H, T, d]`` views of ``[B, T, H, d]``
ones, granite's GQA 24/8 at the prefill shape among them) and times them at the
prefill shape beside the plain version, the bound (the larger of bytes
over the memory rate and flops over the dense bf16 tensor-core rate) and
one PyTorch library call (``F.rms_norm``,
``F.scaled_dot_product_attention``), timed only here; flash also on the
layer's views and at d = 128, each beside its bound. rmsnorm and
``F.rms_norm`` are timed at the prefill rows and the decode rows
(``rmsnorm_timing``): device-only by a replayed CUDA graph, eager, and
host µs per call, medians of ``RMS_ROUNDS`` alternating rounds; the
kernels line takes the device-only time. Phase 5 also requires every
rmsnorm launch on the kernel's register body, and no backward launch.
Phase 2 also holds the flash backward at MLA's widths (q, k 192 and v
128 on the layer's layouts, bf16 at deepseek's training shape and f32 at
``MLA_F32_SEQ``, ragged, rows that see no key, the launcher's other
unequal pairs) against its plain formulas, twice for equal bits, and
times it beside its bound and SDPA's backward (``phase_mla_flash_bwd``);
and the rmsnorm backward at the widths phase 11 trains (512, 1536, 2048,
each on the register body). Phase 2 also holds the two backward kernels
(``flash_attention_bwd``, ``rmsnorm_bwd``: the port's own, the Pallas
kernels have none) against
their plain backward formulas at the training shapes (flash: q [4, 14,
4096, 64] as the layer's views in bf16 and f32, non-causal, rows that see
no key, d = 128; rmsnorm: [16384, 896], an odd width, a wide row; the
tolerances in ``phase_lm_bwd_kernels``), checks the flash backward twice
for equal bits, and times both beside their bound and the backward of
``F.scaled_dot_product_attention`` / ``F.rms_norm``: the flash backward
by CUDA events, with each of its three kernels' device time from the
profiler (and SDPA's backward error against the same plain f32 result,
logged as context), the rmsnorm backward on the device alone (its
kernels by a replayed CUDA graph, ``F.rms_norm``'s backward by the sum of
its kernels' device times; eager times logged beside them). Phases 5 and
9 require every rmsnorm launch, forward and backward, on the register
body.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. It exits non-zero with no
result when there is no CUDA device or no ``src/repro_torch`` beside it.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
# the bound of a kernel is the larger of its bytes over the card's HBM
# rate and its flops over its dense bf16 rate: the rates by card name
# (NVIDIA data sheets) and each kernel's flops and bytes are
# repro_torch/kernels/cost.py's (BANDWIDTH, PEAK_BF16), which the dry-run
# (launch/dryrun.py) reads too
FULL_N, FULL_BATCH, FULL_CAPS = 1_000_000, 4096, (65536, 16384)
# LM path: prefill 4 x 4096 tokens; the serve loop as serve.py's defaults
LM_ARCH, LM_BATCH, LM_SEQ = "qwen2-0.5b", 4, 4096
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, SERVE_CACHE = 4, 16, 32, 128
# phase 9: qwen2-0.5b training at the prefill shape (LMStream 4 x 4096),
# TRAIN_STEPS steps with a checkpoint every TRAIN_CKPT_EVERY
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 4, 4096, 1e-3
TRAIN_STEPS, TRAIN_CKPT_EVERY = 6, 3
# phase 10: the MoE models, served at LM_BATCH x LM_SEQ and the serve loop
# above; the f32 yardstick of deepseek (58.5 GiB in f32 beside 29.3 GiB in
# bf16) is taken block by block
MOE_ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")
F32_BY_LAYER = ("deepseek-v2-lite-16b",)
# phase 11: MoE and MLA training at full width on LMStream TRAIN_BATCH x
# TRAIN_SEQ: the layers each model trains (deepseek-v2-lite-16b cut to its
# dense first layer and three MoE layers: at 12 bytes a parameter in
# training its 15.7 B take 188 GB; PERF.md section 4), and the layers of
# its checkpoint/restart run, MOE_TRAIN_STEPS steps with a checkpoint
# every MOE_TRAIN_CKPT_EVERY
# (a checkpoint of granite's 32 layers, bf16 weights and f32 moments, is
# 30.7 GiB and takes 47 s to write: the restart runs at fewer layers; at 8
# layers it took 31 s, so 4 keep the script inside its time limit), and
# AdamW's rate (at 1e-3 the first updates raise both models' loss from
# random init)
MOE_TRAIN_LAYERS = {"granite-moe-3b-a800m": 32, "deepseek-v2-lite-16b": 4}
MOE_RESTART_LAYERS = {"granite-moe-3b-a800m": 4, "deepseek-v2-lite-16b": 2}
MOE_TRAIN_STEPS, MOE_TRAIN_CKPT_EVERY, MOE_TIMED_STEPS = 3, 2, 4
MOE_TRAIN_LR = 1e-4
# phase 12: BST at full width (the config's 10^6 items, 10^5 user
# features, d = 32) at the reference's recsys cells (configs/bst.py
# SHAPES): timed serving batches, BST_TRAIN_STEPS training steps with a
# checkpoint every BST_CKPT_EVERY; outputs and gradients held against an
# f64 CPU run of the same weights on BST_CHECK_ROWS rows and candidates
BST_SERVE_BATCHES = {512: 50, 262_144: 4}
BST_TRAIN_STEPS, BST_CKPT_EVERY = 6, 3
BST_CHECK_ROWS = 1024
# f32 on the card against f64: sums of at most a few thousand products in
# another order, each rounded to 24 bits
BST_TOL = 1e-4
# phase 2: flash attention at MLA's widths (q and k 128 nope + 64 rope, v
# 128; deepseek's 16 heads), and the shorter T of its f32 check
MLA_HEADS, MLA_NOPE, MLA_ROPE, MLA_V = 16, 128, 64, 128
MLA_F32_SEQ = 1024
# kernels vs plain versions end to end in bf16: both round every
# activation to 8 significant bits, in other orders, through 24 layers.
# The yardstick is measured in the run: ``floor`` = max |plain bf16 - the
# same weights in f32| over the prefill logits, how far bf16 rounding
# alone moves them; two bf16 results, each that far from the f32 ones,
# must agree within LM_TOL_FLOORS * floor
LM_TOL_FLOORS = 2.0
# phase 3's mid-size graph (at 20,000 vertices its plain-version runs
# alone took about two minutes of the script's time limit)
MID_N, MID_BATCH, MID_CAPS = 10_000, 64, (8192, 16384, 32768, 65536)
# rmsnorm and F.rms_norm are each timed as the median of this many rounds
RMS_ROUNDS = 7
# phase 6: the device row cache sized as the JAX gate sizes it
OOC_CACHE_FRAC, OOC_HOT_FRAC = 0.12, 0.04
# phase 7: (n, m_init, batch, steps) of the mid-size stream (the largest
# at which the brute snapshot diff stays near 30 s) and the full stream
# (at 10^6 vertices and 8 x 10^6 edges its host generation alone took
# 107 s of the script's time limit)
SBENU_PATTERNS = ("dtoy", "q1'", "q2'", "q3'", "q5'")
SB_MID = (1000, 2000, 300, 3)
SB_FULL = (500_000, 4_000_000, 100_000, 3)
SB_DELETE, SB_BATCH = 0.3, 4096
# phase 8: the full-size dist triangle with no hot rows and with phase 6's
# 4% of the rows replicated; the mid-size join patterns
DIST_HOT = (0, int(OOC_HOT_FRAC * FULL_N))
JOIN_PATTERNS = ("triangle", "square")
# phase 13: the GNN family (configs/{gin_tu,pna,egnn,meshgraphnet}.py) at
# the reference's cells: GNN_STEPS AdamW steps a full-batch cell at GNN_LR,
# GNN_MB_STEPS sampled minibatch_lg blocks over powerlaw(232,965,
# GNN_MB_DEGREE) (the cell fixes the vertices, not the degree: 8 edges a
# new vertex gives a mean degree of 16, but most vertices have fewer
# than 15 neighbours, so a block holds about 80,000 real nodes and
# 240,000 real edges of its 169,984 / 337,920: a denser host graph, near
# Reddit's, would take minutes to generate on the host), gin-tu's
# restart over GNN_RESTART_STEPS with a checkpoint every
# GNN_RESTART_EVERY, the train CLI for GNN_CLI_STEPS, gin-tu at
# ogb_products for GNN_OGB_STEPS (at 1e-3, pna's and gin-tu's losses rose
# over the first steps from random init); f32 on the card against f64 on
# the CPU within GNN_TOL (BST_TOL's reasoning), each gradient by its L2
# distance over its norm, or within LM_TOL_FLOORS x the same code's f32
# CPU run's distance where f32 rounding alone moves this model's
# gradients further (15 layers of MeshGraphNet; PNA's std at var ~ 0)
GNN_ARCHS = ("gin-tu", "pna", "egnn", "meshgraphnet")
GNN_SHAPES = ("full_graph_sm", "molecule", "minibatch_lg")
GNN_STEPS, GNN_MB_STEPS, GNN_MB_DEGREE = 6, 4, 8
GNN_RESTART_STEPS, GNN_RESTART_EVERY = 6, 3
GNN_CLI_STEPS, GNN_OGB_STEPS = 20, 3
GNN_LR, GNN_TOL = 1e-4, 1e-4
DRYRUN_GRANITE_LAYERS = 4
# phase 14: the dry-run's cells, traced on fake tensors by subprocesses
# side by side beside phase 4's graph generation (tag, cells, multi-pod,
# layers or None for full depth): a train_4k cell takes most of a
# subprocess's time, so each runs in one of its own; granite's at a cut
# depth (its full 32 layers trace in 58-105 s, past the generation); their
# time limit
DRYRUN_RUNS = (
    ("pod", ("qwen2-0.5b:train_4k",), False, None),
    ("pod", ("granite-moe-3b-a800m:train_4k",), False,
     DRYRUN_GRANITE_LAYERS),
    ("pod", ("qwen2-0.5b:decode_32k", "qwen2-0.5b:long_500k",
             "granite-moe-3b-a800m:prefill_32k", "bst:retrieval_cand",
             "gin-tu:ogb_products", "benu:enum_128m",
             "benu:sbenu_delta_16m"), False, None),
    ("multipod", ("qwen2-0.5b:train_4k",), True, None),
    ("multipod", ("granite-moe-3b-a800m:train_4k",), True,
     DRYRUN_GRANITE_LAYERS))
DRYRUN_TIMEOUT_S, HOST_CALLS = 300, 300
# phase 13b: train_lm_torch's steps and checkpoint interval
EXAMPLE_LM_STEPS, EXAMPLE_LM_EVERY = 100, 50


@contextlib.contextmanager
def gc_paused():
    """Cyclic GC off while the full-size graphs and streams (tens of
    millions of Python sets and ints) are built and walked: collection
    over them costs minutes and frees nothing. On exit the survivors are
    frozen out of later collections and GC runs again, so the LM phase
    times its host loop under the default regime."""
    gc.disable()
    try:
        yield
    finally:
        gc.freeze()
        gc.enable()


def log(*args) -> None:
    print(*args, flush=True)


def hgmma_by_body(sass: str) -> dict:
    """HGMMA instructions in each instantiation ``flash_bf16_kernel<NBQK,
    NBV>`` of ``cuobjdump -sass`` output, by ``(NBQK, NBV)``."""
    import re
    out, body = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_bf16_kernelILi(\d+)ELi(\d+)E", line)
            body = (int(m.group(1)), int(m.group(2))) if m else None
            if body is not None:
                out[body] = 0
        elif body is not None and "HGMMA" in line:
            out[body] += 1
    return out


def phase_mla_flash_bwd(dev, bandwidth: float, peak: float) -> dict:
    """The flash backward at MLA's widths (q and k 192, v 128) against its
    plain backward formulas (``ref.flash_attention_backward`` in f32 on
    the same inputs), with phase 2's tolerances (``phase_lm_bwd_kernels``:
    ``1e-2 * max|want|`` in bf16, ``1e-4 * max|want|`` in f32): bf16 at
    deepseek's training shape on the layer's layouts (q a head-major view,
    k a concatenation of nope and the expanded rope, v a view of the
    ``wkv_b`` product) and contiguous, non-causal, a ragged T with rows
    that see no key; f32 at ``MLA_F32_SEQ`` and ragged; and the launcher's
    other unequal pairs ((128, 64), (64, 128), (192, 64), GQA 6/2). Then
    two calls at the training shape must give the same bits, and the
    kernel is timed there beside its bound, the plain version and SDPA's
    backward (which backends take ``Ev != E`` is logged)."""
    from repro_torch.kernels import cost
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 7)
    dqk, dv = MLA_NOPE + MLA_ROPE, MLA_V
    scale = dqk ** -0.5

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def layer_qkv(b, t, dtype):
        """q, k, v as ``MLAAttention`` hands them to the kernel."""
        h = MLA_HEADS
        q = rand((b, t, h, dqk), dtype).transpose(1, 2)
        kv = rand((b, t, h, MLA_NOPE + dv), dtype)
        rope = rand((b, t, 1, MLA_ROPE), dtype)
        k = torch.cat([kv[..., :MLA_NOPE], rope.expand(b, t, h, MLA_ROPE)],
                      dim=-1).transpose(1, 2)
        return q, k, kv[..., MLA_NOPE:].transpose(1, 2)

    def check(tag, q, k, v, causal, keep=False):
        o, lse = fa.flash_attention_lse_cuda(q, k, v, causal, scale)
        do = rand(o.shape, q.dtype)
        got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal, scale)
        want = ref.flash_attention_backward(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(),
            causal, scale)
        torch.cuda.synchronize()
        rel = 1e-4 if q.dtype == torch.float32 else 1e-2
        errs = [float((g.float() - w).abs().max()) for g, w in
                zip(got, want)]
        scales = [float(w.abs().max()) for w in want]
        ok = all(e <= rel * sc for e, sc in zip(errs, scales)) and all(
            g.shape == x.shape for g, x in zip(got, (q, k, v)))
        log(f"  flash_attention_bwd {tag} {str(q.dtype)[6:]} causal="
            f"{causal}: max_abs_err dq/dk/dv {[f'{e:.3g}' for e in errs]} "
            f"of max {[f'{sc:.3g}' for sc in scales]} (tolerance {rel} x "
            f"max): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"flash_attention_bwd disagrees with its "
                               f"plain version at {tag}")
        return (q, k, v, o, lse, do, max(errs)) if keep else None

    b, h, t = LM_BATCH, MLA_HEADS, LM_SEQ
    for dtype, tb, tt in ((torch.bfloat16, b, t),
                          (torch.float32, b, MLA_F32_SEQ)):
        check(f"MLA [{tb},{h},{tt}] (192, 128), the layer's layouts",
              *layer_qkv(tb, tt, dtype), True)
        check(f"MLA [{tb},{h},{tt}] (192, 128), contiguous",
              rand((tb, h, tt, dqk), dtype), rand((tb, h, tt, dqk), dtype),
              rand((tb, h, tt, dv), dtype), True)
        check("MLA [2,16,700] (192, 128), views", *layer_qkv(2, 700, dtype),
              False)
        # Tq > Tk: the first rows see no key
        check("MLA q[1,16,300] kv[1,16,200] (192, 128)",
              rand((1, h, 300, dqk), dtype), rand((1, h, 200, dqk), dtype),
              rand((1, h, 200, dv), dtype), True)
        for pair in ((128, 64), (64, 128), (192, 64)):
            check(f"q[1,6,1000] kv[1,2,1000] {pair}",
                  rand((1, 6, 1000, pair[0]), dtype),
                  rand((1, 2, 1000, pair[0]), dtype),
                  rand((1, 2, 1000, pair[1]), dtype), True)
    q, k, v, o, lse, do, worst = check(
        f"MLA [{b},{h},{t}] (192, 128), the layer's layouts, again",
        *layer_qkv(b, t, torch.bfloat16), True, keep=True)
    a1 = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, True, scale)
    a2 = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, True, scale)
    if not all(torch.equal(x, y) for x, y in zip(a1, a2)):
        raise RuntimeError("flash_attention_bwd is not deterministic at "
                           "MLA's widths")
    log("  flash_attention_bwd at MLA's widths: two calls, the same bits")
    del a1, a2
    split = kernel_times_ms(lambda: fa.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, True, scale), 5)
    log("  flash_attention_bwd at MLA's widths by kernel (device ms a call, "
        "profiler): " + ", ".join(
            f"{kernel_name(key)} {ms:.4f}"
            for key, ms in sorted(split.items(), key=lambda x: -x[1])))
    # S, dK, dQ over dqk; dP, dV over dv
    flops = cost.flash_bwd_flops(b, h, t, t, dqk, dv, True)
    nbytes = cost.flash_bwd_bytes(b, h, h, t, t, dqk, dv, 2)
    bound_ms = max(flops / peak, nbytes / bandwidth) * 1e3
    qc, kc, vc, oc, doc = (x.contiguous() for x in (q, k, v, o, do))
    qs, ks, vs = (x.detach().requires_grad_() for x in (qc, kc, vc))
    sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                          scale=scale)
    res = dict(
        ms=cuda_time_ms(lambda: fa.flash_attention_bwd_cuda(
            q, k, v, o, lse, do, True, scale), 5),
        contiguous_ms=cuda_time_ms(lambda: fa.flash_attention_bwd_cuda(
            qc, kc, vc, oc, lse, doc, True, scale), 5),
        plain_ms=cuda_time_ms(lambda: ref.flash_attention_backward(
            q, k, v, o, lse, do, True, scale), 2),
        library_ms=cuda_time_ms(lambda: torch.autograd.grad(
            sdpa, (qs, ks, vs), doc, retain_graph=True), 10),
        bound_ms=bound_ms,
        bound_by="operations" if flops / peak > nbytes / bandwidth
        else "bytes", max_abs_err=worst,
        shape=f"q,k [{b},{h},{t},{dqk}] v [{b},{h},{t},{dv}] bf16 causal, "
              "the layer's layouts")
    log(f"  flash_attention_bwd at MLA's shape ({res['shape']}): kernel "
        f"{res['ms']:.4f} ms (contiguous {res['contiguous_ms']:.4f}), plain "
        f"{res['plain_ms']:.4f} ms, SDPA backward (contiguous) "
        f"{res['library_ms']:.4f} ms, bound {bound_ms:.4f} ms "
        f"({res['bound_by']}: {flops:.4g} flops, {nbytes} bytes), "
        f"{100 * bound_ms / res['ms']:.1f}% of bound")
    lib = kernel_times_ms(lambda: torch.autograd.grad(
        sdpa, (qs, ks, vs), doc, retain_graph=True), 1)
    log(f"  SDPA's backward at MLA's shape runs "
        f"{sorted(kernel_name(key) for key in lib)}")
    del q, k, v, o, lse, do, qc, kc, vc, oc, doc, qs, ks, vs, sdpa
    torch.cuda.empty_cache()
    return res


def kernel_name(key: str) -> str:
    """A profiler key shortened to the kernel's name: no return type, no
    anonymous namespace, no argument list."""
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    return key.split("(")[0][:60]


def kernel_times_ms(fn, reps: int) -> dict:
    """Device ms a call of each kernel ``fn()`` launches, by name, from
    ``torch.profiler`` over ``reps`` calls after a warm-up (empty when the
    profiler records no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if e.device_type == DeviceType.CUDA and us > 0:
            out[e.key] = us / 1e3 / reps
    return out


def cuda_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch
    fn()                                            # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Phase 2 inputs: random valid padded sets, made on the card from a seed
# ---------------------------------------------------------------------------


def padded_sets(gen, rows: int, width: int, n: int, hole_p: float,
                tail: bool):
    """int32[rows, width] valid padded sets over [0, n): ascending valid
    entries, duplicates turned into holes, then holes punched at random
    (``tail=False``: anywhere; ``tail=True``: only a random-length tail, as
    in adjacency rows). About 1% of the rows are all holes."""
    import torch
    dev = gen.device
    v = torch.randint(0, n, (rows, width), generator=gen, device=dev,
                      dtype=torch.int32).sort(dim=1).values
    dup = torch.zeros_like(v, dtype=torch.bool)
    dup[:, 1:] = v[:, 1:] == v[:, :-1]
    v.masked_fill_(dup, n)
    if tail:
        v = v.sort(dim=1).values                    # holes to the tail
        keep = torch.randint(0, width + 1, (rows, 1), generator=gen,
                             device=dev)
        lane = torch.arange(width, device=dev)[None, :]
        v.masked_fill_(lane >= keep, n)
    else:
        holes = torch.rand((rows, width), generator=gen, device=dev) < hole_p
        v.masked_fill_(holes, n)
    empty = torch.rand((rows,), generator=gen, device=dev) < 0.01
    v[empty] = n
    return v.contiguous()


def punch(gen, sets, n: int, p: float):
    """Holes punched at random into ``sets`` (a subset stays a padded set)."""
    import torch
    holes = torch.rand(sets.shape, generator=gen, device=sets.device) < p
    return sets.masked_fill(holes, n).contiguous()


def plain_rows(fn, rows: int, width_product: int):
    """Run a plain [r, Da, Db]-compare version over row chunks that keep
    the compare near 2 GB; returns the concatenated result."""
    import torch
    step = max(1, (2 << 30) // max(width_product, 1))
    return torch.cat([fn(lo, min(lo + step, rows))
                      for lo in range(0, rows, step)])


def phase_kernels(dev, bandwidth: float) -> dict:
    from repro_torch.kernels import cost
    import torch
    from repro_torch.kernels import gather_intersect as gi
    from repro_torch.kernels import ref
    from repro_torch.kernels import sorted_intersect as si

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    B, n = 65536, 65536
    out = {}

    # -- sorted_intersect: a with holes anywhere, b a punched subset of a
    # superset of a's values (so rows overlap), widths equal and mixed, and
    # widths that are not multiples of 4 (the scalar-load path); then b
    # with holes only in its tail, as every DBQ adjacency row has them
    worst = 0
    for Da, Db, tail in ((3968, 3968, False), (3968, 3968, True),
                         (640, 640, False), (3968, 640, False),
                         (640, 3968, False), (641, 641, False)):
        base = padded_sets(gen, B, max(Da, Db), n, 0.0, tail=False)
        a = punch(gen, base[:, :Da], n, 0.3)
        if tail:             # the superset's prefix, holes after it
            b = base[:, :Db].sort(dim=1).values
            keep = torch.randint(Db // 2, Db + 1, (B, 1), generator=gen,
                                 device=dev)
            b.masked_fill_(torch.arange(Db, device=dev)[None, :] >= keep, n)
        else:
            b = punch(gen, base[:, -Db:] if Db < Da else base[:, :Db], n,
                      0.4)
        got = si.sorted_intersect_cuda(a, b, n)
        want = plain_rows(lambda lo, hi: ref.sorted_intersect(
            a[lo:hi], b[lo:hi], n), B, Da * Db)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        same = torch.equal(got, want)
        kept = int((got != n).sum())
        holes = "tail-only b" if tail else "holes anywhere"
        log(f"  sorted_intersect B={B} Da={Da} Db={Db} {holes}: "
            f"bit-equal={same} max_abs_err={err} kept={kept}")
        if not same or kept == 0:
            raise RuntimeError(f"sorted_intersect disagrees with its plain "
                               f"version at Da={Da} Db={Db} ({holes})")
        worst = max(worst, err)
        if (Da, Db) == (3968, 3968):
            ms = cuda_time_ms(lambda: si.sorted_intersect_cuda(a, b, n), 10)
            nbytes = cost.sorted_intersect_bytes(B, Da, Db)
            bound_ms = nbytes / bandwidth * 1e3
            log(f"  sorted_intersect ({holes}): kernel {ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms, {100 * bound_ms / ms:.1f}% of bound")
            if not tail:     # the line's number: the harder layout
                plain_ms = cuda_time_ms(lambda: plain_rows(
                    lambda lo, hi: ref.sorted_intersect(a[lo:hi], b[lo:hi],
                                                        n), B, Da * Db), 1)
                out["sorted_intersect"] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    shape=f"B={B} Da={Da} Db={Db} holes anywhere")
        del a, b, base, got, want
    out["sorted_intersect"]["max_abs_err"] = worst

    # -- gather_intersect: adjacency rows ascending with tail holes, row N
    # all holes; ids with duplicates, sentinel, out-of-range and negative
    # values; cand half drawn from the addressed row, half independent
    worst = 0
    for Dc, D in ((3968, 3968), (640, 640)):
        adj = padded_sets(gen, n + 1, D, n, 0.0, tail=True)
        adj[n] = n
        ids = torch.randint(0, n, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        ids[:512] = ids[0]                          # duplicates
        ids[512:1024] = n                           # sentinel
        ids[1024:1280] = n + 7                      # out of range
        ids[1280:1536] = 2**31 - 1
        ids[1536:1792] = -5
        ids = ids[torch.randperm(B, generator=gen, device=dev)].contiguous()
        rows = adj.index_select(0, ids.clamp(0, n))
        own = punch(gen, rows[:, :Dc] if Dc <= D else rows, n, 0.3)
        other = padded_sets(gen, B, Dc, n, 0.3, tail=False)
        pick = torch.rand((B, 1), generator=gen, device=dev) < 0.5
        cand = torch.where(pick, own, other).contiguous()
        del rows, own, other
        got = gi.gather_intersect_cuda(ids, cand, adj, n)

        def plain(lo, hi):
            r = adj.index_select(0, ids[lo:hi].clamp(0, n))
            return ref.sorted_intersect(cand[lo:hi], r, n)

        want = plain_rows(plain, B, Dc * D)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        same = torch.equal(got, want)
        kept = int((got != n).sum())
        log(f"  gather_intersect B={B} Dc={Dc} D={D}: bit-equal={same} "
            f"max_abs_err={err} kept={kept}")
        if not same or kept == 0:
            raise RuntimeError(f"gather_intersect disagrees with its plain "
                               f"version at Dc={Dc} D={D}")
        worst = max(worst, err)
        if (Dc, D) == (3968, 3968):
            ms = cuda_time_ms(
                lambda: gi.gather_intersect_cuda(ids, cand, adj, n), 10)
            plain_ms = cuda_time_ms(lambda: plain_rows(plain, B, Dc * D), 1)
            # distinct rows the clipped ids address, each read once
            # (negative ids read row 0; row n is never read)
            rows = ids.clamp(0, n).unique()
            n_valid = int((rows < n).sum())
            nbytes = cost.gather_intersect_bytes(B, Dc, D, n_valid)
            out["gather_intersect"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=nbytes / bandwidth * 1e3,
                shape=f"B={B} Dc={Dc} D={D}")
        del adj, ids, cand, got, want
    out["gather_intersect"]["max_abs_err"] = worst
    for name, r in out.items():
        log(f"  {name} ({r['shape']}): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.4f} ms "
            f"(memory)")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The independent triangle count (host CSR, plain torch ops)
# ---------------------------------------------------------------------------


def independent_triangles(graph, dev) -> int:
    """Triangles u < v < w by a sorted edge-key lookup of every 2-path
    u -> v -> w along edges oriented from low to high id."""
    import numpy as np
    import torch
    n = graph.n
    deg = np.asarray(graph.deg, np.int64)
    col = torch.from_numpy(np.concatenate(graph.adj).astype(np.int64))
    row = torch.repeat_interleave(torch.arange(n), torch.from_numpy(deg))
    up = col > row
    src, dst = row[up].to(dev), col[up].to(dev)     # sorted by (src, dst)
    keys = src * n + dst
    outdeg = torch.bincount(src, minlength=n)
    start = torch.cumsum(outdeg, 0) - outdeg
    total = 0
    step = 1 << 20
    for lo in range(0, src.shape[0], step):
        u, v = src[lo:lo + step], dst[lo:lo + step]
        c = outdeg[v]
        e = torch.repeat_interleave(torch.arange(u.shape[0], device=dev), c)
        first = torch.cumsum(c, 0) - c
        k = torch.arange(e.shape[0], device=dev) - first[e]
        w = dst[start[v[e]] + k]
        q = u[e] * n + w
        pos = torch.searchsorted(keys, q).clamp(max=keys.shape[0] - 1)
        total += int((keys[pos] == q).sum())
    return total


# ---------------------------------------------------------------------------
# Phases 3 and 4: the port's Executor API
# ---------------------------------------------------------------------------


def run_backend(engine, plan, graph, dev, backend_kw=None, **cfg):
    from repro_torch.core.executor import make_executor
    from repro_torch.kernels import gather_intersect as gi
    from repro_torch.kernels import sorted_intersect as si
    import torch
    impl = cfg.pop("plain", None)
    kwargs = dict(backend_kw or {})
    if impl:
        kwargs["gather_intersect_impl"] = impl
    ex = make_executor(engine, device=dev, **kwargs)
    if impl:
        cfg["intersect_impl"] = impl
    si.launches = gi.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = ex.run(plan, graph, **cfg)
    torch.cuda.synchronize()
    st.extras["wall_s"] = time.perf_counter() - t0
    st.extras["launches"] = {"sorted_intersect": si.launches,
                             "gather_intersect": gi.launches}
    st.extras["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return st


def describe(tag, st) -> str:
    lv = st.extras["level_sizes"].tolist()
    return (f"  {tag}: matches {st.count}, wall {st.extras['wall_s']:.3f} s "
            f"(set-up {st.extras['prepare_s']:.3f} s), "
            f"chunks run/split/retried {st.chunks_run}/{st.chunks_split}/"
            f"{st.chunks_retried}, levels {lv}, launches "
            f"{st.extras['launches']}, peak "
            f"{st.extras['peak_bytes'] / 2**30:.2f} GiB")


def phase_mid(dev) -> None:
    import numpy as np
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.plangen import generate_best_plan
    from repro_torch.graph.generate import powerlaw
    t0 = time.perf_counter()
    g = powerlaw(MID_N, 8, seed=SEED)
    log(f"  powerlaw({MID_N}, 8): {g.m} edges, max degree {g.deg.max()}, "
        f"{time.perf_counter() - t0:.1f} s")
    tri = independent_triangles(g, dev)
    torch_runs = {}
    for pname in ("triangle", "square", "clique4", "house"):
        plan = generate_best_plan(get_pattern(pname), g.stats())
        collect = pname == "house"
        cfg = dict(batch=MID_BATCH, caps=MID_CAPS[:len(
            [i for i in plan.instrs if i.op == "ENU"])],
            collect_matches=collect)
        runs = {"torch": run_backend("torch", plan, g, dev, **cfg),
                "torch-gpu": run_backend("torch-gpu", plan, g, dev, **cfg),
                "plain": run_backend("torch-gpu", plan, g, dev,
                                     plain="chunked", **cfg)}
        for tag, st in runs.items():
            log(describe(f"{pname:8s} {tag:9s}", st))
        base = runs["plain"]
        for tag, st in runs.items():
            if st.count != base.count or \
                    st.extras["level_sizes"].tolist() != \
                    base.extras["level_sizes"].tolist():
                raise RuntimeError(f"{pname}: {tag} disagrees with plain")
            # same chunks in the same order, bit-equal compaction: the
            # collected match arrays agree row for row
            if collect and not np.array_equal(st.matches, base.matches):
                raise RuntimeError(f"{pname}: {tag} match set differs")
        if runs["torch"].extras["launches"]["sorted_intersect"] == 0:
            raise RuntimeError(f"{pname}: torch never launched a kernel")
        if pname == "triangle" and base.count != tri:
            raise RuntimeError(f"triangle {base.count} != independent {tri}")
        torch_runs[pname] = (plan, cfg, runs["torch"])
    plan = generate_best_plan(get_pattern("triangle"), g.stats())
    st = run_backend("torch-gpu", plan, g, dev, batch=MID_BATCH,
                     caps=(128, 32), max_retries=12)
    log(describe("triangle tiny caps", st))
    if st.count != tri or st.chunks_split == 0:
        raise RuntimeError("forced-overflow triangle run is not exact/split")
    log(f"  mid-size exact: triangle == independent count {tri}")
    return g, tri, torch_runs


def phase_full(dev, beside_setup=None) -> dict:
    """The triangle over all starts of ``powerlaw(FULL_N, 8)``, ``torch``
    and ``torch-gpu`` against an independent count. ``beside_setup``
    (started processes' waiter) is called once the graph is generated:
    work that runs beside the generation, host set-up that is not timed
    as the port's, ends before any timed run starts."""
    import torch
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.plangen import generate_best_plan
    from repro_torch.graph.generate import powerlaw
    t0 = time.perf_counter()
    g = powerlaw(FULL_N, 8, seed=SEED)
    note = "; phase 14's dry-run cells beside it" if beside_setup else ""
    log(f"  powerlaw({FULL_N}, 8): {g.m} edges, max degree {g.deg.max()}, "
        f"generated in {time.perf_counter() - t0:.1f} s (host{note})")
    if beside_setup is not None:
        beside_setup()
    t0 = time.perf_counter()
    want = independent_triangles(g, dev)
    torch.cuda.synchronize()
    log(f"  independent triangle count {want} "
        f"({time.perf_counter() - t0:.1f} s)")
    torch.cuda.empty_cache()
    plan = generate_best_plan(get_pattern("triangle"), g.stats())
    launches = {"sorted_intersect": 0, "gather_intersect": 0}
    levels = None
    for engine in ("torch", "torch-gpu"):
        st = run_backend(engine, plan, g, dev, batch=FULL_BATCH,
                         caps=FULL_CAPS)
        levels = levels or st.extras["level_sizes"].tolist()
        log(describe(f"triangle {engine:9s}", st)
            + f" (batch {FULL_BATCH}, caps {FULL_CAPS}, all {g.n} starts)")
        if st.count != want:
            raise RuntimeError(f"{engine}: {st.count} triangles, "
                               f"independent count {want}")
        for k, v in st.extras["launches"].items():
            launches[k] += v
        torch.cuda.empty_cache()
    for k, v in launches.items():
        if v == 0:
            raise RuntimeError(f"the main path never launched {k}")
    return launches, g, want, levels


# ---------------------------------------------------------------------------
# Phase 2 (LM kernels): rmsnorm and flash_attention vs their plain versions
# ---------------------------------------------------------------------------


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    import torch
    mag = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def rotating(fn, args_list):
    """A callable that runs ``fn`` on the next argument tuple each call, so
    timed launches read inputs that are not left in L2 by the last one."""
    state = {"i": 0}

    def call():
        args = args_list[state["i"] % len(args_list)]
        state["i"] += 1
        return fn(*args)
    return call


def rmsnorm_timing(dev, bandwidth: float) -> dict:
    """rmsnorm_cuda and F.rms_norm at the prefill rows [16384, 896] and the
    decode rows [4, 896] bf16, in RMS_ROUNDS rounds that alternate which
    goes first. A round takes for each: device ms per launch (one replayed
    CUDA graph of 40 launches, ``rmsnorm_ab.graph_ms``), eager ms per
    launch (CUDA events around 40 eager launches) and host µs per call of
    the op as a layer calls it (``ops.rmsnorm``, ``F.rms_norm``;
    ``rmsnorm_ab.host_us``).
    Launches rotate over four input sets (117 MB at the prefill rows, more
    than the 50 MB L2). Returns, per row count, the medians by impl and
    metric, the plain version's eager ms and the bytes bound."""
    from repro_torch.kernels import cost
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch.rmsnorm_ab import LAUNCHES, graph_ms, host_us
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    d, res = 896, {}
    log(f"  rmsnorm timing: device ms = one replay of a CUDA graph of "
        f"{LAUNCHES} launches / {LAUNCHES}; eager ms = CUDA events "
        f"around {LAUNCHES} eager launches; host µs = host clock over "
        f"many calls; medians of {RMS_ROUNDS} alternating rounds")
    for rows, calls in ((LM_BATCH * LM_SEQ, 200), (LM_BATCH, 2000)):
        sets = [(torch.randn((rows, d), generator=gen, device=dev
                             ).to(torch.bfloat16),
                 torch.randn((d,), generator=gen, device=dev
                             ).to(torch.bfloat16)) for _ in range(4)]
        x, g = sets[0]
        impls = {
            "kernel": (lambda x, g: rn.rmsnorm_cuda(x, g, 1e-6),
                       lambda: ops.rmsnorm(x, g, 1e-6)),
            "F.rms_norm": (lambda x, g: F.rms_norm(x, (d,), g, 1e-6),
                           lambda: F.rms_norm(x, (d,), g, 1e-6))}
        graphs = {k: graph_ms(fn, sets) for k, (fn, _) in impls.items()}
        rounds = {k: {"device_ms": [], "eager_ms": [], "host_us": []}
                  for k in impls}
        for r in range(RMS_ROUNDS):
            for k in (list(impls) if r % 2 == 0 else list(impls)[::-1]):
                fn, op = impls[k]
                rounds[k]["device_ms"].append(graphs[k]())
                rounds[k]["eager_ms"].append(
                    cuda_time_ms(rotating(fn, sets), LAUNCHES))
                rounds[k]["host_us"].append(host_us(op, calls))
        res[rows] = {
            "bound_ms": cost.rmsnorm_bytes(rows, d, 2) / bandwidth * 1e3,
            "plain_eager_ms": cuda_time_ms(rotating(
                lambda x, g: ref.rmsnorm(x, g, 1e-6), sets), 8)}
        for k, metrics in rounds.items():
            res[rows][k] = {m: statistics.median(v)
                            for m, v in metrics.items()}
            for m, v in metrics.items():
                log(f"  rmsnorm [{rows}, {d}] bf16 {k} {m}: rounds "
                    f"{[round(t, 5) for t in v]}, median "
                    f"{statistics.median(v):.5f}")
        r = res[rows]
        log(f"  rmsnorm [{rows}, {d}] bf16: kernel device "
            f"{r['kernel']['device_ms']:.5f} ms / eager "
            f"{r['kernel']['eager_ms']:.5f} ms / host "
            f"{r['kernel']['host_us']:.2f} us; F.rms_norm device "
            f"{r['F.rms_norm']['device_ms']:.5f} ms / eager "
            f"{r['F.rms_norm']['eager_ms']:.5f} ms / host "
            f"{r['F.rms_norm']['host_us']:.2f} us; plain eager "
            f"{r['plain_eager_ms']:.5f} ms; bytes bound "
            f"{r['bound_ms']:.6g} ms (the kernel on the device at "
            f"{100 * r['bound_ms'] / r['kernel']['device_ms']:.1f}% of it)")
        del graphs, sets, x, g
        torch.cuda.empty_cache()
    return res


def phase_lm_kernels(dev, bandwidth: float, peak: float) -> dict:
    from repro_torch.kernels import cost
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    out = {}

    # -- rmsnorm: the prefill rows, the decode rows, the widths of the
    # dense configs and of the card tests, each width the MoE models of
    # phase 10 run at their prefill and decode rows (granite 1536,
    # deepseek 2048 and MLA's latent norm 512), an odd width and a
    # misaligned view (the block body)
    worst = 0.0
    for rows, d, offset in ((LM_BATCH * LM_SEQ, 896, False), (4, 896, False),
                            (1, 896, False), (33, 2048, False),
                            (5, 3072, False), (3, 8192, False),
                            (LM_BATCH * LM_SEQ, 1536, False),
                            (SERVE_BATCH, 1536, False),
                            (LM_BATCH * LM_SEQ, 2048, False),
                            (SERVE_BATCH, 2048, False),
                            (LM_BATCH * LM_SEQ, 512, False),
                            (SERVE_BATCH, 512, False),
                            (1000, 1001, False), (17, 896, True),
                            (3, 8192, True)):
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn((rows, d), generator=gen, device=dev)
                 * 3).to(dtype)
            g = torch.randn((d,), generator=gen, device=dev).to(dtype)
            if offset:             # one element into a buffer: misaligned
                x = torch.empty(rows * d + 1, dtype=dtype,
                                device=dev)[1:].view(rows, d).copy_(x)
            by_body = dict(rn.body_launches)
            got = rn.rmsnorm_cuda(x, g, 1e-6)
            body = "+".join(b for b, n in rn.body_launches.items()
                            if n != by_body[b])
            want = ref.rmsnorm(x, g, 1e-6)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            if dtype == torch.float32:
                ok = bool((err <= 1e-5 + 1e-5 * want.abs()).all())
                tol = "1e-5"
            else:
                ok = bool((err <= bf16_ulp(want)).all())
                tol = "one bf16 ulp"
            log(f"  rmsnorm [{rows}, {d}] {str(dtype)[6:]}"
                f"{' misaligned' if offset else ''} ({body} body): "
                f"max_abs_err {float(err.max()):.3g} (tolerance {tol}): "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"rmsnorm disagrees with its plain "
                                   f"version at [{rows}, {d}] {dtype}")
            if (rows, dtype) == (LM_BATCH * LM_SEQ, torch.bfloat16):
                worst = float(err.max())
    timing = rmsnorm_timing(dev, bandwidth)
    rows, d = LM_BATCH * LM_SEQ, 896
    t = timing[rows]
    out["rmsnorm"] = dict(
        ms=t["kernel"]["device_ms"], plain_ms=t["plain_eager_ms"],
        library_ms=t["F.rms_norm"]["device_ms"], bound_ms=t["bound_ms"],
        bound_by="bytes", max_abs_err=worst,
        shape=f"[{rows}, {d}] bf16, device-only (CUDA graph replay)")

    # -- flash_attention
    cases = [  # (B, Hq, Hkv, Tq, Tk, d, causal, strided)
        (LM_BATCH, 14, 2, LM_SEQ, LM_SEQ, 64, True, False),  # prefill shape
        (LM_BATCH, 14, 2, LM_SEQ, LM_SEQ, 64, True, True),   # as the layer
        (LM_BATCH, 24, 8, LM_SEQ, LM_SEQ, 64, True, False),  # granite's GQA
        (LM_BATCH, 24, 8, LM_SEQ, LM_SEQ, 64, True, True),
        (1, 16, 2, 2048, 2048, 128, True, False),
        (1, 16, 2, 2048, 2048, 128, True, True),
        (1, 14, 2, 1000, 1000, 64, True, False),             # ragged tails
        (1, 14, 2, 1000, 1000, 64, True, True),
        (1, 14, 2, 256, 1024, 64, True, False),              # decode offset
        (1, 14, 2, 256, 128, 64, True, False),               # rows see no key
        (2, 14, 2, 512, 384, 64, False, False),
    ]
    worst = 0.0
    for b, hq, hkv, tq, tk, d, causal, strided in cases:
        for dtype in (torch.bfloat16, torch.float32):
            def rand(h, t):
                if strided:          # [B, H, T, d] views of [B, T, H, d]
                    return torch.randn((b, t, h, d), generator=gen,
                                       device=dev).to(dtype).transpose(1, 2)
                return torch.randn((b, h, t, d), generator=gen,
                                   device=dev).to(dtype)
            q, k, v = rand(hq, tq), rand(hkv, tk), rand(hkv, tk)
            got = fa.flash_attention_cuda(q, k, v, causal=causal)
            want = ref.flash_attention(q.float(), k.float(), v.float(),
                                       causal=causal)
            torch.cuda.synchronize()
            err = float((got.float() - want).abs().max())
            if dtype == torch.float32:
                ok = bool(((got - want).abs()
                           <= 2e-5 + 2e-5 * want.abs()).all())
            else:
                ok = err <= 2e-2
                worst = max(worst, err)
            log(f"  flash_attention B={b} Hq={hq} Hkv={hkv} Tq={tq} "
                f"Tk={tk} d={d} causal={causal} strided={strided} "
                f"{str(dtype)[6:]}: max_abs_err {err:.3g}: "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError("flash_attention disagrees with its plain "
                                   f"version at {(b, hq, hkv, tq, tk, d)}")
            del q, k, v, got, want
    def flash_bound(b, hq, hkv, t, d):
        flops = cost.flash_flops(b, hq, t, t, d, d, True)
        nbytes = cost.flash_bytes(b, hq, hkv, t, t, d, d, 2)
        return (max(nbytes / bandwidth, flops / peak) * 1e3,
                "operations" if flops / peak > nbytes / bandwidth
                else "bytes")

    def bf16_qkv(b, hq, hkv, t, d, strided):
        def rand(h):
            if strided:
                return torch.randn((b, t, h, d), generator=gen, device=dev
                                   ).bfloat16().transpose(1, 2)
            return torch.randn((b, h, t, d), generator=gen,
                               device=dev).bfloat16()
        return rand(hq), rand(hkv), rand(hkv)

    b, hq, hkv, t, d = LM_BATCH, 14, 2, LM_SEQ, 64
    q, k, v = bf16_qkv(b, hq, hkv, t, d, False)
    bound_ms, bound_by = flash_bound(b, hq, hkv, t, d)
    out["flash_attention"] = dict(
        ms=cuda_time_ms(lambda: fa.flash_attention_cuda(q, k, v), 20),
        plain_ms=cuda_time_ms(lambda: ref.flash_attention(q, k, v), 2),
        library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20),
        bound_ms=bound_ms, bound_by=bound_by,
        max_abs_err=worst, shape=f"q[{b},{hq},{t},{d}] kv[{b},{hkv},{t},{d}]"
                                 " bf16 causal")
    del q, k, v
    # the layer's views of [B, T, H, d] activations, and d = 128, each
    # beside its own bound
    for shape, strided in (((b, hq, hkv, t, d), True),
                           ((1, 16, 2, 2048, 128), False)):
        q, k, v = bf16_qkv(*shape, strided)
        ms = cuda_time_ms(lambda: fa.flash_attention_cuda(q, k, v), 20)
        sdpa_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20)
        bms, by = flash_bound(*shape)
        log(f"  flash_attention {shape} bf16 causal strided={strided}: "
            f"kernel {ms:.4f} ms, SDPA {sdpa_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by}), {100 * bms / ms:.1f}% of bound")
        del q, k, v
    for name in ("rmsnorm", "flash_attention"):
        r = out[name]
        log(f"  {name} ({r['shape']}): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    torch.cuda.empty_cache()
    return out


def sdpa_backends(q, k, v, **kw) -> str:
    """The backends of ``F.scaled_dot_product_attention`` that take these
    inputs (each tried alone), and the kernels the default call runs."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    took = []
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            took.append(name)
        except RuntimeError:
            pass
    names = sorted(kernel_name(key) for key in kernel_times_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, **kw), 1))
    return (f"backends that take it alone: {took or 'none'}; the default "
            f"call runs {names}")


def mla_qkv(gen, b, t, dtype, views):
    """q, k [B, H, T, nope + rope] and v [B, H, T, v] at MLA's widths:
    contiguous, or as the MLA layer passes them (q and k head-major views
    of ``[B, T, H, d]`` tensors, v the last ``v`` columns of a
    ``[B, T, H, nope + v]`` product, viewed head-major)."""
    import torch
    h, dqk = MLA_HEADS, MLA_NOPE + MLA_ROPE

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=gen.device
                           ).to(dtype)
    if not views:
        return rand(b, h, t, dqk), rand(b, h, t, dqk), rand(b, h, t, MLA_V)
    return (rand(b, t, h, dqk).transpose(1, 2),
            rand(b, t, h, dqk).transpose(1, 2),
            rand(b, t, h, MLA_NOPE + MLA_V)[..., MLA_NOPE:].transpose(1, 2))


def phase_mla_flash(dev, bandwidth: float, peak: float) -> dict:
    """The flash kernel at MLA's widths (q and k 192, v 128) against its
    plain version: bf16 at deepseek's prefill shape, contiguous and as the
    layer's views, a ragged T, and f32 at MLA_F32_SEQ (2e-2 abs in bf16,
    2e-5 in f32, as phase 2's other flash cases); then timed on the
    layer's views beside its bound, the plain version and
    ``F.scaled_dot_product_attention`` at the same shape."""
    from repro_torch.kernels import cost
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    dqk, dv = MLA_NOPE + MLA_ROPE, MLA_V
    scale = dqk ** -0.5
    worst = 0.0
    for b, t, causal, dtype, views in (
            (LM_BATCH, LM_SEQ, True, torch.bfloat16, False),
            (LM_BATCH, LM_SEQ, True, torch.bfloat16, True),
            (1, 1000, True, torch.bfloat16, True),
            (2, 700, False, torch.bfloat16, True),
            (LM_BATCH, MLA_F32_SEQ, True, torch.float32, False),
            (LM_BATCH, MLA_F32_SEQ, True, torch.float32, True),
            (1, 1000, True, torch.float32, True)):
        q, k, v = mla_qkv(gen, b, t, dtype, views)
        got = fa.flash_attention_cuda(q, k, v, causal=causal, scale=scale)
        want = ref.flash_attention(q.float(), k.float(), v.float(),
                                   causal=causal, scale=scale)
        torch.cuda.synchronize()
        err = float((got.float() - want).abs().max())
        if dtype == torch.float32:
            ok = bool(((got - want).abs() <= 2e-5 + 2e-5 * want.abs()).all())
        else:
            ok = err <= 2e-2
            worst = max(worst, err)
        log(f"  flash_attention MLA B={b} H={MLA_HEADS} T={t} dqk={dqk} "
            f"dv={dv} causal={causal} views={views} {str(dtype)[6:]}: "
            f"out {tuple(got.shape)}, max_abs_err {err:.3g}: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok or got.shape != (b, MLA_HEADS, t, dv):
            raise RuntimeError("flash_attention disagrees with its plain "
                               f"version at MLA's widths, {(b, t, dtype)}")
        del q, k, v, got, want
    # the launcher's other unequal pairs: bf16 bodies <2, 1>, <1, 2> and
    # <3, 1>, f32 tiles <128, 64>, <64, 128> and <192, 64> (GQA 6/2, ragged)
    for dqk_o, dv_o in ((128, 64), (64, 128), (192, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            def rand(h, t, d):
                return torch.randn((1, h, t, d), generator=gen,
                                   device=dev).to(dtype)
            q, k, v = rand(6, 1000, dqk_o), rand(2, 1000, dqk_o), \
                rand(2, 1000, dv_o)
            got = fa.flash_attention_cuda(q, k, v)
            want = ref.flash_attention(q.float(), k.float(), v.float())
            torch.cuda.synchronize()
            err = float((got.float() - want).abs().max())
            ok = bool(((got - want).abs() <= 2e-5 + 2e-5 * want.abs()).all()
                      ) if dtype == torch.float32 else err <= 2e-2
            log(f"  flash_attention B=1 Hq=6 Hkv=2 T=1000 dqk={dqk_o} "
                f"dv={dv_o} causal {str(dtype)[6:]}: max_abs_err "
                f"{err:.3g}: {'ok' if ok else 'FAIL'}")
            if not ok or got.shape != (1, 6, 1000, dv_o):
                raise RuntimeError("flash_attention disagrees with its "
                                   f"plain version at {(dqk_o, dv_o)}")
            del q, k, v, got, want
    b, h, t = LM_BATCH, MLA_HEADS, LM_SEQ
    flops = cost.flash_flops(b, h, t, t, dqk, dv, True)
    nbytes = cost.flash_bytes(b, h, h, t, t, dqk, dv, 2)
    bound_ms = max(flops / peak, nbytes / bandwidth) * 1e3
    bound_by = "operations" if flops / peak > nbytes / bandwidth \
        else "bytes"
    q, k, v = mla_qkv(gen, b, t, torch.bfloat16, True)
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    res = dict(
        ms=cuda_time_ms(lambda: fa.flash_attention_cuda(
            q, k, v, scale=scale), 20),
        contiguous_ms=cuda_time_ms(lambda: fa.flash_attention_cuda(
            qc, kc, vc, scale=scale), 20),
        plain_ms=cuda_time_ms(lambda: ref.flash_attention(
            q, k, v, scale=scale), 2),
        library_ms=cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, is_causal=True, scale=scale), 20),
        bound_ms=bound_ms, bound_by=bound_by, max_abs_err=worst,
        shape=f"q,k [{b},{h},{t},{dqk}] v [{b},{h},{t},{dv}] bf16 causal, "
              "the layer's views")
    log(f"  flash_attention at MLA's shape ({res['shape']}): kernel "
        f"{res['ms']:.4f} ms (contiguous {res['contiguous_ms']:.4f}), plain "
        f"{res['plain_ms']:.4f} ms, SDPA (contiguous) "
        f"{res['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{flops:.4g} flops, {nbytes} bytes), {100 * bound_ms / res['ms']:.1f}"
        "% of bound")
    log(f"  SDPA at MLA's shape: "
        f"{sdpa_backends(qc, kc, vc, is_causal=True, scale=scale)}")
    del q, k, v, qc, kc, vc
    torch.cuda.empty_cache()
    return res


def phase_lm_bwd_kernels(dev, bandwidth: float, peak: float) -> dict:
    """The two backward kernels against their plain backward versions
    (explicit f32 formulas, ``ref.flash_attention_backward`` and
    ``ref.rmsnorm_backward``) on the same inputs, then timed at the
    training shapes beside the plain version, the bound and one PyTorch
    call's backward (timed only here).

    Tolerances, against the plain result in f32 on the same (bf16 or f32)
    inputs: flash f32 ``max|err| <= 1e-4 * max|want|`` for each of dq,
    dk, dv (sums in another order), bf16 ``<= 1e-2 * max|want|`` (one
    rounding of each output to 8 significant bits, ~4e-3 of a value, plus
    f32 sums in another order), lse ``<= 1e-4`` absolute; rmsnorm f32
    ``<= 1e-4 * max|want|``, bf16 within one bf16 ulp of the f32 value plus
    ``1e-6 * max|want|`` (dx cancels in ``g*gamma - x*coef``, where f32
    rounding is absolute, not relative)."""
    from repro_torch.kernels import cost
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    out = {}

    def rand(shape, dtype, strided=False):
        if strided:             # [B, H, T, d] views of [B, T, H, d]
            b, h, t, d = shape
            return torch.randn((b, t, h, d), generator=gen, device=dev
                               ).to(dtype).transpose(1, 2)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def flash_inputs(b, hq, hkv, tq, tk, d, causal, dtype, strided):
        q = rand((b, hq, tq, d), dtype, strided)
        k, v = (rand((b, hkv, tk, d), dtype, strided) for _ in range(2))
        o, lse = fa.flash_attention_lse_cuda(q, k, v, causal)
        return q, k, v, o, lse, rand((b, hq, tq, d), dtype, strided)

    # -- flash_attention_bwd: the training shape as the layer passes it,
    # f32 there too, non-causal, rows that see no key, d = 128 ragged
    cases = [  # (B, Hq, Hkv, Tq, Tk, d, causal, strided)
        (LM_BATCH, 14, 2, LM_SEQ, LM_SEQ, 64, True, True),
        (2, 14, 2, 1024, 1024, 64, False, False),
        (1, 14, 2, 256, 128, 64, True, False),
        (1, 16, 2, 1000, 1000, 128, True, True),
    ]
    worst = 0.0
    for b, hq, hkv, tq, tk, d, causal, strided in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, o, lse, do = flash_inputs(b, hq, hkv, tq, tk, d,
                                               causal, dtype, strided)
            got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
            _, want_lse = ref.flash_attention(q, k, v, causal,
                                              return_lse=True)
            want = ref.flash_attention_backward(
                q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                causal)
            torch.cuda.synchronize()
            rel = 1e-4 if dtype == torch.float32 else 1e-2
            errs = [float((g.float() - w).abs().max()) for g, w in
                    zip(got, want)]
            scales = [float(w.abs().max()) for w in want]
            lse_err = float((lse - want_lse).abs().max())
            ok = lse_err <= 1e-4 and all(e <= rel * sc for e, sc in
                                         zip(errs, scales))
            if dtype == torch.bfloat16 and (b, tq) == (LM_BATCH, LM_SEQ):
                worst = max(errs)
            log(f"  flash_attention_bwd B={b} Hq={hq} Hkv={hkv} Tq={tq} "
                f"Tk={tk} d={d} causal={causal} strided={strided} "
                f"{str(dtype)[6:]}: max_abs_err dq/dk/dv "
                f"{[f'{e:.3g}' for e in errs]} of max "
                f"{[f'{sc:.3g}' for sc in scales]} (tolerance {rel} x max), "
                f"lse {lse_err:.3g}: {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError("flash_attention_bwd disagrees with its "
                                   "plain version at "
                                   f"{(b, hq, hkv, tq, tk, d, causal)}")
            del q, k, v, o, lse, do, got, want
    b, hq, hkv, t, d, causal = LM_BATCH, 14, 2, LM_SEQ, 64, True
    q, k, v, o, lse, do = flash_inputs(b, hq, hkv, t, t, d, causal,
                                       torch.bfloat16, True)
    a1 = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    a2 = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    if not all(torch.equal(x, y) for x, y in zip(a1, a2)):
        raise RuntimeError("flash_attention_bwd is not deterministic")
    del a1, a2
    # SDPA's own backward against the same f32 plain result: context for
    # the bf16 tolerance, no check
    want = ref.flash_attention_backward(q.float(), k.float(), v.float(),
                                        o.float(), lse, do.float(), causal)
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                          enable_gqa=True)
    got = torch.autograd.grad(sdpa, (qs, ks, vs), do)
    errs = [float((g.float() - w).abs().max() / w.abs().max())
            for g, w in zip(got, want)]
    log(f"  SDPA backward vs the plain f32 result at the training shape: "
        f"max_abs_err / max dq/dk/dv {[f'{e:.3g}' for e in errs]} "
        "(context, not checked)")
    del want, got, qs, ks, vs, sdpa
    split = kernel_times_ms(lambda: fa.flash_attention_bwd_cuda(
        q, k, v, o, lse, do, causal), 5)
    log("  flash_attention_bwd by kernel (device ms a call, profiler): " +
        ", ".join(f"{kernel_name(key)} {ms:.4f}"
                  for key, ms in sorted(split.items(), key=lambda x: -x[1])))
    flops = cost.flash_bwd_flops(b, hq, t, t, d, d, True)  # S dP dV dK dQ
    nbytes = cost.flash_bwd_bytes(b, hq, hkv, t, t, d, d, 2)
    bound_ms = max(flops / peak, nbytes / bandwidth) * 1e3
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                          enable_gqa=True)
    out["flash_attention_bwd"] = dict(
        ms=cuda_time_ms(lambda: fa.flash_attention_bwd_cuda(
            q, k, v, o, lse, do, causal), 5),
        plain_ms=cuda_time_ms(lambda: ref.flash_attention_backward(
            q, k, v, o, lse, do, causal), 2),
        library_ms=cuda_time_ms(lambda: torch.autograd.grad(
            sdpa, (qs, ks, vs), do, retain_graph=True), 10),
        bound_ms=bound_ms,
        bound_by="operations" if flops / peak > nbytes / bandwidth
        else "bytes", max_abs_err=worst,
        shape=f"q[{b},{hq},{t},{d}] kv[{b},{hkv},{t},{d}] bf16 causal, "
              "[B, T, H, d] views")
    del q, k, v, o, lse, do, qs, ks, vs, sdpa

    # -- rmsnorm_bwd: the training rows at qwen2's width and at the widths
    # phase 11 trains (MLA's latent 512, granite's 1536, deepseek's 2048,
    # each on the register body), an odd width, a wide row
    worst = 0.0
    for rows, d in ((LM_BATCH * LM_SEQ, 896), (LM_BATCH * LM_SEQ, 512),
                    (LM_BATCH * LM_SEQ, 1536), (LM_BATCH * LM_SEQ, 2048),
                    (1000, 1001), (3, 8192)):
        for dtype in (torch.bfloat16, torch.float32):
            x = rand((rows, d), dtype) * 3
            g, gam = rand((rows, d), dtype), rand((d,), dtype)
            got = rn.rmsnorm_bwd_cuda(x, gam, g, 1e-6)
            want = ref.rmsnorm_backward(x.float(), gam.float(), g.float(),
                                        1e-6)
            torch.cuda.synchronize()
            errs, oks = [], []
            for gt, w in zip(got, want):
                err = (gt.float() - w).abs()
                scale = float(w.abs().max())
                if dtype == torch.float32:
                    oks.append(bool((err <= 1e-4 * scale).all()))
                else:
                    oks.append(bool((err <= bf16_ulp(w) + 1e-6 * scale
                                     ).all()))
                errs.append(float(err.max()))
            if dtype == torch.bfloat16 and rows == LM_BATCH * LM_SEQ:
                worst = max(worst, *errs)
            tol = "1e-4 x max" if dtype == torch.float32 else \
                "one bf16 ulp + 1e-6 x max"
            body = rn.rmsnorm_plan(rows, d, dtype, True).body
            if rows == LM_BATCH * LM_SEQ and body != "register":
                raise RuntimeError(f"rmsnorm_bwd [{rows}, {d}]: {body} body")
            log(f"  rmsnorm_bwd [{rows}, {d}] {str(dtype)[6:]} ({body} "
                f"body): max_abs_err dx {errs[0]:.3g}, dgamma "
                f"{errs[1]:.3g} (tolerance {tol}): "
                f"{'ok' if all(oks) else 'FAIL'}")
            if not all(oks):
                raise RuntimeError("rmsnorm_bwd disagrees with its plain "
                                   f"version at [{rows}, {d}] {dtype}")
    # timed on the device alone, as the forward is (rmsnorm_timing): the
    # kernel's two launches by a replayed CUDA graph, F.rms_norm's backward
    # (autograd, which a graph does not capture) by the sum of its kernels'
    # device times in the profiler; eager times (CUDA events, host gaps
    # included) are logged beside them
    from repro_torch.launch.rmsnorm_ab import graph_ms
    rows, d = LM_BATCH * LM_SEQ, 896
    sets = [(rand((rows, d), torch.bfloat16), rand((d,), torch.bfloat16),
             rand((rows, d), torch.bfloat16)) for _ in range(3)]
    lib_sets = []
    for x, gam, g in sets:
        xs, gs = x.detach().requires_grad_(), gam.detach().requires_grad_()
        lib_sets.append((F.rms_norm(xs, (d,), gs, 1e-6), (xs, gs), g))
    kernel = lambda x, gam, g: rn.rmsnorm_bwd_cuda(x, gam, g, 1e-6)
    library = lambda y, ins, g: torch.autograd.grad(y, ins, g,
                                                    retain_graph=True)
    replay = graph_ms(kernel, sets)
    device_ms = statistics.median(replay() for _ in range(RMS_ROUNDS))
    del replay
    split = kernel_times_ms(lambda: kernel(*sets[0]), 20)
    lib_split = kernel_times_ms(lambda: library(*lib_sets[0]), 20)
    eager = {"kernel": cuda_time_ms(rotating(kernel, sets), 40),
             "library": cuda_time_ms(rotating(library, lib_sets), 40)}
    for who, parts in (("kernel", split), ("F.rms_norm backward", lib_split)):
        log(f"  rmsnorm_bwd [{rows}, {d}] bf16, {who} by kernel (device ms "
            "a call, profiler): " +
            ", ".join(f"{kernel_name(key)} {ms:.5f}"
                      for key, ms in sorted(parts.items(),
                                            key=lambda x: -x[1])))
    log(f"  rmsnorm_bwd [{rows}, {d}] bf16: kernel device {device_ms:.5f} ms "
        f"(graph replay, median of {RMS_ROUNDS}) / eager "
        f"{eager['kernel']:.5f} ms; F.rms_norm backward device "
        f"{sum(lib_split.values()):.5f} ms (profiler) / eager "
        f"{eager['library']:.5f} ms")
    out["rmsnorm_bwd"] = dict(
        ms=device_ms,
        plain_ms=cuda_time_ms(rotating(lambda x, gam, g:
                                       ref.rmsnorm_backward(x, gam, g, 1e-6),
                                       sets), 8),
        library_ms=sum(lib_split.values()),
        bound_ms=cost.rmsnorm_bwd_bytes(rows, d, 2) / bandwidth * 1e3,
        bound_by="bytes", max_abs_err=worst,
        shape=f"[{rows}, {d}] bf16, device-only")
    del sets, lib_sets
    for name in ("flash_attention_bwd", "rmsnorm_bwd"):
        r = out[name]
        log(f"  {name} ({r['shape']}): kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library (backward) "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% of "
            "bound")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 5: the LM serving path at full width
# ---------------------------------------------------------------------------


def lm_counts():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    return {"flash_attention": fa.launches,
            "flash_attention_bwd": fa.bwd_launches,
            "rmsnorm": rn.launches, "rmsnorm_bwd": rn.bwd_launches}


def zero_lm_counts() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    fa.launches = rn.launches = fa.bwd_launches = rn.bwd_launches = 0
    for counts in (rn.body_launches, rn.bwd_body_launches):
        for body in counts:
            counts[body] = 0


def expect_counts(tag: str, want: dict) -> dict:
    """The launch counts must be ``want``, and every rmsnorm launch,
    forward and backward, on the register body (d = 896 bf16, aligned, in
    every layer)."""
    from repro_torch.kernels import rmsnorm as rn
    got = lm_counts()
    log(f"  {tag}: launches {got}, rmsnorm by body {rn.body_launches}, "
        f"its backward by body {rn.bwd_body_launches}")
    if got != want:
        raise RuntimeError(f"{tag}: launches {got}, expected {want}")
    for kind, counts in (("rmsnorm", rn.body_launches),
                         ("rmsnorm_bwd", rn.bwd_body_launches)):
        if counts["register"] != got[kind]:
            raise RuntimeError(f"{tag}: {kind} launches by body {counts}, "
                               "expected all on the register body")
    return got


def compare_logits(tag: str, got, want, tol: float) -> None:
    diff = float((got.float() - want.float()).abs().max())
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    log(f"  {tag}: max |logit diff| {diff:.4g} (tolerance {tol:.4g}), "
        f"argmax agreement {agree:.3f}")
    if not diff <= tol:
        raise RuntimeError(f"{tag}: logits differ by {diff} > {tol}")


def device_profile(tag: str, fn) -> list:
    """Run ``fn`` under torch.profiler; print the wall time, the device's
    busy share (kernel time over wall) and the kernels by device time.
    Returns the kernels' ``(device µs, launches, name)``, longest first
    (empty when the profiler records no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side entries only: an aten op's entry carries its kernels'
    # time too, which would count them twice
    rows = sorted(((getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)),
                    e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    rows = [r for r in rows if r[0] > 0]
    busy = sum(r[0] for r in rows) / 1e6
    if busy == 0:
        log(f"  profile {tag}: the profiler recorded no device time "
            "(busy share not measured)")
        return rows
    log(f"  profile {tag}: wall {wall:.4f} s (profiled), device busy "
        f"{busy:.4f} s ({100 * busy / wall:.1f}%), idle "
        f"{100 * (1 - busy / wall):.1f}%")
    for us, count, key in rows[:10]:
        log(f"    {us / 1e3:9.3f} ms {100 * us / 1e6 / busy:5.1f}% "
            f"x{count:<5d} {key[:90]}")
    return rows


def phase_lm(dev) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_loop
    from repro_torch.models.transformer import (Transformer, init_params,
                                                prefill_step)
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH).model_cfg
    L = cfg.n_layers
    model = init_params(cfg, seed=SEED, device=dev)
    n = sum(p.numel() for p in model.parameters())
    # the config's count, as the reference's, leaves out the QKV biases
    bias = L * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head
    log(f"  {cfg.name}: {n} parameters ({cfg.n_params} by the config + "
        f"{bias} QKV bias), {str(cfg.dtype)[6:]}, initialised on the card")
    if n != cfg.n_params + bias:
        raise RuntimeError(f"{n} parameters, the config says "
                           f"{cfg.n_params} + {bias}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ), generator=gen,
                           device=dev)
    # the serving path pays for no backward and no lse
    launches = {"flash_attention": 0, "rmsnorm": 0,
                "flash_attention_bwd": 0, "rmsnorm_bwd": 0}
    none = dict(launches)

    runs = {}
    for tag, impl in (("kernels", "auto"), ("plain", "ref")):
        prefill_step(model, tokens[:, :128], attn_impl=impl,
                     norm_impl=impl)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_lm_counts()
        t0 = time.perf_counter()
        runs[tag] = prefill_step(model, tokens, attn_impl=impl,
                                 norm_impl=impl)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        log(f"  prefill_step {LM_BATCH} x {LM_SEQ} ({tag}): {dt:.4f} s, "
            f"{LM_BATCH * LM_SEQ / dt:.0f} tok/s, peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        got = expect_counts(f"prefill ({tag})",
                            {**none, "flash_attention": L,
                             "rmsnorm": 2 * L + 1}
                            if tag == "kernels" else none)
        if tag == "kernels":
            for k, c in got.items():
                launches[k] += c
    logits = runs["kernels"]
    if logits.shape != (LM_BATCH, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"prefill logits {tuple(logits.shape)} not finite "
                           "or of the wrong shape")
    # the yardstick: the same weights in f32 (plain versions, full-f32
    # matmuls) against the plain bf16 run
    torch.backends.cuda.matmul.allow_tf32 = False
    model32 = Transformer(dataclasses.replace(cfg, dtype=torch.float32),
                          torch.Generator(device=dev))
    model32.load_state_dict(model.state_dict())        # bf16 -> f32 copy
    ref32 = prefill_step(model32, tokens, attn_impl="ref", norm_impl="ref")
    floor = float((runs["plain"].float() - ref32).abs().max())
    err32 = float((logits.float() - ref32).abs().max())
    tol = LM_TOL_FLOORS * floor
    log(f"  prefill logits vs the f32 model: plain bf16 {floor:.4g} (the "
        f"bf16 floor), kernels bf16 {err32:.4g}; tolerance "
        f"{LM_TOL_FLOORS} x floor = {tol:.4g}")
    if not err32 <= tol:
        raise RuntimeError(f"prefill with the kernels is {err32} from the "
                           f"f32 model, more than {tol}")
    compare_logits("prefill last-position logits, kernels vs plain",
                   logits, runs["plain"], tol)
    del model32, ref32
    device_profile("prefill_step (kernels)", lambda: prefill_step(
        model, tokens))

    prompt = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           generator=gen, device=dev)
    serve_loop(model, prompt, 2, SERVE_CACHE)          # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    zero_lm_counts()
    out = serve_loop(model, prompt, SERVE_STEPS, SERVE_CACHE)
    steps = SERVE_PROMPT + SERVE_STEPS
    log(f"  serve loop batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, decode "
        f"{SERVE_STEPS}, cache {SERVE_CACHE} (kernels): "
        f"{out['seconds']:.4f} s, {SERVE_BATCH * steps / out['seconds']:.0f}"
        f" tok/s, peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
        f"GiB; sample {out['tokens'][0][:16].tolist()}")
    got = expect_counts("serve loop (kernels)",
                        {**none, "rmsnorm": (2 * L + 1) * steps})
    for k, c in got.items():
        launches[k] += c
    zero_lm_counts()
    plain = serve_loop(model, prompt, SERVE_STEPS, SERVE_CACHE,
                       norm_impl="ref", forced=out["tokens"])
    log(f"  serve loop teacher-forced (plain): {plain['seconds']:.4f} s, "
        f"{SERVE_BATCH * steps / plain['seconds']:.0f} tok/s")
    expect_counts("serve loop (plain)", none)
    compare_logits(f"serve loop, all {steps} steps' logits, kernels vs plain",
                   out["logits"], plain["logits"], tol)
    pre = prefill_step(model, prompt)
    compare_logits("decode logits after the prompt vs prefill_step",
                   out["logits"][SERVE_PROMPT - 1], pre, tol)
    device_profile(f"serve loop, {SERVE_PROMPT} + 8 steps (kernels)",
                   lambda: serve_loop(model, prompt, 8, SERVE_CACHE))
    log(f"  phase 5: {time.perf_counter() - t_phase:.1f} s")
    del model
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 9: LM training at full width
# ---------------------------------------------------------------------------


def train_step(model, batch, impl: str, opt_cfg):
    """One training step through the port's entry points, from a fresh
    AdamW state: ``loss_fn`` (``impl`` for both kernels), backward,
    ``adamw_update`` (the model updated in place). Returns the loss, the
    grad norm and the gradients by name."""
    import torch
    from repro_torch.models.transformer import decay_mask, loss_fn
    from repro_torch.train.optimizer import adamw_init, adamw_update
    params = dict(model.named_parameters())
    state = adamw_init(params)
    loss, _ = loss_fn(model, batch, attn_impl=impl, norm_impl=impl)
    loss.backward()
    grads = {n: p.grad for n, p in params.items()}
    model.zero_grad(set_to_none=True)
    _, _, metrics = adamw_update(opt_cfg, grads, state, params,
                                 decay_mask(params))
    torch.cuda.synchronize()
    return loss.item(), metrics["grad_norm"].item(), grads


def leaf_dists(a: dict, b: dict) -> dict:
    """The L2 distance of each pair of same-named tensors, in f64."""
    import torch
    return {k: float(torch.linalg.vector_norm(a[k].double() - b[k].double()))
            for k in a}


# the parameters of phases 9 and 11 by group (a name's first match)
LEAF_GROUPS = (("attention", ".attn."), ("mlp", ".ffn."), ("norms", "norm"),
               ("embedding", "embed"), ("head", "lm_head"))


def check_agreement(what: str, diff: dict, floor: dict,
                    each_tensor: bool, label: str = "kernels vs plain"
                    ) -> None:
    """Kernels vs plain by parameter: ``diff`` and ``floor`` hold each
    tensor's L2 distance kernels-vs-plain and plain-bf16-vs-f32. With
    ``each_tensor`` every tensor must be within LM_TOL_FLOORS x its own
    yardstick, else each group's L2 within LM_TOL_FLOORS x the group's.
    Logs the worst of each group; fails on any over its tolerance."""
    groups = {}
    for n in diff:
        g = next((g for g, key in LEAF_GROUPS if key in n), None)
        groups.setdefault(g, []).append(n)
    if None in groups:
        raise RuntimeError(f"parameters outside {LEAF_GROUPS}")
    bad = []
    for group, names in groups.items():
        if each_tensor:
            items = {n: (diff[n], floor[n]) for n in names}
        else:
            items = {f"{len(names)} tensors": (
                math.sqrt(sum(diff[n] ** 2 for n in names)),
                math.sqrt(sum(floor[n] ** 2 for n in names)))}
        ratio = {n: d / f if f else (0.0 if d == 0 else math.inf)
                 for n, (d, f) in items.items()}
        n = max(ratio, key=ratio.get)
        log(f"  {label}, {what}, {group}, worst of {len(items)}: "
            f"{n} {items[n][0]:.4g} against {items[n][1]:.4g} (ratio "
            f"{ratio[n]:.4g}, tolerance {LM_TOL_FLOORS})")
        bad += [n for n, r in ratio.items() if not r <= LM_TOL_FLOORS]
    if bad:
        raise RuntimeError(f"training step, {label}: {what} of "
                           f"{bad} over {LM_TOL_FLOORS} x their yardstick")


def restart_run(what: str, loss_fn, init_fn, batch_fn, opt_cfg,
                steps: int, every: int, dev, decay_mask,
                per_step: dict = None):
    """``steps`` AdamW steps through ``run_training`` with a checkpoint
    every ``every`` (under ``build/``, removed after), against a run that
    fails at step ``every`` and resumes from its checkpoint: the resumed
    steps' losses, the final parameters and AdamW moments must equal the
    uninterrupted run's bit for bit (its final state waits on the host
    meanwhile: two training states of an MoE model do not fit on the card
    together), every loss finite. With ``per_step`` the uninterrupted
    run's launches must be ``steps`` times it. Returns (its launches, its
    losses, the resumed run's final state)."""
    import shutil
    import torch
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.loop import TrainLoopConfig, run_training
    ck_root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ck_root, ignore_errors=True)
    ck_root.mkdir(parents=True)
    free = shutil.disk_usage(ck_root).free
    loop = dict(steps=steps, ckpt_every=every, log_every=1)
    kw = dict(device=dev, decay_mask=decay_mask)
    zero_lm_counts()
    t0 = time.perf_counter()
    h_a = run_training(loss_fn, init_fn, batch_fn, opt_cfg,
                       TrainLoopConfig(**loop),
                       ckpt=CheckpointManager(str(ck_root / "a"), keep=1),
                       **kw)
    ck_bytes = sum(f.stat().st_size for f in (ck_root / "a").rglob("*")
                   if f.is_file())
    log(f"  {what}: uninterrupted run, {steps} steps with a checkpoint "
        f"every {every} ({ck_bytes / 2**30:.2f} GiB; {free / 2**30:.0f} GiB "
        f"free before): {time.perf_counter() - t0:.1f} s")
    got = {} if per_step is None else expect_counts(
        f"{steps} training steps (kernels)",
        {k: steps * c for k, c in per_step.items()})
    shutil.rmtree(ck_root / "a", ignore_errors=True)
    if not all(math.isfinite(x) for x in h_a["loss"]) or \
            len(h_a["loss"]) != steps:
        raise RuntimeError(f"{what}: losses {h_a['loss']}")
    s_a = h_a.pop("final_state")
    final_a = {"params": {k: v.cpu() for k, v in
                          s_a["params"].state_dict().items()},
               "m": {k: v.cpu() for k, v in s_a["opt"].m.items()},
               "v": {k: v.cpu() for k, v in s_a["opt"].v.items()},
               "step": int(s_a["opt"].step)}
    del s_a
    torch.cuda.empty_cache()
    ck_b = CheckpointManager(str(ck_root / "b"), keep=1)
    try:
        run_training(loss_fn, init_fn, batch_fn, opt_cfg,
                     TrainLoopConfig(**loop, fail_at_step=every), ckpt=ck_b,
                     **kw)
        raise RuntimeError("the injected failure did not fire")
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
    t0 = time.perf_counter()
    h_b = run_training(loss_fn, init_fn, batch_fn, opt_cfg,
                       TrainLoopConfig(**loop), ckpt=ck_b, **kw)
    log(f"  {what}: resumed run from step {h_b['step'][0] - 1}: "
        f"{time.perf_counter() - t0:.1f} s (restore included)")
    shutil.rmtree(ck_root, ignore_errors=True)
    s_b = h_b.pop("final_state")
    same = h_b["step"] == h_a["step"][every:] and \
        h_b["loss"] == h_a["loss"][every:]
    same &= all(torch.equal(final_a["params"][k], t.cpu())
                for k, t in s_b["params"].state_dict().items())
    for f in ("m", "v"):
        same &= all(torch.equal(final_a[f][k], t.cpu())
                    for k, t in getattr(s_b["opt"], f).items())
    same &= final_a["step"] == int(s_b["opt"].step) == steps
    log(f"  {what}: losses, uninterrupted: {h_a['loss']}; resumed steps "
        f"{h_b['step']}: {h_b['loss']}; parameters, m and v bit-equal: "
        f"{same}")
    if not same:
        raise RuntimeError(f"{what}: the resumed run differs from the "
                           "uninterrupted one")
    return got, h_a["loss"], s_b


def phase_train(dev) -> dict:
    """LM training at full width: qwen2-0.5b in bf16 with remat on the
    ``LMStream`` at ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens a step, AdamW on
    the card, all under ``torch.use_deterministic_algorithms(True)``.
    Returns the main path's launches by kernel."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipelines import LMStream
    from repro_torch.models.transformer import (Transformer, decay_mask,
                                                init_params, loss_fn)
    from repro_torch.train.loop import to_device
    from repro_torch.train.optimizer import AdamWConfig, make_train_step
    t_phase = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    cfg = get_config(LM_ARCH).model_cfg
    L = cfg.n_layers
    if not cfg.remat or cfg.dtype != torch.bfloat16:
        raise RuntimeError(f"{cfg.name}: expected remat in bf16")
    per_step = {"flash_attention": 2 * L, "flash_attention_bwd": L,
                "rmsnorm": 4 * L + 1, "rmsnorm_bwd": 2 * L + 1}
    none = {k: 0 for k in per_step}
    stream = LMStream(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                          decay_steps=TRAIN_STEPS)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"  {cfg.name} bf16, remat, LMStream {TRAIN_BATCH} x {TRAIN_SEQ} = "
        f"{tokens} tokens a step, AdamW (lr {TRAIN_LR}, warm-up 2); "
        "torch.use_deterministic_algorithms(True)")
    launches = dict(none)

    # -- agreement: one step with the kernels, with the plain versions and
    # with the plain versions on the same weights in f32
    batch = to_device(stream.batch(0), dev)
    model = init_params(cfg, seed=SEED, device=dev)
    init = {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}
    zero_lm_counts()
    t0 = time.perf_counter()
    loss_k, gn_k, g_k = train_step(model, batch, "auto", opt_cfg)
    log(f"  first step (kernels): {time.perf_counter() - t0:.3f} s, loss "
        f"{loss_k:.6f}, grad norm {gn_k:.6f}")
    for k, c in expect_counts("training step (kernels)", per_step).items():
        launches[k] += c
    p_k = {k: v.detach().clone() for k, v in model.named_parameters()}
    model.load_state_dict(init)
    zero_lm_counts()
    t0 = time.perf_counter()
    loss_p, gn_p, g_p = train_step(model, batch, "ref", opt_cfg)
    log(f"  step (plain versions): {time.perf_counter() - t0:.3f} s, loss "
        f"{loss_p:.6f}, grad norm {gn_p:.6f}")
    expect_counts("training step (plain)", none)
    p_p = {k: v.detach().clone() for k, v in model.named_parameters()}
    del model
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    model32 = Transformer(dataclasses.replace(cfg, dtype=torch.float32),
                          torch.Generator(device=dev))
    model32.load_state_dict(init)                       # bf16 -> f32
    loss_32, gn_32, g_32 = train_step(model32, batch, "ref", opt_cfg)
    p_32 = {k: v.detach() for k, v in model32.named_parameters()}
    del model32
    log(f"  f32 step (plain versions): loss {loss_32:.6f}, grad norm "
        f"{gn_32:.6f}")
    # like with like: each quantity against the plain bf16 step's distance
    # from the f32 one in the same quantity
    for what, diff, floor in (("loss", abs(loss_k - loss_p),
                               abs(loss_p - loss_32)),
                              ("grad norm", abs(gn_k - gn_p),
                               abs(gn_p - gn_32))):
        tol = LM_TOL_FLOORS * floor
        log(f"  kernels vs plain, {what}: {diff:.4g} (tolerance "
            f"{LM_TOL_FLOORS} x {floor:.4g} = {tol:.4g}): "
            f"{'ok' if diff <= tol else 'FAIL'}")
        if not diff <= tol:
            raise RuntimeError(f"training step, kernels vs plain: {what} "
                               f"{diff} > {tol}")
    # gradients tensor by tensor. The updated parameters are bf16 on both
    # sides, so the f32 step's are rounded to bf16 first; they are held by
    # group: AdamW's first step is lr * g / (|g| + eps), a sign, and a
    # component whose gradient is within rounding of 0 may flip, moving by
    # 2 * lr. A 128-wide bias sees 0 or 1 such flips, no stable
    # yardstick for it alone
    check_agreement("gradient", leaf_dists(g_k, g_p),
                    leaf_dists(g_p, g_32), each_tensor=True)
    check_agreement("updated parameters", leaf_dists(p_k, p_p),
                    leaf_dists(p_p, {k: v.to(p_p[k].dtype)
                                     for k, v in p_32.items()}),
                    each_tensor=False)
    del g_k, g_p, g_32, p_k, p_p, p_32
    torch.cuda.empty_cache()
    log(f"  agreement: {time.perf_counter() - t_phase:.1f} s")

    # -- restart: TRAIN_STEPS steps with a checkpoint every
    # TRAIN_CKPT_EVERY, against a run that fails there and resumes
    got, _, state = restart_run(
        cfg.name, loss_fn, lambda: init_params(cfg, seed=SEED, device=dev),
        stream.batch, opt_cfg, TRAIN_STEPS, TRAIN_CKPT_EVERY, dev,
        decay_mask, per_step)
    for k, c in got.items():
        launches[k] += c
    model, opt = state["params"], state["opt"]
    del state
    torch.cuda.empty_cache()

    # -- throughput, peak memory and a profiled step
    step_fn = make_train_step(loss_fn, opt_cfg, decay=decay_mask(
        dict(model.named_parameters())))
    torch.cuda.reset_peak_memory_stats(dev)
    seconds = []
    for i in range(3):
        b = to_device(stream.batch(TRAIN_STEPS + i), dev)
        t0 = time.perf_counter()
        model, opt, metrics = step_fn(model, opt, b)
        loss = metrics["loss_total"].item()
        seconds.append(time.perf_counter() - t0)
        if not math.isfinite(loss):
            raise RuntimeError(f"loss {loss} at a timed step")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    rate = tokens / statistics.mean(seconds[1:])
    log(f"  training steps: {[round(x, 4) for x in seconds]} s; "
        f"{rate:.0f} tok/s (steps 2-3); peak {peak:.2f} GiB")
    b = to_device(stream.batch(TRAIN_STEPS + 3), dev)
    device_profile("one training step (kernels)",
                   lambda: step_fn(model, opt, b))
    torch.use_deterministic_algorithms(False)
    del model, opt
    torch.cuda.empty_cache()
    log(f"  phase 9: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 10: MoE and MLA serving at full width
# ---------------------------------------------------------------------------


def moe_modules(module):
    from repro_torch.layers.moe import MoE
    return [m for m in module.modules() if isinstance(m, MoE)]


@contextlib.contextmanager
def routing_recorded(modules, into: list):
    """Forward hooks on MoE ``modules`` that append each call's routing
    (the top-k expert set of every token, sorted) to ``into``, in call
    order. The route is recomputed from the layer's input (a [n_tok, E]
    f32 product), outside the layer's own work."""
    def hook(mod, inp, _):
        x = inp[0]
        into.append(mod.route(x.reshape(-1, x.shape[-1])).experts
                    .sort(dim=-1).values)
    handles = [m.register_forward_hook(hook) for m in modules]
    try:
        yield into
    finally:
        for h in handles:
            h.remove()


def routing_flips(a: list, b: list) -> str:
    """Tokens whose expert set differs between two runs' routings, summed
    over the MoE layers, and tokens with a difference in any layer."""
    import torch
    diff = torch.stack([(x != y).any(dim=-1) for x, y in zip(a, b)])
    return (f"{int(diff.sum())} of {diff.numel()} (token, layer) expert "
            f"sets differ; {int(diff.any(dim=0).sum())} of {diff.shape[1]} "
            "tokens differ in some layer")


def prefill_f32_by_layer(model, tokens, into: list):
    """``prefill_step`` of ``model`` in f32 (the plain versions, TF32 off)
    without an f32 copy of the whole model: the embedding rows in f32,
    then each block copied to f32 alone (at most one MoE block, 2.2 GiB
    for deepseek, at a time), the final norm and an f32 copy of the head
    on the last position. The same function as the f32 model's
    ``prefill_step``, term by term. Routing goes to ``into``."""
    import copy
    import torch
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device).expand(b, t)
    x = model.embed[tokens].float()
    for layer in model.layers:
        block = copy.deepcopy(layer).float()
        with routing_recorded(moe_modules(block), into):
            x, _ = block(x, positions, None, attn_impl="ref",
                         norm_impl="ref")
        del block
    x = model.final_norm(x[:, -1:], impl="ref")
    head = model.embed.T if model.lm_head is None else model.lm_head
    return (x @ head.float())[:, -1]


def prefill_f32(model, tokens, into: list, by_layer: bool):
    """The yardstick's f32 run: the whole model copied to f32 (as phase 5
    does), or block by block where that copy does not fit beside the
    bf16 model (:func:`prefill_f32_by_layer`)."""
    import torch
    from repro_torch.models.transformer import Transformer, prefill_step
    if by_layer:
        with torch.inference_mode():
            return prefill_f32_by_layer(model, tokens, into)
    model32 = Transformer(dataclasses.replace(model.cfg,
                                              dtype=torch.float32),
                          torch.Generator(device=tokens.device))
    model32.load_state_dict(model.state_dict())       # bf16 -> f32 copy
    with routing_recorded(moe_modules(model32), into):
        out = prefill_step(model32, tokens, attn_impl="ref",
                           norm_impl="ref")
    del model32
    torch.cuda.empty_cache()
    return out


def device_ms_by_kind(rows: list) -> dict:
    """Device ms of :func:`device_profile`'s kernel ``rows`` summed by
    kind of kernel."""
    kinds = (("flash_attention_bwd", ("dkdv_bf16_kernel", "dq_bf16_kernel",
                                      "rowdot_kernel")),
             ("flash_attention", ("flash_bf16_kernel",)),
             ("rmsnorm", ("rmsnorm",)),
             ("matmul", ("gemm", "nvjet", "sm90_", "cutlass", "xmma")),
             ("sort/search", ("sort", "Sort", "radix", "searchsorted")),
             ("gather/index", ("index", "Index", "gather", "Gather")),
             ("elementwise/copy", ("elementwise", "copy", "Copy", "Cat",
                                   "Functor", "reduce")))
    out = {}
    for us, _, key in rows:
        kind = next((k for k, words in kinds
                     if any(w in key for w in words)), "other")
        out[kind] = out.get(kind, 0.0) + us / 1e3
    return out


def moe_stage_ms(model, tokens) -> dict:
    """Device ms of each stage of the last MoE layer at the prefill shape
    (CUDA events, the layer's own input caught by a hook): the router,
    the dispatch (sort, slots), the gather of the expert inputs, the
    expert products, the combine and the shared experts."""
    import torch
    from repro_torch.models.transformer import prefill_step
    moe = moe_modules(model)[-1]
    seen = []
    handle = moe.register_forward_hook(lambda m, i, o: seen.append(i[0]))
    prefill_step(model, tokens)
    handle.remove()
    x = seen[0]
    xf = x.reshape(-1, x.shape[-1])
    r = moe.route(xf)
    disp = moe.dispatch(r.experts)
    xin = moe.gather(xf, disp)
    y = moe.expert_ffn(xin)
    stages = {"route": lambda: moe.route(xf),
              "dispatch": lambda: moe.dispatch(r.experts),
              "gather": lambda: moe.gather(xf, disp),
              "experts": lambda: moe.expert_ffn(xin),
              "combine": lambda: moe.combine(y, r.gates, disp)}
    if moe.shared is not None:
        stages["shared"] = lambda: moe.shared(x)
    out = {k: cuda_time_ms(fn, 5) for k, fn in stages.items()}
    out["cap"] = disp.cap
    del seen, x, xf, r, disp, xin, y
    torch.cuda.empty_cache()
    return out


def phase_moe_lm(dev, arch: str) -> dict:
    """One MoE model at full width in bf16 from seed 0 on the card:
    ``prefill_step`` at LM_BATCH x LM_SEQ with the kernels (twice: the
    same bits) and the plain versions against an f32 yardstick, the
    routing flips between them, the serve loop with the kernels and
    teacher-forced with the plain versions, and decode after the prompt
    against ``prefill_step`` with no drops. Returns the main path's
    launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_loop
    from repro_torch.layers.moe import no_drops
    from repro_torch.models.transformer import init_params, prefill_step
    t_arch = time.perf_counter()
    cfg = get_config(arch).model_cfg
    L, mla = cfg.n_layers, cfg.attn_kind == "mla"
    n_moe = L - cfg.first_dense_layers
    model = init_params(cfg, seed=SEED, device=dev)
    n = sum(p.numel() for p in model.parameters())
    extra = L * cfg.kv_lora_rank if mla else 0
    log(f"  {cfg.name}: {n} parameters ({cfg.n_params} by the config"
        f"{f' + {extra} MLA latent-norm gains' if mla else ''}), "
        f"{str(cfg.dtype)[6:]}, {L} layers ({n_moe} MoE: {cfg.n_experts} "
        f"experts top-{cfg.top_k}, {cfg.n_shared} shared), "
        f"{'MLA' if mla else 'GQA'} attention; initialised on the card in "
        f"{time.perf_counter() - t_arch:.1f} s, "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB")
    # the config's count (the reference's) takes int() of L times the
    # mean FFN size over the layers: at most L - 1 short
    if not 0 <= n - cfg.n_params - extra < L:
        raise RuntimeError(f"{n} parameters, the config says "
                           f"{cfg.n_params} + {extra}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    tokens = torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ), generator=gen,
                           device=dev)
    norms = (3 if mla else 2) * L + 1
    none = {"flash_attention": 0, "rmsnorm": 0, "flash_attention_bwd": 0,
            "rmsnorm_bwd": 0}
    launches = dict(none)
    moes = moe_modules(model)

    runs, routes = {}, {}
    for tag, impl in (("kernels", "auto"), ("plain", "ref")):
        prefill_step(model, tokens[:, :128], attn_impl=impl,
                     norm_impl=impl)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_lm_counts()
        routes[tag] = []
        with routing_recorded(moes, routes[tag]):
            t0 = time.perf_counter()
            runs[tag] = prefill_step(model, tokens, attn_impl=impl,
                                     norm_impl=impl)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        log(f"  prefill_step {LM_BATCH} x {LM_SEQ} ({tag}): {dt:.4f} s "
            f"(routing recorded), {LM_BATCH * LM_SEQ / dt:.0f} tok/s, peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        got = expect_counts(f"prefill ({tag})",
                            {**none, "flash_attention": L, "rmsnorm": norms}
                            if tag == "kernels" else none)
        if tag == "kernels":
            for k, c in got.items():
                launches[k] += c
    logits = runs["kernels"]
    if logits.shape != (LM_BATCH, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"prefill logits {tuple(logits.shape)} not finite "
                           "or of the wrong shape")
    # timed without hooks, and the repeat must give the same bits
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = prefill_step(model, tokens)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"  prefill_step {LM_BATCH} x {LM_SEQ} (kernels, again): {dt:.4f} s, "
        f"{LM_BATCH * LM_SEQ / dt:.0f} tok/s; bit-equal to the first: "
        f"{torch.equal(again, logits)}")
    if not torch.equal(again, logits):
        raise RuntimeError("a repeat of the same prefill gives other logits")

    # the yardstick: the same weights in f32, the plain versions, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    by_layer = arch in F32_BY_LAYER
    routes["f32"] = []
    t0 = time.perf_counter()
    ref32 = prefill_f32(model, tokens, routes["f32"], by_layer)
    torch.cuda.synchronize()
    how = "block by block" if by_layer else "an f32 copy of the model"
    log(f"  f32 yardstick ({how}): {time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    floor = float((runs["plain"].float() - ref32).abs().max())
    err32 = float((logits.float() - ref32).abs().max())
    tol = LM_TOL_FLOORS * floor
    log(f"  routing flips, kernels vs plain (bf16): "
        f"{routing_flips(routes['kernels'], routes['plain'])}")
    log(f"  routing flips, plain bf16 vs f32: "
        f"{routing_flips(routes['plain'], routes['f32'])}")
    log(f"  prefill logits vs the f32 model: plain bf16 {floor:.4g} (the "
        f"bf16 floor), kernels bf16 {err32:.4g}; tolerance "
        f"{LM_TOL_FLOORS} x floor = {tol:.4g}")
    del routes
    if not err32 <= tol:
        raise RuntimeError(f"prefill with the kernels is {err32} from the "
                           f"f32 model, more than {tol}")
    compare_logits("prefill last-position logits, kernels vs plain",
                   logits, runs["plain"], tol)
    del ref32, runs
    torch.cuda.empty_cache()
    log(f"  ({time.perf_counter() - t_arch:.1f} s in)")

    # where a prefill's device time goes
    kinds = device_ms_by_kind(device_profile(
        "prefill_step (kernels)", lambda: prefill_step(model, tokens)))
    total = sum(kinds.values())
    log(f"  prefill device ms by kind of kernel (the profile above): "
        + ", ".join(f"{k} {v:.3f} ({100 * v / max(total, 1e-9):.1f}%)"
                    for k, v in sorted(kinds.items(), key=lambda x: -x[1]))
        + f"; total {total:.3f}")
    with torch.inference_mode():
        stages = moe_stage_ms(model, tokens)
    cap = stages.pop("cap")
    moe_ms = sum(stages.values())
    dispatch_ms = sum(stages[k] for k in ("route", "dispatch", "gather",
                                          "combine"))
    log(f"  one MoE layer at the prefill shape (cap {cap}), device ms by "
        "CUDA events: " + ", ".join(f"{k} {v:.4f}"
                                    for k, v in stages.items())
        + f"; layer total {moe_ms:.4f}, x {n_moe} layers = "
        f"{moe_ms * n_moe:.3f} ms: dispatch (route, dispatch, gather, "
        f"combine) {dispatch_ms * n_moe:.3f} ms, expert products "
        f"{stages['experts'] * n_moe:.3f} ms; flash "
        f"{kinds.get('flash_attention', 0.0):.3f} ms a prefill")
    log(f"  ({time.perf_counter() - t_arch:.1f} s in)")

    # the serve loop, kernels, then teacher-forced with the plain versions
    prompt = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           generator=gen, device=dev)
    serve_loop(model, prompt, 2, SERVE_CACHE)          # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    zero_lm_counts()
    out = serve_loop(model, prompt, SERVE_STEPS, SERVE_CACHE)
    steps = SERVE_PROMPT + SERVE_STEPS
    log(f"  serve loop batch {SERVE_BATCH}, prompt {SERVE_PROMPT}, decode "
        f"{SERVE_STEPS}, cache {SERVE_CACHE} (kernels): "
        f"{out['seconds']:.4f} s, {SERVE_BATCH * steps / out['seconds']:.0f}"
        f" tok/s, peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
        f"GiB; sample {out['tokens'][0][:16].tolist()}")
    got = expect_counts("serve loop (kernels)",
                        {**none, "rmsnorm": norms * steps})
    for k, c in got.items():
        launches[k] += c
    zero_lm_counts()
    plain = serve_loop(model, prompt, SERVE_STEPS, SERVE_CACHE,
                       norm_impl="ref", forced=out["tokens"])
    log(f"  serve loop teacher-forced (plain): {plain['seconds']:.4f} s, "
        f"{SERVE_BATCH * steps / plain['seconds']:.0f} tok/s")
    expect_counts("serve loop (plain)", none)
    compare_logits(f"serve loop, all {steps} steps' logits, kernels vs plain",
                   out["logits"], plain["logits"], tol)
    del plain
    log(f"  ({time.perf_counter() - t_arch:.1f} s in)")
    # decode after the prompt == prefill_step, with nothing dropped in
    # either (a decode step of SERVE_BATCH tokens has cap 1 otherwise)
    with no_drops(model):
        nd = serve_loop(model, prompt, 1, SERVE_CACHE)
        pre = prefill_step(model, prompt)
    compare_logits("decode logits after the prompt vs prefill_step "
                   "(capacity_factor = E / k)",
                   nd["logits"][SERVE_PROMPT - 1], pre, tol)
    # a short window: the profiler's host-side records of an MoE decode
    # step (~40 ops a layer) take it tens of seconds to sum at 16 + 8
    log(f"  ({time.perf_counter() - t_arch:.1f} s in)")
    device_profile("serve loop, 4 + 4 steps (kernels)",
                   lambda: serve_loop(model, prompt[:, :4], 4, SERVE_CACHE))
    del model, out, nd, pre
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  {arch}: {time.perf_counter() - t_arch:.1f} s")
    return launches


def phase_moe(dev) -> dict:
    """Phase 10: each of MOE_ARCHS in turn (:func:`phase_moe_lm`), freed
    before the next. Returns the main path's launches summed."""
    import torch
    t_phase = time.perf_counter()
    launches = {}
    for arch in MOE_ARCHS:
        for k, c in phase_moe_lm(dev, arch).items():
            launches[k] = launches.get(k, 0) + c
    torch.cuda.empty_cache()
    log(f"  phase 10: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 11: MoE and MLA training at full width
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def routing_fixed(modules, table: dict, flips: list):
    """Each MoE module's ``route`` patched while the context is open (in
    this script only): the module at position i of ``modules`` takes the
    experts of ``table[i]`` (another run's, in their order), with gates
    recomputed from this run's probabilities and renormalised over the k,
    the function ``jax.grad`` differentiates; a module without an entry
    records its first call's experts there first. Every call takes that
    one form (the values and gradients of ``MoE.route``'s own top-k), so
    remat's recompute saves what the forward saved. Each call appends
    the tokens whose own top-k set differs from the table's to
    ``flips``."""
    from repro_torch.layers.moe import Routing

    def fixed(mod, i):
        own = mod.route

        def route(xf):
            r = own(xf)
            if i not in table:
                table[i] = r.experts.detach().clone()
            want = table[i]
            flips.append(int((r.experts.sort(dim=-1).values !=
                              want.sort(dim=-1).values).any(dim=-1).sum()))
            gates = r.probs.gather(-1, want)
            return Routing(gates / gates.sum(dim=-1, keepdim=True), want,
                           r.probs)
        return route
    for i, m in enumerate(modules):
        m.route = fixed(m, i)
    try:
        yield table
    finally:
        for m in modules:
            del m.route                             # the class's again


def grad_step(model, batch, impl: str):
    """``loss_fn`` and its backward with ``impl`` for both kernels, no
    optimizer: (loss, grad norm, aux, the gradients by name)."""
    import torch
    from repro_torch.models.transformer import loss_fn
    from repro_torch.train.optimizer import global_norm
    loss, metrics = loss_fn(model, batch, attn_impl=impl, norm_impl=impl)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    gn = float(global_norm(grads))
    torch.cuda.synchronize()
    return loss.item(), gn, metrics["aux"].item(), grads


def leaf_dists_on(a: dict, b: dict, dev) -> dict:
    """:func:`leaf_dists` with each pair moved to ``dev`` for its turn
    (the gradients of two runs wait on the host)."""
    return {k: leaf_dists({k: a[k].to(dev)}, {k: b[k].to(dev)})[k]
            for k in a}


def phase_moe_train_lm(dev, arch: str) -> dict:
    """One MoE model's training at full width (``MOE_TRAIN_LAYERS`` layers)
    in bf16 with remat on ``LMStream`` TRAIN_BATCH x TRAIN_SEQ, under
    deterministic algorithms: a step's loss, aux, grad norm and every
    gradient with the kernels against the plain versions within
    ``LM_TOL_FLOORS`` x the plain bf16 step's distance from the same
    weights in f32, all three on the kernel run's routing (replayed, its
    flips logged); then ``MOE_TRAIN_STEPS`` AdamW steps at
    ``MOE_RESTART_LAYERS`` layers with a checkpoint and a failed-and-
    resumed run that must be bit-exact, exact launches; then
    ``MOE_TIMED_STEPS`` AdamW steps at ``MOE_TRAIN_LAYERS`` layers from
    seed 0 (tok/s; the loss must fall over them), peak memory and a
    profiled step. Returns the main path's launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipelines import LMStream
    from repro_torch.models.transformer import (Transformer, decay_mask,
                                                init_params, loss_fn)
    from repro_torch.train.loop import to_device
    from repro_torch.train.optimizer import AdamWConfig, make_train_step
    t_arch = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch).model_cfg,
                              n_layers=MOE_TRAIN_LAYERS[arch])
    L, mla = cfg.n_layers, cfg.attn_kind == "mla"
    if not cfg.remat or cfg.dtype != torch.bfloat16:
        raise RuntimeError(f"{cfg.name}: expected remat in bf16")
    norms = 3 if mla else 2
    per_step = {"flash_attention": 2 * L, "flash_attention_bwd": L,
                "rmsnorm": 2 * norms * L + 1, "rmsnorm_bwd": norms * L + 1}
    none = {k: 0 for k in per_step}
    launches = dict(none)
    stream = LMStream(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    batch = to_device(stream.batch(0), dev)
    model = init_params(cfg, seed=SEED, device=dev)
    n = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name}: {L} of {get_config(arch).model_cfg.n_layers} layers "
        f"({L - cfg.first_dense_layers} MoE), {n} parameters, bf16, remat, "
        f"LMStream {TRAIN_BATCH} x {TRAIN_SEQ} = {tokens} tokens a step; "
        f"torch.use_deterministic_algorithms(True)")

    # -- agreement on one routing: the kernel step records it, the plain
    # bf16 and f32 steps replay it
    table, flips = {}, {"kernels": [], "kernels again": [], "plain": [],
                        "f32": []}
    moes = moe_modules(model)
    zero_lm_counts()
    t0 = time.perf_counter()
    with routing_fixed(moes, table, flips["kernels"]):
        loss_k, gn_k, aux_k, g_k = grad_step(model, batch, "auto")
    log(f"  first step (kernels, no optimizer): "
        f"{time.perf_counter() - t0:.3f} s, loss {loss_k:.6f} (aux "
        f"{aux_k:.6f}), grad norm {gn_k:.6f}")
    for k, c in expect_counts("training step (kernels)",
                              {**per_step}).items():
        launches[k] += c
    with routing_fixed(moes, table, flips["kernels again"]):
        loss_r, _, _, g_r = grad_step(model, batch, "auto")
    same = loss_r == loss_k and all(torch.equal(g_r[k], g_k[k])
                                    for k in g_k)
    zero_lm_counts()
    log(f"  a repeated kernel step (replayed routing): the same bits "
        f"{same}")
    if not same:
        raise RuntimeError("a repeated training step differs")
    del g_r
    g_k = {k: v.cpu() for k, v in g_k.items()}
    t0 = time.perf_counter()
    with routing_fixed(moes, table, flips["plain"]):
        loss_p, gn_p, aux_p, g_p = grad_step(model, batch, "ref")
    log(f"  step (plain versions, replayed routing): "
        f"{time.perf_counter() - t0:.3f} s, loss {loss_p:.6f}, grad norm "
        f"{gn_p:.6f}")
    expect_counts("training step (plain)", none)
    g_p = {k: v.cpu() for k, v in g_p.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    model32 = Transformer(dataclasses.replace(cfg, dtype=torch.float32),
                          torch.Generator(device=dev))
    model32.load_state_dict(model.state_dict())          # bf16 -> f32
    del model
    torch.cuda.empty_cache()
    with routing_fixed(moe_modules(model32), table, flips["f32"]):
        loss_32, gn_32, _, g_32 = grad_step(model32, batch, "ref")
    del model32
    log(f"  f32 step (plain versions, replayed routing): loss "
        f"{loss_32:.6f}, grad norm {gn_32:.6f}")
    n_sets = tokens * len(moes)
    for tag, f in flips.items():
        log(f"  routing flips, {tag} run against the kernel run's routing: "
            f"{sum(f)} of {n_sets} (token, layer) expert sets "
            f"({100 * sum(f) / n_sets:.2f}%; recompute calls included: "
            f"{len(f)} calls)")
    if sum(flips["kernels again"]) or sum(flips["kernels"]):
        raise RuntimeError("the kernel run's own routing changed between "
                           "its forward and its recompute")
    for what, diff, floor in (("loss", abs(loss_k - loss_p),
                               abs(loss_p - loss_32)),
                              ("grad norm", abs(gn_k - gn_p),
                               abs(gn_p - gn_32))):
        tol = LM_TOL_FLOORS * floor
        log(f"  kernels vs plain, {what}: {diff:.4g} (tolerance "
            f"{LM_TOL_FLOORS} x {floor:.4g} = {tol:.4g}): "
            f"{'ok' if diff <= tol else 'FAIL'}")
        if not diff <= tol:
            raise RuntimeError(f"{arch} training step, kernels vs plain: "
                               f"{what} {diff} > {tol}")
    check_agreement("gradient", leaf_dists_on(g_k, g_p, dev),
                    leaf_dists_on(g_p, g_32, dev), each_tensor=True)
    del g_k, g_p, g_32
    torch.cuda.empty_cache()
    log(f"  agreement: {time.perf_counter() - t_arch:.1f} s")

    # -- restart: MOE_TRAIN_STEPS AdamW steps with a checkpoint every
    # MOE_TRAIN_CKPT_EVERY, against a run that fails there and resumes
    rcfg = dataclasses.replace(cfg, n_layers=MOE_RESTART_LAYERS[arch])
    opt_cfg = AdamWConfig(lr=MOE_TRAIN_LR, warmup_steps=1,
                          decay_steps=MOE_TRAIN_STEPS + MOE_TIMED_STEPS)
    got, _, state = restart_run(
        f"{cfg.name}, {rcfg.n_layers} layers", loss_fn,
        lambda: init_params(rcfg, seed=SEED, device=dev), stream.batch,
        opt_cfg, MOE_TRAIN_STEPS, MOE_TRAIN_CKPT_EVERY, dev, decay_mask,
        {"flash_attention": 2 * rcfg.n_layers,
         "flash_attention_bwd": rcfg.n_layers,
         "rmsnorm": 2 * norms * rcfg.n_layers + 1,
         "rmsnorm_bwd": norms * rcfg.n_layers + 1})
    for k, c in got.items():
        launches[k] += c
    del state
    torch.cuda.empty_cache()

    # -- at MOE_TRAIN_LAYERS layers from seed 0: timed AdamW steps (the
    # loss must fall over them), peak memory, a profiled step
    from repro_torch.train.optimizer import adamw_init
    model = init_params(cfg, seed=SEED, device=dev)
    opt = adamw_init(dict(model.named_parameters()))
    step_fn = make_train_step(loss_fn, opt_cfg, decay=decay_mask(
        dict(model.named_parameters())))
    torch.cuda.reset_peak_memory_stats(dev)
    seconds, losses = [], []
    for i in range(MOE_TIMED_STEPS):
        b = to_device(stream.batch(i), dev)
        t0 = time.perf_counter()
        model, opt, metrics = step_fn(model, opt, b)
        losses.append(metrics["loss_total"].item())
        seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    rate = tokens / statistics.mean(seconds[1:])
    # the first step's batch again, after the steps: its loss must fall
    # (a fixed batch, so the batches' own spread does not enter)
    with torch.no_grad():
        after = loss_fn(model, to_device(stream.batch(0), dev))[0].item()
    log(f"  {L} layers, AdamW steps (lr {MOE_TRAIN_LR}): "
        f"{[round(x, 4) for x in seconds]} s; {rate:.0f} tok/s (all but "
        f"the first); peak {peak:.2f} GiB; losses "
        f"{[round(x, 4) for x in losses]}; the first batch's loss "
        f"{losses[0]:.4f} before, {after:.4f} after")
    if not all(math.isfinite(x) for x in losses) or \
            not after < losses[0]:
        raise RuntimeError(f"{arch}: the loss did not fall: {losses}, "
                           f"{after} after")
    b = to_device(stream.batch(MOE_TIMED_STEPS), dev)
    rows = device_profile(f"one {cfg.name} training step (kernels)",
                          lambda: step_fn(model, opt, b))
    kinds = device_ms_by_kind(rows)
    busy = sum(kinds.values())
    if busy:
        log("  device ms of the step by kind: " + ", ".join(
            f"{k} {ms:.1f} ({100 * ms / busy:.1f}%)"
            for k, ms in sorted(kinds.items(), key=lambda x: -x[1])))
    del model, opt
    torch.cuda.empty_cache()
    log(f"  {cfg.name}: {time.perf_counter() - t_arch:.1f} s")
    return launches


def phase_moe_train(dev) -> dict:
    """Phase 11: each of MOE_ARCHS in turn (:func:`phase_moe_train_lm`),
    freed after, under ``torch.use_deterministic_algorithms(True)``."""
    import torch
    t_phase = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    launches = {}
    for arch in MOE_ARCHS:
        for k, c in phase_moe_train_lm(dev, arch).items():
            launches[k] = launches.get(k, 0) + c
    torch.use_deterministic_algorithms(False)
    log(f"  phase 11: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 12: BST (recsys) at full width
# ---------------------------------------------------------------------------


def bst_f64(model):
    """A float64 copy of a BST model on the CPU (the yardstick)."""
    import copy
    import torch
    cpu = copy.deepcopy(model).to("cpu", torch.float64)
    cpu.cfg = dataclasses.replace(model.cfg, dtype=torch.float64)
    return cpu


def check_close(tag: str, got, want, tol: float) -> float:
    """``max|got - want| <= tol * max(1, max|want|)`` or raise; returns
    the error."""
    err = float((got.double().cpu() - want).abs().max()) if want.numel() \
        else 0.0
    bound = tol * max(1.0, float(want.abs().max()) if want.numel() else 0.0)
    log(f"  {tag}: max_abs_err {err:.3g} against f64 (tolerance "
        f"{bound:.3g}): {'ok' if err <= bound else 'FAIL'}")
    if not err <= bound:
        raise RuntimeError(f"{tag}: {err} > {bound}")
    return err


def phase_bst(dev) -> None:
    """BST at full width on the card (f32, TF32 off), through the entry
    points a user calls: ``serve_recsys`` (the serve CLI's loop) at the p99
    and bulk batches in req/s; ``bst_retrieval`` of one user against every
    one of the 10^6 items, in chunks sized from the bytes reckoned here;
    ``run_training`` with ``bst_loss`` at 65,536 rows a step under
    deterministic algorithms (a repeated step bit-equal, the loss falling,
    a checkpoint and a failed-and-resumed run bit-exact), rows/s, peak
    memory and a profiled step. Scores, retrieval logits, the loss and
    every gradient are held against an f64 CPU run of the same weights on
    ``BST_CHECK_ROWS`` rows and candidates, within ``BST_TOL``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.bst import SHAPES
    from repro_torch.data.pipelines import RecsysStream
    from repro_torch.launch.serve import serve_recsys
    from repro_torch.models.bst import (bst_decay_mask, bst_loss,
                                        bst_retrieval, bst_scores,
                                        init_bst_params)
    from repro_torch.train.loop import to_device
    from repro_torch.train.optimizer import AdamWConfig, make_train_step
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("bst").model_cfg
    if sorted(BST_SERVE_BATCHES) != sorted(
            SHAPES[k]["batch"] for k in ("serve_p99", "serve_bulk")):
        raise RuntimeError(f"serving batches differ from {SHAPES}")
    model = init_bst_params(cfg, seed=SEED, device=dev)
    n = sum(p.numel() for p in model.parameters())
    log(f"  {cfg.name}: {n} parameters (config {cfg.n_params}), f32, "
        f"{cfg.n_items} items, {cfg.n_user_feats} user features in bags "
        f"of {cfg.user_feat_len}, d {cfg.embed_dim}, {cfg.seq_len} + 1 "
        f"positions, {cfg.n_heads} heads, MLP {cfg.mlp_sizes}")
    if n != cfg.n_params:
        raise RuntimeError(f"{n} parameters, the config says {cfg.n_params}")
    ref64 = bst_f64(model)
    k = BST_CHECK_ROWS

    def stream(batch):
        return RecsysStream(cfg.n_items, cfg.n_user_feats, cfg.seq_len,
                            cfg.user_feat_len, batch)

    # -- serving: the CLI's loop (seed-0 weights, the same as model's)
    for batch, steps in BST_SERVE_BATCHES.items():
        serve_recsys(cfg, batch, 1, dev)                    # warm-up
        torch.cuda.reset_peak_memory_stats(dev)
        scores, dt = serve_recsys(cfg, batch, steps, dev)
        log(f"  serve {steps} batches of {batch}: {dt:.4f} s, "
            f"{steps * batch / dt:.0f} req/s, peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, mean "
            f"CTR {float(scores.mean()):.4f}")
        last = {key: torch.from_numpy(v[:k]).long() if v.dtype.kind == "i"
                else torch.from_numpy(v[:k])
                for key, v in stream(batch).batch(steps - 1).items()}
        with torch.no_grad():
            want = torch.sigmoid(bst_scores(ref64, last["hist"],
                                            last["target"],
                                            last["user_feats"]))
        if scores.shape != (batch,) or not bool(torch.isfinite(scores).all()):
            raise RuntimeError(f"serve batch {batch}: scores "
                               f"{tuple(scores.shape)}")
        check_close(f"serve {batch}: CTR of the first {k} rows",
                    scores[:k], want, BST_TOL)
    del scores

    # -- retrieval: one user against every item, in chunks
    one = to_device(stream(1).batch(0), dev)
    cands = torch.randperm(cfg.n_items, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    c_total = SHAPES["retrieval_cand"]["n_candidates"]
    t = cfg.seq_len + 1
    d, f = cfg.embed_dim, cfg.embed_dim * cfg.d_ff_mult
    per_cand = 4 * (2 * cfg.n_heads * t * t + 8 * t * d + 2 * t * f
                    + cfg.concat_dim + 2 * sum(cfg.mlp_sizes))
    free = torch.cuda.mem_get_info(dev)[0]
    chunk = min(c_total, 1 << int(math.log2(free / 4 / per_cand)))
    log(f"  retrieval of {c_total} candidates: ~{per_cand} bytes of "
        f"activations a candidate ({per_cand * c_total / 2**30:.1f} GiB at "
        f"once; the [C, {cfg.n_heads}, {t}, {t}] f32 scores alone "
        f"{4 * cfg.n_heads * t * t * c_total / 2**30:.1f} GiB), "
        f"{free / 2**30:.1f} GiB free: chunks of {chunk} (the same scores: "
        "each row depends on its own candidate)")
    with torch.inference_mode():
        bst_retrieval(model, one["hist"], one["user_feats"], cands[:chunk],
                      chunk=chunk)                           # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        logits = bst_retrieval(model, one["hist"], one["user_feats"],
                               cands[:c_total], chunk=chunk)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    log(f"  retrieval: {dt:.4f} s, {c_total / dt:.0f} candidates/s, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, top "
        f"logit {float(logits.max()):.4f}")
    if logits.shape != (c_total,) or not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"retrieval logits {tuple(logits.shape)}")
    sample = torch.arange(0, c_total, c_total // k, device=dev)[:k]
    with torch.no_grad():
        want = bst_retrieval(ref64, one["hist"].cpu(),
                             one["user_feats"].cpu(), cands[sample].cpu())
    check_close(f"retrieval: {k} candidates' logits", logits[sample], want,
                BST_TOL)
    del logits, cands

    # -- training at 65,536 rows a step, deterministic
    torch.use_deterministic_algorithms(True)
    rows = SHAPES["train_batch"]["batch"]
    tstream = stream(rows)
    batch = to_device(tstream.batch(0), dev)
    grads = []
    for _ in range(2):
        loss, metrics = bst_loss(model, batch)
        loss.backward()
        grads.append({n_: p.grad.clone() for n_, p in
                      model.named_parameters()})
        model.zero_grad(set_to_none=True)
    same = all(torch.equal(grads[0][n_], grads[1][n_]) for n_ in grads[0])
    log(f"  a training step of {rows} rows: loss {loss.item():.6f}, acc "
        f"{metrics['acc'].item():.4f}; repeated, the same gradient bits "
        f"{same}")
    if not same:
        raise RuntimeError("BST: a repeated training step differs")
    del grads
    part = {key: v[:k] for key, v in batch.items()}
    loss, _ = bst_loss(model, part)
    loss.backward()
    got = {n_: p.grad for n_, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    loss64, _ = bst_loss(ref64, {key: v.cpu() for key, v in part.items()})
    loss64.backward()
    check_close(f"training: the loss of the first {k} rows",
                loss.detach().reshape(1), loss64.detach().reshape(1),
                BST_TOL)
    worst = max((float((got[n_].double().cpu() - p.grad).abs().max())
                 / max(float(p.grad.abs().max()), 1e-30), n_)
                for n_, p in ref64.named_parameters())
    log(f"  training: every gradient of the first {k} rows against f64, "
        f"worst max_abs_err / max|want| {worst[0]:.3g} ({worst[1]}; "
        f"tolerance {BST_TOL}): {'ok' if worst[0] <= BST_TOL else 'FAIL'}")
    if not worst[0] <= BST_TOL:
        raise RuntimeError(f"BST gradient {worst[1]}: {worst[0]}")
    del got, ref64, model
    torch.cuda.empty_cache()

    opt_cfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                          decay_steps=BST_TRAIN_STEPS)
    _, losses, state = restart_run(
        cfg.name, bst_loss, lambda: init_bst_params(cfg, seed=SEED,
                                                    device=dev),
        tstream.batch, opt_cfg, BST_TRAIN_STEPS, BST_CKPT_EVERY, dev,
        bst_decay_mask)
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"BST: the loss did not fall: {losses}")
    model, opt = state["params"], state["opt"]
    del state
    step_fn = make_train_step(bst_loss, opt_cfg, decay=bst_decay_mask(
        dict(model.named_parameters())))
    torch.cuda.reset_peak_memory_stats(dev)
    seconds = []
    for i in range(3):
        b = to_device(tstream.batch(BST_TRAIN_STEPS + i), dev)
        t0 = time.perf_counter()
        model, opt, metrics = step_fn(model, opt, b)
        metrics["loss_total"].item()
        seconds.append(time.perf_counter() - t0)
    log(f"  training steps of {rows} rows: "
        f"{[round(x, 4) for x in seconds]} s; "
        f"{rows / statistics.mean(seconds[1:]):.0f} rows/s (steps 2-3, "
        f"host batch included); peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    b = to_device(tstream.batch(BST_TRAIN_STEPS + 3), dev)
    device_profile("one BST training step", lambda: step_fn(model, opt, b))
    torch.use_deterministic_algorithms(False)
    del model, opt
    torch.cuda.empty_cache()
    log(f"  phase 12: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 6: out-of-core B-BENU (host row store + bounded device row cache)
# ---------------------------------------------------------------------------


def ooc_kw(n: int, **kw) -> dict:
    """The JAX gate's sizing (test_oocache_conformance_bounded_device_cache):
    an LRU slab of 12% and a pinned hot set of 4% of the rows."""
    return dict(cache_rows=int(OOC_CACHE_FRAC * n),
                hot=int(OOC_HOT_FRAC * n), **kw)


def describe_cache(st) -> str:
    c, x = st.extras["cache"], st.extras
    lines = [
        f"    cache: device rows {x['device_resident_rows']} "
        f"({x['device_resident_bytes'] / 2**30:.3f} GiB, slab "
        f"{x['cache_capacity_rows']}, hot {x['cache_hot_rows']}), host store "
        f"{x['host_store_bytes'] / 2**30:.3f} GiB in "
        f"{x['host_store_shards']} shards",
        f"    queries {c['queries']} (unique {c['unique_queries']}), cold "
        f"rows {c['cold_rows']}, hit rate {c['hit_rate']:.4f}, hot hits "
        f"{c['hot_hits']}, evictions {c['evictions']}, prefetch "
        f"staged/used {c['prefetch_rows']}/{c['prefetch_used']}",
        f"    H2D bytes {c['bytes_moved']} (demand {c['bytes_demand']}, "
        f"prefetch {c['bytes_prefetch']}), lookups {c['lookups']}, host "
        f"seconds in lookup {x['lookup_host_s']:.3f}"]
    for lvl, (q, cold, b) in c["per_level"].items():
        lines.append(f"    DBQ level {lvl}: {q} queries, {cold} cold, "
                     f"{b} bytes")
    return "\n".join(lines)


def phase_ooc(dev, g_mid, tri_mid, mid_runs, g_full, tri_full) -> int:
    """oocache == phase 3's torch runs at mid size (counts, level sizes, the
    house match array), at zero capacity and under tiny caps; then the
    full-size triangle on phase 4's graph with the device holding under a
    quarter of the rows. Returns the full-size runs' intersect launches."""
    import numpy as np
    import torch
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.plangen import generate_best_plan
    t_phase = time.perf_counter()
    for pname, (plan, cfg, want) in mid_runs.items():
        st = run_backend("oocache", plan, g_mid, dev,
                         backend_kw=ooc_kw(g_mid.n), **cfg)
        log(describe(f"{pname:8s} oocache  ", st))
        if st.count != want.count or st.extras["level_sizes"].tolist() != \
                want.extras["level_sizes"].tolist():
            raise RuntimeError(f"{pname}: oocache disagrees with torch")
        if cfg["collect_matches"] and \
                not np.array_equal(st.matches, want.matches):
            raise RuntimeError(f"{pname}: oocache match set differs")
        if st.extras["launches"]["sorted_intersect"] == 0:
            raise RuntimeError(f"{pname}: oocache never launched a kernel")
    plan, cfg, _ = mid_runs["triangle"]
    st = run_backend("oocache", plan, g_mid, dev,
                     backend_kw=dict(cache_rows=0, hot=0), **cfg)
    log(describe("triangle cache_rows=0", st))
    if st.count != tri_mid or st.extras["cache"]["cold_rows"] == 0:
        raise RuntimeError("oocache at zero capacity is not exact")
    st = run_backend("oocache", plan, g_mid, dev,
                     backend_kw=ooc_kw(g_mid.n), batch=MID_BATCH,
                     caps=(512, 16), max_retries=12)
    log(describe("triangle oocache tiny caps", st))
    if st.count != tri_mid or st.chunks_split == 0:
        raise RuntimeError("forced-overflow oocache run is not exact/split")
    log(f"  mid-size exact: oocache == torch on 4 patterns, "
        f"{time.perf_counter() - t_phase:.1f} s")

    plan = generate_best_plan(get_pattern("triangle"), g_full.stats())
    n = g_full.n
    launches = 0
    for prefetch in (True, False):
        kw = ooc_kw(n, prefetch=prefetch)

        def run():
            return run_backend("oocache", plan, g_full, dev, backend_kw=kw,
                               batch=FULL_BATCH, caps=FULL_CAPS)
        if prefetch:
            st = run()
        else:          # the second run, under the profiler
            held = {}
            device_profile("triangle oocache prefetch=False",
                           lambda: held.setdefault("st", run()))
            st = held["st"]
        x, c = st.extras, st.extras["cache"]
        log(describe(f"triangle oocache prefetch={prefetch}", st)
            + f" (batch {FULL_BATCH}, caps {FULL_CAPS}, all {n} starts)")
        log(describe_cache(st))
        if st.count != tri_full:
            raise RuntimeError(f"oocache: {st.count} triangles, independent "
                               f"count {tri_full}")
        if not x["device_resident_rows"] < 0.25 * (n + 1):
            raise RuntimeError(f"oocache holds {x['device_resident_rows']} "
                               "rows on the card, not under a quarter")
        if c["cold_rows"] == 0 or (prefetch and c["prefetch_used"] == 0):
            raise RuntimeError("oocache: no cold rows / prefetch unused")
        if st.extras["launches"]["sorted_intersect"] == 0:
            raise RuntimeError("oocache never launched sorted_intersect")
        launches += st.extras["launches"]["sorted_intersect"]
        torch.cuda.empty_cache()
    log(f"  phase 6: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 7: streaming S-BENU
# ---------------------------------------------------------------------------


def cycle_trace(keys, n: int, dev) -> int:
    """sum((A A) o A^T) of the digraph whose edges are the sorted int64 keys
    ``src * n + dst``: every 2-path u -> v -> w closed by an edge w -> u.
    Plain torch ops on the card (no engine, no kernel)."""
    import torch
    k = torch.from_numpy(keys).to(dev)
    src, dst = k // n, k % n
    outdeg = torch.bincount(src, minlength=n)
    start = torch.cumsum(outdeg, 0) - outdeg
    total = 0
    step = 1 << 20
    for lo in range(0, k.shape[0], step):
        u, v = src[lo:lo + step], dst[lo:lo + step]
        c = outdeg[v]
        e = torch.repeat_interleave(torch.arange(u.shape[0], device=dev), c)
        first = torch.cumsum(c, 0) - c
        j = torch.arange(e.shape[0], device=dev) - first[e]
        w = dst[start[v[e]] + j]
        q = w * n + u[e]
        pos = torch.searchsorted(k, q).clamp(max=k.shape[0] - 1)
        total += int((k[pos] == q).sum())
    return total


def edge_keys(g) -> "np.ndarray":
    """The sorted int64 keys ``src * n + dst`` of a DiGraph's edges."""
    import itertools
    import numpy as np
    src = np.repeat(np.arange(g.n, dtype=np.int64),
                    [len(s) for s in g.out])
    dst = np.fromiter(itertools.chain.from_iterable(g.out), np.int64,
                      count=src.shape[0])
    return np.sort(src * g.n + dst)


def batch_keys(batch, n: int, op: str) -> "np.ndarray":
    import numpy as np
    return np.sort(np.array([a * n + b for o, a, b in batch if o == op],
                            np.int64))


def run_stream_step(dev, engine, plans, store, **cfg):
    """One drive of a begun step; returns the stats with the wall time and
    the intersect launches in its extras."""
    import torch
    from repro_torch.core.executor import Executor
    from repro_torch.kernels import sorted_intersect as si
    backend = engine
    si.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = Executor(backend).run(plans, store, **cfg)
    torch.cuda.synchronize()
    st.extras["wall_s"] = time.perf_counter() - t0
    st.extras["launches"] = si.launches
    st.extras["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return st


def describe_step(tag, st, n_updates, n_starts) -> str:
    c = st.extras["counters"]
    w = st.extras["wall_s"]
    return (f"  {tag}: dR+ {c.matches_plus} dR- {c.matches_minus}, wall "
            f"{w:.3f} s, {n_updates / w:.0f} updates/s, {n_starts} starts, "
            f"chunks run/split {st.chunks_run}/{st.chunks_split}, levels "
            f"{st.extras['level_sizes'].tolist()}, sorted_intersect "
            f"launches {st.extras['launches']}, snapshot "
            f"{st.extras['snapshot_device_bytes']} B on the card, rebuilds "
            f"{st.extras['rebuilds']}, peak "
            f"{st.extras['peak_bytes'] / 2**30:.2f} GiB")


def phase_sbenu(dev) -> int:
    """Mid size: sbenu-torch (device and host snapshot storage) and the
    interpreter == the brute snapshot diff on five patterns, plus a
    tiny-caps run that splits. Full size: the q1' counts against the
    independent cycle count, q2' on the kernel == q2' on the binary probe.
    Returns the full-size kernel runs' intersect launches."""
    import numpy as np
    import torch
    from repro_torch.core.estimate import GraphStats
    import scipy.sparse as sp
    from repro_torch.core.executor import (Executor, ExecutorConfig,
                                           SBenuTorchBackend, drive)
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.sbenu import (enumerate_matches_digraph,
                                        generate_best_sbenu_plans,
                                        run_timestep, snapshot_diff_oracle)
    from repro_torch.core.symmetry import symmetry_breaking_constraints
    from repro_torch.graph.dynamic import SnapshotStore, stream_width_floors
    from repro_torch.graph.generate import edge_stream
    t_phase = time.perf_counter()
    n, m, b, steps = SB_MID
    g0, batches = edge_stream(n=n, m_init=m, steps=steps, batch=b,
                              seed=SEED, delete_frac=SB_DELETE)
    d, dd = stream_width_floors(g0, batches)
    log(f"  mid stream: n {n}, m_init {m}, {steps} steps of {b} updates "
        f"(delete share {SB_DELETE}), widths pinned at {d}/{dd}")
    # q1': sum((A A) o A^T) per reported match, fixed here against the
    # brute force and used unchanged at full size
    q1 = get_pattern("q1'")
    r0 = enumerate_matches_digraph(q1, g0, symmetry_breaking_constraints(q1))
    keys = edge_keys(g0)
    trace0 = cycle_trace(keys, n, dev)
    a = sp.csr_matrix((np.ones(keys.shape[0]), (keys // n, keys % n)),
                      shape=(n, n))
    if trace0 != int((a @ a).multiply(a.T).sum()):
        raise RuntimeError("cycle_trace disagrees with scipy.sparse")
    if not r0 or trace0 % len(r0):
        raise RuntimeError(f"q1': trace {trace0} over {len(r0)} matches")
    per_match = trace0 // len(r0)
    log(f"  q1' on G_0: {len(r0)} matches by brute force, "
        f"sum((A A) o A^T) = {trace0}: {per_match} per match")
    t_oracle = 0.0
    for pname in SBENU_PATTERNS:
        P = get_pattern(pname)
        plans = generate_best_sbenu_plans(P, GraphStats(n, m, delta_edges=b))
        stores = {k: SnapshotStore(g0)
                  for k in ("device", "host", "sbenu", "tiny")}
        backends = {k: SBenuTorchBackend(d_min=d, delta_d_min=dd,
                                         snapshot_storage=k, device=dev)
                    for k in ("device", "host")}
        # one run under tiny capacities (q2': its third level fans out)
        tiny = SBenuTorchBackend(d_min=d, delta_d_min=dd, device=dev) \
            if pname == "q2'" else None
        split = 0
        for step, batch in enumerate(batches, 1):
            t0 = time.perf_counter()
            want = snapshot_diff_oracle(P, stores["sbenu"], batch)
            t_oracle += time.perf_counter() - t0
            got = {k: run_timestep(P, plans, stores[k], batch, backend=be,
                                   chunk=64)[:2]
                   for k, be in backends.items()}
            got["sbenu"] = run_timestep(P, plans, stores["sbenu"], batch,
                                        engine="sbenu")[:2]
            if tiny is not None:
                store = stores["tiny"]
                store.begin_step(batch)
                st = drive(tiny, plans, store, ExecutorConfig(
                    batch=64, caps=[8] * 4, max_retries=12,
                    collect_matches=True))
                store.end_step()
                split += st.chunks_split
                got["tiny caps"] = (st.extras["delta_plus"],
                                    st.extras["delta_minus"])
            for k, (gp, gm) in got.items():
                if (gp, gm) != want:
                    raise RuntimeError(f"{pname} step {step}: {k} dR+/dR- "
                                       f"{len(gp)}/{len(gm)} != oracle "
                                       f"{len(want[0])}/{len(want[1])}")
            log(f"  {pname:4s} step {step}: dR+ {len(want[0])} dR- "
                f"{len(want[1])} == oracle for {sorted(got)}")
        if tiny is not None:
            log(f"  {pname} tiny caps: {split} splits over the stream")
            if split == 0:
                raise RuntimeError(f"{pname}: the tiny-caps run never split")
        if any(be.dstore.rebuilds != 1 for be in backends.values()):
            raise RuntimeError(f"{pname}: snapshot rebuilt more than once")
    log(f"  mid-size exact ({time.perf_counter() - t_phase:.1f} s, "
        f"oracle {t_oracle:.1f} s)")

    n, m, b, steps = SB_FULL
    t0 = time.perf_counter()
    g0, batches = edge_stream(n=n, m_init=m, steps=steps, batch=b,
                              seed=SEED, delete_frac=SB_DELETE)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    d, dd = stream_width_floors(g0, batches)
    store = SnapshotStore(g0)
    keys = edge_keys(g0)
    log(f"  full stream: n {n}, m_init {m} ({keys.shape[0]} edges), "
        f"{steps} steps of {b} updates: generated in {t_gen:.1f} s (host), "
        f"widths pinned at {d}/{dd}, store + edge keys "
        f"{time.perf_counter() - t0:.1f} s")
    q2 = get_pattern("q2'")
    stats = GraphStats(n, m, delta_edges=b)
    plans = {"q1'": generate_best_sbenu_plans(q1, stats),
             "q2'": generate_best_sbenu_plans(q2, stats)}
    runs = {"q1'": ("auto", "q1'"), "q2'": ("auto", "q2'"),
            "q2' binary": ("binary", "q2'")}
    backends = {k: SBenuTorchBackend(collect="counts", d_min=d,
                                     delta_d_min=dd, device=dev)
                for k in runs}
    c_prev = cycle_trace(keys, n, dev) // per_match
    launches = 0
    answers = []
    for step, batch in enumerate(batches, 1):
        dels, ins = batch_keys(batch, n, "-"), batch_keys(batch, n, "+")
        u_keys = np.setdiff1d(keys, dels, assume_unique=True)
        keys = np.union1d(u_keys, ins)
        c_cur = cycle_trace(keys, n, dev) // per_match
        c_u = cycle_trace(u_keys, n, dev) // per_match
        store.begin_step(batch)
        n_starts = len(store.start_vertices())
        out = {}
        for tag, (impl, pname) in runs.items():
            st = run_stream_step(dev, backends[tag], plans[pname], store,
                                 batch=SB_BATCH, intersect_impl=impl)
            log(describe_step(f"step {step} {tag:10s}", st, len(batch),
                              n_starts))
            out[tag] = st
            if impl == "auto":
                if st.extras["launches"] == 0:
                    raise RuntimeError(f"{tag} never launched the kernel")
                launches += st.extras["launches"]
        if step == steps:
            device_profile(f"step {step} q1' (kernels)", lambda: Executor(
                backends["q1'"]).run(plans["q1'"], store, batch=SB_BATCH))
        store.end_step()
        ctr = out["q1'"].extras["counters"]
        want = (c_cur - c_u, c_prev - c_u)
        log(f"  step {step} independent q1': C(G_t) {c_cur}, C(U_t) {c_u}, "
            f"C(G_t-1) {c_prev}: dR+ {want[0]}, dR- {want[1]}")
        if (ctr.matches_plus, ctr.matches_minus) != want:
            raise RuntimeError(f"q1' step {step}: engine "
                               f"{ctr.matches_plus}/{ctr.matches_minus}, "
                               f"independent {want[0]}/{want[1]}")
        k, p = out["q2'"], out["q2' binary"]
        kc, pc = k.extras["counters"], p.extras["counters"]
        if (kc.matches_plus, kc.matches_minus) != \
                (pc.matches_plus, pc.matches_minus) or \
                k.extras["level_sizes"].tolist() != \
                p.extras["level_sizes"].tolist():
            raise RuntimeError(f"q2' step {step}: kernel != binary probe")
        answers.append({"q1'": want,
                        "q2'": (kc.matches_plus, kc.matches_minus)})
        c_prev = c_cur
    rebuilds = backends["q1'"].dstore.rebuilds
    log(f"  snapshot rebuilds over the stream: {rebuilds}")
    if rebuilds != 1:
        raise RuntimeError(f"{rebuilds} snapshot rebuilds, expected 1")
    log(f"  phase 7: {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    # phase 8b drives sbenu-dist over the same stream and plans
    stream = dict(g0=g0, batches=batches, d=d, dd=dd, plans=plans,
                  answers=answers)
    return launches, stream


# ---------------------------------------------------------------------------
# Phase 8: distributed B-BENU / S-BENU over NCCL, and the join baseline
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def nccl_world_of_one(dev):
    """One NCCL process group of world size 1 in this process, meeting
    through a file store in a temporary directory (no network); destroyed
    on exit. There is one card, and NCCL takes one rank a card."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def describe_dist(tag, st) -> str:
    x = st.extras
    lv = x["per_shard_level_sizes"]
    return (f"  {tag}: matches {st.count}, wall {x['wall_s']:.3f} s "
            f"(set-up {x['prepare_s']:.3f} s), chunks run/split/retried "
            f"{st.chunks_run}/{st.chunks_split}/{st.chunks_retried}, levels "
            f"{lv.sum(axis=1).tolist()}, cold rows {x['cold_rows_fetched']}, "
            f"request drops {st.drops_seen}, final req_cap {x['req_cap']}, "
            f"launches {x['launches']}, peak "
            f"{x['peak_bytes'] / 2**30:.2f} GiB")


def phase_dist(dev, g_mid, mid_runs, g_full, tri_full, full_levels) -> int:
    """``dist`` over a world of one NCCL rank: the full-size triangle with
    and without hot rows (rebalanced) == the independent count, its level
    sizes == phase 4's ``torch`` run; the join baseline on phase 3's graph
    == phase 3's counts, its shuffled bytes beside a ``dist`` run's cold
    row bytes. Returns the runs' intersect launches."""
    import torch
    from repro_torch.core.baseline_join import enumerate_join
    from repro_torch.core.pattern import get_pattern
    from repro_torch.core.plangen import generate_best_plan
    from repro_torch.graph.storage import padded_width
    t_phase = time.perf_counter()
    plan = generate_best_plan(get_pattern("triangle"), g_full.stats())
    d = padded_width(int(g_full.deg.max()), lane=128)
    launches = 0
    for hot in DIST_HOT:
        kw = dict(hot=hot, rebalance=True)

        def run():
            return run_backend("dist", plan, g_full, dev, backend_kw=kw,
                               batch=FULL_BATCH, caps=FULL_CAPS)
        if hot:        # the second run, under the profiler
            held = {}
            device_profile(f"triangle dist hot={hot}",
                           lambda: held.setdefault("st", run()))
            st = held["st"]
        else:
            st = run()
        x = st.extras
        log(describe_dist(f"triangle dist hot={hot}", st)
            + f" (batch {FULL_BATCH}, caps {FULL_CAPS}, all {g_full.n} "
            f"starts; response buffer [1, {x['req_cap']}, {d}] int32 = "
            f"{x['req_cap'] * d * 4 / 1e9:.2f} GB)")
        if st.count != tri_full:
            raise RuntimeError(f"dist hot={hot}: {st.count} triangles, "
                               f"independent count {tri_full}")
        if x["per_shard_level_sizes"].sum(axis=1).tolist() != full_levels:
            raise RuntimeError(f"dist hot={hot}: level sizes differ from "
                               "phase 4's torch run")
        if x["launches"]["sorted_intersect"] == 0:
            raise RuntimeError("dist never launched sorted_intersect")
        launches += x["launches"]["sorted_intersect"]
        torch.cuda.empty_cache()
    log(f"  full-size dist: {time.perf_counter() - t_phase:.1f} s")
    for pname in JOIN_PATTERNS:
        plan, cfg, want = mid_runs[pname]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        js = enumerate_join(get_pattern(pname), g_mid, device=dev)
        torch.cuda.synchronize()
        t_join = time.perf_counter() - t0
        st = run_backend("dist", plan, g_mid, dev, **cfg)
        if not js.matches == st.count == want.count:
            raise RuntimeError(f"{pname}: join {js.matches}, dist "
                               f"{st.count}, phase 3 {want.count}")
        launches += st.extras["launches"]["sorted_intersect"]
        cold = st.extras["cold_rows_fetched"]
        row = padded_width(int(g_mid.deg.max()), lane=128) * 4
        log(describe_dist(f"{pname:8s} dist", st))
        log(f"  {pname:8s} join: matches {js.matches}, wall {t_join:.3f} s, "
            f"steps {js.steps}, max intermediate rows "
            f"{js.max_intermediate_rows}, bytes shuffled "
            f"{js.bytes_shuffled} vs dist cold rows {cold} x {row} B = "
            f"{cold * row} B ({js.bytes_shuffled / max(cold * row, 1):.2f}x)")
    log(f"  phase 8a: {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_sbenu_dist(dev, stream) -> int:
    """``sbenu-dist`` over a world of one NCCL rank on phase 7's full
    stream: q1' == phase 7's independent count and q2' == phase 7's
    ``sbenu-torch`` on every step, one sharded snapshot build. Returns
    the runs' intersect launches."""
    import torch
    from repro_torch.core.executor import SBenuDistBackend
    from repro_torch.graph.dynamic import SnapshotStore
    t_phase = time.perf_counter()
    store = SnapshotStore(stream["g0"])
    log(f"  store from phase 7's G_0: {time.perf_counter() - t_phase:.1f} s")
    backends = {k: SBenuDistBackend(collect="counts", d_min=stream["d"],
                                    delta_d_min=stream["dd"], device=dev)
                for k in ("q1'", "q2'")}
    launches = 0
    for step, (batch, want) in enumerate(
            zip(stream["batches"], stream["answers"]), 1):
        store.begin_step(batch)
        n_starts = len(store.start_vertices())
        for tag, be in backends.items():
            st = run_stream_step(dev, be, stream["plans"][tag], store,
                                 batch=SB_BATCH, max_retries=12)
            c, x = st.extras["counters"], st.extras
            log(f"  step {step} {tag} sbenu-dist: dR+ {c.matches_plus} dR- "
                f"{c.matches_minus}, wall {x['wall_s']:.3f} s, "
                f"{len(batch) / x['wall_s']:.0f} updates/s, {n_starts} "
                f"starts, chunks run/split {st.chunks_run}/"
                f"{st.chunks_split}, levels "
                f"{x['per_shard_level_sizes'].sum(axis=1).tolist()}, cold "
                f"rows {x['cold_rows_fetched']}, request drops "
                f"{st.drops_seen}, req_cap {x['req_cap']}, sorted_intersect "
                f"launches {x['launches']}, snapshot "
                f"{x['snapshot_device_bytes']} B on the card, peak "
                f"{x['peak_bytes'] / 2**30:.2f} GiB")
            if (c.matches_plus, c.matches_minus) != tuple(want[tag]):
                raise RuntimeError(f"{tag} step {step}: sbenu-dist "
                                   f"{c.matches_plus}/{c.matches_minus}, "
                                   f"phase 7 {want[tag]}")
            if x["launches"] == 0:
                raise RuntimeError(f"{tag}: sbenu-dist never launched the "
                                   "kernel")
            launches += x["launches"]
        store.end_step()
    rebuilds = backends["q1'"].dstore.rebuilds
    if rebuilds != 1 or backends["q2'"].dstore is not \
            backends["q1'"].dstore:
        raise RuntimeError(f"{rebuilds} sharded snapshot builds, expected "
                           "one shared by both patterns")
    log(f"  phase 8b: {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the GNN family trained at full width
# ---------------------------------------------------------------------------


def gnn_graph(spec, shape: str, cfg):
    """The numpy batch of a full-batch cell: ``synthetic_mesh`` for node
    regression, ``synthetic_full_graph`` of the cell's nodes and half its
    (symmetrized) edges, or ``synthetic_molecules`` for ``molecule``;
    seed 0, as the train CLI and the reference's launcher make them."""
    from repro_torch.graph.batch import (synthetic_full_graph,
                                         synthetic_mesh, synthetic_molecules)
    dims = spec.shapes[shape].dims
    if spec.shapes[shape].kind == "gnn_molecule":
        per = dims["n_nodes"] // dims["n_graphs"]
        gb = synthetic_molecules(dims["n_graphs"], per,
                                 dims["n_edges"] // (2 * dims["n_graphs"]),
                                 cfg.d_feat, cfg.n_out)
    elif cfg.task == "node_reg":
        gb = synthetic_mesh(dims["n_nodes"], dims["n_edges"], cfg.d_feat,
                            cfg.d_edge)
    else:
        gb = synthetic_full_graph(dims["n_nodes"], dims["n_edges"] // 2,
                                  cfg.d_feat, cfg.n_out)
    return gb


def minibatch_stream(spec, cfg_reg) -> list:
    """``GNN_MB_STEPS`` sampled blocks of ``minibatch_lg`` from the ported
    ``MinibatchGraphStream`` over ``powerlaw(graph_nodes, GNN_MB_DEGREE)``
    with seeded features and labels; each block also gets seeded
    positions, edge features and regression targets (as
    ``synthetic_mesh`` makes them), which EGNN and MeshGraphNet read and
    the others ignore: the stream samples none of them."""
    import numpy as np
    from repro_torch.data.pipelines import MinibatchGraphStream
    from repro_torch.graph.generate import powerlaw
    dims = spec.shapes["minibatch_lg"].dims
    t0 = time.perf_counter()
    with gc_paused():
        g = powerlaw(dims["graph_nodes"], GNN_MB_DEGREE, seed=SEED)
    rng = np.random.default_rng(SEED)
    feats = rng.normal(size=(g.n, dims["d_feat"])).astype(np.float32)
    labels = rng.integers(0, dims["n_classes"], g.n).astype(np.int32)
    t_graph = time.perf_counter() - t0
    stream = MinibatchGraphStream(
        graph=g, feats=feats, labels=labels,
        batch_nodes=dims["batch_nodes"],
        fanouts=(dims["fanout1"], dims["fanout2"]),
        n_max=dims["n_nodes"], e_max=dims["n_edges"], seed=SEED)
    t0 = time.perf_counter()
    batches = []
    for step in range(GNN_MB_STEPS):
        b = stream.batch(step)
        r = np.random.default_rng(SEED + 1 + step)
        b["edge_attr"] = r.normal(size=(dims["n_edges"], cfg_reg.d_edge)
                                  ).astype(np.float32)
        b["targets"] = r.normal(size=(dims["n_nodes"], cfg_reg.n_out)
                                ).astype(np.float32)
        b["pos"] = r.normal(size=(dims["n_nodes"], 3)).astype(np.float32)
        batches.append(b)
    real = [int((b["edge_src"] < dims["n_nodes"]).sum()) for b in batches]
    log(f"  minibatch_lg host graph powerlaw({g.n}, {GNN_MB_DEGREE}): "
        f"{g.m} edges, features [{g.n}, {dims['d_feat']}], {t_graph:.1f} s; "
        f"{GNN_MB_STEPS} blocks of {dims['batch_nodes']} targets, fan-out "
        f"{dims['fanout1']}-{dims['fanout2']}, padded to "
        f"{dims['n_nodes']} nodes / {dims['n_edges']} edges (real edges "
        f"{real}, real nodes "
        f"{[int(b['node_mask'].sum()) for b in batches]}): "
        f"{time.perf_counter() - t0:.1f} s")
    return batches


def scatter_shares(rows: list) -> str:
    """The profiled step's device time in segment reductions (the sums,
    maxima and minima by node), in gathers and index selects, and in
    sorts (the edge index)."""
    total = sum(r[0] for r in rows) or 1
    kinds = {"segment reductions": ("segment",),
             "gathers / index": ("index", "gather"),
             "sorts": ("sort", "radix")}
    out = []
    for kind, keys in kinds.items():
        us = sum(r[0] for r in rows
                 if any(k in r[2].lower() for k in keys))
        out.append(f"{kind} {us / 1e3:.3f} ms ({100 * us / total:.1f}%)")
    return ", ".join(out)


def gnn_f64(model):
    """A float64 copy of a GNN on the CPU (the yardstick)."""
    import copy
    import torch
    cpu = copy.deepcopy(model).to("cpu", torch.float64)
    cpu.cfg = dataclasses.replace(model.cfg, dtype=torch.float64)
    return cpu


def gnn_grads(model, loss_fn, batch):
    """(loss, {name: gradient}) of one backward, the model's gradients
    cleared after."""
    import torch
    loss, _ = loss_fn(model, batch)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return loss.detach(), grads


def l2_dists(got: dict, want: dict) -> tuple:
    """(the worst tensor's L2 distance over its L2 norm, its name; the
    L2 distance of all the gradients as one vector over its norm)."""
    d2 = {n: float(((got[n].double().cpu() - w) ** 2).sum())
          for n, w in want.items()}
    w2 = {n: float((w ** 2).sum()) for n, w in want.items()}
    worst = max((math.sqrt(d2[n] / w2[n]) if w2[n] else
                 (0.0 if d2[n] == 0 else math.inf), n) for n in want)
    return worst, math.sqrt(sum(d2.values()) / max(sum(w2.values()),
                                                   1e-300))


def gnn_agree(tag: str, got: dict, want: dict, floor: tuple,
              against: str = "f64") -> None:
    """Each gradient's L2 distance from ``want`` over its norm, and all
    the gradients' as one vector, within ``GNN_TOL`` or within
    ``LM_TOL_FLOORS x`` the same measure of ``floor`` (the same code's
    f32 CPU run against f64: how far f32 rounding alone moves this
    model's gradients; per tensor its worst tensor's). Raises when
    either is over both."""
    (worst, name), total = l2_dists(got, want)
    (f_worst, f_name), f_total = floor
    tol_t = max(GNN_TOL, LM_TOL_FLOORS * f_worst)
    tol_g = max(GNN_TOL, LM_TOL_FLOORS * f_total)
    ok = worst <= tol_t and total <= tol_g
    log(f"  {tag}: every gradient against {against}, L2 distance over "
        f"norm: worst tensor {worst:.3g} ({name}; tolerance {tol_t:.3g}), "
        f"all {total:.3g} (tolerance {tol_g:.3g}); the f32 CPU run's "
        f"{f_worst:.3g} ({f_name}) and {f_total:.3g}: "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"{tag}: gradients off: {name} {worst}, all "
                           f"{total}")


def gnn_check(tag: str, model, batch_dev, index) -> dict:
    """One step's loss and every gradient on the card (f32) against an
    f64 CPU run of the same port code and weights (``GNN_TOL``, or the
    floor of :func:`gnn_agree`: the f32 CPU run's distances from it).
    Returns that floor."""
    import copy
    import torch
    from repro_torch.models.gnn import gnn_loss
    loss, got = gnn_grads(model, lambda m, b: gnn_loss(m, b, index),
                          batch_dev)
    cpu = {k: v.cpu() for k, v in batch_dev.items()}
    ref64 = gnn_f64(model)
    cpu64 = dict(cpu, x=cpu["x"].double())
    loss64, want = gnn_grads(ref64, gnn_loss, cpu64)
    cpu32 = copy.deepcopy(model).to("cpu")
    _, f32 = gnn_grads(cpu32, gnn_loss, cpu)
    floor = l2_dists(f32, want)
    check_close(f"{tag}: the loss", loss.reshape(1), loss64.reshape(1),
                GNN_TOL)
    gnn_agree(tag, got, want, floor)
    return floor


def gnn_cell(arch: str, shape: str, dev, batches: list, check: bool
             ) -> dict:
    """``arch`` at ``shape`` on the card: a checked step against f64
    (``check``), then ``len(batches)`` AdamW steps (the first a warm-up;
    the same batch every step for a full-batch cell, its edge index
    sorted once), s per step, nodes and edges per second, peak memory and
    a profiled step. Returns what phase 13 reports of it."""
    import math
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.gnn import (gnn_decay_mask, gnn_loss,
                                        graph_index, init_gnn_params)
    from repro_torch.train.loop import to_device
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             make_train_step)
    cfg = get_config(arch).model_cfg_for(shape)
    full = len(batches) == 1
    first = to_device(batches[0], dev)
    index = graph_index(first["edge_src"], first["edge_dst"],
                        first["x"].shape[0]) if full else None
    model = init_gnn_params(cfg, seed=SEED, device=dev)
    floor = gnn_check(f"{arch} {shape}", model, first, index) if check \
        else None
    steps = GNN_STEPS if full else len(batches)
    opt = AdamWConfig(lr=GNN_LR, warmup_steps=1, decay_steps=steps)
    loss_fn = lambda m, b: gnn_loss(m, b, index)
    step_fn = make_train_step(loss_fn, opt, decay=gnn_decay_mask(
        dict(model.named_parameters())))
    state = adamw_init(dict(model.named_parameters()))
    losses, seconds, host = [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for i in range(steps):
        t0 = time.perf_counter()
        b = first if full else to_device(batches[i], dev)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        model, state, metrics = step_fn(model, state, b)
        losses.append(metrics["loss_total"].item())
        seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    s = statistics.mean(seconds[1:])
    # the rates count each step's own real nodes (node_mask) and real
    # edges (both endpoints below the padding id), not the padded shape
    n_pad = batches[0]["x"].shape[0]
    real = [(int(np.asarray(b["node_mask"]).sum()),
             int(((np.asarray(b["edge_src"]) < n_pad)
                  & (np.asarray(b["edge_dst"]) < n_pad)).sum()))
            for b in batches]
    real = real * steps if full else real
    t_timed = sum(seconds[1:])
    n_rate = sum(r[0] for r in real[1:steps]) / t_timed
    e_rate = sum(r[1] for r in real[1:steps]) / t_timed
    log(f"  {arch} {shape}: {cfg.n_params} parameters, d {cfg.d_hidden} x "
        f"{cfg.n_layers}, padded to {n_pad} nodes and "
        f"{batches[0]['edge_src'].shape[0]} edges, real (nodes, edges) "
        f"{real[0] if full else real}; steps "
        f"{[round(x, 4) for x in seconds]} s, {s:.4f} s a step (steps 2-"
        f"{steps}), {n_rate:.0f} real nodes/s, {e_rate:.0f} real "
        f"edges/s, peak {peak:.2f} GiB; losses "
        f"{[round(x, 4) for x in losses]}"
        + ("" if full else f"; the host batch to the card "
           f"{statistics.mean(host):.4f} s a step besides"))
    if not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{arch} {shape}: losses {losses}")
    if full and not losses[-1] < losses[0]:
        raise RuntimeError(f"{arch} {shape}: the loss did not fall: {losses}")
    b = first if full else to_device(batches[-1], dev)
    rows = device_profile(f"one {arch} {shape} step",
                          lambda: step_fn(model, state, b))
    log(f"    scatters: {scatter_shares(rows)}")
    del model, state, first, b
    torch.cuda.empty_cache()
    return {"s": s, "peak": peak, "floor": floor, "losses": losses}


def ogb_bytes(spec) -> str:
    """The largest ``[E, w]`` tensors a layer of each arch holds at
    ``ogb_products`` in bf16: what rules out three of the four on one
    80 GB card without edge chunks."""
    e = spec.shapes["ogb_products"].dims["n_edges"]
    gb = lambda w: e * w * 2 / 1e9
    return (f"pna's [E, 150] concat {gb(150):.1f} GB beside [E, 75] gathers "
            f"of {gb(75):.1f} GB each; egnn's [E, 129] concat {gb(129):.1f} "
            f"GB beside [E, 64] gathers of {gb(64):.1f} GB; meshgraphnet's "
            f"[E, 128] edge state {gb(128):.1f} GB carried across layers and "
            f"its [E, 384] concat {gb(384):.1f} GB (E = {e})")


def phase_gnn(dev) -> None:
    """Phase 13: the four GNNs trained at full width under deterministic
    algorithms (f32, TF32 off): at ``full_graph_sm`` and ``molecule`` a
    step's loss and every gradient against an f64 CPU run, then AdamW
    steps, s per step, nodes and edges per second, peak memory and a
    profiled step (the scatters' share); ``minibatch_lg`` on blocks of the
    ported ``MinibatchGraphStream``; gin-tu's checkpoint restart
    bit-exact; the train CLI; the distributed loss as one NCCL rank
    (equal to ``gnn_loss`` at ``full_graph_sm``, then gin-tu at
    ``ogb_products`` in bf16 with remat); the motif-feature example.
    Must run inside :func:`nccl_world_of_one`."""
    import importlib.util
    import math
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipelines import FullGraphData
    from repro_torch.models import gnn_dist
    from repro_torch.models.gnn import (gnn_decay_mask, gnn_loss,
                                        graph_index, init_gnn_params)
    from repro_torch.train.loop import to_device
    from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                             make_train_step)
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)

    # which scatters raise under deterministic algorithms (logged: the
    # port's message passing runs none of them)
    x = torch.randn(4096, 64, device=dev, requires_grad=True)
    idx = torch.randint(0, 256, (4096,), device=dev)
    wide = idx[:, None].expand(-1, 64)
    probes = {
        "index_add_": lambda: torch.zeros(256, 64, device=dev).index_add_(
            0, idx, x.detach()),
        "index_select backward (index_add_)": lambda: x.index_select(
            0, idx).sum().backward(),
        "scatter_reduce_ amax": lambda: torch.zeros(256, 64, device=dev)
        .scatter_reduce_(0, wide, x.detach(), "amax"),
        "scatter_reduce amax backward": lambda: torch.zeros(
            256, 64, device=dev).scatter_reduce(
            0, wide, x, "amax", include_self=False).sum().backward(),
        "scatter_reduce_ amin": lambda: torch.zeros(256, 64, device=dev)
        .scatter_reduce_(0, wide, x.detach(), "amin"),
        "index_put_ accumulate": lambda: torch.zeros(
            256, 64, device=dev).index_put_((idx,), x.detach(),
                                            accumulate=True),
    }
    for tag, fn in probes.items():
        try:
            fn()
            torch.cuda.synchronize()
            log(f"  deterministic algorithms: {tag} runs")
        except RuntimeError as e:
            log(f"  deterministic algorithms: {tag} raises: "
                f"{str(e).splitlines()[0][:120]}")
    del x, idx, wide

    # -- the cells
    reg = get_config("meshgraphnet").model_cfg
    mb = minibatch_stream(get_config("gin-tu"), reg)
    results = {}
    for arch in GNN_ARCHS:
        spec = get_config(arch)
        for shape in GNN_SHAPES:
            cfg = spec.model_cfg_for(shape)
            if shape == "molecule" and cfg.task == "node_reg":
                log(f"  {arch} {shape}: not run: synthetic_molecules gives "
                    "neither edge_attr nor targets, so the reference cannot "
                    "feed this pair either")
                continue
            batches = mb if shape == "minibatch_lg" else \
                [gnn_graph(spec, shape, cfg).as_arrays()]
            results[arch, shape] = gnn_cell(arch, shape, dev, batches,
                                            check=shape != "minibatch_lg")
    del mb

    # -- restart: gin-tu at full_graph_sm through run_training
    spec = get_config("gin-tu")
    cfg = spec.model_cfg_for("full_graph_sm")
    data = FullGraphData(gnn_graph(spec, "full_graph_sm", cfg))
    first = to_device(data(0), dev)
    index = graph_index(first["edge_src"], first["edge_dst"],
                        first["x"].shape[0])
    del first
    restart_run(
        "gin-tu full_graph_sm", lambda m, b: gnn_loss(m, b, index),
        lambda: init_gnn_params(cfg, seed=SEED, device=dev), data,
        AdamWConfig(lr=GNN_LR, warmup_steps=1, decay_steps=GNN_RESTART_STEPS),
        GNN_RESTART_STEPS, GNN_RESTART_EVERY, dev, gnn_decay_mask)
    del data, index

    # -- the train CLI on the card
    from repro_torch.launch.train import main as train_main
    t0 = time.perf_counter()
    hist = train_main(["--arch", "gin-tu", "--steps", str(GNN_CLI_STEPS)])
    log(f"  python -m repro_torch.launch.train --arch gin-tu --steps "
        f"{GNN_CLI_STEPS}: {time.perf_counter() - t0:.1f} s, final loss "
        f"{hist['loss'][-1]:.4f} (first {hist['loss'][0]:.4f})")
    if not hist["loss"][-1] < hist["loss"][0]:
        raise RuntimeError(f"the train CLI's loss did not fall: "
                           f"{hist['loss']}")
    del hist

    # -- the distributed loss as one NCCL rank
    grid = gnn_dist.make_grid(1, 1)
    for arch in GNN_ARCHS:
        spec = get_config(arch)
        cfg = spec.model_cfg_for("full_graph_sm")
        arrays = gnn_graph(spec, "full_graph_sm", cfg).as_arrays()
        b = to_device(gnn_dist.shard_batch(arrays, grid), dev)
        model = init_gnn_params(cfg, seed=SEED, device=dev)
        want_loss, want = gnn_grads(model, gnn_loss, b)
        loss, got = gnn_grads(model, gnn_dist.build_dist_loss(
            cfg, arrays["x"].shape[0], grid), b)
        got = gnn_dist.reduce_grads(grid)(got)
        check_close(f"gnn_dist {arch} full_graph_sm, one NCCL rank: the "
                    "loss against gnn_loss's", loss.reshape(1).cpu(),
                    want_loss.reshape(1).cpu().double(), GNN_TOL)
        gnn_agree(f"gnn_dist {arch} full_graph_sm, one NCCL rank", got,
                  {k: v.double().cpu() for k, v in want.items()},
                  results[arch, "full_graph_sm"]["floor"],
                  against="gnn_loss's on the card")
        del model, b, got, want
    spec = get_config("gin-tu")
    dims = spec.shapes["ogb_products"].dims
    cfg = dataclasses.replace(spec.model_cfg_for("ogb_products"),
                              dtype=torch.bfloat16, remat=True)
    t0 = time.perf_counter()
    arrays = gnn_graph(spec, "ogb_products", cfg).as_arrays()
    t_gen = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    b = to_device(gnn_dist.shard_batch(arrays, grid), dev)
    del arrays
    model = init_gnn_params(cfg, seed=SEED, device=dev)
    opt = AdamWConfig(lr=GNN_LR, warmup_steps=1, decay_steps=GNN_OGB_STEPS)
    step_fn = make_train_step(
        gnn_dist.build_dist_loss(cfg, dims["n_nodes"], grid), opt,
        gnn_dist.reduce_grads(grid),
        gnn_decay_mask(dict(model.named_parameters())))
    state = adamw_init(dict(model.named_parameters()))
    losses, seconds = [], []
    for _ in range(GNN_OGB_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, state, metrics = step_fn(model, state, b)
        losses.append(metrics["loss_total"].item())
        seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    s = statistics.mean(seconds[1:])
    log(f"  gnn_dist gin-tu ogb_products, one NCCL rank, bf16 with remat: "
        f"{dims['n_nodes']} nodes, {b['edge_src'].shape[0]} edges (host "
        f"generation {t_gen:.1f} s); steps {[round(x, 3) for x in seconds]} "
        f"s, {s:.3f} s a step, {dims['n_nodes'] / s:.0f} nodes/s, "
        f"{b['edge_src'].shape[0] / s:.0f} edges/s, peak {peak:.2f} GiB; "
        f"losses {[round(x, 4) for x in losses]}")
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        raise RuntimeError(f"gin-tu ogb_products: losses {losses}")
    log(f"  ogb_products, not run (no edge chunks, as in the reference): "
        f"{ogb_bytes(spec)}")
    del model, state, b, step_fn
    torch.cuda.empty_cache()

    # -- the motif-feature example on the card
    path = ROOT / "examples" / "motif_features_torch.py"
    mspec = importlib.util.spec_from_file_location("motif_features_torch",
                                                   path)
    mod = importlib.util.module_from_spec(mspec)
    mspec.loader.exec_module(mod)
    t0 = time.perf_counter()
    counts, hist = mod.main([])
    want = mod.motif_counts(mod.powerlaw(300, 4, seed=7), "cpu")
    log(f"  examples/motif_features_torch.py on the card: "
        f"{time.perf_counter() - t0:.1f} s; triangle and square totals "
        f"{int(counts[:, 0].sum())}, {int(counts[:, 1].sum())}; per-vertex "
        f"counts equal the CPU run's: {bool(np.array_equal(counts, want))}; "
        f"loss {hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f}")
    if not np.array_equal(counts, want):
        raise RuntimeError("the motif counts on the card differ from the "
                           "CPU's")
    torch.use_deterministic_algorithms(False)
    log(f"  phase 13: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 13b: the examples
# ---------------------------------------------------------------------------


def load_example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_examples() -> None:
    """``examples/quickstart_torch.py`` (its match count equal to its own
    brute force), ``continuous_enum_torch.py`` (each step's ΔR⁺/ΔR⁻ on
    the card equal to the snapshot diff and to the interpreter) and
    ``train_lm_torch.py`` (``EXAMPLE_LM_STEPS`` steps checkpointed every
    ``EXAMPLE_LM_EVERY``, the loss falling, then a rerun in the same
    directory that resumes after the last checkpoint), each on the card
    as a user runs it. Each example raises when its check fails."""
    import shutil
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    count = load_example("quickstart_torch").main([])
    log(f"  examples/quickstart_torch.py: {count} matches, equal to the "
        f"brute force ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    rows = load_example("continuous_enum_torch").main([])
    log(f"  examples/continuous_enum_torch.py: (dR+, dR-, DBQ) by step "
        f"{rows}, each equal to the snapshot diff "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    lm = load_example("train_lm_torch")
    ckpt = ROOT / "build" / "train_lm_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    args = ["--ckpt-dir", str(ckpt), "--ckpt-every", str(EXAMPLE_LM_EVERY)]
    first = lm.main([str(EXAMPLE_LM_STEPS)] + args)
    again = lm.main([str(EXAMPLE_LM_STEPS + EXAMPLE_LM_EVERY)] + args)
    log(f"  examples/train_lm_torch.py: loss {first['loss'][0]:.4f} -> "
        f"{first['loss'][-1]:.4f} over {EXAMPLE_LM_STEPS} steps; the rerun "
        f"resumed at step {again['step'][0] - 1} ({again['loss'][-1]:.4f}"
        f" at step {again['step'][-1]}); {time.perf_counter() - t0:.1f} s")
    if not first["loss"][-1] < first["loss"][0]:
        raise RuntimeError("train_lm_torch: the loss did not fall")
    if again["step"][0] != EXAMPLE_LM_STEPS + 1:
        raise RuntimeError(f"train_lm_torch: the rerun started at step "
                           f"{again['step'][0]}, not after the checkpoint "
                           f"of step {EXAMPLE_LM_STEPS}")
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"  phase 13b: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 14: the dry-run tooling
# ---------------------------------------------------------------------------


def start_dryrun(out: Path) -> list:
    """Start the dry-run CLI on each of ``DRYRUN_RUNS``: subprocesses (so
    that their fake worlds never meet this process's NCCL world), fake
    tensors on the card's device. Returns ``[(tag, Popen)]``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for tag, cells, multi_pod, layers in DRYRUN_RUNS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
               "cuda", "--out", str(out),
               *(["--multi-pod"] if multi_pod else []),
               *(["--layers", str(layers)] if layers else []),
               "--cells", *cells]
        procs.append((tag, subprocess.Popen(
            cmd, cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    # a failure here leaves none of them running
    atexit.register(lambda: [p.kill() for _, p in procs
                             if p.poll() is None])
    return procs


def wait_dryrun(procs: list, t0: float) -> list:
    """Wait for :func:`start_dryrun`'s processes (started at ``t0``),
    each within what is left of ``DRYRUN_TIMEOUT_S``. Returns ``[(tag,
    returncode or None on timeout, output)]``."""
    done = []
    for tag, proc in procs:
        left = max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t0))
        try:
            text, _ = proc.communicate(timeout=left)
            done.append((tag, proc.returncode, text))
        except subprocess.TimeoutExpired:
            proc.kill()
            done.append((tag, None, proc.communicate()[0]))
    log(f"  phase 14's dry-run cells: {time.perf_counter() - t0:.1f} s")
    return done


def report_dryrun(done: list, out: Path) -> dict:
    """Print each cell's line of :func:`wait_dryrun`'s runs (per-device
    GiB, the three roofline terms, the dominant one, the wire bytes by
    kind). Raises when a run
    failed or a cell is not OK. Returns the reports."""
    failed = []
    for tag, rc, text in done:
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(("OK", "FAIL"))]
        for ln in lines:
            log(f"  [{tag}] {ln}")
        bad = [ln for ln in lines if ln.startswith("FAIL")]
        if rc != 0 or bad or not lines:
            log("  " + "\n  ".join(text.splitlines()[-60:]))
            failed.append(f"a {tag} run (rc {rc}, {len(bad)} cells"
                          f"{'' if rc is not None else '; timed out'})")
    if failed:
        raise RuntimeError(f"the dry-run failed: {failed}")
    reports = {}
    for path in sorted(out.glob("*.json")):
        rep = json.loads(path.read_text())
        r, m = rep["roofline"], rep["memory_analysis"]
        reports[path.stem] = rep
        cut = f" ({rep['layers']} layers)" if rep.get("layers") else ""
        wire = ", ".join(f"{k} {v:.4g}" for k, v in
                         rep["collectives_wire"].items() if v) or "none"
        log(f"  {path.stem}{cut}: "
            f"{m['peak_bytes_per_device'] / 2**30:.3f} GiB/device (args "
            f"{m['argument_bytes'] / 2**30:.3f}), compute "
            f"{r['compute_s'] * 1e3:.3f} ms, memory {r['memory_s'] * 1e3:.3f}"
            f" ms, collective {r['collective_s'] * 1e3:.3f} ms -> "
            f"{r['dominant']}; wire B/device by kind: {wire}; flops "
            f"{rep['cost_analysis']['flops_per_chip']:.4g}, kernel ops' bytes "
            f"{rep['cost_analysis']['kernel_bytes_by_op']}")
    return reports


def replicated_lm(model, mesh):
    """``model``'s parameters as DTensors on a mesh of one rank (the
    same values; every placement ``Replicate``)."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        d = DTensor.from_local(p.detach(), mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
        setattr(mod, leaf, torch.nn.Parameter(d))


def step_grads(model, batch, ctx) -> tuple:
    """``loss_fn``'s loss and every parameter's gradient (whole tensors)
    of one forward and backward, the gradients then cleared."""
    from repro_torch.models.transformer import loss_fn

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t
    loss, _ = loss_fn(model, batch, ctx=ctx)
    loss.backward()
    grads = {n: whole(p.grad) for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return float(whole(loss)), grads


def phase_counted_step(dev, peak: float) -> dict:
    """The program the dry-run traces, on the card: one qwen2-0.5b
    training step at phase 9's shape (bf16, remat) on a (1, 1) mesh
    (DTensor parameters and batch, the model under a ``ShardCtx``: the
    embedding, flash, RMSNorm and the cross entropy on local shards)
    against the same step without a mesh, the loss and every gradient
    within ``LM_TOL_FLOORS`` x the no-mesh bf16 step's distance from its
    f32 one; then that step counted by ``launch/op_analysis.OpCounter``
    and timed outside the counter."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.kernels import cost
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.launch.steps import _accumulating_step
    from repro_torch.layers.common import NO_SHARD, ShardCtx
    from repro_torch.models.transformer import (Transformer, decay_mask,
                                                init_params, loss_fn)
    from repro_torch.train.optimizer import AdamWConfig, AdamWState
    cfg = get_config(LM_ARCH).model_cfg
    b, t = TRAIN_BATCH, TRAIN_SEQ
    res = {}
    with nccl_world_of_one(dev), implicit_replication():
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        ctx = ShardCtx(mesh=mesh, dp=("data",), tp="model")
        model = init_params(cfg, seed=SEED, device=dev)
        decay = decay_mask(dict(model.named_parameters()))
        gen = torch.Generator(device=dev).manual_seed(SEED)
        toks = torch.randint(0, cfg.vocab, (b, t + 1), generator=gen,
                             device=dev, dtype=torch.int32)
        plain = {"tokens": toks[:, :-1].contiguous(),
                 "labels": toks[:, 1:].contiguous()}
        # the yardstick: the step without a mesh in bf16 and in f32
        loss_p, g_p = step_grads(model, plain, NO_SHARD)
        torch.backends.cuda.matmul.allow_tf32 = False
        model32 = Transformer(dataclasses.replace(cfg, dtype=torch.float32),
                              torch.Generator(device=dev))
        model32.load_state_dict(model.state_dict())       # bf16 -> f32
        loss_32, g_32 = step_grads(model32, plain, NO_SHARD)
        del model32
        torch.cuda.empty_cache()
        replicated_lm(model, mesh)
        params = dict(model.named_parameters())
        opt = AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            m={k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in params.items()},
            v={k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in params.items()})
        batch = {k: DTensor.from_local(v, mesh, [Replicate()] * 2,
                                       run_check=False)
                 for k, v in plain.items()}
        loss_m, g_m = step_grads(model, batch, ctx)
        diff, floor = abs(loss_m - loss_p), abs(loss_p - loss_32)
        log(f"  the step on a (1, 1) mesh vs without: loss {loss_m:.6f} vs "
            f"{loss_p:.6f} (f32 {loss_32:.6f}), {diff:.4g} (tolerance "
            f"{LM_TOL_FLOORS} x {floor:.4g})")
        if not diff <= LM_TOL_FLOORS * floor:
            raise RuntimeError(f"the step on a mesh: loss {diff} over "
                               f"{LM_TOL_FLOORS} x {floor}")
        check_agreement("gradient", leaf_dists(g_m, g_p),
                        leaf_dists(g_p, g_32), each_tensor=True,
                        label="mesh vs no mesh")
        del g_m, g_p, g_32
        step = _accumulating_step(
            model, lambda m, bt: loss_fn(m, bt, ctx=ctx), AdamWConfig(), 1,
            decay)
        opt, _ = step(opt, batch)                 # warm
        torch.cuda.synchronize()
        counter = OpCounter()
        with counter:
            opt, met = step(opt, batch)
        torch.cuda.synchronize()
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            opt, met = step(opt, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        loss = met["loss"]
        loss = float(getattr(loss, "full_tensor", lambda: loss)())
        del model, params, opt, batch, step
    tot = counter.totals
    kflops = sum(v for k, v in tot.flops_by_op.items()
                 if k.startswith("repro_torch"))
    mflops = tot.flops - kflops
    tokens = b * t
    attn = cfg.n_layers * 3 * cost.flash_flops(b, cfg.n_heads, t, t,
                                               cfg.d_head, cfg.d_head, True)
    model_flops = 6 * cfg.n_active_params * tokens + attn
    step_s = statistics.median(secs)
    rate = tot.flops / step_s
    by_kernel = {k: f"{v:.4g}" for k, v in tot.flops_by_op.items()
                 if k.startswith("repro_torch")}
    log(f"  counted qwen2-0.5b step [{b} x {t}] bf16 remat on a (1, 1) "
        f"mesh: {tot.flops:.6g} flops ({kflops:.6g} in kernel ops "
        f"{by_kernel}, {mflops:.6g} in matmuls); 6*N*tokens + 3 x causal "
        f"attention "
        f"= {model_flops:.6g}, ratio {tot.flops / model_flops:.4f}; "
        f"HBM bytes (unfused eager) {tot.hbm_bytes:.6g}; peak live "
        f"{tot.peak_bytes / 2**30:.2f} GiB; loss {loss:.4f}")
    log(f"  step time outside the counter {[round(s, 4) for s in secs]} s, "
        f"median {step_s:.4f} s: {rate / 1e12:.1f} TFLOP/s, "
        f"{100 * rate / peak:.1f}% of {peak / 1e12:.0f} TFLOP/s")
    res.update(flops=tot.flops, kernel_flops=kflops, step_s=step_s,
               ratio=tot.flops / model_flops, tflops=rate / 1e12)
    return res


def phase_kernel_ops(dev) -> dict:
    """Each kernel op at its phase-2 shape: its fake implementation's
    shape, dtype and strides equal the launched kernel's output; a launch
    through the dispatcher is bit-equal to the ctypes launch; the counter
    reads one rmsnorm call's bytes and one flash call's flops as
    ``kernels/cost.py`` gives them; host µs per call, ctypes against the
    dispatcher."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import cost, library, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gather_intersect as gi
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import sorted_intersect as si
    from repro_torch.launch.op_analysis import OpCounter
    from repro_torch.launch.rmsnorm_ab import host_us
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n, B = FULL_N, 4096

    def rnd(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    b, hq, hkv, t, d = LM_BATCH, 14, 2, LM_SEQ, 64
    q, k, v = rnd((b, hq, t, d)), rnd((b, hkv, t, d)), rnd((b, hkv, t, d))
    scale = d ** -0.5
    out, lse = fa.launch_forward(q, k, v, True, scale, True)
    dout = rnd(out.shape)
    x, g = rnd((LM_BATCH * LM_SEQ, 896)), rnd((896,))
    gy = rnd(x.shape)
    a = padded_sets(gen, B, 640, n, 0.1, tail=False)
    bb = padded_sets(gen, B, 640, n, 0.0, tail=True)
    adj = padded_sets(gen, 20001, 128, 20000, 0.0, tail=True)
    adj[20000] = 20000
    ids = torch.randint(0, 20000, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    cand = padded_sets(gen, B, 128, 20000, 0.1, tail=False)
    cases = {
        "flash_attention": ((q, k, v, True, scale),
                            lambda: fa.launch_forward(q, k, v, True, scale,
                                                      False)[0],
                            lambda: fa.flash_attention_cuda(q, k, v)),
        "flash_attention_lse": ((q, k, v, True, scale),
                                lambda: fa.launch_forward(q, k, v, True,
                                                          scale, True),
                                lambda: fa.flash_attention_lse_cuda(q, k,
                                                                    v)),
        "flash_attention_bwd": ((q, k, v, out, lse, dout, True, scale),
                                lambda: fa.launch_backward(
                                    q, k, v, out, lse, dout, True, scale),
                                lambda: fa.flash_attention_bwd_cuda(
                                    q, k, v, out, lse, dout, True, scale)),
        "rmsnorm": ((x, g, 1e-6), lambda: rn.launch_forward(x, g, 1e-6),
                    lambda: rn.rmsnorm_cuda(x, g, 1e-6)),
        "rmsnorm_bwd": ((x, g, gy, 1e-6),
                        lambda: rn.launch_backward(x, g, gy, 1e-6),
                        lambda: rn.rmsnorm_bwd_cuda(x, g, gy, 1e-6)),
        "sorted_intersect": ((a, bb, n), lambda: si.launch(a, bb, n),
                             lambda: si.sorted_intersect_cuda(a, bb, n)),
        "gather_intersect": ((ids, cand, adj, 20000),
                             lambda: gi.launch(ids, cand, adj, 20000),
                             lambda: gi.gather_intersect_cuda(ids, cand, adj,
                                                              20000)),
    }
    host = {}
    for name, (args, old, new) in cases.items():
        with FakeTensorMode(allow_non_fake_inputs=True) as fm:
            fake_args = [fm.from_tensor(a_) if isinstance(a_, torch.Tensor)
                         else a_ for a_ in args]
            fake = library.op(name)(*fake_args)

        def via_op(name=name, args=args):
            return library.op(name)(*args)
        got_old, got_op = old(), via_op()
        torch.cuda.synchronize()
        fake, got_old, got_op = (r if isinstance(r, tuple) else (r,)
                                 for r in (fake, got_old, got_op))
        for f_, o_, n_ in zip(fake, got_old, got_op):
            if (f_.shape, f_.dtype, f_.stride()) != \
                    (n_.shape, n_.dtype, n_.stride()):
                raise RuntimeError(
                    f"{name}: the fake implementation gives "
                    f"{(tuple(f_.shape), f_.dtype, f_.stride())}, the kernel "
                    f"{(tuple(n_.shape), n_.dtype, n_.stride())}")
            if not torch.equal(o_, n_):
                raise RuntimeError(f"{name}: the dispatcher launch differs "
                                   "from the ctypes launch")
        calls = HOST_CALLS if name.startswith(("rmsnorm", "flash_attention"
                                               )) else HOST_CALLS // 3
        # the ctypes launch (the parent's binding), the dispatcher op, the
        # wrapper (direct when nothing intercepts), in turns
        us = {k: [] for k in ("ctypes_us", "dispatcher_us", "wrapper_us")}
        for fns in ((old, via_op, new), (new, via_op, old)):
            for key, fn in zip(("ctypes_us", "dispatcher_us", "wrapper_us")
                               if fns[0] is old else
                               ("wrapper_us", "dispatcher_us", "ctypes_us"),
                               fns):
                us[key].append(host_us(fn, calls))
        host[name] = {k: statistics.mean(v) for k, v in us.items()}
        log(f"  {name}: fake implementation == kernel output (shape, dtype, "
            f"strides); dispatcher == ctypes bit for bit; host us a call "
            + ", ".join(f"{k[:-3]} {'/'.join(f'{x:.2f}' for x in v)}"
                        for k, v in us.items()))
    # the public entry points, as the serving path calls them
    for name, fn in (("ops.rmsnorm", lambda: ops.rmsnorm(x, g)),
                     ("ops.flash_attention",
                      lambda: ops.flash_attention(q, k, v))):
        with torch.inference_mode():
            host[name] = {"dispatcher_us": (host_us(fn, HOST_CALLS)
                                            + host_us(fn, HOST_CALLS)) / 2}
        log(f"  {name} (inference_mode): host "
            f"{host[name]['dispatcher_us']:.2f} us a call")
    with torch.inference_mode():
        c1 = OpCounter()
        with c1:
            ops.rmsnorm(x, g)
        c2 = OpCounter()
        with c2:
            ops.flash_attention(q, k, v)
    want_b = cost.rmsnorm_bytes(x.shape[0], x.shape[1], 2)
    want_f = cost.flash_flops(b, hq, t, t, d, d, True)
    log(f"  counted: one rmsnorm [{x.shape[0]}, {x.shape[1]}] bf16 call "
        f"{c1.totals.hbm_bytes:.0f} bytes (cost.py {want_b}); one "
        f"flash_attention [{b}, {hq}/{hkv}, {t}, {d}] causal call "
        f"{c2.totals.flops:.0f} flops (cost.py {want_f})")
    if c1.totals.hbm_bytes != want_b or c2.totals.flops != want_f:
        raise RuntimeError("the counter disagrees with kernels/cost.py")
    return host


def phase_dryrun(dev, peak: float, out: Path, cells: list) -> dict:
    """Phase 14: the kernel ops (:func:`phase_kernel_ops`), the training
    step on a mesh and counted (:func:`phase_counted_step`), and the
    dry-run's cells, which ran beside phase 4's graph generation
    (``cells``: :func:`wait_dryrun`'s result)."""
    t_phase = time.perf_counter()
    host = phase_kernel_ops(dev)
    step = phase_counted_step(dev, peak)
    reports = report_dryrun(cells, out)
    log(f"  phase 14: {time.perf_counter() - t_phase:.1f} s")
    return {"host": host, "step": step, "cells": sorted(reports)}


def main() -> int:
    t_script = time.perf_counter()
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py needs the repository around it "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    # cuBLAS is deterministic only with a fixed workspace (phase 9 runs
    # under torch.use_deterministic_algorithms); set before its first use
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cost
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on the card only",
              file=sys.stderr)
        return 1
    for var in [v for v in os.environ if v.startswith("REPRO_TORCH_")]:
        del os.environ[var]                       # no impl overrides
    dev = torch.device("cuda", 0)
    from repro_torch.kernels import build

    log("phase 1: build")
    t0 = time.perf_counter()
    built = build.build()
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.nvcc_path()})")
    for name, text in build.build_log.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "smem")):
                log(f"  [{name}] {line.strip()}")
    # the bf16 flash bodies, forward and backward, must run on the tensor
    # cores: their SASS holds HGMMA (wgmma) instructions
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    for lib in ("flash_attention", "flash_attention_bwd"):
        sass = subprocess.run(
            [str(cuobjdump), "-sass", str(build.library_path(lib))],
            capture_output=True, text=True, check=True).stdout
        hgmma = sum("HGMMA" in line for line in sass.splitlines())
        log(f"  [{lib}] {hgmma} HGMMA instructions in the SASS")
        if hgmma == 0:
            raise RuntimeError(f"the {lib} library has no HGMMA instruction")
    bodies = hgmma_by_body(subprocess.run(
        [str(cuobjdump), "-sass", str(build.library_path("flash_attention"))],
        capture_output=True, text=True, check=True).stdout)
    log(f"  [flash_attention] HGMMA by bf16 body <NBQK, NBV>: {bodies}")
    if len(bodies) != 6 or not all(bodies.values()):
        raise RuntimeError(f"a bf16 body of the flash library has no HGMMA "
                           f"instruction: {bodies}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    bandwidth = cost.card_rate(cost.BANDWIDTH, kind)
    peak = cost.card_rate(cost.PEAK_BF16, kind)
    log(f"  card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; bound at {bandwidth / 1e12:.2f} TB/s and "
        f"{peak / 1e12:.0f} TFLOP/s (bf16)")

    log("phase 2: kernels vs plain versions on the card")
    kern = phase_kernels(dev, bandwidth)
    kern.update(phase_lm_kernels(dev, bandwidth, peak))
    mla = phase_mla_flash(dev, bandwidth, peak)
    kern["flash_attention"]["max_abs_err"] = max(
        kern["flash_attention"]["max_abs_err"], mla["max_abs_err"])
    kern.update(phase_lm_bwd_kernels(dev, bandwidth, peak))
    mla_bwd = phase_mla_flash_bwd(dev, bandwidth, peak)
    kern["flash_attention_bwd"]["max_abs_err"] = max(
        kern["flash_attention_bwd"]["max_abs_err"], mla_bwd["max_abs_err"])
    log("phase 3: mid-size exactness")
    g_mid, tri_mid, mid_runs = phase_mid(dev)
    log("phase 4: full size (main path)")
    # phase 14's dry-run cells run in subprocesses (their fake worlds never
    # meet this process's NCCL world) beside phase 4's graph generation:
    # host set-up, untimed as the port's; every timed run of the script
    # starts after they end
    dry_out = ROOT / "results" / "dryrun_torch"
    dry_out.mkdir(parents=True, exist_ok=True)
    for old in dry_out.glob("*.json"):
        old.unlink()
    dry_t0, dry = time.perf_counter(), []
    dry_procs = start_dryrun(dry_out)
    with gc_paused():
        launches, g_full, tri_full, full_levels = phase_full(
            dev, lambda: dry.extend(wait_dryrun(dry_procs, dry_t0)))
    log("phase 5: LM serving path at full width (qwen2-0.5b)")
    launches.update(phase_lm(dev))
    # phase 9 right after phase 5: the card then holds nothing of the
    # enumeration phases
    log("phase 9: LM training at full width (qwen2-0.5b)")
    for k, c in phase_train(dev).items():
        launches[k] += c
    log("phase 10: MoE and MLA serving at full width "
        f"({', '.join(MOE_ARCHS)})")
    for k, c in phase_moe(dev).items():
        launches[k] += c
    log("phase 11: MoE and MLA training at full width "
        f"({', '.join(MOE_ARCHS)})")
    for k, c in phase_moe_train(dev).items():
        launches[k] += c
    log("phase 12: BST (recsys) at full width: serving, retrieval, "
        "training")
    phase_bst(dev)
    log("phase 6: out-of-core B-BENU (host row store + device row cache)")
    with gc_paused():
        launches["sorted_intersect"] += phase_ooc(
            dev, g_mid, tri_mid, mid_runs, g_full, tri_full)
    with nccl_world_of_one(dev):
        log("phase 8a: dist over NCCL (a world of one rank) and the join "
            "baseline")
        with gc_paused():
            launches["sorted_intersect"] += phase_dist(
                dev, g_mid, mid_runs, g_full, tri_full, full_levels)
        del g_mid, mid_runs, g_full
        log("phase 7: streaming S-BENU")
        with gc_paused():
            n, stream = phase_sbenu(dev)
            launches["sorted_intersect"] += n
        log("phase 8b: sbenu-dist over NCCL on phase 7's full stream")
        with gc_paused():
            launches["sorted_intersect"] += phase_sbenu_dist(dev, stream)
        del stream
        log("phase 13: GNN training at full width (gin-tu, pna, egnn, "
            "meshgraphnet), gnn_dist over NCCL, the motif example")
        phase_gnn(dev)
    log("phase 13b: the examples on the card (quickstart_torch, "
        "continuous_enum_torch, train_lm_torch)")
    phase_examples()
    log("phase 14: the dry-run tooling (the kernel ops; a qwen2-0.5b "
        "training step on a (1, 1) mesh against no mesh, and the op counter "
        "on it; the cells on the 16 x 16 and 2 x 16 x 16 meshes, run in "
        "subprocesses beside phase 4's graph generation)")
    phase_dryrun(dev, peak, dry_out, dry)

    sources = {"sorted_intersect": ("src/repro_torch/csrc/sorted_intersect.cu",
                                    "src/repro/kernels/sorted_intersect.py:50"),
               "gather_intersect": ("src/repro_torch/csrc/gather_intersect.cu",
                                    "src/repro/kernels/gather_intersect.py:77"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention.py:68"),
               "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                           "src/repro/kernels/rmsnorm.py:25"),
               # the port's own backwards of those two TPU kernels
               "flash_attention_bwd": (
                   "src/repro_torch/csrc/flash_attention_bwd.cu",
                   "src/repro/kernels/flash_attention.py:68"),
               "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm_bwd.cu",
                               "src/repro/kernels/rmsnorm.py:25")}
    for name, at in (("flash_attention", mla),
                     ("flash_attention_bwd", mla_bwd)):
        kern[name]["at_mla_shape"] = {
            k: at[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                               "bound_by", "shape")}
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": kern[name]["max_abs_err"],
                "ms": kern[name]["ms"], "plain_ms": kern[name]["plain_ms"],
                "bound_ms": kern[name]["bound_ms"],
                "bound_by": kern[name].get("bound_by", "bytes"),
                "library_ms": kern[name].get("library_ms"),
                **({"at_mla_shape": kern[name]["at_mla_shape"]}
                   if "at_mla_shape" in kern[name] else {})}
               for name, (src, replaces) in sources.items()]
    log(f"chip_smoke.py: {time.perf_counter() - t_script:.1f} s in all")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
