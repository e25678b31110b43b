"""Deterministic synthetic data pipelines (sharded, restart-reproducible).

Counterpart of ``repro/data/pipelines.py``, numpy only: every batch is
bit-equal to the reference's for the same seed and step. Batches stay
numpy; the training loop moves them to the device.

Every batch is a pure function of (stream seed, step), so a restarted job
regenerates the exact stream from its checkpoint step — no data-loader
state needs checkpointing. In a multi-host deployment each process slices
``[proc_index * per_proc : (proc_index+1) * per_proc]`` of the global batch
(the ``process_slice`` helper), keeping global batch identity.

The LM stream is a mixture of Zipf-distributed tokens with short-range
induced structure (copy motifs), so a few hundred steps of training show a
real loss decrease (used by the training loop and its restart tests).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from ..graph.batch import GraphBatch, NeighborSampler
from ..graph.storage import Graph


def process_slice(batch: Dict[str, np.ndarray], proc: int, n_procs: int
                  ) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        per = b // n_procs
        out[k] = v[proc * per:(proc + 1) * per]
    return out


# --------------------------------------------------------------------------
# LM token stream
# --------------------------------------------------------------------------


@dataclass
class LMStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        b, t = self.global_batch, self.seq_len
        # Zipf-ish marginal + copy motif: second half repeats the first
        # (compressible structure => CE decreases quickly)
        half = t // 2
        x = rng.zipf(self.zipf_a, size=(b, t)).astype(np.int64)
        x = np.minimum(x, self.vocab - 1)
        x[:, half:half * 2] = x[:, :half]
        tokens = x.astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], tokens[:, :1]], axis=1).astype(np.int32)
        return {"tokens": tokens, "labels": labels}


# --------------------------------------------------------------------------
# RecSys stream (BST)
# --------------------------------------------------------------------------


@dataclass
class RecsysStream:
    n_items: int
    n_user_feats: int
    seq_len: int
    user_feat_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        b = self.global_batch
        hist = rng.integers(1, self.n_items,
                            size=(b, self.seq_len)).astype(np.int32)
        # positive targets correlate with history (same id bucket)
        pos = (hist[:, -1] + rng.integers(0, 16, size=b)) % self.n_items
        neg = rng.integers(1, self.n_items, size=b)
        label = rng.integers(0, 2, size=b).astype(np.float32)
        target = np.where(label > 0.5, pos, neg).astype(np.int32)
        uf = rng.integers(0, self.n_user_feats,
                          size=(b, self.user_feat_len)).astype(np.int32)
        uf[:, self.user_feat_len // 2:] = 0     # ragged bags via pad id 0
        return {"hist": hist, "target": target, "user_feats": uf,
                "label": label}


# --------------------------------------------------------------------------
# GNN streams
# --------------------------------------------------------------------------


@dataclass
class FullGraphData:
    """Static full-batch dataset: the same batch each step."""

    batch: GraphBatch

    def __call__(self, step: int) -> Dict[str, np.ndarray]:
        return self.batch.as_arrays()


@dataclass
class MinibatchGraphStream:
    """Fan-out sampled blocks from a big host graph (minibatch_lg cell)."""

    graph: Graph
    feats: np.ndarray
    labels: np.ndarray
    batch_nodes: int
    fanouts: Tuple[int, ...]
    n_max: int
    e_max: int
    seed: int = 0

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        sampler = NeighborSampler(self.graph, self.fanouts,
                                  seed=int(rng.integers(1 << 31)))
        targets = rng.choice(self.graph.n, size=self.batch_nodes,
                             replace=False)
        gb = sampler.sample_batch(targets, self.feats, self.labels,
                                  self.n_max, self.e_max)
        return gb.as_arrays()
