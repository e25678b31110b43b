"""Padded graph batches + neighbor sampling (GNN substrate).

Counterpart of ``repro/graph/batch.py``, numpy only and the same values
bit for bit: every graph workload is normalized into a
:class:`GraphBatch` of sentinel-padded edge lists (static shapes, which
the reference's segment-sum message passing needs and the port's GNN
slice will read), built over the port's :class:`~repro_torch.graph.storage.Graph`.

Conventions: edge endpoints == ``n_nodes`` are padding (they scatter into a
dropped extra segment); node rows beyond ``n_valid`` are zeros.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .storage import Graph


@dataclass
class GraphBatch:
    """Host-side batch; fields become the device arrays of input_specs."""

    x: np.ndarray             # [N, F] float32
    edge_src: np.ndarray      # [E] int32 (sentinel N = padding)
    edge_dst: np.ndarray      # [E] int32
    labels: np.ndarray        # [N] or [G] int32/float32
    n_nodes: int              # static row count N
    node_mask: np.ndarray     # [N] bool
    loss_mask: np.ndarray     # [N] or [G] bool (supervised nodes/graphs)
    graph_ids: Optional[np.ndarray] = None   # [N] int32 (batched graphs)
    n_graphs: int = 1
    pos: Optional[np.ndarray] = None          # [N, 3] (EGNN)
    edge_attr: Optional[np.ndarray] = None    # [E, de] (MeshGraphNet)
    targets: Optional[np.ndarray] = None      # [N, dt] regression targets

    def as_arrays(self) -> Dict[str, np.ndarray]:
        out = {"x": self.x, "edge_src": self.edge_src,
               "edge_dst": self.edge_dst, "labels": self.labels,
               "node_mask": self.node_mask, "loss_mask": self.loss_mask}
        if self.graph_ids is not None:
            out["graph_ids"] = self.graph_ids
        if self.pos is not None:
            out["pos"] = self.pos
        if self.edge_attr is not None:
            out["edge_attr"] = self.edge_attr
        if self.targets is not None:
            out["targets"] = self.targets
        return out


# --------------------------------------------------------------------------
# Synthetic full graphs (Cora-like / products-like)
# --------------------------------------------------------------------------


def synthetic_full_graph(n_nodes: int, n_edges: int, d_feat: int,
                         n_classes: int, seed: int = 0,
                         directed_double: bool = True) -> GraphBatch:
    """ER-ish graph with features correlated to labels (learnable signal)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    if directed_double:   # symmetric message passing
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    labels = rng.integers(0, n_classes, size=n_nodes).astype(np.int32)
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    x = (centers[labels] + rng.normal(size=(n_nodes, d_feat)) * 2.0
         ).astype(np.float32)
    return GraphBatch(
        x=x, edge_src=src.astype(np.int32), edge_dst=dst.astype(np.int32),
        labels=labels, n_nodes=n_nodes,
        node_mask=np.ones(n_nodes, bool), loss_mask=np.ones(n_nodes, bool),
        pos=rng.normal(size=(n_nodes, 3)).astype(np.float32))


def synthetic_mesh(n_nodes: int, n_edges: int, d_feat: int, d_edge: int,
                   seed: int = 0) -> GraphBatch:
    """MeshGraphNet-style batch: edge features + 3D regression targets."""
    g = synthetic_full_graph(n_nodes, n_edges // 2, d_feat, 4, seed=seed)
    rng = np.random.default_rng(seed + 1)
    e = len(g.edge_src)
    g.edge_attr = rng.normal(size=(e, d_edge)).astype(np.float32)
    g.targets = rng.normal(size=(n_nodes, 3)).astype(np.float32)
    g.pos = rng.normal(size=(n_nodes, 3)).astype(np.float32)
    return g


def synthetic_molecules(n_graphs: int, nodes_per: int, edges_per: int,
                        d_feat: int, n_classes: int, seed: int = 0
                        ) -> GraphBatch:
    """Block-diagonal batch of small graphs (graph classification)."""
    rng = np.random.default_rng(seed)
    N = n_graphs * nodes_per
    E = n_graphs * edges_per * 2
    src = np.empty(E, np.int32)
    dst = np.empty(E, np.int32)
    gid = np.repeat(np.arange(n_graphs, dtype=np.int32), nodes_per)
    for gidx in range(n_graphs):
        o = gidx * nodes_per
        s = rng.integers(0, nodes_per, size=edges_per)
        t = rng.integers(0, nodes_per, size=edges_per)
        base = gidx * edges_per * 2
        src[base:base + edges_per] = o + s
        dst[base:base + edges_per] = o + t
        src[base + edges_per:base + 2 * edges_per] = o + t
        dst[base + edges_per:base + 2 * edges_per] = o + s
    labels = rng.integers(0, n_classes, size=n_graphs).astype(np.int32)
    x = rng.normal(size=(N, d_feat)).astype(np.float32)
    x[:, 0] += labels[gid] * 0.5       # learnable signal
    pos = rng.normal(size=(N, 3)).astype(np.float32)
    return GraphBatch(
        x=x, edge_src=src, edge_dst=dst, labels=labels, n_nodes=N,
        node_mask=np.ones(N, bool),
        loss_mask=np.ones(n_graphs, bool), graph_ids=gid,
        n_graphs=n_graphs, pos=pos)


# --------------------------------------------------------------------------
# Fan-out neighbor sampler (minibatch_lg)
# --------------------------------------------------------------------------


class NeighborSampler:
    """GraphSAGE-style uniform fan-out sampler over a Graph's adjacency.

    ``sample(targets)`` returns a padded induced block: the union of sampled
    nodes (targets first), the sampled edges relabeled to block-local ids,
    padded to static (n_max, e_max). Models run all their layers on the
    induced block; the loss covers the target rows only.
    """

    def __init__(self, graph: Graph, fanouts: Sequence[int], seed: int = 0):
        self.graph = graph
        self.fanouts = list(fanouts)
        self.rng = np.random.default_rng(seed)

    def capacity(self, batch_nodes: int) -> Tuple[int, int]:
        n = batch_nodes
        e = 0
        for f in self.fanouts:
            e += n * f
            n += n * f
        return n, e * 2

    def sample(self, targets: np.ndarray,
               n_max: Optional[int] = None,
               e_max: Optional[int] = None) -> GraphBatch:
        cap_n, cap_e = self.capacity(len(targets))
        n_max = n_max or cap_n
        e_max = e_max or cap_e
        nodes: List[int] = list(dict.fromkeys(int(t) for t in targets))
        local = {v: i for i, v in enumerate(nodes)}
        edges: List[Tuple[int, int]] = []
        frontier = list(nodes)
        for f in self.fanouts:
            nxt: List[int] = []
            for v in frontier:
                nbrs = self.graph.adj[v]
                if len(nbrs) == 0:
                    continue
                take = self.rng.choice(nbrs, size=min(f, len(nbrs)),
                                       replace=False)
                for w in take:
                    w = int(w)
                    if w not in local:
                        if len(nodes) >= n_max:
                            continue
                        local[w] = len(nodes)
                        nodes.append(w)
                        nxt.append(w)
                    edges.append((local[w], local[v]))   # message w -> v
                    edges.append((local[v], local[w]))
            frontier = nxt
        n = len(nodes)
        e = min(len(edges), e_max)
        src = np.full(e_max, n_max, np.int32)
        dst = np.full(e_max, n_max, np.int32)
        for i, (a, b) in enumerate(edges[:e]):
            src[i], dst[i] = a, b
        node_mask = np.zeros(n_max, bool)
        node_mask[:n] = True
        loss_mask = np.zeros(n_max, bool)
        loss_mask[:len(targets)] = True
        return GraphBatch(
            x=np.zeros((n_max, 0), np.float32),   # features filled by caller
            edge_src=src, edge_dst=dst,
            labels=np.zeros(n_max, np.int32), n_nodes=n_max,
            node_mask=node_mask, loss_mask=loss_mask,
        ), np.array(nodes, dtype=np.int64)

    def sample_batch(self, targets: np.ndarray, feats: np.ndarray,
                     labels: np.ndarray, n_max: int, e_max: int
                     ) -> GraphBatch:
        batch, global_ids = self.sample(targets, n_max, e_max)
        x = np.zeros((n_max, feats.shape[1]), np.float32)
        x[:len(global_ids)] = feats[global_ids]
        lb = np.zeros(n_max, np.int32)
        lb[:len(global_ids)] = labels[global_ids]
        batch.x = x
        batch.labels = lb
        return batch
