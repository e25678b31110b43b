"""BENU as a motif-count feature extractor for a GNN, on the port.

Counterpart of ``examples/motif_features.py`` that imports only
``repro_torch``: BENU counts each vertex's triangle and square
participation (collecting matches, not just counts), the counts become
``log1p`` node features, and the assigned GIN architecture (3 x 32)
trains for 100 steps on a task where motif counts carry the label
signal. On the card unless ``--device cpu``.

    PYTHONPATH=src python examples/motif_features_torch.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.engine_torch import enumerate_graph, resolve_device
from repro_torch.core.pattern import get_pattern
from repro_torch.core.plangen import generate_best_plan
from repro_torch.graph.batch import GraphBatch
from repro_torch.graph.generate import powerlaw
from repro_torch.graph.storage import edge_index_from_graph
from repro_torch.models.gnn import GNNConfig, gnn_loss, init_gnn_params
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.optimizer import AdamWConfig


def motif_counts(g, device) -> np.ndarray:
    """``float32[n, 2]``: each vertex's triangle and square matches."""
    feats = np.zeros((g.n, 2), np.float32)
    for j, pname in enumerate(("triangle", "square")):
        plan = generate_best_plan(get_pattern(pname), g.stats())
        res = enumerate_graph(plan, g, batch=64, collect_matches=True,
                              device=device)
        for match in res["matches"]:
            for v in match:
                feats[v, j] += 1.0
    return feats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "when there is none)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = powerlaw(300, 4, seed=7)
    counts = motif_counts(g, dev)
    print(f"motif features: triangles total={int(counts[:, 0].sum())}, "
          f"squares total={int(counts[:, 1].sum())}")
    feats = np.log1p(counts)

    # labels derived from motif participation (learnable signal)
    labels = (feats[:, 0] > np.median(feats[:, 0])).astype(np.int32)

    ei = edge_index_from_graph(g)
    batch = GraphBatch(
        x=feats, edge_src=ei[0], edge_dst=ei[1], labels=labels,
        n_nodes=g.n, node_mask=np.ones(g.n, bool),
        loss_mask=np.ones(g.n, bool)).as_arrays()

    cfg = GNNConfig("gin-motif", "gin", n_layers=3, d_hidden=32, d_feat=2,
                    n_out=2)
    hist = run_training(
        gnn_loss, lambda: init_gnn_params(cfg, seed=0, device=dev),
        lambda step: batch,
        AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=100),
        TrainLoopConfig(steps=100, ckpt_every=1000, log_every=25),
        device=dev)
    print(f"GIN on BENU motif features: loss {hist['loss'][0]:.3f} -> "
          f"{hist['loss'][-1]:.3f}")
    if not hist["loss"][-1] < hist["loss"][0]:
        raise SystemExit("the loss did not fall")
    return counts, hist


if __name__ == "__main__":
    main()
