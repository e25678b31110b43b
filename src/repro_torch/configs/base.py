"""Architecture/shape registry plumbing.

Counterpart of ``repro/configs/base.py``. Every architecture ships as an
:class:`ArchSpec`:

    * the exact published model config,
    * its assigned shape set (each cell of the dry-run matrix),
    * ``input_specs(shape)``: meta tensors with the name, shape and dtype
      of every input (never allocated; the reference's
      ``jax.ShapeDtypeStruct`` stand-ins),
    * ``smoke()``: a reduced same-family config for CPU smoke tests.

Shape-kind vocabulary (drives which step function the dry-run traces):
    lm_train | lm_prefill | lm_decode | lm_long_decode
    gnn_full | gnn_minibatch | gnn_molecule
    rec_train | rec_serve | rec_retrieval
    benu_enum | sbenu_enum
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Optional

import torch

f32, i32, bf16 = torch.float32, torch.int32, torch.bfloat16


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor: a shape and a dtype, no storage."""
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype,
                       device="meta")


def pad512(n: int) -> int:
    """Edge/candidate arrays are padded to a multiple of 512 (the largest
    mesh) so they shard evenly; sentinel-padded entries are no-ops in the
    segment-sum / scoring paths."""
    return -(-n // 512) * 512


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str
    dims: Dict[str, int]          # e.g. {"seq": 4096, "batch": 256}
    note: str = ""


@dataclass
class ArchSpec:
    name: str
    family: str                   # lm | gnn | recsys | benu
    model_cfg: Any
    shapes: Dict[str, ShapeSpec] = field(default_factory=dict)
    source: str = ""              # citation tag from the assignment
    applicability: str = ""       # how the paper's technique applies
    smoke_builder: Optional[Callable[[], "ArchSpec"]] = None

    # ------------------------------------------------------------- input specs
    def input_specs(self, shape_name: str) -> Dict[str, torch.Tensor]:
        """Meta tensors of the cell's inputs, by the reference's names."""
        sp = self.shapes[shape_name]
        fam, cfg = self.family, self.model_cfg
        d = sp.dims
        if fam == "lm":
            if sp.kind == "lm_train":
                return {"tokens": sds((d["batch"], d["seq"]), i32),
                        "labels": sds((d["batch"], d["seq"]), i32)}
            if sp.kind == "lm_prefill":
                return {"tokens": sds((d["batch"], d["seq"]), i32)}
            if sp.kind in ("lm_decode", "lm_long_decode"):
                return {"tokens": sds((d["batch"], 1), i32)}
            raise KeyError(sp.kind)
        if fam == "gnn":
            n, e = d["n_nodes"], pad512(d["n_edges"])
            specs = {"x": sds((n, d["d_feat"]), f32),
                     "edge_src": sds((e,), i32),
                     "edge_dst": sds((e,), i32),
                     "node_mask": sds((n,), torch.bool)}
            if cfg.task == "node_reg":
                specs["targets"] = sds((n, cfg.n_out), f32)
                specs["labels"] = sds((n,), i32)
                specs["loss_mask"] = sds((n,), torch.bool)
            elif sp.kind == "gnn_molecule":
                specs["labels"] = sds((d["n_graphs"],), i32)
                specs["loss_mask"] = sds((d["n_graphs"],), torch.bool)
                specs["graph_ids"] = sds((n,), i32)
            else:
                specs["labels"] = sds((n,), i32)
                specs["loss_mask"] = sds((n,), torch.bool)
            if cfg.kind == "egnn":
                specs["pos"] = sds((n, 3), f32)
            if cfg.kind == "mgn":
                specs["edge_attr"] = sds((e, cfg.d_edge), f32)
            return specs
        if fam == "recsys":
            b = d["batch"]
            base = {"hist": sds((b, cfg.seq_len), i32),
                    "target": sds((b,), i32),
                    "user_feats": sds((b, cfg.user_feat_len), i32)}
            if sp.kind == "rec_train":
                base["label"] = sds((b,), f32)
            if sp.kind == "rec_retrieval":
                base = {"hist": sds((1, cfg.seq_len), i32),
                        "user_feats": sds((1, cfg.user_feat_len), i32),
                        "cand_ids": sds((pad512(d["n_candidates"]),), i32)}
            return base
        if fam == "benu":
            if sp.kind == "sbenu_enum":
                n1, D, Dd = d["n_vertices"] + 1, d["row_width"], \
                    d["delta_width"]
                specs = {k: sds((n1, D), i32)
                         for k in ("prev_out", "prev_in",
                                   "cur_out", "cur_in")}
                specs.update({k: sds((n1, Dd), i32)
                              for k in ("delta_out", "delta_out_sign",
                                        "delta_in", "delta_in_sign")})
                specs["starts"] = sds((d["batch"],), i32)
                specs["starts_valid"] = sds((d["batch"],), torch.bool)
                return specs
            S = d["n_shards"]
            return {
                "shards": sds((S, d["rows_per_shard"], d["row_width"]), i32),
                "hot_rows": sds((d["hot"] + 1, d["row_width"]), i32),
                "starts": sds((S * d["batch_per_shard"],), i32),
                "starts_valid": sds((S * d["batch_per_shard"],),
                                    torch.bool),
            }
        raise KeyError(fam)

    # ------------------------------------------------------ per-shape config
    def model_cfg_for(self, shape_name: str):
        """GNN configs vary with the shape (feature dim / classes /
        task); the other families' configs do not."""
        if self.family != "gnn":
            return self.model_cfg
        sp = self.shapes[shape_name]
        cfg = self.model_cfg
        if cfg.task == "node_reg":                      # meshgraphnet
            return replace(cfg, d_feat=sp.dims["d_feat"])
        task = "graph_class" if sp.kind == "gnn_molecule" else "node_class"
        return replace(cfg, d_feat=sp.dims["d_feat"],
                       n_out=sp.dims["n_classes"], task=task)

    # ----------------------------------------------------------------- smoke
    def smoke(self) -> "ArchSpec":
        """Reduced same-family config for CPU smoke tests."""
        if self.smoke_builder is None:
            raise ValueError(f"{self.name}: no smoke config")
        return self.smoke_builder()


# --------------------------------------------------------------------------
# Shared shape sets (the per-family shape lists)
# --------------------------------------------------------------------------


def lm_shapes() -> Dict[str, ShapeSpec]:
    return {
        "train_4k": ShapeSpec("train_4k", "lm_train",
                              {"seq": 4096, "batch": 256}),
        "prefill_32k": ShapeSpec("prefill_32k", "lm_prefill",
                                 {"seq": 32768, "batch": 32}),
        "decode_32k": ShapeSpec("decode_32k", "lm_decode",
                                {"seq": 32768, "batch": 128}),
        "long_500k": ShapeSpec(
            "long_500k", "lm_long_decode",
            {"seq": 524288, "batch": 1},
            note="decode vs a 512k KV cache; attention is O(L) per emitted "
                 "token: the cache is sharded over every axis and the "
                 "softmax combines partial max/sum by all-reduce "
                 "(flash-decode)"),
    }


def lm_smoke_shapes() -> Dict[str, ShapeSpec]:
    """The LM smoke configs' cells (the reference's ``smoke()`` shapes)."""
    return {"train": ShapeSpec("train", "lm_train", {"seq": 32, "batch": 2}),
            "decode": ShapeSpec("decode", "lm_decode",
                                {"seq": 64, "batch": 2})}


def gnn_shapes(d_feat_override: Optional[Dict[str, int]] = None
               ) -> Dict[str, ShapeSpec]:
    ov = d_feat_override or {}
    return {
        "full_graph_sm": ShapeSpec(
            "full_graph_sm", "gnn_full",
            {"n_nodes": 2708, "n_edges": 2 * 10556,
             "d_feat": ov.get("full_graph_sm", 1433), "n_classes": 7},
            note="Cora-scale full batch (edges symmetrized: 2x)"),
        "minibatch_lg": ShapeSpec(
            "minibatch_lg", "gnn_minibatch",
            {"n_nodes": 169_984, "n_edges": 337_920,
             "d_feat": ov.get("minibatch_lg", 602),
             "batch_nodes": 1024, "fanout1": 15, "fanout2": 10,
             "n_classes": 41, "graph_nodes": 232_965},
            note="Reddit-scale sampled block: 1024 targets, fanout 15-10 -> "
                 "padded induced block (nodes 1024*(1+15+150))"),
        "ogb_products": ShapeSpec(
            "ogb_products", "gnn_full",
            {"n_nodes": 2_449_408, "n_edges": 2 * 61_859_140,
             "d_feat": ov.get("ogb_products", 100), "n_classes": 47},
            note="full-batch-large (edges symmetrized; nodes padded "
                 "2449029 -> 2449408 for even 1D node sharding)"),
        "molecule": ShapeSpec(
            "molecule", "gnn_molecule",
            {"n_nodes": 128 * 30, "n_edges": 2 * 128 * 64,
             "d_feat": ov.get("molecule", 16), "n_graphs": 128,
             "n_classes": 2},
            note="batched small graphs, block-diagonal"),
    }


def recsys_shapes() -> Dict[str, ShapeSpec]:
    return {
        "train_batch": ShapeSpec("train_batch", "rec_train",
                                 {"batch": 65_536}),
        "serve_p99": ShapeSpec("serve_p99", "rec_serve", {"batch": 512}),
        "serve_bulk": ShapeSpec("serve_bulk", "rec_serve",
                                {"batch": 262_144}),
        "retrieval_cand": ShapeSpec("retrieval_cand", "rec_retrieval",
                                    {"batch": 1,
                                     "n_candidates": 1_000_000}),
    }
