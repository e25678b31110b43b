"""benu [paper]: the paper's own technique as a dry-runnable architecture.

Counterpart of ``repro/configs/benu.py``. Distributed subgraph
enumeration of the chordal-square (the core structure of the paper's hard
patterns q7-q9, Table 1) over a production-scale synthetic power-law
graph: 2^27 vertices, padded row width 128, rows block-partitioned over
all 256 (512 multi-pod) devices. The dry-run traces one frontier step of
the distributed engine (INI -> DBQ(all_to_all) -> INT -> ENU -> ... ->
RES) as rank 0 runs it, and one vectorized Delta-P_1 step of S-BENU.
"""

from dataclasses import dataclass
from typing import Dict, Tuple

from .base import ArchSpec, ShapeSpec


@dataclass(frozen=True)
class BenuEnumConfig:
    name: str = "benu"
    pattern: str = "chordal-square"
    n_vertices: int = 1 << 27            # 134M-vertex data graph
    row_width: int = 128                 # padded adjacency width (lanes)
    hot: int = 4096                      # replicated hot rows
    batch_per_shard: int = 4096          # start vertices per device
    req_cap: int = 512                   # all_to_all per-peer budget
    cap_mult: Tuple[int, ...] = (8, 16, 16)   # per-ENU capacity x batch
    # S-BENU (streaming) cell
    sbenu_pattern: str = "q1'"           # directed pattern of the delta cell
    sbenu_n_vertices: int = 1 << 24      # 16M-vertex dynamic graph
    delta_width: int = 16                # padded delta adjacency width
    sbenu_batch: int = 8192              # touched start vertices per step


def _shapes(cfg: BenuEnumConfig, n_shards: int) -> Dict[str, ShapeSpec]:
    rps = -(-(cfg.n_vertices + 1) // n_shards)
    return {
        "enum_128m": ShapeSpec(
            "enum_128m", "benu_enum",
            {"n_shards": n_shards, "rows_per_shard": rps,
             "row_width": cfg.row_width, "hot": cfg.hot,
             "batch_per_shard": cfg.batch_per_shard},
            note="one distributed frontier step over the full mesh"),
        "sbenu_delta_16m": ShapeSpec(
            "sbenu_delta_16m", "sbenu_enum",
            {"n_vertices": cfg.sbenu_n_vertices,
             "row_width": cfg.row_width, "delta_width": cfg.delta_width,
             "batch": cfg.sbenu_batch},
            note="one vectorized Delta-P_1 step over the dual snapshot"),
    }


CONFIG = BenuEnumConfig()


def _smoke() -> ArchSpec:
    cfg = BenuEnumConfig(name="benu-smoke", n_vertices=512, row_width=128,
                         hot=16, batch_per_shard=64, req_cap=64,
                         sbenu_n_vertices=512, delta_width=8,
                         sbenu_batch=64)
    return ArchSpec(name="benu/smoke", family="benu", model_cfg=cfg,
                    shapes=_shapes(cfg, n_shards=1))


SPEC = ArchSpec(
    name="benu", family="benu", model_cfg=CONFIG,
    shapes=_shapes(CONFIG, n_shards=256),
    source="this paper",
    applicability="the technique itself",
    smoke_builder=_smoke)
