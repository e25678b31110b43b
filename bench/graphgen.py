"""The benchmark's data graphs, made in bulk from two seeds.

``uniform_edges`` is the GAP Benchmark Suite's uniform random graph
(``Urand``; Beamer, Asanovic and Patterson, arXiv:1508.03619): ``degree``
times ``2**scale`` endpoint pairs drawn uniformly at random, made
undirected, with self-loops and repeated pairs removed, as the suite's
builder does. The draws and the layout run in bulk on the device that
the run uses (a stream of draws a device: the card's graph of a seed is
not the CPU's). The program's own generators are not used, so a change
to the program cannot move the graph it is measured on.

Two seeds, two jobs. The configuration's ``structure_seed`` draws the
edges, so every run of a cell enumerates one graph and does one amount
of work. The run's ``--seed`` draws the order of the vertices: the ids
are ranked by degree, as the program's loader ranks them, and the seed
breaks the ties among equal degrees, which almost all vertices share
with many others. So the seed moves every chunk's contents, the splits
and each symmetry-breaking order between equal-degree neighbours, while
the padded width, the frontier totals and the answer stay those of the
one graph.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Csr:
    """An undirected simple graph: ``col[indptr[v]:indptr[v + 1]]`` are
    the neighbours of ``v``, ascending; ids ascend with degree."""

    n: int
    indptr: np.ndarray     # int64[n + 1]
    col: np.ndarray        # int64[2m]

    @property
    def deg(self) -> np.ndarray:
        return np.diff(self.indptr)


def uniform_edges(n: int, degree: int, seed: int, device="cpu"
                  ) -> torch.Tensor:
    """``int64[E, 2]`` edges ``(a, b)``, ``a < b``, no loop, no repeat,
    from ``degree * n`` uniform endpoint pairs drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pairs = torch.randint(0, n, (degree * n, 2), generator=gen,
                          device=device)
    a, b = pairs.min(dim=1).values, pairs.max(dim=1).values
    key = torch.unique((a * n + b)[a != b])
    return torch.stack([key // n, key % n], dim=1)


def canonical_csr(n: int, edges: torch.Tensor, seed: int) -> Csr:
    """Rank the vertices by ``(degree, a draw from seed)`` ascending, as
    the program's loader ranks them by ``(degree, id)``, and lay the
    relabelled graph out as sorted adjacency lists."""
    edges = torch.as_tensor(edges, dtype=torch.int64)
    device = edges.device
    deg = torch.bincount(edges.reshape(-1), minlength=n)
    gen = torch.Generator(device=device).manual_seed(seed)
    tie = torch.randperm(n, generator=gen, device=device)
    order = torch.argsort(deg * n + tie)
    rank = torch.empty(n, dtype=torch.int64, device=device)
    rank[order] = torch.arange(n, device=device)
    a, b = rank[edges[:, 0]], rank[edges[:, 1]]
    key = torch.sort(torch.cat([a * n + b, b * n + a])).values
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    indptr[1:] = torch.cumsum(torch.bincount(key // n, minlength=n), 0)
    return Csr(n=n, indptr=indptr.cpu().numpy(),
               col=(key % n).cpu().numpy())


def make_graph(spec: dict, seed: int, device="cpu") -> Csr:
    """A configuration's graph (``graph_model``, ``scale``, ``degree``,
    ``structure_seed``) in the vertex order of one run's seed, drawn on
    ``device`` (the stream of draws is the device's own)."""
    if spec["graph_model"] != "uniform_random":
        raise ValueError(f"unknown graph model {spec['graph_model']!r}")
    n = 1 << int(spec["scale"])
    edges = uniform_edges(n, int(spec["degree"]), int(spec["structure_seed"]),
                          device)
    return canonical_csr(n, edges, seed)
