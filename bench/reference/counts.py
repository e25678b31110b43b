"""Plain reference: how many copies of a pattern a graph holds.

Straight PyTorch over the benchmark's own CSR arrays (``graphgen.Csr``),
written from the patterns' definitions and nothing of the program: no
plan, no frontier, no padded rows. A copy is a subgraph, counted once
however many automorphisms the pattern has, and it need not be induced
(a 4-cycle with a chord still holds one 4-cycle per chord-free cycle).

Every copy is charged to its lowest vertex, the start vertex that
B-BENU's symmetry breaking gives it, so ``starts`` (``bool[n]``) counts
only the copies whose lowest vertex it marks; ``None`` counts them all.

Work runs in blocks of edges grouped by their lower end, so a block
holds every wedge of the starts it covers and no block outgrows
``block`` wedges by more than one vertex's.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch


class _Graph:
    """The CSR on ``device``: ``src``, ``dst`` are the edges ``(a, b)``,
    ``a < b``, in ``(a, b)`` order."""

    def __init__(self, csr, device):
        n = csr.n
        self.n = n
        self.device = torch.device(device)
        indptr = torch.from_numpy(csr.indptr).to(self.device)
        col = torch.from_numpy(csr.col).to(self.device)
        deg = indptr[1:] - indptr[:-1]
        row = torch.repeat_interleave(
            torch.arange(n, device=self.device), deg)
        up = col > row
        self.src, self.dst = row[up], col[up]
        self.indptr, self.col = indptr, col
        self.row_key = row * n + col     # ascending: rows in order, each
        #                                  row ascending

    def blocks(self, weight: torch.Tensor, block: int):
        """Slices of ``self.src``'s edges, cut only between two lower
        ends, each holding about ``block`` units of ``weight``."""
        e = self.src.numel()
        if e == 0:
            return
        cum = torch.cumsum(weight, 0).cpu().numpy()
        src = self.src.cpu().numpy()
        lo = 0
        while lo < e:
            hi = int(np.searchsorted(cum, (cum[lo - 1] if lo else 0) + block,
                                     side="right"))
            hi = min(max(hi, lo + 1), e)
            hi = int(np.searchsorted(src, src[hi - 1], side="right"))
            yield lo, hi
            lo = hi


def _expand(starts_ptr: torch.Tensor, counts: torch.Tensor,
            pool: torch.Tensor):
    """For item ``i``, the ``counts[i]`` entries of ``pool`` from
    ``starts_ptr[i]`` on: ``(item index, entry)`` pairs."""
    item = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)
    first = torch.cumsum(counts, 0) - counts
    k = torch.arange(item.numel(), device=counts.device) - first[item]
    return item, pool[starts_ptr[item] + k]


def four_cycles(csr, device="cpu", starts: Optional[np.ndarray] = None,
                block: int = 1 << 25) -> int:
    """4-cycles ``a-b-c-d-a``. With ``a`` the lowest vertex, ``c`` is its
    opposite corner and ``b``, ``d`` two common neighbours of ``a`` and
    ``c`` above ``a``: the copies are ``sum over pairs a < c`` of
    ``C(k, 2)``, ``k`` those common neighbours."""
    g = _Graph(csr, device)
    start_mask = _mask(starts, g)
    # wedge a - b - c with b > a, c > a: edge (a, b) of `up`, then the
    # neighbours of b above a, which end row b
    pos = torch.searchsorted(g.row_key, g.dst * g.n + g.src, right=True)
    cnt = g.indptr[g.dst + 1] - pos
    total = 0
    for lo, hi in g.blocks(cnt, block):
        a = g.src[lo:hi]
        keep = start_mask[a]
        item, c = _expand(pos[lo:hi][keep], cnt[lo:hi][keep], g.col)
        pair = a[keep][item] * g.n + c
        _, k = torch.unique(pair, return_counts=True)
        total += int((k * (k - 1) // 2).sum())
    return total


def _mask(starts: Optional[np.ndarray], g: _Graph) -> torch.Tensor:
    if starts is None:
        return torch.ones(g.n, dtype=torch.bool, device=g.device)
    return torch.as_tensor(np.asarray(starts, bool), device=g.device)


#: pattern name (the program's and the paper's) -> its count
COUNTS: Dict[str, Callable[..., int]] = {"q1": four_cycles}


def count(pattern: str, csr, device="cpu",
          starts: Optional[np.ndarray] = None) -> int:
    """Copies of ``pattern`` in ``csr`` whose lowest vertex ``starts``
    marks (all of them when ``None``)."""
    if pattern not in COUNTS:
        raise KeyError(f"no reference count for pattern {pattern!r}; "
                       f"have {sorted(COUNTS)}")
    return COUNTS[pattern](csr, device=device, starts=starts)
