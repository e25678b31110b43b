"""The work each hand-written kernel does: flops and bytes.

One definition serves three readers: the flop formulas registered for
the kernel ops (:mod:`repro_torch.kernels.library`, read by
``torch.utils.flop_counter`` and ``launch/op_analysis.py``), the dry-run's
byte counts of a kernel op, and the bound column of ``chip_smoke.py``
(``bound_ms``: the larger of bytes over the memory rate and flops over
the peak rate).

Flops count the products only (two per multiply-add), as the dry-run's
counter counts matmuls: RMSNorm and the intersects do no products and
count 0. Flash attention is counted at the granularity the kernel works
at: the visible query-key pairs (a causal mask aligned bottom-right
halves them, ``t(t+1)/2`` a head at ``Tq = Tk = t``). Bytes are the
least traffic of the function: each input read once, each output
written once.
"""

from __future__ import annotations


def visible_pairs(tq: int, tk: int, causal: bool) -> int:
    """Query-key pairs a head computes: all ``tq * tk``, or with the
    bottom-right causal mask (query ``i`` sees keys ``<= i + tk - tq``)
    ``sum_i min(tk, max(0, i + tk - tq + 1))``."""
    if not causal:
        return tq * tk
    # rows i >= tq - tk see i + tk - tq + 1 keys: 1 .. tk, or the last tq
    # of them when tq < tk
    rows = min(tq, tk)
    return rows * (2 * tk - rows + 1) // 2


def flash_flops(b: int, hq: int, tq: int, tk: int, dqk: int, dv: int,
                causal: bool) -> int:
    """Forward: ``S = q k^T`` (``2 * dqk``) and ``P v`` (``2 * dv``) per
    visible pair and q head."""
    return 2 * (dqk + dv) * b * hq * visible_pairs(tq, tk, causal)


def flash_bwd_flops(b: int, hq: int, tq: int, tk: int, dqk: int, dv: int,
                    causal: bool) -> int:
    """Backward: S and dQ, dK (``2 * dqk`` each), dP and dV (``2 * dv``
    each) per visible pair and q head."""
    return 2 * (3 * dqk + 2 * dv) * b * hq * visible_pairs(tq, tk, causal)


def flash_bytes(b: int, hq: int, hkv: int, tq: int, tk: int, dqk: int,
                dv: int, elem: int, with_lse: bool = False) -> int:
    """q, k, v read and out written (``elem`` bytes an element), plus the
    f32 ``lse`` written for training."""
    n = elem * (b * hq * tq * (dqk + dv) + b * hkv * tk * (dqk + dv))
    return n + (4 * b * hq * tq if with_lse else 0)


def flash_bwd_bytes(b: int, hq: int, hkv: int, tq: int, tk: int, dqk: int,
                    dv: int, elem: int) -> int:
    """q, k, v, out, dout and lse read; dq, dk, dv written."""
    return (elem * (2 * b * hq * tq * (dqk + dv)
                    + 2 * b * hkv * tk * (dqk + dv))
            + 4 * b * hq * tq)


def rmsnorm_bytes(rows: int, d: int, elem: int) -> int:
    """x and gamma read, out written."""
    return (2 * rows * d + d) * elem


def rmsnorm_bwd_bytes(rows: int, d: int, elem: int) -> int:
    """x, g and gamma read; dx and dgamma written."""
    return (3 * rows * d + 2 * d) * elem


def sorted_intersect_bytes(b: int, da: int, db: int) -> int:
    """int32 a [B, Da] and b [B, Db] read, out [B, Da] written."""
    return 4 * (b * (da + db) + b * da)


def gather_intersect_bytes(b: int, dc: int, d: int,
                           n_valid: int = None) -> int:
    """int32 ids [B] and cand [B, Dc] read, out [B, Dc] written, and one
    adjacency row [D] read per id below the sentinel (``n_valid``; every
    id when it is not known, as in a traced program)."""
    rows = b if n_valid is None else n_valid
    return 4 * (2 * b * dc + b + rows * d)


# --------------------------------------------------------------------------
# The cards' rates (NVIDIA data sheets: peaks, not measurements)
# --------------------------------------------------------------------------

#: HBM bandwidth by card name; a memory-bound kernel's bound is its bytes
#: over this rate
BANDWIDTH = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
             ("H100", 3.35e12))
#: dense bf16 tensor-core rate by card name; an operation-bound kernel's
#: bound is its flops over this rate
PEAK_BF16 = (("H100 PCIe", 756e12), ("H100 NVL", 835e12), ("H200", 989e12),
             ("H100", 989e12))
#: NVLink 4 bandwidth of an H100 SXM5, per direction
NVLINK_H100 = 450e9


def card_rate(table, name: str) -> float:
    """The rate of the first entry of ``table`` whose key is in the card's
    ``name``."""
    for key, rate in table:
        if key in name:
            return rate
    raise KeyError(f"no rate for card {name!r}")
