"""Per-device roofline accounting of a traced program, op by op.

Counterpart of ``repro/launch/hlo_analysis.py``. The reference reads the
compiled HLO of one SPMD partition; the port has no HLO, so it reads the
ops that rank 0 dispatches: :class:`OpCounter` is a ``TorchDispatchMode``
that lets DTensor handle a DTensor op (it returns ``NotImplemented``, so
DTensor's sharding propagation and redistribution run) and then sees the
**local** ops below it, each on rank 0's shards:

    flops        ``torch.utils.flop_counter``'s formulas (matmuls,
                 convolutions, attention) plus the formulas registered for
                 the port's kernel ops (``kernels/cost.py``); elementwise
                 ops count 0, as the reference counts dots only
    hbm_bytes    operand plus result bytes of every dispatched op. Views
                 and metadata ops are free (the reference's ``_FREE_OPS``);
                 a gather or an index reads and writes its result's size, a
                 scatter twice its update's; a kernel op is one op at its
                 ``kernels/cost.py`` bytes. This is unfused eager traffic:
                 each op reads its inputs from memory and writes its output
                 there, which a fused program would not
    collectives  every c10d or functional collective (DTensor's
                 redistributions and the port's own ``torch.distributed``
                 calls): operand bytes by kind and the reference's ring wire
                 model at the op's group size
    peak bytes   the most bytes of tensor storage alive at once, arguments
                 included

Ops that DTensor runs only to derive a sharding strategy or a global
output shape (from its sharding propagator) are not counted.
"""

from __future__ import annotations

import sys
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")

#: collective op name (namespace-free, without overload) -> kind
_COLL_OPS = {
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
    "send": "collective-permute", "recv_": "collective-permute",
}

#: ops that move no bytes: views, metadata, allocation without a write,
#: waits
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "wait_tensor", "detach", "lift_fresh",
         "_local_scalar_dense"}
#: ops that touch a result-sized window of their source
_WINDOW = {"index", "index_select", "gather", "embedding", "take"}
#: in-place window updates: traffic is twice the update
_UPDATE = {"index_put", "index_put_", "scatter", "scatter_", "scatter_add",
           "scatter_add_", "index_add", "index_add_", "index_copy_",
           "scatter_reduce", "scatter_reduce_", "_index_put_impl_"}


def collective_bytes(kind: str, result_bytes: float,
                     group: int) -> Tuple[float, float]:
    """``(operand, wire)`` bytes of one collective with ``result_bytes``
    out on a group of ``group`` ranks: the reference's ring model
    (``hlo_analysis.analyze``)."""
    g, r = max(group, 1), result_bytes
    if kind == "all-gather":
        operand = r / g
        return operand, operand * (g - 1)
    if kind == "reduce-scatter":
        return r * g, r * (g - 1)
    if kind == "all-reduce":
        return r, 2.0 * r * (g - 1) / g
    if kind == "all-to-all":
        return r, r * (g - 1) / g
    return r, r


@dataclass
class Totals:
    """The reference's ``Totals``: per-device flops, HBM bytes and
    collective bytes by kind, plus the peak of live tensor bytes."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_operand_bytes: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLL_KINDS})
    coll_wire_bytes: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLL_KINDS})
    coll_count: int = 0
    peak_bytes: float = 0.0
    #: flops by the op that did them (``repro_torch::*`` kernels apart)
    flops_by_op: Dict[str, float] = field(default_factory=dict)
    bytes_by_op: Dict[str, float] = field(default_factory=dict)

    def add_collective(self, kind: str, result_bytes: float,
                       group: int) -> None:
        operand, wire = collective_bytes(kind, result_bytes, group)
        self.coll_operand_bytes[kind] += operand
        self.coll_wire_bytes[kind] += wire
        self.coll_count += 1

    @property
    def coll_operand_total(self) -> float:
        return sum(self.coll_operand_bytes.values())

    @property
    def coll_wire_total(self) -> float:
        return sum(self.coll_wire_bytes.values())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x: Any) -> Iterable[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


#: the modules of DTensor's sharding propagation: an op dispatched from
#: inside them runs on stand-in tensors, not on rank 0's data
_PROPAGATION = ("tensor/_sharding_prop.py", "tensor/_decompositions.py")


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


def _group_size(args, kwargs) -> int:
    """The group size of a collective: a ``group_size`` int of a
    functional collective, or the size of its process group (by object
    or by name)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if isinstance(a, torch.ScriptObject) and a._type().qualified_name(
                ).endswith("c10d.ProcessGroup"):
            return dist.ProcessGroup.unbox(a).size()
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (RuntimeError, ValueError, KeyError):
                continue
    return 1


class OpCounter(TorchDispatchMode):
    """Counts what rank 0 executes while the mode is on (see the module's
    docstring); :attr:`totals` holds the result. :meth:`track` registers
    tensors that exist before the program (its arguments) with the live
    bytes."""

    def __init__(self):
        super().__init__()
        self.totals = Totals()
        self._live: Dict[int, list] = {}        # storage key -> [bytes, refs]
        self._live_bytes = 0
        from ..kernels import library
        from torch.utils.flop_counter import flop_registry
        library.register_rules()
        self._flops = flop_registry
        self._kernel_bytes = library.BYTES

    # -- live bytes ----------------------------------------------------------
    def track(self, tensors: Iterable[torch.Tensor]) -> int:
        """Register tensors (DTensors by their local shard) as live;
        returns the bytes of storage newly counted."""
        before = self._live_bytes
        for t in tensors:
            t = getattr(t, "_local_tensor", t)
            self._hold(t)
        self.totals.peak_bytes = max(self.totals.peak_bytes,
                                     self._live_bytes)
        return self._live_bytes - before

    def _hold(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [st.nbytes(), 0]
            self._live_bytes += entry[0]
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self._live_bytes -= entry[0]
            del self._live[key]

    # -- dispatch ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func.namespace == "aten" and \
                torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), "CompositeImplicitAutograd"):
            # a composite op reaches the mode whole under inference_mode:
            # count the ops it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        ins = _tensors((args, kwargs))
        out = func(*args, **kwargs)
        outs = _tensors(out)
        name = func.__name__.split(".")[0]
        if _in_propagation():
            return out
        self._count(func, name, args, kwargs, ins, out, outs)
        for t in outs:
            self._hold(t)
        if self._live_bytes > self.totals.peak_bytes:
            self.totals.peak_bytes = self._live_bytes
        return out

    def _count(self, func, name, args, kwargs, ins, out, outs) -> None:
        tot = self.totals
        ns = func.namespace
        packet = func.overloadpacket
        if ns == "repro_torch":
            f = float(self._flops[packet](*args, out_val=out, **kwargs)) \
                if packet in self._flops else 0.0
            b = float(self._kernel_bytes[name](*args))
            tot.flops += f
            tot.hbm_bytes += b
            tot.flops_by_op[str(packet)] = \
                tot.flops_by_op.get(str(packet), 0.0) + f
            tot.bytes_by_op[str(packet)] = \
                tot.bytes_by_op.get(str(packet), 0.0) + b
            return
        if ns in ("c10d", "_c10d_functional", "c10d_functional") \
                and name in _COLL_OPS:
            kind = _COLL_OPS[name]
            g = _group_size(args, kwargs)
            inb = sum(_nbytes(t) for t in ins)
            if ns == "c10d" and kind in ("all-gather", "reduce-scatter",
                                         "all-to-all"):
                inb = sum(_nbytes(t) for t in _tensors(args[1]))
            result = {"all-gather": inb * g,
                      "reduce-scatter": inb / max(g, 1)}.get(kind, inb)
            tot.add_collective(kind, result, g)
            tot.hbm_bytes += inb + result
            return
        if not outs or name in _FREE:
            return
        schema = func._schema
        if all(r.alias_info is not None and not r.alias_info.is_write
               for r in schema.returns):
            return                                   # a view
        if packet in self._flops:
            f = float(self._flops[packet](*args, out_val=out, **kwargs))
            tot.flops += f
            tot.flops_by_op[str(packet)] = \
                tot.flops_by_op.get(str(packet), 0.0) + f
        res = sum(_nbytes(t) for t in outs)
        if name in _WINDOW:
            b = 2 * res
        elif name in _UPDATE:
            b = 2 * min((_nbytes(t) for t in ins if not t.dtype in (
                torch.int64, torch.int32, torch.bool)), default=res)
        else:
            b = sum(_nbytes(t) for t in ins) + res
        tot.hbm_bytes += b
