"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch.

Counterpart of ``repro/layers/moe.py`` (``moe_params`` / ``moe_ffn``),
with its parameter names, shapes and semantics:

    1. f32 router logits -> softmax -> top-k experts per token, the k
       gates normalised to sum to 1; the Switch aux loss
       ``w * E * sum_e f_e * p_e``;
    2. the (token, choice) assignments, token-major, stably sorted by
       expert; an assignment's slot in its expert is its rank minus the
       expert's first rank, and slots at or past the capacity
       ``cap = int(max(1, round(n_tok * k / E * capacity_factor)))``
       (Python's ``round``: half to even) are dropped (the token keeps
       its residual path);
    3. an ``[E, cap]`` slot table of token ids, ``n_tok`` (a zero row)
       where a slot is empty; the tokens gathered to ``[E, cap, D]`` and
       the per-expert SwiGLU as batched matrix products (``torch.bmm``,
       as the reference leaves its einsums to XLA);
    4. the combine, which differs in method from the reference's
       scatter-add but not in result: each token gathers its k
       assignments' expert rows, each times its gate in the activation
       dtype (the reference's rounding point), and sums them over the k
       choices **in f32**, cast once to the activation dtype. No atomics:
       a repeat gives the same bits. (The reference scatter-adds in the
       activation dtype, in an order XLA picks.)

Training: the gather (3.) and the combine (4.) are
``torch.autograd.Function`` classes whose backward passes are gathers by
the inverse maps, not the ``index_put_(accumulate=True)`` that autograd over
indexing runs (atomic on the card, or slow under
``torch.use_deterministic_algorithms``). The dispatch is a permutation
plus drops: each slot holds at most one (token, choice) and each
(token, choice) at most one row, so

    d y[slot]     = g[token] * gate[token, choice] (activation dtype) for
                    the slot's owner, 0 for a slot without one and for the
                    drop row ``E * cap``;
    d gates[t, c] = sum over D of g[t] * y[rows[t, c]] (activation dtype,
                    as autograd rounds the forward's product);
    d xf[t]       = sum over c of d xin[rows[t, c]], in f32 in a fixed
                    order, cast once (0 for a dropped choice).

The router gets its gradient through the normalised top-k gates and the
aux loss, as ``jax.grad`` of the reference does. :func:`gather_plain` and
:func:`combine_plain` are the plain versions: autograd over the indexing.

Shared experts (DeepSeek-MoE) run as a dense SwiGLU of width
``d_ff * n_shared`` on every token and are added after the combine.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import (NO_SHARD, AllGather, ShardCtx, _is_dtensor,
                     dense_init, mean_over, sum_grad_over, sum_over, swish)
from .mlp import SwiGLU


def capacity(n_tok: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert, as the reference computes them: on a Python
    float, so ``round`` takes a tie (x.5) to the even integer."""
    return int(max(1, round(n_tok * top_k / n_experts * capacity_factor)))


class Routing(NamedTuple):
    """The router's choice for ``n_tok`` tokens: ``gates`` [n_tok, k] f32
    (normalised), ``experts`` [n_tok, k] int64 (descending probability)
    and ``probs`` [n_tok, E] f32."""
    gates: torch.Tensor
    experts: torch.Tensor
    probs: torch.Tensor


class Dispatch(NamedTuple):
    """Where the assignments go: ``slot_tok`` [E, cap] int64 token ids
    (``n_tok`` where empty), ``rows`` [n_tok, k] int64, each
    assignment's row of the flattened ``[E * cap]`` expert outputs
    (``E * cap``, a zero row, where it was dropped), and ``slot_asg``
    [E * cap + 1] int64, the inverse of ``rows``: each row's assignment
    ``token * k + choice`` (``n_tok * k`` for an empty slot and for the
    drop row); ``slot_tok == slot_asg[:-1] // k``."""
    slot_tok: torch.Tensor
    rows: torch.Tensor
    cap: int
    slot_asg: torch.Tensor


class _GatherSlots(torch.autograd.Function):
    """``xin = [xf; 0][slot_tok]`` -> [E, cap, D]; backward: each token
    sums its k rows of the gradient in f32 (see the module's header)."""

    @staticmethod
    def forward(ctx, xf, slot_tok, rows):
        e, cap = slot_tok.shape
        ctx.save_for_backward(rows)
        xpad = torch.cat([xf, xf.new_zeros((1, xf.shape[1]))])
        return xpad[slot_tok.reshape(-1)].view(e, cap, -1)

    @staticmethod
    def backward(ctx, g):
        rows, = ctx.saved_tensors
        d = g.shape[-1]
        gpad = torch.cat([g.reshape(-1, d), g.new_zeros((1, d))])
        return (gpad[rows].sum(dim=1, dtype=torch.float32).to(g.dtype),
                None, None)


class _CombineRows(torch.autograd.Function):
    """``out[t] = sum_c y[rows[t, c]] * gates[t, c]`` (each product in
    y's dtype, the sum in f32, cast once); backward by the inverse map
    ``slot_asg`` (see the module's header)."""

    @staticmethod
    def forward(ctx, y, gates, rows, slot_asg):
        ctx.save_for_backward(y, gates, rows, slot_asg)
        yk = y[rows] * gates.to(y.dtype)[..., None]     # [n_tok, k, D]
        return yk.sum(dim=1, dtype=torch.float32).to(y.dtype)

    @staticmethod
    def backward(ctx, g):
        y, gates, rows, slot_asg = ctx.saved_tensors
        g = g.to(y.dtype)
        d = g.shape[-1]
        ga = g[:, None, :] * gates.to(y.dtype)[..., None]   # [n_tok, k, D]
        gapad = torch.cat([ga.reshape(-1, d), ga.new_zeros((1, d))])
        dy = gapad[slot_asg]                                # [E * cap + 1, D]
        dgates = (g[:, None, :] * y[rows]).sum(dim=-1).to(gates.dtype)
        return dy, dgates, None, None


def gather_plain(xf: torch.Tensor, disp: Dispatch) -> torch.Tensor:
    """:meth:`MoE.gather` by plain indexing (autograd's backward)."""
    e, cap = disp.slot_tok.shape
    xpad = torch.cat([xf, xf.new_zeros((1, xf.shape[1]))])
    return xpad[disp.slot_tok.reshape(-1)].view(e, cap, -1)


def combine_plain(y: torch.Tensor, gates: torch.Tensor,
                  disp: Dispatch) -> torch.Tensor:
    """:meth:`MoE.combine` by plain indexing (autograd's backward)."""
    yk = y[disp.rows] * gates.to(y.dtype)[..., None]
    return yk.sum(dim=1, dtype=torch.float32).to(y.dtype)


def expert_products(xin: torch.Tensor, w_gate: torch.Tensor,
                    w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU on its slots: ``xin [E, cap, D]`` and the
    weights ``[E, D, F]`` / ``[E, F, D]`` -> ``[E, cap, D]``."""
    h = swish(torch.bmm(xin, w_gate)) * torch.bmm(xin, w_up)
    return torch.bmm(h, w_down)


class _AllToAll(torch.autograd.Function):
    """Over mesh dim ``mesh_dim`` (``n`` ranks): ``x`` split into ``n``
    blocks along ``split``, block ``j`` sent to rank ``j``, the blocks
    received concatenated along ``cat`` (in rank order). Backward: the
    inverse exchange."""

    @staticmethod
    def forward(ctx, x, mesh, mesh_dim, split, cat):
        ctx.args = (mesh, mesh_dim, split, cat)
        return _all_to_all(x, mesh, mesh_dim, split, cat)

    @staticmethod
    def backward(ctx, g):
        mesh, mesh_dim, split, cat = ctx.args
        return _all_to_all(g, mesh, mesh_dim, cat, split), None, None, \
            None, None


def _all_to_all(x, mesh, mesh_dim: int, split: int, cat: int):
    import torch.distributed._functional_collectives as funcol
    n = mesh.shape[mesh_dim]
    send = torch.stack(x.chunk(n, dim=split)).contiguous()
    got = funcol.wait_tensor(funcol.all_to_all_single(
        send.flatten(0, 1), None, None, (mesh, mesh_dim)))
    return torch.cat(got.view(send.shape).unbind(0), dim=cat)


class MoE(nn.Module):
    """``router [D, E]`` (f32), ``w_gate`` / ``w_up [E, D, F]``,
    ``w_down [E, F, D]`` and, with ``n_shared > 0``, ``shared`` (a
    :class:`SwiGLU` of width ``F * n_shared``), in the reference's
    layout. ``capacity_factor`` is a plain attribute read at each call."""

    def __init__(self, d_model: int, n_experts: int, d_ff: int,
                 n_shared: int, top_k: int, capacity_factor: float,
                 dtype: torch.dtype, gen: torch.Generator,
                 aux_loss_weight: float = 0.01):
        super().__init__()
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.aux_loss_weight = aux_loss_weight
        e = n_experts
        self.router = nn.Parameter(dense_init(gen, (d_model, e),
                                              torch.float32))
        self.w_gate = nn.Parameter(dense_init(gen, (e, d_model, d_ff),
                                              dtype))
        self.w_up = nn.Parameter(dense_init(gen, (e, d_model, d_ff), dtype))
        self.w_down = nn.Parameter(dense_init(gen, (e, d_ff, d_model),
                                              dtype))
        self.shared = SwiGLU(d_model, d_ff * n_shared, dtype, gen) \
            if n_shared > 0 else None

    def route(self, xf: torch.Tensor, router=None) -> Routing:
        """Route the rows of ``xf`` [n_tok, D]: f32 logits, softmax, top-k
        and the gates normalised over the k choices. ``router`` stands in
        for ``self.router`` (a rank's local copy of it on a mesh)."""
        router = self.router if router is None else router
        probs = torch.softmax(xf.float() @ router, dim=-1)
        gates, experts = torch.topk(probs, self.top_k, dim=-1)
        return Routing(gates / gates.sum(dim=-1, keepdim=True), experts,
                       probs)

    def dispatch(self, experts: torch.Tensor) -> Dispatch:
        """The slot table and each assignment's row for ``experts``
        [n_tok, k]. The assignments, token-major, are sorted stably by
        expert; no host synchronisation (a dropped assignment's write
        goes to a spare entry that is cut off)."""
        n_tok, k = experts.shape
        e = self.router.shape[1]
        cap = capacity(n_tok, k, e, self.capacity_factor)
        flat = experts.reshape(-1)
        order = torch.sort(flat, stable=True).indices
        se = flat[order]
        first = torch.searchsorted(se, se, side="left")
        asg = torch.arange(n_tok * k, device=flat.device)
        slot = asg - first
        keep = slot < cap
        dest = torch.where(keep, se * cap + slot, e * cap)
        # a dropped assignment's write goes to a spare entry of its own, so
        # every index is written once (the deterministic index_put_ walks
        # a run of equal indices serially)
        none = n_tok * k
        slot_asg = torch.full((e * cap + none,), none, dtype=torch.long,
                              device=flat.device)
        slot_asg[torch.where(keep, dest, e * cap + asg)] = order
        slot_asg = slot_asg[:e * cap + 1]
        slot_asg[e * cap] = none            # the drop row
        rows = torch.empty_like(dest)
        rows[order] = dest                  # order is a permutation
        return Dispatch((slot_asg[:e * cap] // k).view(e, cap),
                        rows.view(n_tok, k), cap, slot_asg)

    def aux_loss(self, r: Routing) -> torch.Tensor:
        """Switch load balance: ``w * E * sum_e mean_prob_e *
        mean_count_e`` with the count of each expert among a token's k
        choices."""
        e = r.probs.shape[1]
        counts = F.one_hot(r.experts, e).sum(dim=1).float().mean(dim=0)
        return self.aux_loss_weight * e * (r.probs.mean(dim=0)
                                           * counts).sum()

    def gather(self, xf: torch.Tensor, disp: Dispatch) -> torch.Tensor:
        """The expert inputs ``[E, cap, D]``: the rows of ``xf``
        [n_tok, D] by the slot table, zeros in empty slots. Its backward
        is a gather by ``rows`` (no atomics)."""
        return _GatherSlots.apply(xf, disp.slot_tok, disp.rows)

    def expert_ffn(self, xin: torch.Tensor) -> torch.Tensor:
        """Each expert's SwiGLU on its ``[cap, D]`` slots, as batched
        products -> ``[E * cap + 1, D]``, the last row zero (a dropped
        assignment's)."""
        y = expert_products(xin, self.w_gate, self.w_up, self.w_down)
        return torch.cat([y.flatten(0, 1), y.new_zeros((1, y.shape[2]))])

    def combine(self, y: torch.Tensor, gates: torch.Tensor,
                disp: Dispatch) -> torch.Tensor:
        """``[n_tok, D]``: each token's k expert rows of ``y``, each times
        its gate in y's dtype, summed over the k choices in f32 and cast
        once to y's dtype. Deterministic, forward and backward (gathers
        and reductions, no atomics)."""
        return _CombineRows.apply(y, gates, disp.rows, disp.slot_asg)

    def forward(self, x: torch.Tensor, ctx: ShardCtx = NO_SHARD
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, T, D] -> (out [B, T, D] in x's dtype, aux f32 scalar)."""
        if ctx.mesh is not None and _is_dtensor(x):
            return self._forward_sharded(x, ctx)
        b, t, d = x.shape
        xf = x.reshape(b * t, d)
        r = self.route(xf)
        disp = self.dispatch(r.experts)
        y = self.expert_ffn(self.gather(xf, disp))
        out = self.combine(y, r.gates, disp).view(b, t, d)
        if self.shared is not None:
            out = out + self.shared(x)
        return out, self.aux_loss(r)

    def _forward_sharded(self, x: torch.Tensor, ctx: ShardCtx
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The layer over a mesh (DTensor x, parameters and result).

        Each rank routes and dispatches its own tokens (its block of the
        batch over the ``dp`` axes; the router gathered whole), so the
        capacity is the local token count's, as in GShard's local
        dispatch (the reference sorts the global token set under GSPMD).
        The experts then run as the reference's layout has them: the
        slots ``[E, cap, D]`` with their experts over ``tp`` (``E``
        padded to a multiple of tp, as GSPMD pads), every dp rank's
        slots on each rank, and the expert weights as FSDP shards them,
        over ``D`` on the dp axes, never gathered: all-to-alls over dp
        hand each rank its block of ``D`` of every dp rank's slots, the
        gate and up products are partial sums over dp (all-reduced), the
        down product gives the rank's block of ``D``, and the inverse
        all-to-alls bring each rank its own slots whole. The experts'
        outputs come back over tp for a local combine. The aux loss is
        the mean over the ``dp`` ranks of each one's local loss."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        mesh = ctx.mesh
        b, t, d = x.shape
        x = ctx.shard(x, ctx.dp, None, None)
        dp_dims = [i for i, p in enumerate(x.placements)
                   if isinstance(p, Shard)]
        tp_dims = list(ctx.tp_dims())
        xl = x.to_local()
        xf = xl.reshape(-1, d)
        # the router's gradient from this rank's tokens: a partial sum over
        # the dp dims (the tp ranks hold the same tokens)
        router = self.router.redistribute(
            mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=[
                Partial() if i in dp_dims else Replicate()
                for i in range(mesh.ndim)])
        r = self.route(xf, router)
        disp = self.dispatch(r.experts)
        e = disp.slot_tok.shape[0]
        n_tp, t_idx = ctx.tp_block()
        e_loc = -(-e // n_tp)
        own = slice(min(t_idx * e_loc, e), min((t_idx + 1) * e_loc, e))
        # this rank's experts see only their slots: their part of the
        # tokens' gradient is summed over tp (the router's part is whole)
        xs = self.gather(sum_grad_over(xf, mesh, tp_dims), disp)[own]
        # every dp rank's slots, this rank's block of D (major dims first)
        for i in dp_dims:
            xs = _AllToAll.apply(xs, mesh, i, 2, 1)

        # the weights as FSDP lays them out: this rank's experts, its block
        # of D; each gradient whole over its D block (every dp rank's
        # slots are here), a partial sum over tp (its own experts)
        def local(w, ddim):
            pl = [Shard(ddim) if i in dp_dims else Replicate()
                  for i in range(mesh.ndim)]
            return w.redistribute(mesh, pl).to_local(grad_placements=[
                p if i in dp_dims else Partial()
                for i, p in enumerate(pl)])[own]
        wg, wu, wd = local(self.w_gate, 1), local(self.w_up, 1), \
            local(self.w_down, 2)
        h = swish(sum_over(torch.bmm(xs, wg), mesh, dp_dims)) * \
            sum_over(torch.bmm(xs, wu), mesh, dp_dims)
        y = torch.bmm(h, wd)
        for i in reversed(dp_dims):            # this rank's slots, whole
            y = _AllToAll.apply(y, mesh, i, 1, 2)
        if y.shape[0] < e_loc:
            y = torch.cat([y, y.new_zeros((e_loc - y.shape[0],)
                                          + y.shape[1:])])
        for i in reversed(tp_dims):
            y = AllGather.apply(y, 0, mesh, i)
        y = torch.cat([y[:e].flatten(0, 1), y.new_zeros((1, d))])
        out = self.combine(y, r.gates, disp).view(xl.shape)
        out = DTensor.from_local(out, mesh, x.placements, run_check=False)
        if self.shared is not None:
            out = out + self.shared(x, ctx)
        # the mean over the dp ranks, whole on every rank (a partial
        # placement would meet the cross entropy's, whose kind of partial
        # differs between torch versions)
        aux = DTensor.from_local(
            mean_over(self.aux_loss(r), mesh, dp_dims), mesh,
            [Replicate()] * mesh.ndim, run_check=False)
        return ctx.shard(out, ctx.dp, None, None), aux


@contextlib.contextmanager
def no_drops(model: nn.Module) -> Iterator[nn.Module]:
    """``model`` with ``capacity_factor = E / k`` in every :class:`MoE`
    layer while the context is open, the config's factor again after it:
    the capacity is then ``n_tok``, so no assignment drops and a decode
    step routes each token as a prefill of the same tokens does."""
    moes = [m for m in model.modules() if isinstance(m, MoE)]
    old = [m.capacity_factor for m in moes]
    for m in moes:
        m.capacity_factor = m.router.shape[1] / m.top_k
    try:
        yield model
    finally:
        for m, cf in zip(moes, old):
            m.capacity_factor = cf
