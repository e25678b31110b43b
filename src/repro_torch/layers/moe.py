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

from .common import (NO_SHARD, ShardCtx, _is_dtensor,
                     dense_init, row_offset, sum_grad_over,
                     sum_partials_over, swish)
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
    y's dtype, the sum in f32, cast once to ``dtype``, y's unless given);
    backward by the inverse map ``slot_asg`` (see the module's header)."""

    @staticmethod
    def forward(ctx, y, gates, rows, slot_asg, dtype=None):
        ctx.save_for_backward(y, gates, rows, slot_asg)
        yk = y[rows] * gates.to(y.dtype)[..., None]     # [n_tok, k, D]
        return yk.sum(dim=1, dtype=torch.float32).to(dtype or y.dtype)

    @staticmethod
    def backward(ctx, g):
        y, gates, rows, slot_asg = ctx.saved_tensors
        g = g.to(y.dtype)
        d = g.shape[-1]
        ga = g[:, None, :] * gates.to(y.dtype)[..., None]   # [n_tok, k, D]
        gapad = torch.cat([ga.reshape(-1, d), ga.new_zeros((1, d))])
        dy = gapad[slot_asg]                                # [E * cap + 1, D]
        dgates = (g[:, None, :] * y[rows]).sum(dim=-1).to(gates.dtype)
        return dy, dgates, None, None, None


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


class _SlotsToOwner(torch.autograd.Function):
    """Over mesh dim ``mesh_dim``: the sum of the ranks' ``x`` (each rank
    its own slots, zeros in the others'), this rank's block of dim
    ``dim`` of it (a reduce-scatter). Backward: the gradient's blocks
    gathered whole (an all-gather), since every rank's slots take their
    gradient from every block."""

    @staticmethod
    def forward(ctx, x, mesh, mesh_dim, dim):
        import torch.distributed._functional_collectives as funcol
        ctx.args = (mesh, mesh_dim, dim)
        return funcol.wait_tensor(funcol.reduce_scatter_tensor(
            x.contiguous(), "sum", dim, (mesh, mesh_dim)))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol
        mesh, mesh_dim, dim = ctx.args
        return funcol.wait_tensor(funcol.all_gather_tensor(
            g.contiguous(), dim, (mesh, mesh_dim))), None, None, None


class _SlotsFromOwner(torch.autograd.Function):
    """The inverse of :class:`_SlotsToOwner`: the ranks' blocks of dim
    ``dim`` gathered whole (an all-gather), of which each rank reads only
    its own slots. Backward: the sum of the ranks' gradients, this rank's
    block of it (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, mesh_dim, dim):
        import torch.distributed._functional_collectives as funcol
        ctx.args = (mesh, mesh_dim, dim)
        return funcol.wait_tensor(funcol.all_gather_tensor(
            x.contiguous(), dim, (mesh, mesh_dim)))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol
        mesh, mesh_dim, dim = ctx.args
        return funcol.wait_tensor(funcol.reduce_scatter_tensor(
            g.contiguous(), "sum", dim, (mesh, mesh_dim))), None, None, None


def _own_rows(rows: torch.Tensor, first: int, n: int) -> torch.Tensor:
    """Rows of the flattened ``[E * cap]`` slots (the drop row ``E *
    cap`` too) as rows of a rank's ``n`` slots from row ``first``, ``n``
    (its zero row) for any other."""
    local = rows - first
    return torch.where((local >= 0) & (local < n), local, n)


def _inverse(rows: torch.Tensor, n: int) -> torch.Tensor:
    """``[n + 1]``: each of ``n`` slot rows' assignment ``token * k +
    choice`` by ``rows [n_tok, k]`` (each slot row taken at most once),
    ``n_tok * k`` for an empty one and for the zero row ``n``; written
    once each, as :meth:`MoE.dispatch` writes it."""
    flat = rows.reshape(-1)
    none = flat.shape[0]
    asg = torch.arange(none, device=flat.device)
    inv = torch.full((n + none,), none, dtype=torch.long,
                     device=flat.device)
    inv[torch.where(flat < n, flat, n + asg)] = asg
    inv = inv[:n + 1]
    inv[n] = none
    return inv


class _SwapBlocks(torch.autograd.Function):
    """Over mesh dim ``mesh_dim`` (``n`` ranks): ``x``'s axis ``axis``
    (``n`` blocks of rows, block ``j`` for rank ``j``) sent by block, so
    that the axis then holds the ``n`` ranks' blocks of this rank's rows
    (an all-to-all). Its own inverse: the backward is the same swap."""

    @staticmethod
    def forward(ctx, x, mesh, mesh_dim, axis):
        ctx.args = (mesh, mesh_dim, axis)
        return _swap(x, mesh, mesh_dim, axis)

    @staticmethod
    def backward(ctx, g):
        return _swap(g, *ctx.args), None, None, None


def _swap(x, mesh, mesh_dim: int, axis: int):
    import torch.distributed._functional_collectives as funcol
    send = x.movedim(axis, 0).contiguous()
    got = funcol.wait_tensor(funcol.all_to_all_single(
        send, None, None, (mesh, mesh_dim)))
    return got.view(send.shape).movedim(0, axis)


class _ExpertsToOwner(torch.autograd.Function):
    """Over mesh dim ``mesh_dim`` (``n`` ranks): ``x [n * e_loc, ...]``,
    every expert's block of dim ``dim``, -> ``[e_loc, ...]``, this
    rank's experts whole along ``dim`` (an all-to-all: expert chunk ``j``
    goes to rank ``j``, the blocks received concatenated in rank order).
    Backward: the inverse all-to-all, each rank's block of the gradient
    of every expert."""

    @staticmethod
    def forward(ctx, x, mesh, mesh_dim, dim):
        ctx.args = (mesh, mesh_dim, dim)
        return _all_to_all(x, mesh, mesh_dim, 0, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, mesh_dim, dim = ctx.args
        return _all_to_all(g, mesh, mesh_dim, dim, 0), None, None, None


def _all_to_all(x, mesh, mesh_dim: int, split: int, cat: int):
    """``x`` in ``n`` chunks along ``split``, chunk ``j`` sent to rank
    ``j`` of mesh dim ``mesh_dim``; the chunks received concatenated
    along ``cat`` in rank order."""
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

    def dispatch(self, experts: torch.Tensor, cap: int = None,
                 offset: torch.Tensor = None,
                 valid: torch.Tensor = None) -> Dispatch:
        """The slot table and each assignment's row for ``experts``
        [n_tok, k]. The assignments, token-major, are sorted stably by
        expert; no host synchronisation (a dropped assignment's write
        goes to a spare entry that is cut off).

        Under a mesh (:meth:`_forward_sharded`) ``n_tok`` is a rank's
        rows of a larger token set: ``cap`` is then that set's capacity,
        ``offset`` [E] the slots of each expert that the rows before this
        rank's took (an assignment's slot is its rank among this rank's
        assignments to its expert plus the expert's offset), and rows
        where ``valid`` [n_tok] is False (padding) take no slot."""
        n_tok, k = experts.shape
        e = self.router.shape[1]
        if cap is None:
            cap = capacity(n_tok, k, e, self.capacity_factor)
        flat = experts.reshape(-1)
        if valid is not None:          # padding sorts last, past expert e-1
            flat = torch.where(valid.repeat_interleave(k), flat, e)
        order = torch.sort(flat, stable=True).indices
        se = flat[order]
        first = torch.searchsorted(se, se, side="left")
        asg = torch.arange(n_tok * k, device=flat.device)
        slot = asg - first
        if offset is not None:
            slot = slot + torch.cat([offset, offset.new_zeros(1)])[se]
        keep = (slot < cap) & (se < e)
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

    @staticmethod
    def expert_counts(experts: torch.Tensor, n_experts: int,
                      valid: torch.Tensor = None) -> torch.Tensor:
        """[E] int64: how many of the rows' assignments chose each expert
        (rows where ``valid`` is False left out). By a sort and a search,
        no atomics."""
        flat = experts.reshape(-1)
        if valid is not None:
            flat = torch.where(valid.repeat_interleave(experts.shape[1]),
                               flat, n_experts)
        bounds = torch.searchsorted(
            torch.sort(flat).values,
            torch.arange(n_experts + 1, device=flat.device), side="left")
        return bounds[1:] - bounds[:-1]

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
        """The layer over a mesh (DTensor x, parameters and result): the
        function of :meth:`forward` on the whole batch, drops included.

        Each rank routes its own tokens (its block of the batch over the
        ``dp`` axes; the router gathered whole). The capacity is the one
        of the batch's ``N`` real tokens (``ctx.rows`` real rows when the
        batch was padded to a multiple of the dp ranks: the padding rows
        take no slot), and each expert's slots are filled in the order of
        the tokens, so of the dp ranks: an assignment's slot is its rank
        among this rank's assignments to its expert plus the count of
        assignments to that expert on the dp ranks before this one (an
        all-gather of every rank's ``[E]`` counts over dp). Each rank's
        ``[e_loc, cap, D]`` buffer of its experts then holds its own
        tokens in their slots and zeros elsewhere, and the dp ranks'
        buffers sum to the no-mesh dispatch's slots of those experts.

        The experts run as the reference's layout has them: over ``tp``
        (``E`` padded to a multiple of tp, as GSPMD pads), and the expert
        weights as FSDP shards them, over ``D`` on the dp axes, never
        gathered there (stored with their ``F`` over tp, when tp does not
        divide ``E``, each rank receives its experts' ``F`` blocks by an
        all-to-all). A reduce-scatter over dp sums the ranks' slots of
        this rank's experts and hands it its block of ``D``; the gate and
        up products are partial sums over dp (all-reduced), and the down
        product gives the rank's block of ``D`` of every slot (its
        gradient reaches the hidden state as a partial sum, all-reduced
        once). The combine runs where the slots are: with every dp rank's
        rows and gates gathered, each rank sums its experts' share of
        every token's output on its block of ``D`` (in f32), all-to-alls
        over dp hand each token's blocks to its rank, and an all-reduce
        over tp sums the experts' shares, cast once. Nothing of the
        ``[E, cap, D]`` size is gathered whole. The aux loss is the
        reference's, of the whole batch: the router probabilities' ``[E]``
        sums all-reduced over dp, the counts from the all-gathered ones."""
        import torch.distributed._functional_collectives as funcol
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
        e = self.router.shape[1]
        n_rows = b if ctx.rows is None else ctx.rows
        valid = None
        if n_rows < b:
            first = row_offset(x.placements, mesh, xl.shape[0])
            valid = (torch.arange(xl.shape[0], device=xf.device) + first
                     < n_rows).repeat_interleave(t)
        # the router's gradient from this rank's tokens: a partial sum over
        # the dp dims (the tp ranks hold the same tokens)
        router = self.router.redistribute(
            mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=[
                Partial() if i in dp_dims else Replicate()
                for i in range(mesh.ndim)])
        r = self.route(xf, router)
        n_real = n_rows * t
        counts = self.expert_counts(r.experts, e, valid)[None]
        for i in reversed(dp_dims):        # [dp, E], dp ranks major first
            counts = funcol.wait_tensor(funcol.all_gather_tensor(
                counts, 0, (mesh, i)))
        before = counts[:row_offset(x.placements, mesh, 1)].sum(dim=0)
        disp = self.dispatch(
            r.experts, capacity(n_real, self.top_k, e, self.capacity_factor),
            before, valid)
        n_tp, t_idx = ctx.tp_block()
        e_loc = -(-e // n_tp)
        own = slice(min(t_idx * e_loc, e), min((t_idx + 1) * e_loc, e))
        n_own, cap = own.stop - own.start, disp.cap
        # this rank's experts see only their slots: their part of the
        # tokens' gradient is summed over tp (the router's part is whole)
        xs = _GatherSlots.apply(sum_grad_over(xf, mesh, tp_dims),
                                disp.slot_tok[own],
                                _own_rows(disp.rows, own.start * cap,
                                          n_own * cap))
        # every dp rank's tokens in their slots, this rank's block of D
        # (major dims first)
        for i in dp_dims:
            xs = _SlotsToOwner.apply(xs, mesh, i, 2)

        # the weights as FSDP lays them out: this rank's experts, its block
        # of D; each gradient whole over its D block (every slot is here)
        # and in the weight's own layout. Experts the tp ranks do not
        # divide are stored with their F split over tp instead: each rank
        # then receives its experts' F blocks (an all-to-all over tp, the
        # experts padded to n_tp * e_loc)
        def local(w, ddim):
            pl = [Shard(ddim) if i in dp_dims else p if i in tp_dims
                  else Replicate() for i, p in enumerate(w.placements)]
            wl = w.redistribute(mesh, pl).to_local(grad_placements=[
                Partial() if i in tp_dims and not isinstance(p, Shard)
                else p for i, p in enumerate(pl)])
            for i in tp_dims:
                if not isinstance(pl[i], Shard):      # whole: slice
                    wl = wl[own]
                elif pl[i].dim != 0:                  # F split: receive
                    if wl.shape[0] < n_tp * e_loc:
                        wl = torch.cat([wl, wl.new_zeros(
                            (n_tp * e_loc - wl.shape[0],) + wl.shape[1:])])
                    wl = _ExpertsToOwner.apply(wl, mesh, i, pl[i].dim)
            return wl[:own.stop - own.start]
        wg, wu, wd = local(self.w_gate, 1), local(self.w_up, 1), \
            local(self.w_down, 2)
        # every dp rank computes h alike from the summed products, and the
        # down product's gradient reaches it as a partial sum over dp:
        # summed once, on h
        h = swish(sum_partials_over(torch.bmm(xs, wg), mesh, dp_dims)) * \
            sum_partials_over(torch.bmm(xs, wu), mesh, dp_dims)
        y = torch.bmm(sum_grad_over(h, mesh, dp_dims), wd)
        # the combine, where the slots are: every dp rank's routing here
        # (the gates' gradient summed back over tp and dp), this rank's
        # experts' share of every token's output on this rank's block of D
        # (in f32), then each token's blocks sent to its dp rank and the
        # experts' shares summed over tp
        rows, gates = disp.rows, sum_grad_over(r.gates, mesh, tp_dims)
        for i in reversed(dp_dims):
            rows = funcol.wait_tensor(funcol.all_gather_tensor(
                rows, 0, (mesh, i)))
            gates = _SlotsFromOwner.apply(gates, mesh, i, 0)
        rows = _own_rows(rows, own.start * cap, n_own * cap)
        part = _CombineRows.apply(
            torch.cat([y.flatten(0, 1), y.new_zeros((1, y.shape[2]))]),
            gates, rows, _inverse(rows, n_own * cap), torch.float32)
        part = part.view([mesh.shape[i] for i in dp_dims]
                         + [xf.shape[0], -1])
        for j, i in enumerate(dp_dims):
            part = _SwapBlocks.apply(part, mesh, i, j)
        part = part.movedim(-2, 0).reshape(xf.shape[0], d)
        out = sum_partials_over(part, mesh, tp_dims).to(xf.dtype).view(
            xl.shape)
        out = DTensor.from_local(out, mesh, x.placements, run_check=False)
        if self.shared is not None:
            out = out + self.shared(x, ctx)
        # the whole batch's aux, on every rank (a partial placement would
        # meet the cross entropy's, whose kind of partial differs between
        # torch versions)
        probs = r.probs if valid is None else r.probs * valid[:, None]
        mean_prob = sum_partials_over(probs.sum(dim=0), mesh,
                                      dp_dims) / n_real
        mean_count = counts.sum(dim=0).float() / n_real
        aux = DTensor.from_local(
            self.aux_loss_weight * e * (mean_prob * mean_count).sum(), mesh,
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
