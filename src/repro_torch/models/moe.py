"""Mixture-of-Experts FFN of the moe family (llama4-scout, kimi-k2).
Counterpart of ``repro/models/moe.py``.

Placement. Whole experts (tp = 1): every expert is on one device. Split
over 'model' (``distributed/tensor_parallel.py``: ``wi``/``wg``/``wo`` as
``Shards`` of E / tp experts, rank r's from ``e0 = r E / tp``): the
reference's ``_local_moe`` and ``_gathered_moe``. The routing runs once,
on the first device, over every expert, so the top-k, capacity and drops
are tp = 1's: the reference routes on each rank over its own experts,
and a stable sort of the local expert ids keeps each expert's pairs in
the same order, so its keep decisions are the same. Each rank gathers
its experts' slots of the buffer and its contributions, and the ranks'
partial outputs go through ``tensor_parallel.reduce_sum``. Under the
reference's ``shard_map`` the tokens enter ``P(('pod', 'data'))``: on a
mesh with n dp shards each shard of the batch routes on its own
(``moe_ffn``'s ``dp``: its own capacity, the aux loss the shards' mean).

The reference's numerics, step by step:

* the router product in float32 (``router`` is float32 whatever the
  parameters' dtype), softmax, top-k, ``gate / max(sum, 1e-9)``;
* the Switch aux loss ``E * sum(mean(probs) * counts / (T k))``, the
  counts integers made float32 (bitwise the reference's ``+1.0`` scatter
  below 2^24 pairs);
* sort-compact dispatch: a stable argsort of the pairs' expert ids, each
  expert's pairs at positions ``pos`` past its start, kept while ``pos <
  cap``, written to slot ``eid * cap + pos`` of an (E, cap, D) buffer; the
  capacity in Python float arithmetic with Python's (banker's) ``round``:
  ``max(1, round(T k / E * cf))`` in prefill and training,
  ``min(max(1, round(T k / E * cf * 4)), T k)`` in decode;
* the experts' SwiGLU as batched products in the activation dtype;
* the combine: each kept pair's output times ``(gate * keep)`` cast to
  the activation dtype, summed per token in the activation dtype.

Determinism. Routing is bitwise the reference's (``top_k``'s ``ids``;
``route``'s ``order``, ``slot``, ``keep``): top-k is a stable descending
sort, so a tie goes to the lower expert index as ``lax.top_k`` gives it;
``argsort`` is stable; ``searchsorted`` takes the left side. No step accumulates
through float atomics, on the card or off it. Every data movement between
token order and slot order is ``gather_rows``, an autograd Function whose
forward and backward are both gathers: the dispatch's backward sums each
token's k slot gradients in pair order, the combine's backward reads each
slot's one contributor. A token's k contributions are added left to right
in sorted-position order, the order in which the reference's scatter adds
them. So a replayed step is bitwise the first.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import layers as L


# ------------------------------------------------------------ parameters
def leaf_shapes(d_model: int, m: MoEConfig) -> Dict[str, object]:
    """{name: shape} of one layer's moe leaves, the reference's tree:
    ``router`` (d, E), ``wi``/``wg`` (E, d, F), ``wo`` (E, F, d) and, with
    shared experts, ``shared`` {``wi``/``wg`` (d, f), ``wo`` (f, d)},
    f = d_shared * num_shared_experts."""
    e, f = m.num_experts, m.d_expert
    out: Dict[str, object] = {"router": (d_model, e),
                              "wi": (e, d_model, f), "wg": (e, d_model, f),
                              "wo": (e, f, d_model)}
    if m.num_shared_experts:
        fs = m.d_shared * m.num_shared_experts
        out["shared"] = {"wi": (d_model, fs), "wg": (d_model, fs),
                         "wo": (fs, d_model)}
    return out


def init_scale(d_model: int, m: MoEConfig, path: Tuple[str, ...]) -> float:
    """The reference's init scale of the moe leaf at ``path`` (names
    below ``moe``): router 0.02, ``wi``/``wg`` 1/sqrt(d), ``wo``
    1/sqrt(d_expert), and 1/sqrt(d) for all three shared leaves, ``wo``
    included."""
    if path == ("router",):
        return 0.02
    if path == ("wo",):
        return 1.0 / math.sqrt(m.d_expert)
    return 1.0 / math.sqrt(d_model)


# ------------------------------------------------------------ data moves
class _GatherRows(torch.autograd.Function):
    """out[n] = src[idx[n]] (zero where idx[n] < 0); the gradient
    grad_src[r] = sum over j, in column order, of grad_out[inv[r, j]]
    (zero terms where inv[r, j] < 0). ``inv`` must list every n with
    idx[n] == r exactly once: then the backward is the exact adjoint,
    made of gathers and fixed-order adds."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return _take(src, idx)

    @staticmethod
    def backward(ctx, grad):
        inv, = ctx.saved_tensors
        picked = _take(grad, inv.reshape(-1)).reshape(
            inv.shape + grad.shape[1:])
        out = picked[:, 0]
        for j in range(1, inv.shape[1]):
            out = out + picked[:, j]
        return out, None, None


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src's rows at idx (N,), zero rows where idx < 0."""
    out = src.index_select(0, idx.clamp(min=0))
    return out.masked_fill_((idx < 0).reshape((-1,) + (1,) * (src.ndim - 1)),
                            0)


def gather_rows(src: torch.Tensor, idx: torch.Tensor,
                inv: torch.Tensor) -> torch.Tensor:
    """Rows ``src[idx]`` (zero rows where idx < 0), differentiable with
    the gather backward of ``_GatherRows``; idx (N,), inv (src rows, J)."""
    return _GatherRows.apply(src, idx, inv)


# ---------------------------------------------------------------- routing
class Routing(NamedTuple):
    """One call's routing. Reference-named (sorted-pair order, T k
    entries): ``order`` the stable argsort of the flat expert ids,
    ``slot`` each sorted pair's buffer row (E cap when dropped), ``keep``;
    ``cap`` the buffer rows an expert. The port's
    gather maps, -1 for none: ``slot_tok`` (E cap,) the token filling each
    buffer row; ``pair_slot`` (T, k) each pair's buffer row; ranked order
    (token t's r-th pair in sorted-position order at t k + r):
    ``rank_pair`` (T k,) its flat pair t k + j, ``pair_rank`` (T k, 1) the
    inverse, ``rank_slot`` (T k,) its buffer row, ``slot_rank`` (E cap, 1)
    the inverse; ``counts`` (E,) the pairs routed to each expert, kept or
    dropped (the differences of the left ``searchsorted`` starts: the
    integers ``bincount`` gives, with no extra op on the card and a meta
    kernel)."""
    order: torch.Tensor
    slot: torch.Tensor
    keep: torch.Tensor
    cap: int
    slot_tok: torch.Tensor
    pair_slot: torch.Tensor
    rank_pair: torch.Tensor
    pair_rank: torch.Tensor
    rank_slot: torch.Tensor
    slot_rank: torch.Tensor
    counts: torch.Tensor


def prefill_capacity(tokens: int, m: MoEConfig) -> int:
    """``max(1, round(T k / E * cf))``, the reference's float order."""
    return int(max(1, round(tokens * m.top_k / m.num_experts
                            * m.capacity_factor)))


def decode_capacity(tokens: int, m: MoEConfig) -> int:
    """``min(max(1, round(T k / E * cf * 4)), T k)``."""
    return int(min(max(1, round(tokens * m.top_k / m.num_experts
                                * m.capacity_factor * 4)),
                   tokens * m.top_k))


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest probabilities per row, largest
    first and the lower index first on ties (``lax.top_k``'s order): a
    stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def route(ids: torch.Tensor, num_experts: int, cap: int) -> Routing:
    """The sort-compact routing of the pairs ``ids`` (T, k) into
    ``num_experts`` buffers of ``cap`` rows, integers only, over every
    expert (a rank's experts take their rows of the maps,
    ``_expert_block``)."""
    t, k = ids.shape
    e = num_experts
    dev = ids.device
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    sorted_eid = flat[order]
    sorted_tok = order // k
    ar = torch.arange(t * k, device=dev)
    starts = torch.searchsorted(sorted_eid, torch.arange(e + 1, device=dev),
                                right=False)
    pos = ar - starts[sorted_eid]
    keep = pos < cap
    slot = torch.where(keep, sorted_eid * cap + pos,
                       torch.full_like(pos, e * cap))
    none = torch.full_like(ar, -1)
    inv = torch.argsort(order)                  # flat pair -> sorted pos
    pair_slot = torch.where(keep[inv], slot[inv], none).reshape(t, k)
    # a token's pairs in sorted-position order: their positions ascend
    tok_pos = torch.sort(inv.reshape(t, k), dim=1).values.reshape(-1)
    rank_pair = order[tok_pos]
    pair_rank = torch.argsort(rank_pair)[:, None]
    rank_slot = torch.where(keep[tok_pos], slot[tok_pos], none)
    rank_of_pos = torch.argsort(tok_pos)        # sorted pos -> rank
    # buffer row (eid, p) holds sorted pair starts[eid] + p while p <
    # min(count, cap)
    src = starts[:e, None] + torch.arange(cap, device=dev)[None]
    filled = src < torch.minimum(starts[1:, None], starts[:e, None] + cap)
    src = src.clamp(max=t * k - 1)
    slot_tok = torch.where(filled, sorted_tok[src], -1).reshape(-1)
    slot_rank = torch.where(filled, rank_of_pos[src], -1).reshape(-1, 1)
    return Routing(order, slot, keep, cap, slot_tok, pair_slot,
                   rank_pair, pair_rank, rank_slot, slot_rank,
                   starts[1:] - starts[:-1])


def _router(xf: torch.Tensor, router_w: torch.Tensor, k: int):
    logits = xf.float() @ router_w                                # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, ids = top_k(probs, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, ids


def _expert_block(xf, g_rank, r: Routing, wi, wg, wo, k: int, e0: int
                  ) -> torch.Tensor:
    """The output (T, D) in xf's dtype of the experts ``e0..e0 + len(wi)``
    (on wi's device, as xf and g_rank are): their rows of the buffer,
    their products, and each token's contributions from them, k in
    sorted-position order (zero where another block holds the pair)."""
    t, d = xf.shape
    el, cap, dt = wi.shape[0], r.cap, xf.dtype
    lo, hi = e0 * cap, (e0 + el) * cap
    if lo == 0 and hi == r.slot_tok.shape[0]:
        slot_tok, pair_slot = r.slot_tok, r.pair_slot
        rank_slot, slot_rank = r.rank_slot, r.slot_rank
    else:
        def local(idx):
            return torch.where((idx >= lo) & (idx < hi), idx - lo,
                               -1).to(xf.device)
        slot_tok, pair_slot = r.slot_tok[lo:hi].to(xf.device), local(
            r.pair_slot)
        rank_slot, slot_rank = local(r.rank_slot), r.slot_rank[lo:hi].to(
            xf.device)
    xbuf = gather_rows(xf, slot_tok, pair_slot).reshape(el, cap, d)
    h = torch.bmm(xbuf, wi.to(dt))
    g = torch.bmm(xbuf, wg.to(dt))
    obuf = torch.bmm(F.silu(g) * h, wo.to(dt)).reshape(el * cap, d)
    # each token's k contributions in sorted-position order
    contrib = gather_rows(obuf, rank_slot, slot_rank)
    kept = (rank_slot >= 0)[:, None]
    contrib = contrib * (g_rank * kept).to(dt)
    contrib = contrib.reshape(t, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def _experts(xf: torch.Tensor, gate: torch.Tensor, r: Routing, params,
             m: MoEConfig) -> torch.Tensor:
    """The routed experts' output (T, D) in xf's dtype: one block, or
    each rank's experts' block on its device, ``reduce_sum``'d onto xf's
    device."""
    g_rank = gather_rows(gate.reshape(-1, 1), r.rank_pair, r.pair_rank)
    wi, wg, wo = params["wi"], params["wg"], params["wo"]
    if not isinstance(wi, TP.Shards):
        return _expert_block(xf, g_rank, r, wi, wg, wo, m.top_k, 0)
    parts = TP.map_ranks(
        lambda j, xr, gr, rank, a, b, c: _expert_block(
            xr, gr, r, a, b, c, m.top_k, rank * a.shape[0]),
        TP.broadcast(xf, wi), TP.broadcast(g_rank, wi), wi.ranks, wi, wg, wo)
    return TP.reduce_sum(parts, xf.device, wi.tp)


def moe_ffn(x: torch.Tensor, params, m: MoEConfig, *, dp: int = 1
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed-experts FFN of the prefill and training paths (the
    reference's ``_local_moe``). x (B, S, D). Returns (y (B, S, D) in x's
    dtype, the float32 aux loss). Shared experts are applied outside
    (``shared_ffn``). With ``dp`` > 1 (the dp shards of the reference's
    ``shard_map``) the batch splits into ``dp`` contiguous row blocks,
    each routed on its own with its own capacity; y is their outputs in
    block order, aux the float32 mean of theirs (summed in block order,
    ``lax.pmean``). Raises where the rows do not divide ``dp``."""
    b, s, d = x.shape
    if dp > 1:
        if b % dp:
            raise ValueError(f"a batch of {b} rows does not split over "
                             f"{dp} dp shards")
        outs = [moe_ffn(blk, params, m) for blk in x.split(b // dp)]
        aux = outs[0][1]
        for _, a in outs[1:]:
            aux = aux + a
        return torch.cat([y for y, _ in outs]), aux / dp
    t, e, k = b * s, m.num_experts, m.top_k
    xf = x.reshape(t, d)
    probs, gate, ids = _router(xf, params["router"], k)
    r = route(ids, e, prefill_capacity(t, m))
    me = probs.mean(0)
    ce = r.counts.float() / (t * k)
    aux = e * torch.sum(me * ce)
    return _experts(xf, gate, r, params, m).reshape(b, s, d), aux


def moe_ffn_decode(x: torch.Tensor, params, m: MoEConfig) -> torch.Tensor:
    """The decode path's routed experts (the reference's
    ``_gathered_moe``, experts over 'model' when split): x (B, S, D), the
    decode capacity, no aux. The reference's placement on a serving mesh
    with dp > 1 (each expert's hidden dim over dp, the tokens replicated)
    changes no value: its routing reads the whole batch, as here."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    _, gate, ids = _router(xf, params["router"], m.top_k)
    r = route(ids, m.num_experts, decode_capacity(b * s, m))
    return _experts(xf, gate, r, params, m).reshape(b, s, d)


def shared_ffn(x: torch.Tensor, params) -> torch.Tensor:
    """The shared experts' SwiGLU, dense compute (a tensor-parallel MLP
    when split over 'model')."""
    sp = params["shared"]
    if isinstance(sp["wi"], TP.Shards):
        return TP.run_ranks(L.swiglu, x, sp["wi"], sp["wg"], sp["wo"])
    return L.swiglu(x, sp["wi"], sp["wg"], sp["wo"])
