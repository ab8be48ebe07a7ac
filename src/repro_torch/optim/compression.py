"""Int8 error-feedback gradient compression over the data-parallel ranks.
Counterpart of ``repro/optim/compression.py``, operation for operation.

The reference runs inside a ``shard_map`` manual over ('pod', 'data'):
each rank holds its own vector and the hops are ``lax.ppermute``s. The
port's mesh is single-process (``launch/mesh.py``), so a per-rank value
is a list with one tensor per rank, rank r's on rank r's device (ranks
pod-major, as ``distributed/sharding.shard_plan`` orders them), and a hop
is ``.to(device of the receiving rank)``. Nothing leaves the devices: a
scale stays a 0-d device tensor and no value is read on the host.

* ``ring_allreduce_int8``: the mean over one axis of n ranks on int8
  messages: an n - 1 hop reduce-scatter that requantizes the whole
  partial at every hop, a division by n, then an all-gather that
  quantizes each owned chunk once.
* ``compressed_mean``: the ring over 'data' inside each pod, then an int8
  partner exchange over 'pod' (two pods only, as the reference asserts).
* ``sync_grads``: each rank's gradient tree flattened in the reference's
  leaf order (``adamw.tree_leaves``: dict keys sorted, each leaf row-major),
  its error row added, every leaf fake-quantized with its own scale (the
  exact error-feedback boundary), the residual kept as the new bf16 error
  row, the compressed mean, and the tree rebuilt in each leaf's dtype.

Dequantize-and-add is two operations (``q.float() * s``, then ``+``), as
the reference's source writes it and as the card runs it. XLA's CPU
fusion contracts the reduce-scatter's and the partner exchange's into one
fused multiply-add, so on the CPU the port's ring is within 2 ulps of the
reference's there, not bitwise (``tests/test_torch_compression.py``).
With two pods the ranks' results are equal inside a pod only: each pod
keeps its own exact mean and adds the other's quantized one.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.optim import adamw


def _recip(n: float) -> float:
    """float32(1 / n), exactly representable as the Python float."""
    return float(np.float32(1.0 / n))


def _quant(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 q, float32 0-d scale) with ``q * scale`` ~ x: the scale is
    ``amax|x| / 127 + 1e-30``, q = round(x / scale) half to even, clipped
    to [-127, 127]. The division by 127 is a product with float32(1 /
    127): XLA rewrites a division by a constant so, and the reference's
    scale is what XLA computes."""
    scale = torch.amax(torch.abs(x)) * _recip(127.0) + 1e-30
    t = x / scale
    return t.round_().clamp_(-127, 127).to(torch.int8), scale


def _deq(q: torch.Tensor, s: torch.Tensor, out=None) -> torch.Tensor:
    """q * s in float32 (into ``out`` when given), without a temporary."""
    if out is None:
        return q.to(torch.float32).mul_(s)
    return out.copy_(q).mul_(s)


def ring_allreduce_int8(xs: Sequence[torch.Tensor],
                        n: int) -> List[torch.Tensor]:
    """The mean of the n ranks' flat float32 vectors ``xs`` on int8
    messages, every rank's result (all equal) on its own device. With
    n == 1 the input is returned. The ring consumes its inputs: the
    all-gather writes each rank's result into its padded working vector,
    a fresh pad, or the input itself where it is already a multiple of
    n long (so a caller that pads its vectors needs no second buffer)."""
    if len(xs) != n:
        raise ValueError(f"{len(xs)} vectors for a ring of {n} ranks")
    if n == 1:
        return list(xs)
    length = xs[0].shape[0]
    k = -(-length // n)
    devs = [x.device for x in xs]
    xp = [(x if x.shape[0] == n * k
           else torch.nn.functional.pad(x, (0, n * k - length))).view(n, k)
          for x in xs]

    # reduce-scatter: after n - 1 hops rank r owns chunk (r + 1) % n
    part = [xp[r][r] for r in range(n)]
    for t in range(n - 1):
        sent = [_quant(p) for p in part]
        part = []
        for r in range(n):
            q, s = sent[(r - 1) % n]
            part.append(_deq(q.to(devs[r]), s.to(devs[r])).add_(
                xp[r][(r - t - 1) % n]))
    del sent
    # XLA's `/ n`, as in _quant; in place: the partials are the ring's own
    owned = [p.mul_(_recip(n)) for p in part]
    del part

    # all-gather: circulate each owned chunk, quantized once, into the
    # working vectors, which the reduce-scatter has finished reading
    msgs = [_quant(o) for o in owned]
    del owned
    for r in range(n):
        _deq(*msgs[r], out=xp[r][(r + 1) % n])
    for t in range(1, n):
        msgs = [tuple(m.to(devs[r]) for m in msgs[(r - 1) % n])
                for r in range(n)]
        for r in range(n):
            _deq(*msgs[r], out=xp[r][((r - t) % n + 1) % n])
    return [x.view(-1)[:length] for x in xp]


def compressed_mean(xs: Sequence[torch.Tensor], dp_axes: Tuple[str, ...],
                    dp_sizes: Tuple[int, ...]) -> List[torch.Tensor]:
    """The hierarchical compressed mean over ('pod', 'data') or ('data',)
    of the ranks' vectors ``xs`` (pod-major): the ring over 'data' inside
    each pod (which consumes its inputs), then the int8 partner exchange
    over 'pod'."""
    sizes = dict(zip(dp_axes, dp_sizes))
    npod, ndata = sizes.get("pod", 1), sizes.get("data", 1)
    if len(xs) != npod * ndata:
        raise ValueError(f"{len(xs)} vectors for dp axes {sizes}")
    xs = list(xs)
    if "data" in sizes:
        xs = [y for p in range(npod)
              for y in ring_allreduce_int8(xs[p * ndata:(p + 1) * ndata],
                                           ndata)]
    if npod > 1:
        if npod != 2:
            raise NotImplementedError(
                f"the int8 partner exchange over 'pod' takes 2 pods, not "
                f"{npod}: the reference's own limit (ROADMAP C)")
        sent = [_quant(x) for x in xs]
        out = []
        for r, x in enumerate(xs):
            q, s = sent[(r + ndata) % len(xs)]
            out.append((x + _deq(q.to(x.device), s.to(x.device))) / 2.0)
        xs = out
    return xs


def local_quantize(grads: Any, err: Optional[torch.Tensor], *,
                   length: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One rank's half of ``sync_grads`` before the ring: (the flat
    float32 vector of its fake-quantized leaves, the new bf16 error row),
    the leaves in ``adamw.tree_leaves`` order with ``err`` (a flat bf16
    row, or None: no error feedback and no new row) added. ``length``
    pads the vector with zeros (the ring pads so; a padded vector enters
    it without a copy)."""
    leaves = adamw.tree_leaves(grads)
    n = sum(leaf.numel() for leaf in leaves)
    dev = leaves[0].device
    flat = torch.empty(max(n, length or 0), dtype=torch.float32,
                       device=dev)
    flat[n:].zero_()
    new_err = (None if err is None
               else torch.empty(n, dtype=torch.bfloat16, device=dev))
    off = 0
    for leaf in leaves:
        sz = leaf.numel()
        seg = leaf.reshape(-1).to(torch.float32)
        if err is not None:
            seg = seg + err[off:off + sz].to(torch.float32)
        deq = _deq(*_quant(seg))
        flat[off:off + sz] = deq
        if err is not None:
            new_err[off:off + sz] = (seg - deq).to(torch.bfloat16)
        off += sz
    return flat, new_err


def unflatten(vec: torch.Tensor, like: Any) -> Any:
    """``like``'s tree (tensors, meta tensors included, giving each
    leaf's shape and dtype) filled from the flat ``vec`` in
    ``adamw.tree_leaves`` order: each leaf a view of ``vec`` where its
    dtype is float32, a cast copy otherwise."""
    off = 0

    def fill(leaf):
        nonlocal off
        sz = leaf.numel()
        out = vec[off:off + sz].view(leaf.shape).to(leaf.dtype)
        off += sz
        return out

    def walk(node):
        if isinstance(node, dict):
            done = {k: walk(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        return fill(node)

    return walk(like)


def sync_grads(grads_per_rank: Sequence[Any],
               err_rows: Optional[Sequence[torch.Tensor]],
               dp_axes: Tuple[str, ...], dp_sizes: Tuple[int, ...]):
    """(each rank's synced gradient tree, each rank's new bf16 error row)
    for the ranks' gradient trees (pod-major, each on its rank's device)
    and error rows (None: no error feedback, new rows None). The synced
    trees are equal on every rank."""
    if err_rows is None:
        err_rows = [None] * len(grads_per_rank)
    # padded for the ring over 'data', which then works in place
    ndata = dict(zip(dp_axes, dp_sizes)).get("data", 1)
    total = sum(leaf.numel()
                for leaf in adamw.tree_leaves(grads_per_rank[0]))
    length = ndata * -(-total // ndata)
    parts = [local_quantize(g, e, length=length)
             for g, e in zip(grads_per_rank, err_rows, strict=True)]
    synced = compressed_mean([f for f, _ in parts], dp_axes, dp_sizes)
    new_err = [e for _, e in parts]
    return ([unflatten(v, g) for v, g in zip(synced, grads_per_rank)],
            None if new_err[0] is None else new_err)


def init_error_buffer(params: Any, dp_total: int = 1,
                      devices: Optional[Sequence] = None
                      ) -> List[torch.Tensor]:
    """The reference's (dp_total, n) bf16 error buffer as rows: one zero
    row of the parameter count n per dp rank, rank r's on ``devices[r]``
    (default: the parameters' device)."""
    leaves = adamw.tree_leaves(params)
    n = sum(leaf.numel() for leaf in leaves)
    devices = [leaves[0].device] * dp_total if devices is None else devices
    if len(devices) != dp_total:
        raise ValueError(f"{len(devices)} devices for {dp_total} dp ranks")
    return [torch.zeros(n, dtype=torch.bfloat16, device=d) for d in devices]
