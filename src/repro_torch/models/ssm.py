"""Mamba-2's SSD (state-space duality, arXiv:2405.21060) of the ssm and
hybrid families (mamba2, hymba). Counterpart of ``repro/models/ssm.py``,
cast for cast.

The projections are split as in the reference (``z``, ``x``, ``B``/``C``
and ``dt``, each its own product; the depthwise causal conv split into a
d_inner part and the small B/C part). The chunked SSD: an intra-chunk
"attention-like" product, each chunk's final state, and the inter-chunk
recurrence, a Python loop over the chunks in ``lax.scan``'s order. Decode
keeps the conv tails (the last ``conv_width - 1`` raw projections, in the
activation dtype) and the float32 state: O(1) a token.

Numerics, the reference's: the projections, the conv, ``Y`` and the
output projection in the activation dtype; ``softplus`` as
``logaddexp(x, 0)`` (``jax.nn.softplus``; torch's ``softplus`` has a
threshold and another formula); the decay exponent masked before ``exp``
(the dead branch's exp would poison the gradient with inf * 0); ``CB``,
the chunk states, the recurrence and the inter-chunk term in float32
(with TF32 off, on the CUDA cores); B and C broadcast to every head
when ``ngroups == 1``, repeated per group otherwise; the gated norm in
float32. Prefill's conv accumulates its ``conv_width`` products in float32
and rounds once to the activation dtype; decode's conv step is float32
throughout, so decode and prefill round differently, as in the reference.

Tensor parallelism over 'model' (``distributed/tensor_parallel.py``;
the reference's ``sharding.py`` sends ``ssm_inner`` and ``ssm_heads``
over 'model' and keeps ``ssm_bc`` replicated): where ``z_proj`` is
``Shards``, rank r holds the columns of its H / tp heads of ``z_proj``,
``x_proj``, ``dt_proj`` and ``conv_w_x`` and their rows of
``out_proj``. B and C are projected and convolved once, on the first
device, and broadcast; each rank reads its slices of the replicated
vectors (``conv_b_x``, ``A_log``, ``D``, ``dt_bias``, ``norm_w``) as a
``narrow`` of the broadcast vector, and runs the chunked SSD (or the
decode step) over its heads (``_ssd_heads`` / ``_step_heads``, the
one-device path's own arithmetic). The gated norm's mean over d_inner
is a float32 sum of squares a rank, ``reduce_sum``'d in rank order and
divided by d_inner; the output projection's partials are rounded to
the activation dtype and ``reduce_sum``'d onto the first device. The
decode cache splits as the reference's ``cache_specs``: ``conv_x`` over
d_inner and ``state`` over heads, ``conv_bc`` whole.

Nothing here is a kernel: the reference computes the SSD with XLA ops
outside any Pallas kernel. Every operation is deterministic on the card
(no float atomics: the conv is written as shifted products, not a
cuDNN convolution, whose weight gradient may accumulate by atomics).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.distributed import tensor_parallel as TP

Cache = Dict[str, torch.Tensor]


def dims(d_model: int, s: SSMConfig) -> Dict[str, int]:
    d_in = s.expand * d_model
    return dict(d_in=d_in, nheads=d_in // s.head_dim,
                d_bc=2 * s.ngroups * s.state_dim)


# ------------------------------------------------------------ parameters
def leaf_shapes(d_model: int, s: SSMConfig) -> Dict[str, tuple]:
    """{name: shape} of one layer's ssm leaves, the reference's tree."""
    dm = dims(d_model, s)
    d_in, h, d_bc = dm["d_in"], dm["nheads"], dm["d_bc"]
    return {"z_proj": (d_model, d_in), "x_proj": (d_model, d_in),
            "bc_proj": (d_model, d_bc), "dt_proj": (d_model, h),
            "conv_w_x": (s.conv_width, d_in), "conv_b_x": (d_in,),
            "conv_w_bc": (s.conv_width, d_bc), "conv_b_bc": (d_bc,),
            "A_log": (h,), "D": (h,), "dt_bias": (h,), "norm_w": (d_in,),
            "out_proj": (d_in, d_model)}


def init_scale(d_model: int, name: str) -> float:
    """The reference's init scale of the ssm leaf ``name`` (0: zeros or a
    constant, ``init_constant``): the projections, ``out_proj`` included,
    1/sqrt(d_model); the conv weights 0.1."""
    if name in ("z_proj", "x_proj", "bc_proj", "dt_proj", "out_proj"):
        return 1.0 / math.sqrt(d_model)
    if name in ("conv_w_x", "conv_w_bc"):
        return 0.1
    return 0.0


def init_constant(name: str, shape: tuple) -> Optional[torch.Tensor]:
    """The reference's constant leaves, float32 on the CPU: ``A_log`` =
    log(linspace(1, 16, H)), ``D`` = ones; None for the others."""
    if name == "A_log":
        return torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                        dtype=torch.float32))
    if name == "D":
        return torch.ones(shape, dtype=torch.float32)
    return None


# ---------------------------------------------------------------- pieces
def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv along S, then SiLU. x (B, S, C), w (W, C):
    out[t] = sum_k x[t - W + 1 + k] w[k] (zeros before the start), the
    products summed in float32 in k order and rounded once to x's dtype,
    then ``+ b`` and SiLU in x's dtype."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0)).float()
    wf = w.to(x.dtype).float()
    out = pad[:, 0:s] * wf[0]
    for k in range(1, width):
        out = out + pad[:, k:k + s] * wf[k]
    return F.silu(out.to(x.dtype) + b.to(x.dtype))


def _gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm of y * SiLU(z) in float32 with a ``(1 + w)`` gain, cast
    back to y's dtype."""
    yf = y.float() * F.silu(z.float())
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(y.dtype)


def _project(p, x: torch.Tensor):
    dt_ = x.dtype
    z = torch.einsum("bsd,de->bse", x, p["z_proj"].to(dt_))
    xs = torch.einsum("bsd,de->bse", x, p["x_proj"].to(dt_))
    bc = torch.einsum("bsd,de->bse", x, p["bc_proj"].to(dt_))
    dt = torch.einsum("bsd,dh->bsh", x, p["dt_proj"].to(dt_))
    return z, xs, bc, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _to_heads(t: torch.Tensor, heads: int, axis: int, first: int = 0,
              total: Optional[int] = None) -> torch.Tensor:
    """B or C (..., G, N) at axis ``axis`` to (..., heads, N) for the
    heads ``[first, first + heads)`` of ``total`` (default: ``heads``, all
    of them): broadcast for G = 1; else head h reads group
    h // (total / G), each whole group repeated, or one group a head
    where a rank's heads cut a group."""
    g = t.shape[axis]
    if g == 1:
        shape = list(t.shape)
        shape[axis] = heads
        return t.expand(shape)
    per = (heads if total is None else total) // g
    if first % per == 0 and heads % per == 0:
        if heads // per != g:
            t = t.narrow(axis, first // per, heads // per)
        return torch.repeat_interleave(t, per, dim=axis)
    return torch.stack([t.select(axis, h // per)
                        for h in range(first, first + heads)], axis)


def _rank_slices(v: torch.Tensor, like: "TP.Shards") -> List[torch.Tensor]:
    """Each of ``like``'s ranks' slice of the replicated vector ``v``
    (split as ``like``'s leaf is): a ``narrow`` of ``v`` broadcast to the
    rank's device."""
    n = v.shape[-1] // like.tp
    return [t.narrow(-1, r * n, n) for t, r in zip(TP.broadcast(v, like),
                                                   like.ranks)]


# ------------------------------------------------------------------- SSD
def ssd_forward(p, x: torch.Tensor, d_model: int, s: SSMConfig
                ) -> torch.Tensor:
    """The SSD block's output (B, S, d) of its normed input x (B, S, d)."""
    return _ssd_core(p, x, d_model, s, want_state=False)[0]


def check_prompt(seq_len: int, s: SSMConfig) -> None:
    """Raise ValueError for a prompt shorter than ``conv_width - 1``: the
    reference's prefill then keeps a conv tail shorter than decode needs
    and its decode fails (ROADMAP C)."""
    if seq_len < s.conv_width - 1:
        raise ValueError(
            f"a prompt of {seq_len} tokens is shorter than conv_width - 1 "
            f"= {s.conv_width - 1}: the reference's prefill keeps a "
            f"{seq_len}-token conv tail and its decode fails on it "
            f"(ROADMAP C); prefill needs at least {s.conv_width - 1} tokens")


def ssd_prefill(p, x: torch.Tensor, d_model: int, s: SSMConfig
                ) -> Tuple[torch.Tensor, Cache]:
    """(y, {'conv_x', 'conv_bc', 'state'}): the output and the decode
    cache after the last token. A prompt shorter than ``conv_width - 1``
    raises ValueError (``check_prompt``)."""
    check_prompt(x.shape[1], s)
    return _ssd_core(p, x, d_model, s, want_state=True)


def _ssd_core(p, x: torch.Tensor, d_model: int, s: SSMConfig,
              want_state: bool):
    if isinstance(p["z_proj"], TP.Shards):
        return _ssd_split(p, x, d_model, s, want_state)
    z, xs_raw, bc_raw, dt = _project(p, x)
    xs = _causal_conv(xs_raw, p["conv_w_x"], p["conv_b_x"])
    bc = _causal_conv(bc_raw, p["conv_w_bc"], p["conv_b_bc"])
    y, hs = _ssd_heads(xs, bc, dt, p["A_log"], p["D"], p["dt_bias"], s)
    y = _gated_norm(y, z, p["norm_w"])
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    if not want_state:
        return out, None
    w, s_in = s.conv_width - 1, x.shape[1]
    return out, {"conv_x": xs_raw[:, s_in - w:], "conv_bc": bc_raw[:, s_in - w:],
                 "state": hs}


def _ssd_heads(xs: torch.Tensor, bc: torch.Tensor, dt: torch.Tensor,
               a_log, d_skip, dt_bias, s: SSMConfig, first: int = 0,
               total: Optional[int] = None):
    """The chunked SSD over the heads ``[first, first + H_r)`` of
    ``total`` (default: all): xs (B, S, H_r P) and dt (B, S, H_r), their
    conv output and raw projection; bc (B, S, 2 G N) after its conv;
    a_log, d_skip, dt_bias (H_r,). Returns (y (B, S, H_r P) in xs' dtype,
    before the gated norm; the final state (B, H_r, N, P) float32)."""
    b, s_in, _ = xs.shape
    h, pd, n, g = dt.shape[-1], s.head_dim, s.state_dim, s.ngroups
    dt_, dev = xs.dtype, xs.device

    # pad S to a chunk multiple; padded steps get dt = 0 (identity decay,
    # zero input), so outputs and the final state are unaffected
    cl = min(s.chunk, s_in)
    pad = (-s_in) % cl
    seq = s_in + pad
    if pad:
        xs = F.pad(xs, (0, 0, 0, pad))
        bc = F.pad(bc, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = seq // cl
    xs = xs.reshape(b, seq, h, pd)
    bm = bc[..., :g * n].reshape(b, seq, g, n)
    cm = bc[..., g * n:].reshape(b, seq, g, n)

    dt = _softplus(dt.float() + dt_bias.float())                      # (B,S,H)
    if pad:
        valid = (torch.arange(seq, device=dev) < s_in)[None, :, None]
        dt = torch.where(valid, dt, torch.zeros((), device=dev))
    a_neg = -torch.exp(a_log.float())                                 # (H,)
    a = dt * a_neg[None, None, :]                                     # <= 0

    def ch(t):
        return t.reshape(b, nc, cl, *t.shape[2:])
    xc, bcb, ccb, ac, dtc = map(ch, (xs, bm, cm, a, dt))
    acs = torch.cumsum(ac, dim=2)                               # inclusive
    bch = _to_heads(bcb.float(), h, 3, first, total)                  # (B,nc,cl,H,N)
    cch = _to_heads(ccb.float(), h, 3, first, total)

    cb = torch.einsum("bcihn,bcjhn->bchij", cch, bch)                 # (B,nc,H,cl,cl)
    diff = acs[:, :, :, None, :] - acs[:, :, None, :, :]              # (B,nc,i,j,H)
    diff = diff.permute(0, 1, 4, 2, 3)                                # (B,nc,H,i,j)
    tril = torch.tril(torch.ones((cl, cl), dtype=torch.bool, device=dev))
    # mask BEFORE exp: exp of +large in the dead branch would poison grads
    ldec = torch.exp(torch.where(tril, diff, torch.full(
        (), float("-inf"), device=dev)))
    m = cb * ldec * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]         # * dt_j
    y = torch.einsum("bchij,bcjhp->bcihp", m.to(dt_), xc)

    decay_end = torch.exp(acs[:, :, -1:, :] - acs)                    # (B,nc,cl,H)
    sc = torch.einsum("bcjhn,bcjhp->bchnp",
                      bch * (decay_end * dtc)[..., None],
                      xc.float())                                     # (B,nc,H,N,P)
    chunk_decay = torch.exp(acs[:, :, -1, :])                         # (B,nc,H)

    hs = torch.zeros((b, h, n, pd), dtype=torch.float32, device=dev)
    h_prev = []
    for c in range(nc):
        h_prev.append(hs)
        hs = hs * chunk_decay[:, c, :, None, None] + sc[:, c]
    h_prev = torch.stack(h_prev, dim=1)                               # (B,nc,H,N,P)

    inter = torch.einsum("bcihn,bchnp->bcihp",
                         cch * torch.exp(acs)[..., None], h_prev)
    y = y + inter.to(dt_)
    y = y + (d_skip.float()[None, None, :, None] * xc.float()).to(dt_)
    return y.reshape(b, seq, h * pd)[:, :s_in], hs


def _gated_norm_split(ys, zs, ws, like: "TP.Shards", d_inner: int, dev,
                      eps: float = 1e-6) -> List[torch.Tensor]:
    """``_gated_norm`` over d_inner split across ``like``'s ranks (ys, zs,
    ws: a rank's columns): each rank's float32 sum of squares,
    ``reduce_sum``'d in rank order onto ``dev``, divided by d_inner and
    broadcast back. Returns each rank's normed y."""
    def squares(r, y, z):
        t = y.float() * F.silu(z.float())
        return t, torch.sum(t * t, dim=-1, keepdim=True)
    yf, sq = zip(*TP.map_ranks(squares, ys, zs))
    var = TP.broadcast(TP.reduce_sum(sq, dev, like.tp) / d_inner, like)
    return TP.map_ranks(
        lambda r, t, v, w, y: (t * torch.rsqrt(v + eps)
                               * (1.0 + w.float())).to(y.dtype),
        yf, var, ws, ys)


def _rank_inputs(p, x: torch.Tensor, bc: torch.Tensor):
    """(the split leaves' ``Shards``, x and bc on each rank's device,
    {vector name: each rank's slice}) of a split layer ``p``."""
    like = p["z_proj"]
    vec = {k: _rank_slices(p[k], like)
           for k in ("conv_b_x", "A_log", "D", "dt_bias", "norm_w")}
    return like, TP.broadcast(x, like), TP.broadcast(bc, like), vec


def _rank_project(p, x: torch.Tensor, j: int):
    """Rank j's z, raw x and dt projections of x (on its device)."""
    dt_ = x.dtype
    return tuple(torch.einsum("bsd,de->bse", x, p[k][j].to(dt_))
                 for k in ("z_proj", "x_proj", "dt_proj"))


def _out_split(ys, p, x: torch.Tensor, like) -> torch.Tensor:
    """The row-split output projection: each rank's partial in x's dtype,
    ``reduce_sum``'d onto x's device."""
    return TP.reduce_sum(TP.map_ranks(
        lambda r, y, w: torch.einsum("bse,ed->bsd", y, w.to(x.dtype)), ys,
        p["out_proj"]), x.device, like.tp)


def _ssd_split(p, x: torch.Tensor, d_model: int, s: SSMConfig,
               want_state: bool):
    """``_ssd_core`` with the split leaves of ``p`` (see the module
    docstring)."""
    dt_ = x.dtype
    d_in, h = dims(d_model, s)["d_in"], dims(d_model, s)["nheads"]
    bc_raw = torch.einsum("bsd,de->bse", x, p["bc_proj"].to(dt_))
    bc = _causal_conv(bc_raw, p["conv_w_bc"], p["conv_b_bc"])
    like, xr, bcr, vec = _rank_inputs(p, x, bc)
    hr = h // like.tp

    def heads(j, r):
        z, xs_raw, dt = _rank_project(p, xr[j], j)
        xs = _causal_conv(xs_raw, p["conv_w_x"][j], vec["conv_b_x"][j])
        y, hs = _ssd_heads(xs, bcr[j], dt, vec["A_log"][j], vec["D"][j],
                           vec["dt_bias"][j], s, r * hr, h)
        return y, z, xs_raw, hs
    ys, zs, tails, states = zip(*TP.map_ranks(heads, like.ranks))
    ys = _gated_norm_split(ys, zs, vec["norm_w"], like, d_in, x.device)
    out = _out_split(ys, p, x, like)
    if not want_state:
        return out, None
    w, s_in = s.conv_width - 1, x.shape[1]
    return out, {"conv_x": like.like([t[:, s_in - w:] for t in tails], 2),
                 "conv_bc": bc_raw[:, s_in - w:],
                 "state": like.like(states, 1)}


def init_ssm_cache(batch: int, d_model: int, s: SSMConfig,
                   dtype=torch.bfloat16, device=None) -> Cache:
    dm = dims(d_model, s)
    w = s.conv_width - 1
    return {"conv_x": torch.zeros((batch, w, dm["d_in"]), dtype=dtype,
                                  device=device),
            "conv_bc": torch.zeros((batch, w, dm["d_bc"]), dtype=dtype,
                                   device=device),
            "state": torch.zeros((batch, dm["nheads"], s.state_dim,
                                  s.head_dim), dtype=torch.float32,
                                 device=device)}


# the dimension of each decode-cache buffer (B, ...) split over 'model'
CACHE_SPLIT_DIMS = {"conv_x": 2, "conv_bc": None, "state": 1}


def _conv_step(hist, new, w, b):
    """One causal conv step in float32: (SiLU output (B, C), the new tail
    (B, W - 1, C))."""
    hist = torch.cat([hist, new.to(hist.dtype)], dim=1)              # (B,W,C)
    out = torch.einsum("bwc,wc->bc", hist.float(), w.float())
    return F.silu(out + b.float()), hist[:, 1:]


def _step_heads(xconv, bconv, dt, state, a_log, d_skip, dt_bias,
                s: SSMConfig, dtype, first: int = 0,
                total: Optional[int] = None):
    """One decode step of the heads ``[first, first + H_r)`` of ``total``
    (default: all): xconv (B, H_r P) and bconv (B, 2 G N) after their
    conv steps, dt (B, 1, H_r), state (B, H_r, N, P). Returns (y (B, 1,
    H_r P) in ``dtype``, before the gated norm; the new state)."""
    b, h = dt.shape[0], dt.shape[-1]
    pd, n, g = s.head_dim, s.state_dim, s.ngroups
    xs = xconv.reshape(b, h, pd)
    bm = bconv[:, :g * n].reshape(b, g, n)
    cm = bconv[:, g * n:].reshape(b, g, n)
    dtv = _softplus(dt[:, 0].float() + dt_bias.float())               # (B,H)
    a_neg = -torch.exp(a_log.float())
    dec = torch.exp(dtv * a_neg[None])
    bh = _to_heads(bm.float(), h, 1, first, total)
    chh = _to_heads(cm.float(), h, 1, first, total)
    state = state * dec[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", dtv[..., None] * bh, xs.float())
    y = torch.einsum("bhn,bhnp->bhp", chh, state)
    y = y + d_skip.float()[None, :, None] * xs.float()
    return y.reshape(b, 1, h * pd).to(dtype), state


def ssd_decode(p, x: torch.Tensor, cache: Cache, d_model: int,
               s: SSMConfig) -> Tuple[torch.Tensor, Cache]:
    """One-token step. x (B, 1, d). Returns (y (B, 1, d), the new cache:
    new tensors, the given cache untouched). With split leaves the cache's
    ``conv_x`` and ``state`` are ``Shards`` (``CACHE_SPLIT_DIMS``)."""
    if isinstance(p["z_proj"], TP.Shards):
        return _decode_split(p, x, cache, d_model, s)
    z, xs_raw, bc_raw, dt = _project(p, x)
    xconv, new_cx = _conv_step(cache["conv_x"], xs_raw, p["conv_w_x"],
                               p["conv_b_x"])
    bconv, new_cbc = _conv_step(cache["conv_bc"], bc_raw, p["conv_w_bc"],
                                p["conv_b_bc"])
    y, state = _step_heads(xconv, bconv, dt, cache["state"], p["A_log"],
                           p["D"], p["dt_bias"], s, x.dtype)
    y = _gated_norm(y, z, p["norm_w"])
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    return out, {"conv_x": new_cx, "conv_bc": new_cbc, "state": state}


def _decode_split(p, x: torch.Tensor, cache: Cache, d_model: int,
                  s: SSMConfig) -> Tuple[torch.Tensor, Cache]:
    dt_ = x.dtype
    d_in, h = dims(d_model, s)["d_in"], dims(d_model, s)["nheads"]
    bc_raw = torch.einsum("bsd,de->bse", x, p["bc_proj"].to(dt_))
    bconv, new_cbc = _conv_step(cache["conv_bc"], bc_raw, p["conv_w_bc"],
                                p["conv_b_bc"])
    like, xr, bcr, vec = _rank_inputs(p, x, bconv)
    hr = h // like.tp

    def heads(j, r):
        z, xs_raw, dt = _rank_project(p, xr[j], j)
        xconv, tail = _conv_step(cache["conv_x"][j], xs_raw,
                                 p["conv_w_x"][j], vec["conv_b_x"][j])
        y, st = _step_heads(xconv, bcr[j], dt, cache["state"][j],
                            vec["A_log"][j], vec["D"][j], vec["dt_bias"][j],
                            s, dt_, r * hr, h)
        return y, z, tail, st
    ys, zs, tails, states = zip(*TP.map_ranks(heads, like.ranks))
    ys = _gated_norm_split(ys, zs, vec["norm_w"], like, d_in, x.device)
    return _out_split(ys, p, x, like), {
        "conv_x": like.like(tails, 2), "conv_bc": new_cbc,
        "state": like.like(states, 1)}
