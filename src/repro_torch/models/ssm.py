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

Nothing here is a kernel: the reference computes the SSD with XLA ops
outside any Pallas kernel. Every operation is deterministic on the card
(no float atomics: the conv is written as shifted products, not a
cuDNN convolution, whose weight gradient may accumulate by atomics).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig

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


def _to_heads(t: torch.Tensor, heads: int, axis: int) -> torch.Tensor:
    """B or C (..., G, N) at axis ``axis`` to (..., H, N): broadcast for
    G = 1, each group repeated H / G times otherwise."""
    g = t.shape[axis]
    if g == 1:
        shape = list(t.shape)
        shape[axis] = heads
        return t.expand(shape)
    return torch.repeat_interleave(t, heads // g, dim=axis)


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
    b, s_in, _ = x.shape
    dm = dims(d_model, s)
    h, pd, n, g = dm["nheads"], s.head_dim, s.state_dim, s.ngroups
    dt_ = x.dtype

    z, xs_raw, bc_raw, dt = _project(p, x)
    xs = _causal_conv(xs_raw, p["conv_w_x"], p["conv_b_x"])
    bc = _causal_conv(bc_raw, p["conv_w_bc"], p["conv_b_bc"])

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

    dt = _softplus(dt.float() + p["dt_bias"].float())                # (B,S,H)
    if pad:
        valid = (torch.arange(seq, device=x.device) < s_in)[None, :, None]
        dt = torch.where(valid, dt, torch.zeros((), device=x.device))
    a_neg = -torch.exp(p["A_log"].float())                            # (H,)
    a = dt * a_neg[None, None, :]                                     # <= 0

    def ch(t):
        return t.reshape(b, nc, cl, *t.shape[2:])
    xc, bcb, ccb, ac, dtc = map(ch, (xs, bm, cm, a, dt))
    acs = torch.cumsum(ac, dim=2)                               # inclusive
    bch = _to_heads(bcb.float(), h, 3)                                # (B,nc,cl,H,N)
    cch = _to_heads(ccb.float(), h, 3)

    cb = torch.einsum("bcihn,bcjhn->bchij", cch, bch)                 # (B,nc,H,cl,cl)
    diff = acs[:, :, :, None, :] - acs[:, :, None, :, :]              # (B,nc,i,j,H)
    diff = diff.permute(0, 1, 4, 2, 3)                                # (B,nc,H,i,j)
    tril = torch.tril(torch.ones((cl, cl), dtype=torch.bool,
                                 device=x.device))
    # mask BEFORE exp: exp of +large in the dead branch would poison grads
    ldec = torch.exp(torch.where(tril, diff, torch.full(
        (), float("-inf"), device=x.device)))
    m = cb * ldec * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]         # * dt_j
    y = torch.einsum("bchij,bcjhp->bcihp", m.to(dt_), xc)

    decay_end = torch.exp(acs[:, :, -1:, :] - acs)                    # (B,nc,cl,H)
    sc = torch.einsum("bcjhn,bcjhp->bchnp",
                      bch * (decay_end * dtc)[..., None],
                      xc.float())                                     # (B,nc,H,N,P)
    chunk_decay = torch.exp(acs[:, :, -1, :])                         # (B,nc,H)

    hs = torch.zeros((b, h, n, pd), dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(hs)
        hs = hs * chunk_decay[:, c, :, None, None] + sc[:, c]
    h_prev = torch.stack(h_prev, dim=1)                               # (B,nc,H,N,P)

    inter = torch.einsum("bcihn,bchnp->bcihp",
                         cch * torch.exp(acs)[..., None], h_prev)
    y = y + inter.to(dt_)
    y = y + (p["D"].float()[None, None, :, None] * xc.float()).to(dt_)
    y = y.reshape(b, seq, dm["d_in"])[:, :s_in]
    y = _gated_norm(y, z, p["norm_w"])
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(dt_))
    if not want_state:
        return out, None
    w = s.conv_width - 1
    return out, {"conv_x": xs_raw[:, s_in - w:], "conv_bc": bc_raw[:, s_in - w:],
                 "state": hs}


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


def _conv_step(hist, new, w, b):
    """One causal conv step in float32: (SiLU output (B, C), the new tail
    (B, W - 1, C))."""
    hist = torch.cat([hist, new.to(hist.dtype)], dim=1)              # (B,W,C)
    out = torch.einsum("bwc,wc->bc", hist.float(), w.float())
    return F.silu(out + b.float()), hist[:, 1:]


def ssd_decode(p, x: torch.Tensor, cache: Cache, d_model: int,
               s: SSMConfig) -> Tuple[torch.Tensor, Cache]:
    """One-token step. x (B, 1, d). Returns (y (B, 1, d), the new cache:
    new tensors, the given cache untouched)."""
    b = x.shape[0]
    dm = dims(d_model, s)
    h, pd, n, g = dm["nheads"], s.head_dim, s.state_dim, s.ngroups

    z, xs_raw, bc_raw, dt = _project(p, x)
    xconv, new_cx = _conv_step(cache["conv_x"], xs_raw, p["conv_w_x"],
                               p["conv_b_x"])
    bconv, new_cbc = _conv_step(cache["conv_bc"], bc_raw, p["conv_w_bc"],
                                p["conv_b_bc"])
    xs = xconv.reshape(b, h, pd)
    bm = bconv[:, :g * n].reshape(b, g, n)
    cm = bconv[:, g * n:].reshape(b, g, n)
    dtv = _softplus(dt[:, 0].float() + p["dt_bias"].float())          # (B,H)
    a_neg = -torch.exp(p["A_log"].float())
    dec = torch.exp(dtv * a_neg[None])
    bh = _to_heads(bm.float(), h, 1)
    chh = _to_heads(cm.float(), h, 1)
    state = cache["state"] * dec[..., None, None] + torch.einsum(
        "bhn,bhp->bhnp", dtv[..., None] * bh, xs.float())
    y = torch.einsum("bhn,bhnp->bhp", chh, state)
    y = y + p["D"].float()[None, :, None] * xs.float()
    y = y.reshape(b, 1, dm["d_in"]).to(x.dtype)
    y = _gated_norm(y, z, p["norm_w"])
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    return out, {"conv_x": new_cx, "conv_bc": new_cbc, "state": state}
