"""Decoder LM of the port, for the dense and audio families. Counterpart
of ``repro/models/transformer.py``.

Supported: ``dense``/``audio`` with ``attn_type`` global or sliding,
``post_norm``, ``tie_embeddings``, RoPE, attention and final softcaps, and
the frontend + pruned-ADC path (musicgen-medium's frame embeddings run the
port's ``core.adc.adc_quantize``). Refused with ``NotImplementedError``
naming the ROADMAP item: the moe, ssm and hybrid families, vlm / M-RoPE
and ``local_global`` (A11, later slices), and ``pad_heads_to >
num_heads`` (ROADMAP C: unless KV = 1, padding the heads moves real heads
to other kv heads, so it is not the published model).

Parameters are a dict in the reference's tree and layouts, so the einsum
strings are the same: ``final_norm``, ``front_proj`` (F, d) or ``embed``
(V, d), ``head`` (d, V) unless tied, and ``layers`` with every leaf
stacked on a leading L axis: ``ln1``, ``q`` (d, H, hd), ``k``/``v``
(d, KV, hd), ``o`` (H, hd, d), ``ln2``, ``wi``/``wg`` (d, f), ``wo``
(f, d), and ``ln1p``/``ln2p`` with ``post_norm``. The reference's layer
``scan`` is a Python loop over L. ``init_params`` draws from the port's
own stream (a ``torch.Generator`` seeded on the device), which is not
``jax.random``'s; ``params_from_numpy`` carries the reference's weights
over for parity. ``layers`` leaves may also be lists of per-layer tensors
(the train step's autograd leaves): ``layer(params, i)`` indexes both.

Training: ``forward`` rematerialises each layer under
``torch.utils.checkpoint`` when ``cfg.remat == "full"`` and autograd is
recording (the reference's ``jax.checkpoint`` of its scan body);
``chunked_ce_loss`` is the cross-entropy over 512-position chunks, each
recomputed in the backward, so (B, S, V) logits never materialise;
``loss_fn`` is ``(ce + aux, {"ce", "aux"})`` with ``aux = 0`` for these
families (no router).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import adc
from repro_torch.models import layers as L

Params = Dict[str, object]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for what the
    port does not run yet."""
    if cfg.family in ("moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported to "
            f"repro_torch yet (ROADMAP A11, a later slice); use the JAX "
            f"package")
    if cfg.family == "vlm" or cfg.mrope:
        raise NotImplementedError(
            f"{cfg.name}: vlm / M-RoPE is not ported to repro_torch yet "
            f"(ROADMAP A11, a later slice); use the JAX package")
    if cfg.family not in ("dense", "audio"):
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.attn_type == "local_global":
        raise NotImplementedError(
            f"{cfg.name}: local_global attention is not ported to "
            f"repro_torch yet (ROADMAP A11, a later slice); use the JAX "
            f"package")
    if cfg.attn_type not in ("global", "sliding"):
        raise ValueError(f"{cfg.name}: unknown attn_type {cfg.attn_type!r}")
    if cfg.pad_heads_to > cfg.num_heads:
        raise NotImplementedError(
            f"{cfg.name}: pad_heads_to={cfg.pad_heads_to} > num_heads="
            f"{cfg.num_heads} is refused (ROADMAP C: padding the heads "
            f"changes the model unless num_kv_heads == 1)")


def window_of(cfg: ArchConfig):
    """The attention window of every layer: cfg.window when sliding."""
    return cfg.window if cfg.attn_type == "sliding" else None


# ============================================================ parameters
def param_shapes(cfg: ArchConfig) -> Dict[str, object]:
    """{name: shape} of the top-level leaves and {"layers": {name: shape}}
    with the leading L axis, in the reference's tree."""
    check_supported(cfg)
    d, hd, nl = cfg.d_model, cfg.resolved_head_dim, cfg.num_layers
    h, kv, f, v = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size
    top: Dict[str, object] = {"final_norm": (d,)}
    if cfg.frontend:
        top["front_proj"] = (cfg.frontend_dim, d)
    else:
        top["embed"] = (v, d)
    if cfg.frontend or not cfg.tie_embeddings:
        top["head"] = (d, v)
    lay = {"ln1": (d,), "q": (d, h, hd), "k": (d, kv, hd), "v": (d, kv, hd),
           "o": (h, hd, d), "ln2": (d,), "wi": (d, f), "wg": (d, f),
           "wo": (f, d)}
    if cfg.post_norm:
        lay.update(ln1p=(d,), ln2p=(d,))
    top["layers"] = {k: (nl,) + s for k, s in lay.items()}
    return top


def _init_scale(cfg: ArchConfig, name: str) -> float:
    """The reference's init scale of a leaf (0: zeros, the norm gains)."""
    d = cfg.d_model
    return {"front_proj": 1.0 / math.sqrt(max(cfg.frontend_dim, 1)),
            "embed": 0.02, "head": 1.0 / math.sqrt(d),
            "q": 1.0 / math.sqrt(d), "k": 1.0 / math.sqrt(d),
            "v": 1.0 / math.sqrt(d),
            "o": 1.0 / math.sqrt(cfg.num_heads * cfg.resolved_head_dim),
            "wi": 1.0 / math.sqrt(d), "wg": 1.0 / math.sqrt(d),
            "wo": 1.0 / math.sqrt(max(cfg.d_ff, 1))}.get(name, 0.0)


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device=None) -> Params:
    """Random parameters with the reference's scales (normal * 1/sqrt(fan
    in), embed 0.02, zero norm gains), drawn leaf by leaf in
    ``param_shapes`` order from a ``torch.Generator`` on ``device`` seeded
    with ``seed``: the port's own stream, not ``jax.random``'s."""
    dev = torch.device("cpu" if device is None else device)
    dtype = torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def leaf(name, shape):
        scale = _init_scale(cfg, name)
        if scale == 0.0:
            return torch.zeros(shape, dtype=dtype, device=dev)
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return t.mul_(scale).to(dtype)

    shapes = param_shapes(cfg)
    params: Params = {k: leaf(k, s) for k, s in shapes.items()
                      if k != "layers"}
    params["layers"] = {k: leaf(k, s) for k, s in shapes["layers"].items()}
    return params


def _from_numpy(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes, as jax hands it
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = a.copy()                         # jax hands read-only views
    return torch.from_numpy(a)


def params_from_numpy(tree, cfg: ArchConfig, device=None) -> Params:
    """The reference's parameter tree, as numpy arrays, to the port's
    parameters on ``device``: same keys, shapes, layouts and dtypes,
    bitwise. Raises ValueError on a missing, extra or misshapen leaf."""
    dev = torch.device("cpu" if device is None else device)
    shapes = param_shapes(cfg)

    def carry(node, want, where):
        if set(node) != set(want):
            raise ValueError(f"{where}: leaves {sorted(node)} != "
                             f"{sorted(want)}")
        out = {}
        for k, shape in want.items():
            if isinstance(shape, dict):
                out[k] = carry(node[k], shape, f"{where}.{k}")
                continue
            t = _from_numpy(node[k])
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{where}.{k}: shape {tuple(t.shape)} != "
                                 f"{tuple(shape)}")
            out[k] = t.to(dev)
        return out

    return carry(dict(tree), shapes, "params")


def layer(params: Params, i: int) -> Dict[str, torch.Tensor]:
    """Layer i's leaves (views into the stacked tensors)."""
    return {k: t[i] for k, t in params["layers"].items()}


# ================================================================ forward
def project_qkv(p, x, cfg: ArchConfig, positions):
    """q (B, S, H, hd), k/v (B, S, KV, hd) of x (B, S, d), RoPE applied
    (the reference's ``serving._qkv_one``)."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["q"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["k"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["v"].to(dt))
    if cfg.use_rope:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def attend_qkv(p, q, k, v, cfg: ArchConfig, kpos, *, window):
    """Causal attention over the sequence's own keys, then the output
    projection. kpos (S,) positions shared by the batch."""
    out = L.attention(q, k, v, q_positions=kpos, k_positions=kpos,
                      causal=True, window=window,
                      attn_softcap=cfg.attn_logit_softcap)
    return torch.einsum("bshk,hkd->bsd", out, p["o"].to(q.dtype))


def _attend(p, x, cfg: ArchConfig, positions, *, window):
    q, k, v = project_qkv(p, x, cfg, positions)
    # the batch shares row 0's positions, as in the reference
    return attend_qkv(p, q, k, v, cfg, positions[0], window=window)


def mlp(p, x):
    return L.swiglu(x, p["wi"], p["wg"], p["wo"])


def finish_layer(p, x, a, cfg: ArchConfig):
    """The rest of a dense layer after its attention output a."""
    if cfg.post_norm:
        a = L.rms_norm(a, p["ln1p"], cfg.norm_eps)
    x = x + a
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    h = mlp(p, h)
    if cfg.post_norm:
        h = L.rms_norm(h, p["ln2p"], cfg.norm_eps)
    return x + h


def _dense_layer(p, x, cfg: ArchConfig, positions, *, window):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    return finish_layer(p, x, _attend(p, h, cfg, positions, window=window),
                        cfg)


def embed_input(params: Params, batch, cfg: ArchConfig) -> torch.Tensor:
    """(B, S, d) inputs in cfg.dtype: frontend embeddings through the
    pruned ADC (per-channel ``adc_mask``) and ``front_proj``, or token
    embeddings (scaled by sqrt(d) for tied dense models, gemma2-style)."""
    dt = torch_dtype(cfg.dtype)
    if cfg.frontend:
        emb = batch["embeddings"]
        if cfg.adc.enable:
            emb = adc.adc_quantize(emb, batch.get("adc_mask"),
                                   bits=cfg.adc.bits, vmin=cfg.adc.vmin,
                                   vmax=cfg.adc.vmax)
        x = torch.einsum("bsf,fd->bsd", emb.to(dt),
                         params["front_proj"].to(dt))
    else:
        x = params["embed"][batch["tokens"].long()].to(dt)
    if cfg.family == "dense" and cfg.tie_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
    return x


def forward(params: Params, batch, cfg: ArchConfig) -> torch.Tensor:
    """Final hidden states (B, S, d), after the final norm. Each layer is
    rematerialised in the backward when ``cfg.remat == "full"`` and
    autograd is recording."""
    check_supported(cfg)
    x = embed_input(params, batch, cfg)
    positions = batch["positions"]
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        p = layer(params, i)
        if remat:
            x = checkpoint(_dense_layer, p, x, cfg, positions,
                           window=window_of(cfg), use_reentrant=False)
        else:
            x = _dense_layer(p, x, cfg, positions, window=window_of(cfg))
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def lm_head(params: Params, cfg: ArchConfig) -> torch.Tensor:
    """The (d, V) output projection (the tied embedding's transpose)."""
    return params["head"] if "head" in params else params["embed"].T


def head_logits(x: torch.Tensor, head_w: torch.Tensor, cap: float
                ) -> torch.Tensor:
    """float32, softcapped logits (..., V) of hidden states (..., d) under
    the (d, V) head."""
    lg = torch.einsum("...d,dv->...v", x, head_w.to(x.dtype))
    return L.softcap(lg.float(), cap)


def logits_of(params: Params, x: torch.Tensor, cfg: ArchConfig
              ) -> torch.Tensor:
    """float32 logits (..., V) of final hidden states (..., d)."""
    return head_logits(x, lm_head(params, cfg), cfg.final_logit_softcap)


def logits_fn(params: Params, batch, cfg: ArchConfig) -> torch.Tensor:
    """(B, S, V) float32 logits of the whole sequence."""
    return logits_of(params, forward(params, batch, cfg), cfg)


def _ce_chunk(xb, head_w, lb, cap: float) -> torch.Tensor:
    """Summed negative log-likelihood of labels lb (B, c) under the
    float32, softcapped logits of xb (B, c, d)."""
    logp = torch.log_softmax(head_logits(xb, head_w, cap), dim=-1)
    return -torch.gather(logp, -1, lb.long()[..., None])[..., 0].sum()


def chunked_ce_loss(x: torch.Tensor, head_w: torch.Tensor,
                    labels: torch.Tensor, cfg: ArchConfig,
                    chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy of labels (B, S) under the logits of x (B, S, d)
    and the (d, V) head, over sequence chunks of ``chunk`` positions
    summed in order; each chunk is recomputed in the backward, so no
    (B, S, V) tensor is kept. A float32 scalar."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"loss chunk {chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    grad = torch.is_grad_enabled()
    for c0 in range(0, s, chunk):
        args = (x[:, c0:c0 + chunk], head_w, labels[:, c0:c0 + chunk],
                cfg.final_logit_softcap)
        tot = tot + (checkpoint(_ce_chunk, *args, use_reentrant=False)
                     if grad else _ce_chunk(*args))
    return tot / (b * s)


def loss_fn(params: Params, batch, cfg: ArchConfig):
    """(total loss, {"ce", "aux"}): the chunked cross-entropy of the
    batch's labels; aux (the router loss of the moe family, not ported)
    is 0."""
    x = forward(params, batch, cfg)
    ce = chunked_ce_loss(x, lm_head(params, cfg), batch["labels"], cfg)
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    return ce, {"ce": ce, "aux": aux}


class Transformer(nn.Module):
    """The stacked parameters as an ``nn.Module`` (buffers, no autograd:
    serving only); ``forward`` is ``logits_fn``, and ``params`` is the
    tree the plain functions here and in models/serving.py take."""

    def __init__(self, cfg: ArchConfig, params: Params):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self._top = tuple(k for k in params if k != "layers")
        self._layers = tuple(params["layers"])
        for k in self._top:
            self.register_buffer(k, params[k])
        for k in self._layers:
            self.register_buffer(f"layers_{k}", params["layers"][k])

    @property
    def params(self) -> Params:
        tree: Params = {k: getattr(self, k) for k in self._top}
        tree["layers"] = {k: getattr(self, f"layers_{k}")
                          for k in self._layers}
        return tree

    def forward(self, batch) -> torch.Tensor:
        return logits_fn(self.params, batch, self.cfg)
