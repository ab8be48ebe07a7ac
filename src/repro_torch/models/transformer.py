"""Decoder LM of the port, for the dense, audio, vlm, moe, ssm and hybrid
families. Counterpart of ``repro/models/transformer.py``.

Supported: ``dense``/``audio``/``vlm`` with ``attn_type`` global or
sliding, ``post_norm``, ``tie_embeddings``, RoPE, attention and final
softcaps, and the frontend + pruned-ADC path (musicgen-medium's frame
embeddings and qwen2-vl's patch embeddings run the port's
``core.adc.adc_quantize``); ``local_global`` for the dense family (gemma2:
the stacked layers run in (local, global) pairs, ``layers[i]`` over
``cfg.window`` then ``layers2[i]`` globally); M-RoPE (``cfg.mrope``,
(B, S, 3) positions, ``layers.rope``'s sections), where attention's mask
reads component 0 of the positions, as the reference's does; ``moe``
(llama4-scout, kimi-k2: ``models/moe.py``, ``first_k_dense`` dense
prelayers) with global attention; ``ssm`` (mamba2: each layer ``x + SSD(rms(x))``,
``models/ssm.py``) and ``hybrid`` (hymba: attention over ``cfg.window``
whatever ``attn_type`` is, and the SSD in parallel on the same normed
input, ``x + 0.5 * (rms(a) + rms(s))``, then the SwiGLU MLP). Refused
with ``NotImplementedError`` naming the ROADMAP item: ``local_global``
outside the dense family (ROADMAP C: the reference's serving defines it
only there); moe with a window (ROADMAP C: the reference's moe forward
attends globally while its prefill and decode use the window); and
``pad_heads_to > num_heads`` (ROADMAP C: unless KV = 1, padding the heads
moves real heads to other kv heads, so it is not the published model;
gemma2-2b's published config pads 8 heads to 16).

Parameters are a nested dict in the reference's tree and layouts, so the
einsum strings are the same: ``final_norm``, ``front_proj`` (F, d) or
``embed`` (V, d), ``head`` (d, V) unless tied, and ``layers`` with every
leaf stacked on a leading axis over the scanned layers: ``ln1``, ``q``
(d, H, hd), ``k``/``v`` (d, KV, hd), ``o`` (H, hd, d), ``ln2``, then for
the dense families ``wi``/``wg`` (d, f), ``wo`` (f, d) and
``ln1p``/``ln2p`` with ``post_norm``, for moe the subtree ``moe``
(``models/moe.leaf_shapes``; ``router`` float32 whatever
``param_dtype`` is). An ssm layer is ``ln1`` and the subtree ``ssm``
(``models/ssm.leaf_shapes``); a hybrid layer adds to it the attention
leaves, ``ln2``, ``attn_scale``, ``ssm_scale`` and ``wi``/``wg``/``wo``. A
``local_global`` config stacks num_layers / 2 pairs: ``layers`` the local
layer of each pair, ``layers2`` (same leaves) the global one. A
moe config with ``first_k_dense`` adds ``prelayers``, that many dense
blocks (no post-norms) stacked the same way. The reference's layer
``scan`` is a Python loop. ``init_params`` draws from the port's own
stream (a ``torch.Generator`` seeded on the device), which is not
``jax.random``'s, at the reference's scales and constants
(``ssm.A_log`` = log(linspace(1, 16, H)), ``ssm.D`` = 1);
``params_from_numpy`` carries the reference's weights over for parity.
Stacked leaves may also be lists of per-layer tensors (the train step's
autograd leaves): ``layer(params, i)`` indexes both.

Tensor parallelism (``distributed/tensor_parallel.py``): a parameter
split over 'model' is ``Shards``, one slice a rank on its device, and
the functions here dispatch on it. Split q heads: each rank projects its
heads (``project_qkv``; replicated k/v read per rank by
``kv_weights``), runs the attention kernel on them and its rows of
``o`` (``attend_qkv``); split ``wi``/``wg``/``wo``: ``mlp`` per rank; a
vocab split: ``embed_input``'s masked lookup and ``head_logits``'s
gathered logits. Each rank's partial output is ``reduce_sum``'d onto
the first device, where the replicated work runs once.

Training: ``forward`` rematerialises each layer under
``torch.utils.checkpoint`` when ``cfg.remat == "full"`` and autograd is
recording (the reference's ``jax.checkpoint`` of its scan body);
``chunked_ce_loss`` is the cross-entropy over 512-position chunks, each
recomputed in the backward, so (B, S, V) logits never materialise;
``loss_fn`` is ``(ce + router_aux_weight * aux, {"ce", "aux"})`` with
``aux`` the moe layers' summed Switch loss (0 for the other families).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.arrays import tensor_from_numpy
from repro_torch.configs.base import ArchConfig
from repro_torch.core import adc
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import layers as L
from repro_torch.models import moe, ssm

Params = Dict[str, object]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def check_supported(cfg: ArchConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for what the
    port does not run yet."""
    if cfg.family not in ("dense", "audio", "vlm", "moe", "ssm", "hybrid"):
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    if cfg.attn_type not in ("global", "sliding", "local_global"):
        raise ValueError(f"{cfg.name}: unknown attn_type {cfg.attn_type!r}")
    if cfg.attn_type == "local_global" and cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: local_global attention outside the dense family "
            f"(family {cfg.family!r}) is refused (ROADMAP C: the "
            f"reference's decode defines it only for the dense family)")
    if cfg.attn_type == "local_global" and cfg.num_layers % 2:
        raise ValueError(f"{cfg.name}: local_global pairs need an even "
                         f"num_layers, not {cfg.num_layers}")
    if cfg.family == "moe" and cfg.attn_type != "global":
        raise NotImplementedError(
            f"{cfg.name}: moe with attn_type={cfg.attn_type!r} is refused "
            f"(ROADMAP C: the reference's moe forward attends globally "
            f"while its prefill and decode use the window)")
    if cfg.pad_heads_to > cfg.num_heads:
        raise NotImplementedError(
            f"{cfg.name}: pad_heads_to={cfg.pad_heads_to} > num_heads="
            f"{cfg.num_heads} is refused (ROADMAP C: padding the heads "
            f"changes the model unless num_kv_heads == 1)")


def first_k_dense(cfg: ArchConfig) -> int:
    """The dense prelayers before the scanned moe layers (0 otherwise)."""
    return cfg.moe.first_k_dense if cfg.moe else 0


def local_global(cfg: ArchConfig) -> bool:
    """Whether the layers run in (local, global) pairs (gemma2)."""
    return cfg.attn_type == "local_global"


def scan_len(cfg: ArchConfig) -> int:
    """The stacked ``layers``' length: every layer but the prelayers, or
    the number of (local, global) pairs."""
    n = cfg.num_layers - first_k_dense(cfg)
    return n // 2 if local_global(cfg) else n


def dense_config(cfg: ArchConfig) -> ArchConfig:
    """The config the prelayers run under, as the reference's."""
    return cfg.replace(family="dense", post_norm=False)


def window_of(cfg: ArchConfig):
    """The attention window of every layer of ``layers``, the reference's
    rule: cfg.window for sliding attention, for the local layer of each
    local_global pair (``layers2`` attends globally) and for every hybrid
    layer whatever attn_type is; None (global) otherwise."""
    if cfg.family == "hybrid" or cfg.attn_type in ("sliding",
                                                   "local_global"):
        return cfg.window
    return None


def token_positions(positions: torch.Tensor) -> torch.Tensor:
    """(B, S) positions that attention's mask and the cache's ``kpos``
    read: the positions themselves, or component 0 (t) of M-RoPE's
    (B, S, 3), as in the reference."""
    return positions[..., 0] if positions.ndim == 3 else positions


# ============================================================ parameters
def _attn_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    return {"ln1": (d,), "q": (d, h, hd), "k": (d, kv, hd),
            "v": (d, kv, hd), "o": (h, hd, d), "ln2": (d,)}


def _dense_shapes(cfg: ArchConfig) -> Dict[str, tuple]:
    d, f = cfg.d_model, cfg.d_ff
    lay = dict(_attn_shapes(cfg), wi=(d, f), wg=(d, f), wo=(f, d))
    if cfg.post_norm:
        lay.update(ln1p=(d,), ln2p=(d,))
    return lay


def _stacked(tree, n: int):
    return {k: (_stacked(v, n) if isinstance(v, dict) else (n,) + v)
            for k, v in tree.items()}


def param_shapes(cfg: ArchConfig) -> Dict[str, object]:
    """{name: shape} of the top-level leaves and the stacked subtrees
    (``layers``; ``layers2`` for local_global; ``prelayers`` for a moe
    config with first_k_dense), each
    leaf with its leading layer axis, in the reference's tree."""
    check_supported(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    top: Dict[str, object] = {"final_norm": (d,)}
    if cfg.frontend:
        top["front_proj"] = (cfg.frontend_dim, d)
    else:
        top["embed"] = (v, d)
    if cfg.frontend or not cfg.tie_embeddings:
        top["head"] = (d, v)
    if cfg.family == "moe":
        lay = dict(_attn_shapes(cfg), moe=moe.leaf_shapes(d, cfg.moe))
    elif cfg.family == "ssm":
        lay = {"ln1": (d,), "ssm": ssm.leaf_shapes(d, cfg.ssm)}
    elif cfg.family == "hybrid":
        lay = dict(_attn_shapes(cfg), attn_scale=(d,), ssm_scale=(d,),
                   ssm=ssm.leaf_shapes(d, cfg.ssm), wi=(d, cfg.d_ff),
                   wg=(d, cfg.d_ff), wo=(cfg.d_ff, d))
    else:
        lay = _dense_shapes(cfg)
    top["layers"] = _stacked(lay, scan_len(cfg))
    if local_global(cfg):
        top["layers2"] = _stacked(lay, scan_len(cfg))
    if first_k_dense(cfg):
        top["prelayers"] = _stacked(_dense_shapes(dense_config(cfg)),
                                    first_k_dense(cfg))
    return top


def _init_scale(cfg: ArchConfig, path: Tuple[str, ...]) -> float:
    """The reference's init scale of the leaf at ``path`` (0: zeros, the
    norm gains), keyed by the whole path: a moe leaf's scale is not the
    dense leaf's of the same name."""
    if "moe" in path:
        return moe.init_scale(cfg.d_model, cfg.moe,
                              path[path.index("moe") + 1:])
    if "ssm" in path:
        return ssm.init_scale(cfg.d_model, path[-1])
    d = cfg.d_model
    return {"front_proj": 1.0 / math.sqrt(max(cfg.frontend_dim, 1)),
            "embed": 0.02, "head": 1.0 / math.sqrt(d),
            "q": 1.0 / math.sqrt(d), "k": 1.0 / math.sqrt(d),
            "v": 1.0 / math.sqrt(d),
            "o": 1.0 / math.sqrt(max(cfg.num_heads * cfg.resolved_head_dim,
                                     1)),
            "wi": 1.0 / math.sqrt(d), "wg": 1.0 / math.sqrt(d),
            "wo": 1.0 / math.sqrt(max(cfg.d_ff, 1))}.get(path[-1], 0.0)


def leaf_dtype(cfg: ArchConfig, path: Tuple[str, ...]) -> torch.dtype:
    """The stored dtype of the leaf at ``path``: ``param_dtype``, but the
    moe router is float32 whatever it is (the reference's)."""
    if path[-2:] == ("moe", "router"):
        return torch.float32
    return torch_dtype(cfg.param_dtype)


def _per_expert(path: Tuple[str, ...]) -> bool:
    return len(path) == 3 and path[1] == "moe" and path[2] in ("wi", "wg",
                                                              "wo")


def init_params(cfg: ArchConfig, *, seed: int = 0, device=None,
                plan=None) -> Params:
    """Random parameters with the reference's scales (normal * 1/sqrt(fan
    in), embed and router 0.02, ssm conv weights 0.1, zero norm gains;
    ``_init_scale``), its constant leaves (``ssm.init_constant``) and
    dtypes (``leaf_dtype``), drawn leaf by leaf in ``param_shapes`` order
    from a ``torch.Generator`` on ``device`` seeded with ``seed``: the
    port's own stream, not ``jax.random``'s. A leaf is one float32 draw,
    scaled, then cast, except the stacked experts' ``wi``/``wg``/``wo``,
    drawn one (layer, expert) matrix at a time into the stored dtype, so
    no float32 copy of a whole expert stack is ever held. With a
    ``plan`` (``tensor_parallel.tp_plan``) each leaf is drawn whole on
    its first device, then placed as ``shard_params`` places it: the
    same values, split."""
    dev = (plan.first if plan is not None
           else torch.device("cpu" if device is None else device))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(shape, scale, dtype):
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return t.mul_(scale).to(dtype)

    def leaf(path, shape):
        scale, dtype = _init_scale(cfg, path), leaf_dtype(cfg, path)
        const = ssm.init_constant(path[-1], shape) if "ssm" in path else None
        if const is not None:
            return torch.empty(shape, dtype=dtype, device=dev).copy_(const)
        if scale == 0.0:
            return torch.zeros(shape, dtype=dtype, device=dev)
        if not _per_expert(path):
            return draw(shape, scale, dtype)
        out = torch.empty(shape, dtype=dtype, device=dev)
        for i in range(shape[0]):
            for e in range(shape[1]):
                out[i, e] = draw(shape[2:], scale, dtype)
        return out

    def placed(path, shape):
        t = leaf(path, shape)
        return t if plan is None else TP.place(t, plan.dims.get(path), plan)

    def build(tree, path):
        return {k: (build(v, path + (k,)) if isinstance(v, dict)
                    else placed(path + (k,), v)) for k, v in tree.items()}

    return build(param_shapes(cfg), ())


def params_from_numpy(tree, cfg: ArchConfig, device=None,
                      plan=None) -> Params:
    """The reference's parameter tree, as numpy arrays, to the port's
    parameters on ``device``: same keys, shapes, layouts and dtypes,
    bitwise. With a ``plan`` (``tensor_parallel.tp_plan``) each array is
    placed directly as the plan places it (a split leaf's slices on its
    ranks' devices, a replicated one on the first device). Raises
    ValueError on a missing, extra or misshapen leaf."""
    dev = torch.device("cpu" if device is None else device)
    shapes = param_shapes(cfg)

    def carry(node, want, path):
        where = ".".join(("params",) + path)
        if set(node) != set(want):
            raise ValueError(f"{where}: leaves {sorted(node)} != "
                             f"{sorted(want)}")
        out = {}
        for k, shape in want.items():
            if isinstance(shape, dict):
                out[k] = carry(node[k], shape, path + (k,))
                continue
            t = tensor_from_numpy(node[k])
            if tuple(t.shape) != tuple(shape):
                raise ValueError(f"{where}.{k}: shape {tuple(t.shape)} != "
                                 f"{tuple(shape)}")
            out[k] = (t.to(dev) if plan is None
                      else TP.place(t, plan.dims.get(path + (k,)), plan))
        return out

    return carry(dict(tree), shapes, ())


def err_from_numpy(err, cfg: ArchConfig, devices=None, *, mesh=None) -> list:
    """The reference's int8 error-feedback buffer, a (dp, n) bfloat16
    array, to the port's rows (``TrainState.err``): row r on
    ``devices[r]`` (default: the CPU), or on the first device of dp rank
    r of a (dp, tp) ``mesh`` (its ('pod', 'data') ranks, pod-major),
    bitwise. Raises ValueError where n is not ``cfg``'s parameter count
    or the devices are not one a row."""
    if mesh is not None:
        devices = [g[0] for g in TP.tp_groups(mesh)]
    t = tensor_from_numpy(err)
    n = sum(math.prod(shape) for _, shape in _flat(param_shapes(cfg)))
    if t.dtype != torch.bfloat16 or t.ndim != 2 or t.shape[1] != n:
        raise ValueError(f"an error buffer of {cfg.name} is (dp, {n}) "
                         f"bfloat16, not {tuple(t.shape)} {t.dtype}")
    devices = ["cpu"] * t.shape[0] if devices is None else list(devices)
    if len(devices) != t.shape[0]:
        raise ValueError(f"{len(devices)} devices for {t.shape[0]} rows")
    return [row.to(torch.device(d)) for row, d in zip(t, devices)]


def layer(params: Params, i: int, key: str = "layers") -> Params:
    """Layer i's leaves of the stacked subtree ``key`` (views into the
    stacked tensors, or the per-layer lists' entries; a split leaf's
    ``Shards`` of its ranks' layer i), nesting kept."""
    def pick(node):
        return {k: (pick(v) if isinstance(v, dict)
                    else v.at(i) if isinstance(v, TP.Shards) else v[i])
                for k, v in node.items()}
    return pick(params[key])


# ================================================================ forward
def _project(x, wq, wk, wv, cfg: ArchConfig, positions):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, wq.to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, wk.to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, wv.to(dt))
    if cfg.use_rope:
        sections = cfg.mrope_sections if cfg.mrope else None
        q = L.rope(q, positions, cfg.rope_theta, sections)
        k = L.rope(k, positions, cfg.rope_theta, sections)
    return q, k, v


def kv_weights(p, cfg: ArchConfig):
    """(k, v) weights a rank of the split q heads ``p["q"]`` reads: the
    split ones, or the replicated ones broadcast to the ranks (their
    gradients summed in rank order), each rank taking the kv heads its q
    heads read (``tensor_parallel.rank_kv_heads``): a slice where they
    are consecutive, else one head at a time (no index_add in the
    backward)."""
    wq = p["q"]
    if isinstance(p["k"], TP.Shards):
        return p["k"], p["v"]

    def heads(w, r):
        hs = TP.rank_kv_heads(cfg.num_heads, cfg.num_kv_heads, wq.tp, r)
        if hs == list(range(hs[0], hs[0] + len(hs))):
            return w.narrow(1, hs[0], len(hs))
        return torch.stack([w.select(1, h) for h in hs], 1)
    return tuple(wq.like([heads(w, r) for w, r in zip(
        TP.broadcast(p[key], wq), wq.ranks)]) for key in ("k", "v"))


def project_qkv(p, x, cfg: ArchConfig, positions):
    """q (B, S, H, hd), k/v (B, S, KV, hd) of x (B, S, d), RoPE applied,
    M-RoPE's sections with ``cfg.mrope`` (the reference's
    ``serving._qkv_one``). With q split over 'model' (``Shards``), each
    rank projects its heads on its device and q, k and v are ``Shards``
    over heads (dim 2): column parallelism."""
    if not isinstance(p["q"], TP.Shards):
        return _project(x, p["q"], p["k"], p["v"], cfg, positions)
    wq = p["q"]
    wk, wv = kv_weights(p, cfg)
    out = [_project(xr, a, b, c, cfg, pr) for xr, pr, a, b, c in zip(
        TP.broadcast(x, wq), TP.broadcast(positions, wq), wq, wk, wv)]
    return tuple(wq.like(list(t), 2) for t in zip(*out))


def attend_qkv(p, q, k, v, cfg: ArchConfig, kpos, *, window):
    """Causal attention over the sequence's own keys, then the output
    projection. kpos (S,) positions shared by the batch. Split heads
    (``Shards`` q, k, v): each rank runs the attention kernel on its
    heads and its rows of ``o``, the partials ``reduce_sum``'d onto
    kpos's device."""
    if isinstance(q, TP.Shards):
        parts = [attend_qkv({"o": o}, qr, kr, vr, cfg, kp, window=window)
                 for o, qr, kr, vr, kp in zip(p["o"], q, k, v,
                                              TP.broadcast(kpos, q))]
        return TP.reduce_sum(parts, kpos.device, q.tp)
    out = L.attention(q, k, v, q_positions=kpos, k_positions=kpos,
                      causal=True, window=window,
                      attn_softcap=cfg.attn_logit_softcap)
    return torch.einsum("bshk,hkd->bsd", out, p["o"].to(q.dtype))


def _attend(p, x, cfg: ArchConfig, positions, *, window):
    q, k, v = project_qkv(p, x, cfg, positions)
    # the batch shares row 0's positions, as in the reference
    return attend_qkv(p, q, k, v, cfg, token_positions(positions)[0],
                      window=window)


def mlp(p, x):
    """The SwiGLU MLP; split over 'model' (``Shards``: ``wi``/``wg`` by
    columns, ``wo`` by rows), each rank's partial ``reduce_sum``'d."""
    if isinstance(p["wi"], TP.Shards):
        return TP.run_ranks(L.swiglu, x, p["wi"], p["wg"], p["wo"])
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


def _moe_mlp(p, h, cfg: ArchConfig, *, decode: bool = False,
             dp: int = 1):
    """A moe layer's FFN of its normed input h: the routed experts
    (prefill capacity and the aux loss, routed per dp shard of ``dp``;
    with ``decode`` the decode capacity and aux None) plus the shared
    experts. Returns (y, aux)."""
    if decode:
        y, aux = moe.moe_ffn_decode(h, p["moe"], cfg.moe), None
    else:
        y, aux = moe.moe_ffn(h, p["moe"], cfg.moe, dp=dp)
    if cfg.moe.num_shared_experts:
        y = y + moe.shared_ffn(h, p["moe"])
    return y, aux


def finish_moe_layer(p, x, a, cfg: ArchConfig, *, decode: bool = False,
                     dp: int = 1):
    """The rest of a moe layer after its attention output a: (x, aux)."""
    x = x + a
    y, aux = _moe_mlp(p, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg,
                      decode=decode, dp=dp)
    return x + y, aux


def _moe_layer(p, x, cfg: ArchConfig, positions, dp: int = 1):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    return finish_moe_layer(p, x, _attend(p, h, cfg, positions,
                                          window=None), cfg, dp=dp)


def _ssm_layer(p, x, cfg: ArchConfig):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    return x + ssm.ssd_forward(p["ssm"], h, cfg.d_model, cfg.ssm)


def finish_hybrid_layer(p, x, a, s, cfg: ArchConfig):
    """The rest of a hybrid layer after its attention output a and SSD
    output s: ``x + 0.5 * (rms(a) + rms(s))`` in the activation dtype,
    then the SwiGLU MLP's residual."""
    a = L.rms_norm(a, p["attn_scale"], cfg.norm_eps)
    s = L.rms_norm(s, p["ssm_scale"], cfg.norm_eps)
    x = x + 0.5 * (a + s)
    return x + mlp(p, L.rms_norm(x, p["ln2"], cfg.norm_eps))


def _hybrid_layer(p, x, cfg: ArchConfig, positions):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    a = _attend(p, h, cfg, positions, window=window_of(cfg))
    s = ssm.ssd_forward(p["ssm"], h, cfg.d_model, cfg.ssm)
    return finish_hybrid_layer(p, x, a, s, cfg)


def embed_input(params: Params, batch, cfg: ArchConfig) -> torch.Tensor:
    """(B, S, d) inputs in cfg.dtype: frontend embeddings through the
    pruned ADC (per-channel ``adc_mask``) and ``front_proj``, or token
    embeddings (scaled by sqrt(d) for tied dense models, gemma2-style;
    mamba2 ties its embeddings too, unscaled, as in the reference). A
    vocab split over 'model' is a masked lookup a rank, ``reduce_sum``'d:
    one rank holds each token's row, the others add zeros."""
    dt = torch_dtype(cfg.dtype)
    if cfg.frontend:
        emb = batch["embeddings"]
        if cfg.adc.enable:
            emb = adc.adc_quantize(emb, batch.get("adc_mask"),
                                   bits=cfg.adc.bits, vmin=cfg.adc.vmin,
                                   vmax=cfg.adc.vmax)
        x = torch.einsum("bsf,fd->bsd", emb.to(dt),
                         params["front_proj"].to(dt))
    elif isinstance(params["embed"], TP.Shards):
        x = _embed_split(params["embed"], batch["tokens"]).to(dt)
    else:
        x = params["embed"][batch["tokens"].long()].to(dt)
    if cfg.family == "dense" and cfg.tie_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt)
    return x


def _embed_split(table: "TP.Shards", tokens: torch.Tensor) -> torch.Tensor:
    parts = []
    for r, shard, tok in zip(table.ranks, table, TP.broadcast(tokens,
                                                              table)):
        n = shard.shape[0]
        t = tok.long() - r * n
        mine = (t >= 0) & (t < n)
        parts.append(shard[t.clamp(0, n - 1)].masked_fill(~mine[..., None],
                                                          0))
    return TP.reduce_sum(parts, tokens.device, table.tp)


def forward_aux(params: Params, batch, cfg: ArchConfig, *, dp: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(final hidden states (B, S, d) after the final norm, the float32
    aux loss summed over the moe layers). The prelayers run first, under
    ``dense_config``. Each layer is rematerialised in the backward when
    ``cfg.remat == "full"`` and autograd is recording. ``dp``: the dp
    shards a moe layer routes apart (``moe.moe_ffn``); the other
    families ignore it."""
    check_supported(cfg)
    x = embed_input(params, batch, cfg)
    positions = batch["positions"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat == "full" and torch.is_grad_enabled()

    def run(fn, *args, **kw):
        if remat:
            return checkpoint(TP.remat_fn(fn, params), *args,
                              use_reentrant=False, **kw)
        return fn(*args, **kw)

    pre_cfg = dense_config(cfg)
    for i in range(first_k_dense(cfg)):
        x = run(_dense_layer, layer(params, i, "prelayers"), x, pre_cfg,
                positions, window=None)
    for i in range(scan_len(cfg)):
        p = layer(params, i)
        if cfg.family == "moe":
            x, a = run(_moe_layer, p, x, cfg, positions, dp)
            aux = aux + a
        elif cfg.family == "ssm":
            x = run(_ssm_layer, p, x, cfg)
        elif cfg.family == "hybrid":
            x = run(_hybrid_layer, p, x, cfg, positions)
        else:
            x = run(_dense_layer, p, x, cfg, positions,
                    window=window_of(cfg))
            if local_global(cfg):
                x = run(_dense_layer, layer(params, i, "layers2"), x, cfg,
                        positions, window=None)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def forward(params: Params, batch, cfg: ArchConfig) -> torch.Tensor:
    """Final hidden states (B, S, d), after the final norm."""
    return forward_aux(params, batch, cfg)[0]


def lm_head(params: Params, cfg: ArchConfig) -> torch.Tensor:
    """The (d, V) output projection (the tied embedding's transpose; a
    vocab split's ``Shards`` of its ranks' transposes)."""
    if "head" in params:
        return params["head"]
    emb = params["embed"]
    if isinstance(emb, TP.Shards):
        return emb.like([e.T for e in emb], 1)
    return emb.T


def head_logits(x: torch.Tensor, head_w: torch.Tensor, cap: float
                ) -> torch.Tensor:
    """float32, softcapped logits (..., V) of hidden states (..., d) under
    the (d, V) head. A vocab split (``Shards``): each rank's logits of
    its columns, ``gather_cat``'d onto x's device before the softcap."""
    if isinstance(head_w, TP.Shards):
        lg = TP.gather_cat(
            [torch.einsum("...d,dv->...v", xr, w.to(x.dtype))
             for xr, w in zip(TP.broadcast(x, head_w), head_w)], -1,
            x.device, head_w.tp)
    else:
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


def loss_fn(params: Params, batch, cfg: ArchConfig, *, dp: int = 1):
    """(total loss, {"ce", "aux"}): the chunked cross-entropy of the
    batch's labels, plus ``router_aux_weight * aux`` for the moe family;
    aux is 0 for the others. ``dp``: as ``forward_aux``'s."""
    x, aux = forward_aux(params, batch, cfg, dp=dp)
    ce = chunked_ce_loss(x, lm_head(params, cfg), batch["labels"], cfg)
    total = ce + cfg.moe.router_aux_weight * aux if cfg.moe else ce
    return total, {"ce": ce, "aux": aux}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class Transformer(nn.Module):
    """The parameter tree as an ``nn.Module`` (buffers, no autograd:
    serving only; a nested leaf ``a/b/c`` is the buffer ``a__b__c``);
    ``forward`` is ``logits_fn``, and ``params`` is the tree the plain
    functions here and in models/serving.py take."""

    def __init__(self, cfg: ArchConfig, params: Params):
        super().__init__()
        check_supported(cfg)
        if TP.is_split(params):
            raise ValueError("the Transformer module holds whole "
                             "parameters: gather_params first")
        self.cfg = cfg
        self._paths = tuple(path for path, _ in _flat(params))
        for path, t in _flat(params):
            self.register_buffer("__".join(path), t)

    @property
    def params(self) -> Params:
        tree: Params = {}
        for path in self._paths:
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = getattr(self, "__".join(path))
        return tree

    def forward(self, batch) -> torch.Tensor:
        return logits_fn(self.params, batch, self.cfg)
