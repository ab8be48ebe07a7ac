"""LM serving: prefill (builds the decode cache) and single-token decode,
for the dense, audio, vlm, moe, ssm and hybrid families. Counterpart of
``repro/models/serving.py``.

Cache (leading L = stacked layers). Attention (every family but ssm):
ring buffers ``k``/``v`` (L, B, C, KV, hd) in cfg.dtype with C =
min(S, window) for sliding attention and for every hybrid layer (the
reference's ``local=True`` length: a hybrid layer attends over the window
whatever ``attn_type`` is), S otherwise (S = prompt length +
``extra_slots``), and ``kpos`` (C,) int32 absolute positions (-1 = empty
slot). A ``local_global`` config (gemma2, L pairs) keeps its local layers'
ring there (C = min(S, window)) and its global layers' full-length cache
in ``k2``/``v2`` (L, B, S, KV, hd) with ``kpos2`` (S,); each ring writes
decode's token at its own slot ``pos % C``. Under M-RoPE ((B, S, 3)
positions) ``kpos``, the mask and ``pos`` read component 0, as the
reference's do. The ssm and hybrid families add the SSD's decode state
(``models/ssm.py``): ``conv_x`` (L, B, conv_width - 1, d_inner) and
``conv_bc`` (L, B, conv_width - 1, 2 G N), the raw projections of the last
tokens in cfg.dtype, and ``state`` (L, B, H, N, P) float32; the ssm
family has no ring at all. ``pos`` () int32 is the next position. A moe
config with ``first_k_dense`` adds ``k_pre``/``v_pre`` (first_k_dense,
B, S, KV, hd) for its dense prelayers, which share ``kpos`` (moe attends
globally, so C = S). The reference's ring semantics are kept exactly:
decode writes the new token at slot ``pos % C`` and attends to that slot
too, so with ``extra_slots=0`` it evicts StreamingLLM-style (and a
prompt off the window grid overwrites a visible key, ROADMAP C).

Tensor parallelism over a mesh's 'model' axis (``prefill`` /
``decode_step``'s ``mesh``; the parameters placed by ``serving_plan``,
``tensor_parallel.tp_plan(cfg, mesh, inference=True)``): where the q
heads split over 'model', each rank's
``k``/``v`` (``k2``/``v2``, ``k_pre``/``v_pre``) buffer is ``Shards`` of
(L, B, C, KV_r, hd) on its device, holding the kv heads its q heads read
(``tensor_parallel.rank_kv_heads``: its share of the kv heads where they
divide tp, else the replicated heads it reads). Here the port departs
from the reference's ``cache_specs``, which puts the cache's sequence
over 'model' where the kv heads do not divide it (``sharding.py:203``).
Cache placement changes no value: each rank's decode attention reads
exactly the keys and values its heads read on one device. ``kpos``,
``kpos2`` and ``pos`` stay on the first device, as do the SSD's buffers
(the ssm family's 'model' split is refused). On a mesh whose ('pod',
'data') size n exceeds 1 the first 'data' slice's 'model' ranks serve
the whole batch, as the uncompressed train step does: the reference's
global (GSPMD) serving, whose only dp-dependent value is moe's prefill
routing, where each of the n row blocks of the batch routes apart (its
own capacity; ``moe.moe_ffn``'s ``dp``; decode's ``_gathered_moe``
routes the whole batch on every mesh). Serving the 'data' slices
concurrently is ROADMAP A11.9.

``decode_step`` updates the cache's tensors in place (``k``, ``v``,
``k2``, ``v2``, ``k_pre``, ``v_pre``, ``kpos``, ``kpos2``, and the SSD's
``conv_x``, ``conv_bc``, ``state``) and returns them under a new dict
with ``pos + 1`` (the reference's launcher donates the cache too): clone
a cache that is still needed. Prefill attention runs the flash-attention
kernel on a CUDA tensor (models/layers.py); decode attention is plain
PyTorch, as it is plain jnp in the reference. The moe layers route with the prefill
capacity in prefill and the decode capacity in decode (``models/moe.py``),
the reference's semantics: so for moe, decode after prefill is not
teacher forcing. Prefill of an ssm or hybrid config refuses a prompt
shorter than ``conv_width - 1`` (``ssm.ssd_prefill``, ROADMAP C).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as T

Cache = Dict[str, torch.Tensor]
SSM_KEYS = ("conv_x", "conv_bc", "state")


def attn_cache_len(cfg: ArchConfig, seq_len: int, *, local: bool) -> int:
    if local or cfg.attn_type == "sliding":
        return min(cfg.window, seq_len)
    return seq_len


def serving_plan(cfg: ArchConfig, mesh):
    """The tensor-parallel plan of serving ``cfg`` over ``mesh``
    (``tensor_parallel.tp_plan`` with the inference specs: the first
    'data' slice's 'model' ranks; None without a mesh or where the mesh
    splits no weight). Raises for what ``tp_plan`` refuses."""
    return TP.tp_plan(cfg, mesh, inference=True)


def dp_shards(mesh) -> int:
    """The mesh's ('pod', 'data') size: the row blocks moe's prefill
    routes apart (1 without a mesh)."""
    if mesh is None:
        return 1
    return math.prod(mesh.shape[a] for a in sharding.dp_axes(mesh))


def init_cache(cfg: ArchConfig, batch: int, seq_len: int,
               device=None, plan=None) -> Cache:
    """Empty decode cache sized for a context of ``seq_len``; with a
    ``plan`` whose q heads split, the kv buffers per rank (see the module
    docstring) and the rest on the plan's first device."""
    T.check_supported(cfg)
    dt = T.torch_dtype(cfg.dtype)
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    n = T.scan_len(cfg)
    if plan is not None:
        device = plan.first

    def kvbuf(layers, length):
        if plan is not None and plan.split(("layers", "q")):
            return TP.Shards(
                [torch.zeros((layers, batch, length, len(plan.kv_heads(r)),
                              hd), dtype=dt, device=d)
                 for r, d in zip(plan.ranks, plan.devices)], 3, plan.ranks,
                plan.tp)
        return torch.zeros((layers, batch, length, kv, hd), dtype=dt,
                           device=device)

    def kposbuf(length):
        return torch.full((length,), -1, dtype=torch.int32, device=device)

    cache = {"pos": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.family != "ssm":
        w = attn_cache_len(cfg, seq_len, local=cfg.family == "hybrid"
                           or T.local_global(cfg))
        cache.update(k=kvbuf(n, w), v=kvbuf(n, w), kpos=kposbuf(w))
    if T.local_global(cfg):
        cache.update(k2=kvbuf(n, seq_len), v2=kvbuf(n, seq_len),
                     kpos2=kposbuf(seq_len))
    if T.first_k_dense(cfg):
        npre = T.first_k_dense(cfg)
        cache.update(k_pre=kvbuf(npre, seq_len), v_pre=kvbuf(npre, seq_len))
    if cfg.family in ("ssm", "hybrid"):
        one = ssm.init_ssm_cache(batch, cfg.d_model, cfg.ssm, dtype=dt,
                                 device=device)
        cache.update({k: t.new_zeros((n,) + tuple(t.shape))
                      for k, t in one.items()})
    return cache


def _at(buf, i: int):
    """Layer i of a cache buffer (a tensor, or ``Shards`` of the ranks')."""
    return buf.at(i) if isinstance(buf, TP.Shards) else buf[i]


# ----------------------------------------------------------------- decode
def _decode_one(o, q, k, v, kc, vc, kpos, slot, qpos, cfg: ArchConfig, *,
                window):
    kc.index_copy_(1, slot, k.to(kc.dtype))
    vc.index_copy_(1, slot, v.to(vc.dtype))
    out = L.decode_attention(
        q, kc, vc, q_position=qpos,
        k_positions=kpos[None].expand(q.shape[0], -1), window=window,
        attn_softcap=cfg.attn_logit_softcap)
    return torch.einsum("bshk,hkd->bsd", out, o.to(q.dtype))


def _attend_decode(p, x, kc, vc, kpos, slot, cfg: ArchConfig, positions, *,
                   window):
    """x (B, 1, d); kc/vc (B, C, KV, hd), written at ``slot`` in place;
    kpos (C,) with the slot already holding the new position. Split
    heads: each rank on its heads and its cache (``Shards``), the
    partials ``reduce_sum``'d onto x's device."""
    q, k, v = T.project_qkv(p, x, cfg, positions)
    qpos = T.token_positions(positions)[:, 0]
    if not isinstance(q, TP.Shards):
        return _decode_one(p["o"], q, k, v, kc, vc, kpos, slot, qpos, cfg,
                           window=window)
    parts = [_decode_one(*args, cfg, window=window) for args in zip(
        p["o"], q, k, v, kc, vc, TP.broadcast(kpos, q),
        TP.broadcast(slot, q), TP.broadcast(qpos, q))]
    return TP.reduce_sum(parts, x.device, q.tp)


def _ssd_decode(p, h, cache: Cache, i: int, cfg: ArchConfig):
    """Layer i's SSD step of its normed input h (B, 1, d); its conv tails
    and state are updated in place."""
    y, new = ssm.ssd_decode(p["ssm"], h, {k: cache[k][i] for k in SSM_KEYS},
                            cfg.d_model, cfg.ssm)
    for k in SSM_KEYS:
        cache[k][i].copy_(new[k])
    return y


def _ring_slot(cache: Cache, key: str, pos, qpos):
    """(the ring ``key``'s kpos, the new token's slot pos % C), that slot
    of kpos already holding the new position; (None, None) without the
    ring. The new token's own slot is attendable in every layer; the
    reference writes the same value into the cache-level kpos after the
    stack."""
    kpos = cache.get(key)
    if kpos is None:
        return None, None
    slot = (pos.long() % kpos.shape[0]).reshape(1)
    kpos.index_copy_(0, slot, qpos[0, :1].to(kpos.dtype))
    return kpos, slot


def decode_step(params, batch, cache: Cache, cfg: ArchConfig, mesh=None
                ) -> Tuple[torch.Tensor, Cache]:
    """One token for the whole stack. batch: tokens (B, 1) or embeddings
    (B, 1, F), positions (B, 1) or (B, 1, 3). Returns (logits (B, V)
    float32, cache). ``mesh``: the mesh the parameters and the cache
    (``prefill``'s) are placed on."""
    T.check_supported(cfg)
    TP.check_placed(params, serving_plan(cfg, mesh))
    x = T.embed_input(params, batch, cfg)
    positions = batch["positions"]
    pos = cache["pos"]
    qpos = T.token_positions(positions)
    kpos, slot = _ring_slot(cache, "kpos", pos, qpos)
    kpos2, slot2 = _ring_slot(cache, "kpos2", pos, qpos)
    pre_cfg = T.dense_config(cfg)
    for i in range(T.first_k_dense(cfg)):
        p = T.layer(params, i, "prelayers")
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        a = _attend_decode(p, h, _at(cache["k_pre"], i),
                           _at(cache["v_pre"], i), kpos, slot, pre_cfg,
                           positions, window=None)
        x = T.finish_layer(p, x, a, pre_cfg)
    window = T.window_of(cfg)
    for i in range(T.scan_len(cfg)):
        p = T.layer(params, i)
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        if cfg.family == "ssm":
            x = x + _ssd_decode(p, h, cache, i, cfg)
            continue
        a = _attend_decode(p, h, _at(cache["k"], i), _at(cache["v"], i),
                           kpos, slot, cfg, positions, window=window)
        if cfg.family == "hybrid":
            x = T.finish_hybrid_layer(p, x, a, _ssd_decode(p, h, cache, i,
                                                           cfg), cfg)
        elif cfg.family == "moe":
            x, _ = T.finish_moe_layer(p, x, a, cfg, decode=True)
        else:
            x = T.finish_layer(p, x, a, cfg)
        if kpos2 is not None:
            p = T.layer(params, i, "layers2")
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            a = _attend_decode(p, h, _at(cache["k2"], i),
                               _at(cache["v2"], i), kpos2, slot2, cfg,
                               positions, window=None)
            x = T.finish_layer(p, x, a, cfg)
    new = dict(cache)
    new["pos"] = pos + 1
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return T.logits_of(params, x[:, 0], cfg), new


# ---------------------------------------------------------------- prefill
def _write_kv(kc, vc, k, v, s: int) -> None:
    """A layer's prompt keys and values into its cache (B, C, KV, hd):
    the last C when C <= S, else the first S slots (the tail stays zero:
    empty slots). Each rank's into its own (``Shards``)."""
    if isinstance(kc, TP.Shards):
        for args in zip(kc, vc, k, v):
            _write_kv(*args, s)
        return
    wlen = kc.shape[1]
    if wlen <= s:
        kc.copy_(k[:, s - wlen:])
        vc.copy_(v[:, s - wlen:])
    else:
        kc[:, :s].copy_(k)
        vc[:, :s].copy_(v)


def prefill(params, batch, cfg: ArchConfig, extra_slots: int = 0,
            mesh=None) -> Tuple[torch.Tensor, Cache]:
    """Full-context forward that also builds the decode cache.
    ``extra_slots`` reserves cache capacity for later decode tokens (with
    0, decode ring-evicts the oldest entries). ``mesh``: the mesh the
    parameters are placed on (``tensor_parallel.shard_params`` with
    ``serving_plan(cfg, mesh)``); the cache is placed to match, and moe
    routes each of its dp shards' rows apart; without a mesh the cache
    follows the parameters' own placement (``tensor_parallel.plan_of``).
    Returns (last-position logits (B, V) float32, cache)."""
    T.check_supported(cfg)
    plan = serving_plan(cfg, mesh)
    TP.check_placed(params, plan)
    if mesh is None:
        plan = TP.plan_of(params, cfg)
    dp = dp_shards(mesh)
    x = T.embed_input(params, batch, cfg)
    positions = batch["positions"]
    tpos = T.token_positions(positions)[0]
    b, s = x.shape[:2]
    cache = init_cache(cfg, b, s + extra_slots, device=x.device, plan=plan)
    pre_cfg = T.dense_config(cfg)
    for i in range(T.first_k_dense(cfg)):
        p = T.layer(params, i, "prelayers")
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = T.project_qkv(p, h, cfg, positions)
        _write_kv(_at(cache["k_pre"], i), _at(cache["v_pre"], i), k, v, s)
        a = T.attend_qkv(p, q, k, v, pre_cfg, tpos, window=None)
        x = T.finish_layer(p, x, a, pre_cfg)
    window = T.window_of(cfg)

    def ssd(p, h, i):
        y, st = ssm.ssd_prefill(p["ssm"], h, cfg.d_model, cfg.ssm)
        for k in SSM_KEYS:
            cache[k][i].copy_(st[k])
        return y

    for i in range(T.scan_len(cfg)):
        p = T.layer(params, i)
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        if cfg.family == "ssm":
            x = x + ssd(p, h, i)
            continue
        q, k, v = T.project_qkv(p, h, cfg, positions)
        _write_kv(_at(cache["k"], i), _at(cache["v"], i), k, v, s)
        a = T.attend_qkv(p, q, k, v, cfg, tpos, window=window)
        if cfg.family == "hybrid":
            x = T.finish_hybrid_layer(p, x, a, ssd(p, h, i), cfg)
        elif cfg.family == "moe":
            x, _ = T.finish_moe_layer(p, x, a, cfg, dp=dp)
        else:
            x = T.finish_layer(p, x, a, cfg)
        if T.local_global(cfg):
            p = T.layer(params, i, "layers2")
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            q, k, v = T.project_qkv(p, h, cfg, positions)
            _write_kv(_at(cache["k2"], i), _at(cache["v2"], i), k, v, s)
            a = T.attend_qkv(p, q, k, v, cfg, tpos, window=None)
            x = T.finish_layer(p, x, a, cfg)

    last = tpos[-1].to(torch.int32)
    for key, ring in (("kpos", "k"), ("kpos2", "k2")):
        if key not in cache:
            continue
        buf = cache[ring]
        wlen = (buf[0] if isinstance(buf, TP.Shards) else buf).shape[2]
        valid = min(s, wlen)
        slots = torch.arange(wlen, dtype=torch.int32, device=x.device)
        cache[key] = torch.where(slots < valid, last - valid + 1 + slots,
                                 torch.full_like(slots, -1))
    cache["pos"] = last + 1
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return T.logits_of(params, x[:, -1], cfg), cache
