"""Named entry points of the hand-written kernels. Counterpart of
``repro/kernels/ops.py``.

``adc_quantize`` / ``adc_quantize_population`` take pruned masks, bake
their value tables and run the population quantizer (the search's inner
loop); ``adc_quantize_variants`` runs it over the streaming co-search's
(V, M, C) variant stack in one launch. ``classifier_bank`` takes baked
value tables, as deployment holds them; ``bespoke_mlp`` /
``bespoke_svm`` take a pruned mask and bake its table first. ``mc_eval`` / ``mc_eval_population`` / ``mc_eval_cal`` /
``mc_eval_cal_population`` take the operand tuple
``(lb, ub, values, lo, scale)`` that core/nonideal.mc_operands (or
faulttol/calibrate.mc_operands_ft) compiles and run the Monte-Carlo
kernel. ``flash_attention`` runs an attention kernel (the LM's prefill
attention; tensor cores for bf16 at the configs' head widths, CUDA cores
otherwise); ``flash_attention_bwd`` its backward kernel, and ``attention``
the two as one differentiable call (the LM's prefill and training). Routing (kernel on a CUDA tensor inside the envelope, plain
version on a CPU tensor, ValueError otherwise) is kernels/dispatch's,
applied inside the kernel wrappers. Each kernel entry takes an optional
``block_m``, the kernel's tile (kernels/envelope.py); None leaves it to
the tuned table and the heuristic (kernels/dispatch.py).

``adc_quantize_population_sharded`` / ``classifier_bank_sharded`` split
the leading population or design axis over a ``launch.mesh.Mesh``
(``distributed/sharding``'s rules and ``shard_plan``): x replicates, one
copy per distinct device; each shard gets only its slice, launches the
same kernel on its own device, in mesh order from the calling thread;
the outputs gather in shard order onto the mesh's first device. When no
rule divides the leading axis the unsharded entry runs on the first
device, with the same results. They add no kernel: they place work.
"""
from __future__ import annotations

import torch

from repro_torch.core.spec import AdcSpec, as_spec
from repro_torch.distributed import sharding
from repro_torch.kernels import adc_quantize as _adcq
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mc_eval as _mc
from repro_torch.kernels import qmlp


def adc_quantize(x: torch.Tensor, mask, *, spec: AdcSpec,
                 block_m=None) -> torch.Tensor:
    """Quantize (M, C) samples through per-channel pruned binary-search
    ADCs, mask (C, 2^bits). Returns (M, C)."""
    spec = as_spec(spec)
    table = spec.value_table(torch.as_tensor(mask, device=x.device))
    return _adcq.adc_quantize(x, table.contiguous(), spec=spec,
                              block_m=block_m)


def adc_quantize_population(x: torch.Tensor, masks, *, spec: AdcSpec,
                            block_m=None) -> torch.Tensor:
    """Quantize one shared (M, C) sample batch through a whole population
    of pruned ADC banks, masks (P, C, 2^bits), in one launch. Returns
    (P, M, C)."""
    spec = as_spec(spec)
    tables = spec.value_table(torch.as_tensor(masks, device=x.device))
    return _adcq.adc_quantize_population(x, tables.contiguous(), spec=spec,
                                         block_m=block_m)


def adc_quantize_variants(xv: torch.Tensor, masks, *,
                          spec: AdcSpec) -> torch.Tensor:
    """``adc_quantize_population`` over a variant-stacked sample batch:
    xv (V, M, C), one featurized variant per subsample factor of the
    streaming co-search, through a population of pruned banks, masks
    (P, C, 2^bits). Returns (P, V, M, C); the caller gathers each
    individual's variant. The ADC is elementwise over samples, so (V, M)
    reshaped into one flat sample axis is one launch of the population
    quantizer, and quantize-then-gather equals gather-then-quantize."""
    v, m, c = xv.shape
    q = adc_quantize_population(xv.reshape(v * m, c), masks, spec=spec)
    return q.reshape(q.shape[0], v, m, c)


def adc_quantize_population_sharded(x: torch.Tensor, masks, *, mesh,
                                    spec: AdcSpec, axes=None
                                    ) -> torch.Tensor:
    """``adc_quantize_population`` with the population axis split over
    ``mesh``: each shard receives only its (P/n, C, 2^bits) mask slice,
    bakes value tables for that slice alone and launches the population
    quantizer on its device. ``axes`` defaults to
    ``sharding.population_axes``. Returns (P, M, C) on the mesh's first
    device."""
    spec = as_spec(spec)
    masks = torch.as_tensor(masks)
    p = masks.shape[0]
    plan = sharding.shard_plan(
        mesh, sharding.population_axes(mesh, p) if axes is None else axes, p)
    return _gather([adc_quantize_population(x.to(dev), masks[sl].to(dev),
                                            spec=spec) for dev, sl in plan])


def _gather(outs) -> torch.Tensor:
    """Per-shard outputs concatenated in shard order on the first
    shard's device (the mesh's first device)."""
    if len(outs) == 1:
        return outs[0]
    first = outs[0].device
    return torch.cat([o.to(first) for o in outs])


def bank_shards(tables, weights, *, mesh, axes=None) -> list:
    """A bank's operands placed for ``mesh``: ``[(device, tables_k,
    weights_k), ...]`` in shard order, each slice contiguous on its
    device; one entry holding the whole bank on the first device when
    no rule divides D. ``axes`` defaults to
    ``sharding.design_bank_axes``."""
    tables = torch.as_tensor(tables)
    weights = tuple(torch.as_tensor(w) for w in weights)
    d = tables.shape[0]
    plan = sharding.shard_plan(
        mesh, sharding.design_bank_axes(mesh, d) if axes is None else axes,
        d)
    return [(dev, tables[sl].to(dev).contiguous(),
             tuple(w[sl].to(dev).contiguous() for w in weights))
            for dev, sl in plan]


def classifier_bank_shards(x: torch.Tensor, shards, *, kind: str,
                           spec: AdcSpec) -> torch.Tensor:
    """One shared (M, C) batch through a bank placed by ``bank_shards``:
    one bank launch per shard on its device, the (D_k, M, O) logits
    gathered in shard order onto the first shard's device."""
    return _gather([classifier_bank(x.to(dev), t, w, kind=kind, spec=spec)
                    for dev, t, w in shards])


def classifier_bank_sharded(x: torch.Tensor, tables, weights, *, mesh,
                            kind: str, spec: AdcSpec, axes=None
                            ) -> torch.Tensor:
    """``classifier_bank`` with the design axis split over ``mesh``: each
    shard holds only its (D/n, ...) slice of tables and weights and
    serves the shared batch against it. Returns (D, M, O) on the mesh's
    first device."""
    return classifier_bank_shards(
        x, bank_shards(tables, weights, mesh=mesh, axes=axes), kind=kind,
        spec=spec)


def classifier_bank(x: torch.Tensor, tables: torch.Tensor, weights, *,
                    kind: str, spec: AdcSpec, rows=None,
                    block_m=None) -> torch.Tensor:
    """One shared (M, C) batch through a deployed multi-design bank.

    tables: (D, C, 2^bits) baked value tables; weights: stacked
    ``(w1, b1, w2, b2)`` for kind='mlp' or ``(w, b)`` for kind='svm'.
    ``rows``: optional prebuilt (vmin, scale) range rows on x's device.
    Returns (D, M, O) logits."""
    spec = as_spec(spec)
    if kind == "mlp":
        return qmlp.bespoke_mlp_bank(x, tables, *weights, spec=spec,
                                     rows=rows, block_m=block_m)
    if kind == "svm":
        return qmlp.bespoke_svm_bank(x, tables, *weights, spec=spec,
                                     rows=rows, block_m=block_m)
    raise ValueError(f"unknown classifier kind {kind!r}")


def bespoke_mlp(x, mask, w1, b1, w2, b2, *, spec: AdcSpec,
                block_m=None) -> torch.Tensor:
    """Fused ADC + 1-hidden-layer printed MLP on one design, from its
    pruned mask (C, 2^bits). Returns (M, O)."""
    spec = as_spec(spec)
    table = spec.value_table(torch.as_tensor(mask, device=x.device))
    return qmlp.bespoke_mlp(x, table, w1, b1, w2, b2, spec=spec,
                            block_m=block_m)


def bespoke_svm(x, mask, w, b, *, spec: AdcSpec,
                block_m=None) -> torch.Tensor:
    """Fused ADC + linear SVM on one design, from its pruned mask."""
    spec = as_spec(spec)
    table = spec.value_table(torch.as_tensor(mask, device=x.device))
    return qmlp.bespoke_svm(x, table, w, b, spec=spec, block_m=block_m)


def mc_eval(x, lb, ub, values, lo, scale, *, spec: AdcSpec,
            block_m=None) -> torch.Tensor:
    """S perturbed instances of one design: lb/ub (S, C, 2^N), values
    (C, 2^N), lo/scale (S, C) -> (S, M, C)."""
    as_spec(spec).validate_channels(x.shape[-1])
    return _mc.mc_adc_eval(x, lb, ub, values, lo, scale, block_m=block_m)


def mc_eval_population(x, lb, ub, values, lo, scale, *, spec: AdcSpec,
                       block_m=None) -> torch.Tensor:
    """S perturbed instances of P designs, draws shared: lb/ub
    (P, S, C, 2^N) -> (P, S, M, C)."""
    as_spec(spec).validate_channels(x.shape[-1])
    return _mc.mc_adc_eval_population(x, lb, ub, values, lo, scale,
                                      block_m=block_m)


def mc_eval_cal(x, lb, ub, values, lo, scale, *, spec: AdcSpec,
                block_m=None) -> torch.Tensor:
    """Calibrated tables, one design: values (S, C, 2^N) -> (S, M, C)."""
    as_spec(spec).validate_channels(x.shape[-1])
    return _mc.mc_adc_eval_cal(x, lb, ub, values, lo, scale,
                               block_m=block_m)


def mc_eval_cal_population(x, lb, ub, values, lo, scale, *, spec: AdcSpec,
                           block_m=None) -> torch.Tensor:
    """Calibrated tables, P designs: lb/ub/values (P, S, C, 2^N) ->
    (P, S, M, C)."""
    as_spec(spec).validate_channels(x.shape[-1])
    return _mc.mc_adc_eval_cal_population(x, lb, ub, values, lo, scale,
                                          block_m=block_m)


def flash_attention(q, k, v, q_positions, k_positions, *, causal=True,
                    window: int = 0, attn_softcap: float = 0.0
                    ) -> torch.Tensor:
    """Causal / sliding-window / softcapped GQA attention: q (B, S, H, dh),
    k/v (B, Sk, KV, dh), int32 positions (S,) / (Sk,) -> (B, S, H, dh)."""
    return _fa.flash_attention(q, k, v, q_positions, k_positions,
                               causal=causal, window=window,
                               attn_softcap=attn_softcap)


def flash_attention_bwd(q, k, v, dout, q_positions, k_positions, *,
                        causal=True, window: int = 0,
                        attn_softcap: float = 0.0):
    """(dq, dk, dv) of ``flash_attention`` for the cotangent dout of its
    output: the backward kernel, three launches on the card."""
    return _fa.flash_attention_bwd(q, k, v, dout, q_positions, k_positions,
                                   causal=causal, window=window,
                                   attn_softcap=attn_softcap)


def attention(q, k, v, q_positions, k_positions, *, causal=True,
              window: int = 0, attn_softcap: float = 0.0) -> torch.Tensor:
    """``flash_attention`` with ``flash_attention_bwd`` as its autograd
    backward."""
    return _fa.attention(q, k, v, q_positions, k_positions, causal=causal,
                         window=window, attn_softcap=attn_softcap)
