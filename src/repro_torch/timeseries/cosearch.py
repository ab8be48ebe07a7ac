"""Streaming co-search orchestration (DESIGN.md §14): sensor windows ->
featurized variants -> joint front-end + ADC + classifier search.
Counterpart of ``repro/timeseries/cosearch.py``.

* ``build_search_inputs`` turns raw sliding windows into the co-search
  data contract: the (V, M, C_feat) variant stacks (one featurized view
  per subsample factor, through ``feature.featurize_fn``) and a
  per-channel ``AdcSpec`` auto-ranged over every variant
  (``AdcSpec.from_data``), so each feature channel's range covers all
  searched sample rates;
* ``embed_adc_only`` lifts an ADC-only front into the co-search genome
  space (full-rate, full-allocation feature genes): at those points the
  co-search fitness equals the ADC-only fitness bit for bit;
* ``run`` drives ``search.run_search`` end to end on ``device`` (default
  ``cuda``) and returns everything deployment needs.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import search as search_lib
from repro_torch.core.spec import AdcSpec
from repro_torch.device import DeviceLike
from repro_torch.timeseries import feature as feature_lib
from repro_torch.timeseries.feature import FeatureSpec


def build_search_inputs(data: Dict, fe: FeatureSpec, *, bits: int,
                        pct: float = 0.5, hidden: int = 4,
                        device: DeviceLike = None
                        ) -> Tuple[Dict, Tuple[int, int, int], AdcSpec]:
    """Raw sliding-window splits (x_* of shape (M, W, C_raw), from
    ``make_stream``) -> (variant data (numpy), sizes, auto-ranged
    AdcSpec). The variants are featurized on ``device`` (default
    ``cuda``). The spec's per-channel vmin/vmax are the percentiles of
    the stacked train variants: one feature channel's range must cover
    its values at every subsample factor the genome can pick."""
    xv_tr = feature_lib.stack_variants(data["x_train"], fe, device=device)
    xv_te = feature_lib.stack_variants(data["x_test"], fe, device=device)
    spec = AdcSpec.from_data(xv_tr.reshape(-1, xv_tr.shape[-1]),
                             bits=bits, pct=pct)
    vdata = {"x_train": xv_tr, "y_train": np.asarray(data["y_train"]),
             "x_test": xv_te, "y_test": np.asarray(data["y_test"])}
    classes = int(np.asarray(data["y_train"]).max()) + 1
    sizes = (fe.feature_channels, int(hidden), classes)
    return vdata, sizes, spec


def embed_adc_only(genomes: np.ndarray, fe: FeatureSpec) -> np.ndarray:
    """(K, G_base) ADC-only genomes -> (K, G_base + gene_bits) co-search
    genomes whose feature genes encode the reference front end: full
    sample rate (sub index 0) and full allocation on every feature
    channel. At these points the co-search fitness equals the ADC-only
    fitness (same masks, same variant-0 data), which makes the
    ε-dominance of a co-search seeded with them provable."""
    genomes = np.asarray(genomes, np.uint8)
    tail = feature_lib.encode_genes(fe)
    return np.concatenate(
        [genomes, np.tile(tail, (len(genomes), 1))], axis=1)


def run(data: Dict, fe: FeatureSpec, *, bits: int = 3, pct: float = 0.5,
        hidden: int = 4, init: Optional[np.ndarray] = None, log=None,
        device: DeviceLike = None, mesh=None, **cfg_kw):
    """End-to-end streaming co-search on ``device`` (default ``cuda``):
    build the variant inputs, run the configured engine over the
    extended genome, return ``(pareto_genomes, fitness, decode, trained,
    cfg, vdata, sizes, spec)``, everything ``core.deploy.export_front``
    and the facade need. ``cfg_kw`` mirrors SearchConfig (pop_size,
    generations, train_steps, engine, seed, ...); ``init`` seeds the
    population (e.g. an ``embed_adc_only`` front); ``mesh`` feeds the
    sharded engine (``engine='sharded'``), whose inputs are built on the
    mesh's first device."""
    device = search_lib.search_device(cfg_kw.get("engine", "batched"),
                                      device, mesh)
    vdata, sizes, spec = build_search_inputs(data, fe, bits=bits, pct=pct,
                                             hidden=hidden, device=device)
    cfg = search_lib.SearchConfig.for_spec(spec, frontend=fe.base(),
                                           **cfg_kw)
    pg, pf, decode, trained = search_lib.run_search(
        vdata, sizes, cfg, log=log, return_trained=True, init=init,
        device=device, mesh=mesh)
    return pg, pf, decode, trained, cfg, vdata, sizes, spec
