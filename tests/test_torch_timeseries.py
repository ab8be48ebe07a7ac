"""Port parity, the streaming co-design slice: repro_torch.timeseries
(stream, feature, cosearch), core.area.frontend_tc, ops.adc_quantize_variants,
the co-search genome in core.search (decode, areas, the batched,
reference and gradient engines, the baseline, checkpoint/resume),
feature-baked fronts in core.deploy and api.cosearch, against the JAX
package on the CPU at small sizes (the stress stream cut to 150 train and
80 test windows, FeatureSpec(4, 32): 16 feature channels, 2-bit ADC,
hidden 4, pop <= 8, <= 30 QAT steps).

What is bitwise and what is not:

* make_stream, FeatureSpec (validation messages, meta, geometry), the gene
  codec, the front-end transistor counts, co-search decode and the area
  column: bitwise (numpy copies and integer work).
* featurize and stack_variants: bitwise on both streams at every sub_grid
  factor. The reference's jitted mean is a left-to-right float32 sum times
  float32(1/count) and its slope (last - first) times float32(1/span);
  torch.mean and a true division are shown to differ, so the comparison
  can fail.
* The accuracy column against the reference, both packages trained from
  the reference's initial weights: within 2 test samples per individual
  (the cross-package QAT rule of tests/test_torch_search.py).
* Inside the port, bitwise: batched engine == reference engine, the
  embedded ADC-only front == its ADC-only fitness, search fitness ==
  re-trained == exported == served accuracy on raw windows, before and
  after save/load, and a killed co-search resumed == uninterrupted.
* A front the JAX package co-searched, exported and saved serves in the
  port at exactly its recorded accuracies.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import area as jarea  # noqa: E402
from repro.core import deploy as jdeploy  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.timeseries import cosearch as jcosearch  # noqa: E402
from repro.timeseries import feature as jfeature  # noqa: E402
from repro.timeseries import stream as jstream  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.checkpoint import manager as tmanager  # noqa: E402
from repro_torch.core import area as tarea  # noqa: E402
from repro_torch.core import deploy as tdeploy  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core.spec import AdcSpec  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.timeseries import cosearch as tcosearch  # noqa: E402
from repro_torch.timeseries import feature as tfeature  # noqa: E402
from repro_torch.timeseries import stream as tstream  # noqa: E402
from repro_torch.timeseries.feature import FeatureSpec  # noqa: E402

CPU = "cpu"
STREAMS = {"stress": (4, 32), "vitals": (6, 24)}
FE = FeatureSpec(channels=4, window=32)
JFE = jfeature.FeatureSpec(channels=4, window=32)
BITS = 2
SIZES = (16, 4, 3)
KW = dict(pop_size=8, generations=2, train_steps=30, seed=0)


@pytest.fixture(scope="module")
def streams():
    return {name: jstream.make_stream(name) for name in STREAMS}


@pytest.fixture(scope="module")
def sliced(streams):
    d = streams["stress"]
    return {"x_train": d["x_train"][:150], "y_train": d["y_train"][:150],
            "x_test": d["x_test"][:80], "y_test": d["y_test"][:80]}


@pytest.fixture(scope="module")
def inputs(sliced):
    """The co-search data contract of the cut stream: (vdata, sizes,
    spec), built by the port on the CPU."""
    return tcosearch.build_search_inputs(sliced, FE, bits=BITS, device=CPU)


@pytest.fixture(scope="module")
def trun(sliced):
    """The port's co-search of the cut stream on the CPU."""
    return tcosearch.run(sliced, FE, bits=BITS, device=CPU, **KW)


def _genomes(rng, p, bits=BITS, fe=FE):
    """Random co-search genomes: every subsample index, every alloc rung
    (0 included), the full design first."""
    c = fe.feature_channels
    g = (rng.random((p, tsearch.genome_len(c, bits, frontend=fe))) < 0.6
         ).astype(np.uint8)
    g[0] = 1
    base = c * 2 ** bits + tsearch.DP_BITS
    for i in range(p):
        g[i, base:] = tfeature.encode_genes(
            fe, i % len(fe.sub_grid), rng.integers(0, 4, c))
    g[0, base:] = tfeature.encode_genes(fe)
    return g


# ----------------------------------------------------------------- stream
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_make_stream_is_bitwise(streams, name):
    assert tstream.stream_names() == jstream.stream_names()
    assert vars(tstream.SPECS[name]) == vars(jstream.SPECS[name])
    for seed in (0, 3):
        want = jstream.make_stream(name, seed) if seed else streams[name]
        got = tstream.make_stream(name, seed)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


# ------------------------------------------------------------ FeatureSpec
BAD_SPECS = {
    "unknown kind": dict(channels=2, window=16, features=("mean", "fft")),
    "duplicate kind": dict(channels=2, window=16, features=("mean", "mean")),
    "odd factor": dict(channels=2, window=16, sub_grid=(1, 3)),
    "window": dict(channels=2, window=12, sub_grid=(1, 8)),
    "grid start": dict(channels=2, window=16, sub_grid=(2, 4)),
    "grid order": dict(channels=2, window=16, sub_grid=(1, 4, 2, 8)),
    "grid length": dict(channels=2, window=16, sub_grid=(1, 2, 4)),
    "channels": dict(channels=0, window=16),
    "no features": dict(channels=2, window=16, features=()),
    "baked factor": dict(channels=2, window=16, subsample=3),
    "alloc length": dict(channels=2, window=16, subsample=2, alloc=(3,)),
    "alloc range": dict(channels=1, window=16, subsample=2,
                        alloc=(3, 3, 4, 0)),
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_feature_spec_refuses_with_the_reference_message(case):
    kw = BAD_SPECS[case]
    with pytest.raises(ValueError) as want:
        jfeature.FeatureSpec(**kw)
    with pytest.raises(ValueError) as got:
        FeatureSpec(**kw)
    assert str(got.value) == str(want.value)


def test_feature_spec_meta_round_trips_across_packages():
    import json
    for t, j in [(FE, JFE),
                 (FE.bake(4, [3, 0, 1, 2] * 4),
                  JFE.bake(4, [3, 0, 1, 2] * 4)),
                 (FeatureSpec(6, 24, features=("max", "slope"),
                              sub_grid=(1, 4)),
                  jfeature.FeatureSpec(6, 24, features=("max", "slope"),
                                       sub_grid=(1, 4)))]:
        assert t.to_meta() == j.to_meta()
        assert json.dumps(t.to_meta()) == json.dumps(j.to_meta())
        back = jfeature.FeatureSpec.from_meta(json.loads(json.dumps(
            t.to_meta())))
        assert back == j
        assert FeatureSpec.from_meta(json.loads(json.dumps(
            j.to_meta()))) == t
        assert t.describe() == j.describe()
        assert (t.feature_channels, t.sub_bits, t.gene_bits) == (
            j.feature_channels, j.sub_bits, j.gene_bits)
        assert t.base().to_meta() == j.base().to_meta()
        assert hash(t) == hash(FeatureSpec.from_meta(t.to_meta()))


# -------------------------------------------------------------- featurize
FACTORS = [(name, s) for name in sorted(STREAMS) for s in (1, 2, 4, 8)]


@pytest.mark.parametrize("name, s", FACTORS)
def test_featurize_is_bitwise(streams, name, s):
    c, w = STREAMS[name]
    tfe, jfe = FeatureSpec(c, w), jfeature.FeatureSpec(c, w)
    for split in ("x_train", "x_test"):
        x = streams[name][split]
        want = np.asarray(jfeature.featurize_fn(jfe, s)(x))
        got = tfeature.featurize_fn(tfe, s)(x, device=CPU)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
        # a tensor stays on its own device; the callable is cached
        again = tfeature.featurize_fn(tfe.bake(s, [3] * 4 * c))(
            torch.from_numpy(x))
        np.testing.assert_array_equal(again.numpy(), want)
    assert tfeature.featurize_fn(tfe, s) is tfeature.featurize_fn(
        tfe.bake(s, [0] * 4 * c))


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_featurize_controls_differ(streams, name):
    """torch.mean and a true division do not give the reference's
    features: the bitwise comparison above can fail."""
    c, w = STREAMS[name]
    jfe = jfeature.FeatureSpec(c, w)
    mean_off = slope_off = 0
    for s in jfe.sub_grid:
        x = streams[name]["x_train"]
        want = np.asarray(jfeature.featurize_fn(jfe, s)(x))
        xs = torch.from_numpy(x)[:, ::s]
        w_s = xs.shape[1]
        mean_off += int((xs.mean(1).numpy() != want[:, :c]).sum())
        slope = ((xs[:, -1] - xs[:, 0]) / float(s * (w_s - 1))).numpy()
        slope_off += int((slope != want[:, 3 * c:]).sum())
    assert mean_off > 0 and slope_off > 0


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stack_variants_is_bitwise(streams, name):
    c, w = STREAMS[name]
    x = streams[name]["x_test"]
    want = jfeature.stack_variants(x, jfeature.FeatureSpec(c, w))
    got = tfeature.stack_variants(x, FeatureSpec(c, w), device=CPU)
    assert got.dtype == np.float32 and got.shape == (4, len(x), 4 * c)
    np.testing.assert_array_equal(got, want)


def test_encode_genes_and_frontend_costs_are_bitwise():
    rng = np.random.default_rng(5)
    assert tarea.SAMPLE_HOLD_TC == jarea.SAMPLE_HOLD_TC
    assert tarea.FEATURE_TC == jarea.FEATURE_TC
    for tfe, jfe in [(FE, JFE), (FeatureSpec(6, 24),
                                 jfeature.FeatureSpec(6, 24)),
                     (FeatureSpec(3, 8, features=("min", "slope"),
                                  sub_grid=(1, 2)),
                      jfeature.FeatureSpec(3, 8, features=("min", "slope"),
                                           sub_grid=(1, 2)))]:
        assert tfeature.frontend_full_tc(tfe) == jfeature.frontend_full_tc(
            jfe)
        for i in range(len(tfe.sub_grid)):
            for alloc in (None, rng.integers(0, 4, tfe.feature_channels),
                          [0] * tfe.feature_channels):
                np.testing.assert_array_equal(
                    tfeature.encode_genes(tfe, i, alloc),
                    jfeature.encode_genes(jfe, i, alloc))
                s = tfe.sub_grid[i]
                got = tfeature.frontend_tc(tfe, s, alloc)
                assert got == jfeature.frontend_tc(jfe, s, alloc)
                assert type(got) is int
                assert tarea.frontend_tc(tfe.features, tfe.channels,
                                         tfe.window, s, alloc) == got
    with pytest.raises(ValueError, match="sub_index"):
        tfeature.encode_genes(FE, 4)
    for bad in [dict(subsample=3), dict(alloc=[1] * 3)]:
        kw = dict(dict(subsample=2, alloc=None), **bad)
        with pytest.raises(ValueError) as want:
            jarea.frontend_tc(JFE.features, 4, 32, **kw)
        with pytest.raises(ValueError) as got:
            tarea.frontend_tc(FE.features, 4, 32, **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------- genome decode
@pytest.mark.parametrize("bits", [2, 3])
def test_decode_and_areas_are_bitwise(bits):
    rng = np.random.default_rng(20 + bits)
    g = _genomes(rng, 24, bits)
    g[1, :16 * 2 ** bits] = 0                   # every channel repaired
    c = FE.feature_channels
    assert tsearch.genome_len(c, bits, frontend=FE) == jsearch.genome_len(
        c, bits, JFE)
    tm, td, ts, ta = tsearch.decode_population_cosearch(g, c, bits, 2, FE)
    jm, jd, js, ja = jsearch.decode_population_cosearch(
        jax.numpy.asarray(g), c, bits, 2, JFE)
    for got, want in ((tm, jm), (td, jd), (ts, js), (ta, ja)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.numpy().dtype == np.asarray(want).dtype
    assert (ta == 0).any() and len(set(ts.tolist())) == 4
    m1, d1, s1, a1 = tsearch.decode_genome_cosearch(g[3], c, bits, 2, FE)
    np.testing.assert_array_equal(m1.numpy(), np.asarray(jm[3]))
    assert (float(d1), int(s1)) == (float(jd[3]), int(js[3]))
    for design in ("ours", "baseline", "flash"):
        tcfg = tsearch.SearchConfig(bits=bits, design=design, frontend=FE)
        jcfg = jsearch.SearchConfig(bits=bits, design=design, frontend=JFE)
        np.testing.assert_array_equal(
            tsearch.population_areas(g, c, tcfg),
            jsearch.population_areas(g, c, jcfg))


def test_adc_quantize_variants_is_bitwise(inputs):
    vdata, _, spec = inputs
    rng = np.random.default_rng(7)
    masks, _, sub, _ = tsearch.decode_population_cosearch(
        _genomes(rng, 6), 16, BITS, 2, FE)
    xv = torch.from_numpy(vdata["x_test"])
    got = tops.adc_quantize_variants(xv, masks, spec=spec)
    jspec = jsearch.AdcSpec(bits=BITS, vmin=spec.vmin, vmax=spec.vmax)
    want = jops.adc_quantize_variants(jax.numpy.asarray(vdata["x_test"]),
                                      jax.numpy.asarray(masks.numpy()),
                                      spec=jspec)
    assert got.shape == (6, 4, 80, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # quantize-then-gather == gather-then-quantize
    for p in range(6):
        one = tops.adc_quantize(xv[int(sub[p])], masks[p], spec=spec)
        np.testing.assert_array_equal(got[p, int(sub[p])].numpy(),
                                      one.numpy())


# -------------------------------------------------------------- fitness
def _reference_init(kind):
    params, _ = jsearch._init_model(SIZES, jsearch.SearchConfig(model=kind))
    params = jax.tree_util.tree_map(np.asarray, params)
    return tuple(params) if kind == "svm" else params


@pytest.mark.parametrize("kind", ["mlp", "svm"])
def test_fitness_matches_reference_within_two_samples(inputs, kind):
    vdata, sizes, spec = inputs
    g = _genomes(np.random.default_rng(11), 6)
    kw = dict(bits=BITS, pop_size=6, train_steps=20, model=kind)
    jcfg = jsearch.SearchConfig.for_spec(
        jsearch.AdcSpec(bits=BITS, vmin=spec.vmin, vmax=spec.vmax),
        frontend=JFE, **{k: v for k, v in kw.items() if k != "bits"})
    tcfg = tsearch.SearchConfig.for_spec(
        spec, frontend=FE, **{k: v for k, v in kw.items() if k != "bits"})
    want = jsearch.evaluate_population(g, vdata, sizes, jcfg)
    got = tsearch.evaluate_population(g, vdata, sizes, tcfg, device=CPU,
                                      init_params=_reference_init(kind))
    np.testing.assert_array_equal(got[:, 1], np.asarray(want)[:, 1])
    tol = 2.0 / len(vdata["y_test"]) + 1e-6
    assert np.abs(got[:, 0] - np.asarray(want)[:, 0]).max() <= tol


def test_batched_engine_equals_reference_engine(inputs):
    vdata, sizes, spec = inputs
    g = _genomes(np.random.default_rng(12), 5)
    cfg = tsearch.SearchConfig.for_spec(spec, frontend=FE, pop_size=4,
                                        train_steps=15)
    bat = tsearch.evaluate_population(g, vdata, sizes, cfg, device=CPU)
    ref = tsearch.evaluate_population_reference(g, vdata, sizes, cfg,
                                                device=CPU)
    np.testing.assert_array_equal(bat, ref)


def test_adc_only_embedding_scores_identically(trun, inputs):
    _, _, _, _, cfg, vdata, sizes, spec = trun
    data0 = {"x_train": vdata["x_train"][0], "y_train": vdata["y_train"],
             "x_test": vdata["x_test"][0], "y_test": vdata["y_test"]}
    cfg0 = tsearch.SearchConfig.for_spec(spec, **KW)
    bpg, bpf, _ = tsearch.run_search(data0, sizes, cfg0, device=CPU)
    emb = tcosearch.embed_adc_only(bpg, FE)
    np.testing.assert_array_equal(
        emb, jcosearch.embed_adc_only(bpg, JFE))
    ef = tsearch.evaluate_population(emb, vdata, sizes, cfg, device=CPU)
    np.testing.assert_array_equal(ef[:, 0], bpf[:, 0])
    flash = tarea.flash_full_tc(BITS) * sizes[0]
    full = tfeature.frontend_full_tc(FE)
    np.testing.assert_allclose(ef[:, 1] * (flash + full) - full,
                               bpf[:, 1] * flash, atol=1e-6)
    # the co-search seeded with the embedding ε-dominates the union front
    pg, pf, _ = tsearch.run_search(vdata, sizes, cfg, init=emb, device=CPU)
    _, uf = tsearch.nsga2.pareto_front(np.concatenate([emb, pg]),
                                       np.concatenate([ef, pf]))
    assert all(any(c[0] <= u[0] + 1e-9 and c[1] <= u[1] + 1e-9 for c in pf)
               for u in uf)


def test_config_takes_a_frontend_and_refuses_monte_carlo():
    cfg = tsearch.SearchConfig(frontend=FE)
    assert cfg.frontend == FE and hash(cfg)
    with pytest.raises(ValueError) as want:
        jsearch.SearchConfig(frontend=JFE, mc_samples=4)
    with pytest.raises(ValueError) as got:
        tsearch.SearchConfig(frontend=FE, mc_samples=4)
    assert str(got.value) == str(want.value)


def test_data_contract_is_checked(inputs):
    vdata, sizes, spec = inputs
    cfg = tsearch.SearchConfig.for_spec(spec, frontend=FE, **KW)
    flat = dict(vdata, x_train=vdata["x_train"][0])
    with pytest.raises(ValueError, match="stack one featurized variant"):
        tsearch.run_search(flat, sizes, cfg, device=CPU)
    wide = tsearch.SearchConfig.for_spec(spec, frontend=FeatureSpec(6, 24),
                                         **KW)
    with pytest.raises(ValueError, match="produces 24 feature channels"):
        tsearch.run_gradient_search(vdata, sizes, wide, device=CPU)


# ---------------------------------------------------- export and serving
def test_export_verify_serve_save_load_bitwise(trun, sliced, tmp_path):
    pg, pf, _, trained, cfg, vdata, sizes, _ = trun
    assert cfg.frontend == FE and sizes == SIZES
    assert pg.shape[1] == tsearch.genome_len(16, BITS, frontend=FE)
    designs = tdeploy.export_front(pg, vdata, sizes, cfg, trained=trained,
                                   device=CPU)
    np.testing.assert_array_equal(
        np.array([d.accuracy for d in designs]), 1.0 - pf[:, 0])
    assert tdeploy.verify_front_parity(designs, pg, vdata, sizes, cfg,
                                       device=CPU)
    for d in designs:
        assert d.feature is not None and d.feature.subsample in FE.sub_grid
        assert d.sample_shape == (FE.window, FE.channels)
    xw, y = sliced["x_test"], sliced["y_test"]
    served = tdeploy.served_accuracies(designs, xw, y, device=CPU)
    np.testing.assert_array_equal(served,
                                  np.array([d.accuracy for d in designs]))
    tdeploy.save_front(tmp_path, designs, extra_meta={"dataset": "stress"})
    meta = tdeploy.front_meta(tmp_path)
    assert FeatureSpec.from_meta(meta["feature"]) == FE
    loaded = tdeploy.load_front(tmp_path)
    assert [d.feature for d in loaded] == [d.feature for d in designs]
    np.testing.assert_array_equal(
        tdeploy.served_accuracies(loaded, xw, y, device=CPU), served)
    # the JAX package loads the port's front with its FeatureSpec
    jloaded = jdeploy.load_front(tmp_path)
    assert [d.feature.to_meta() for d in jloaded] == [
        d.feature.to_meta() for d in designs]


def test_mixed_subsample_front_serves_per_group(inputs, sliced):
    """Random genomes over every subsample factor: one bank per group,
    the logits scattered back into front order; each design served
    alone (D=1) and through the bank agree, and serving equals the
    export bitwise."""
    vdata, sizes, spec = inputs
    g = _genomes(np.random.default_rng(13), 6)
    cfg = tsearch.SearchConfig.for_spec(spec, frontend=FE, pop_size=6,
                                        train_steps=20)
    designs = tdeploy.export_front(g, vdata, sizes, cfg, device=CPU)
    groups = tdeploy._feature_groups(designs)
    assert sorted(groups) == [1, 2, 4, 8]
    xw, y = sliced["x_test"], sliced["y_test"]
    logits = tdeploy.serve_bank(designs, xw, device=CPU)
    assert logits.shape == (6, 80, 3)
    for i, d in enumerate(designs):
        np.testing.assert_array_equal(d.logits(xw, device=CPU).numpy(),
                                      logits[i].numpy())
        feat = tfeature.featurize_fn(d.feature)(xw, device=CPU)
        np.testing.assert_array_equal(d.logits(feat, device=CPU).numpy(),
                                      logits[i].numpy())
        want = tsearch.population_areas(g[i:i + 1], 16, cfg)[0] * (
            tarea.flash_full_tc(BITS) * 16 + tfeature.frontend_full_tc(FE))
        assert d.area_tc == round(want)
    np.testing.assert_array_equal(
        tdeploy.served_accuracies(designs, xw, y, device=CPU),
        np.array([d.accuracy for d in designs]))
    assert tdeploy.verify_front_parity(designs, g, vdata, sizes, cfg,
                                       device=CPU)


def test_batch_driver_serves_raw_windows(trun, sliced):
    """launch.serve_classifier.serve answers window requests (rows of the
    front's sample_shape) as the bank serves them, padding included."""
    from repro_torch.launch.serve_classifier import (make_request_stream,
                                                     serve)
    pg, _, _, trained, cfg, vdata, sizes, _ = trun
    designs = tdeploy.export_front(pg, vdata, sizes, cfg, trained=trained,
                                   device=CPU)
    requests = make_request_stream(sliced["x_test"], 13, 5)
    rep = serve(designs, requests, 32, device=CPU)
    assert rep["batches"] == 3 and rep["samples"] == 65
    for rid, x in requests:
        want = tdeploy.serve_bank(designs, x, device=CPU).argmax(-1)
        np.testing.assert_array_equal(rep["responses"][rid], want.numpy())


@pytest.fixture(scope="module")
def jax_front(inputs, tmp_path_factory):
    """A front the JAX package co-searched genomes into, exported and
    saved: random genomes over every subsample factor, trained by the
    reference's own QAT."""
    vdata, sizes, spec = inputs
    g = _genomes(np.random.default_rng(14), 6)
    jcfg = jsearch.SearchConfig.for_spec(
        jsearch.AdcSpec(bits=BITS, vmin=spec.vmin, vmax=spec.vmax),
        frontend=JFE, pop_size=6, train_steps=20)
    designs = jdeploy.export_front(g, vdata, sizes, jcfg)
    path = tmp_path_factory.mktemp("jax_cosearch_front")
    jdeploy.save_front(path, designs, extra_meta={"dataset": "stress"})
    return path, designs


def test_jax_streaming_front_serves_in_port(jax_front, sliced):
    path, jdesigns = jax_front
    designs = tdeploy.load_front(path)
    assert [d.feature.to_meta() for d in designs] == [
        d.feature.to_meta() for d in jdesigns]
    assert {d.feature.subsample for d in designs} == {1, 2, 4, 8}
    xw, y = sliced["x_test"], sliced["y_test"]
    want = np.array([d.accuracy for d in jdesigns])
    served = tdeploy.served_accuracies(designs, xw, y, device=CPU)
    np.testing.assert_array_equal(served, want)
    np.testing.assert_array_equal(
        served, jdeploy.served_accuracies(jdesigns, xw, y))
    jl = np.asarray(jdeploy.serve_bank(jdesigns, xw))
    np.testing.assert_allclose(
        tdeploy.serve_bank(designs, xw, device=CPU).numpy(), jl,
        rtol=1e-6, atol=1e-6)


# ----------------------------------------------------- the other engines
class Killed(RuntimeError):
    pass


def test_killed_cosearch_resumes_bitwise(inputs, tmp_path):
    vdata, sizes, spec = inputs
    cfg = tsearch.SearchConfig.for_spec(spec, frontend=FE, pop_size=4,
                                        generations=3, train_steps=10)
    pg, pf, _ = tsearch.run_search(vdata, sizes, cfg, device=CPU)
    ckpt = tmanager.CheckpointManager(tmp_path / "cosearch", keep=2)
    orig = ckpt.save

    def save_then_die(step, tree):
        orig(step, tree)
        if step == 1:
            raise Killed()

    ckpt.save = save_then_die
    with pytest.raises(Killed):
        tsearch.run_search(vdata, sizes, cfg, ckpt=ckpt, device=CPU)
    ckpt.save = orig
    assert ckpt.restore_flat(1)["genomes"].shape == (
        4, tsearch.genome_len(16, BITS, frontend=FE))
    rg, rf, _ = tsearch.run_search(vdata, sizes, cfg, ckpt=ckpt,
                                   resume=True, device=CPU)
    np.testing.assert_array_equal(rg, pg)
    np.testing.assert_array_equal(rf, pf)


def test_gradient_engine_with_frontend(sliced):
    pg, pf, _, trained, cfg, vdata, sizes, _ = tcosearch.run(
        sliced, FE, bits=BITS, engine="gradient", seed=0, train_steps=20,
        pop_size=4, grad_points=4, grad_train_steps=24,
        grad_polish_rounds=1, grad_polish_evals=8, device=CPU)
    assert len(pg) > 0 and np.isfinite(pf).all()
    assert pg.shape[1] == tsearch.genome_len(16, BITS, frontend=FE)
    designs = tdeploy.export_front(pg, vdata, sizes, cfg, trained=trained,
                                   device=CPU)
    assert tdeploy.verify_front_parity(designs, pg, vdata, sizes, cfg,
                                       device=CPU)
    np.testing.assert_array_equal(
        tdeploy.served_accuracies(designs, sliced["x_test"],
                                  sliced["y_test"], device=CPU),
        np.array([d.accuracy for d in designs]))


@pytest.mark.parametrize("kind", ["mlp", "svm"])
def test_gradient_frontend_branch_matches_reference(inputs, monkeypatch,
                                                     kind):
    """The frontend branch of run_gradient_search against the JAX
    package's on the same snapped gate genomes (injected in place of both
    gate trains, which are held against each other in
    tests/test_torch_grad_gates.py): each gate train sees variant 0
    without the frontend, the snapshot rows extended with the subsample
    cycled over the grid, the anchors and the deduplicated pool are
    bitwise, the area column bitwise, the accuracy column within 2 test
    samples."""
    from repro.core import grad_gates as jgg
    from repro_torch.core import grad_gates as tgg
    vdata, sizes, spec = inputs
    c0 = 16 * 2 ** BITS + tsearch.DP_BITS
    snaps = (np.random.default_rng(21).random((6, c0)) < 0.6
             ).astype(np.uint8)
    kw = dict(model=kind, pop_size=8, train_steps=20, grad_points=6,
              grad_polish_rounds=0)
    runs = {}
    for pkg, mod, gg, cfg in (
            ("jax", jsearch, jgg, jsearch.SearchConfig.for_spec(
                jsearch.AdcSpec(bits=BITS, vmin=spec.vmin, vmax=spec.vmax),
                frontend=JFE, **kw)),
            ("torch", tsearch, tgg, tsearch.SearchConfig.for_spec(
                spec, frontend=FE, **kw))):
        rec = runs[pkg] = {}

        def gate_train(data, sizes_, cfg_, *, lanes, rec=rec, **_):
            rec["gate"] = (np.asarray(data["x_train"]), cfg_.frontend,
                           lanes)
            return snaps.copy(), {}

        def evaluate(genomes, *a, rec=rec, real=mod.evaluate_population,
                     **k):
            fit = np.asarray(real(genomes, *a, **k))
            rec["pool"], rec["fit"] = np.asarray(genomes), fit
            return fit

        monkeypatch.setattr(gg, "train_gate_family", gate_train)
        monkeypatch.setattr(mod, "evaluate_population", evaluate)
        if pkg == "jax":
            mod.run_gradient_search(vdata, sizes, cfg)
        else:
            mod.run_gradient_search(vdata, sizes, cfg, device=CPU,
                                    init_params=_reference_init(kind))
    for rec in runs.values():
        x0, frontend, lanes = rec["gate"]
        np.testing.assert_array_equal(x0, np.asarray(vdata["x_train"][0]))
        assert frontend is None and lanes == 6
    jp, tp = runs["jax"]["pool"], runs["torch"]["pool"]
    np.testing.assert_array_equal(tp, jp)
    base = 16 * 2 ** BITS + tsearch.DP_BITS
    sub = tp[:, base] + 2 * tp[:, base + 1]
    assert set(sub.tolist()) == set(range(len(FE.sub_grid)))
    assert (tp[:, base + FE.sub_bits:] == 1).all()  # full allocation
    jf, tf = runs["jax"]["fit"], runs["torch"]["fit"]
    np.testing.assert_array_equal(tf[:, 1], jf[:, 1])
    tol = 2.0 / len(vdata["y_test"]) + 1e-6
    assert np.abs(tf[:, 0] - jf[:, 0]).max() <= tol


@pytest.mark.parametrize("kind", ["mlp", "svm"])
def test_full_adc_baseline_with_frontend(inputs, kind):
    vdata, sizes, spec = inputs
    cfg = tsearch.SearchConfig.for_spec(spec, frontend=FE, pop_size=4,
                                        train_steps=10, model=kind)
    row = tsearch.full_adc_baseline(vdata, sizes, cfg, device=CPU)
    assert row["area_flash_tc"] == 16 * jarea.flash_full_tc(BITS)
    assert row["area_binary_baseline_tc"] == 16 * jarea.baseline_binary_tc(
        BITS)
    assert row["area_binary_ours_tc"] == 16 * jarea.ours_full_tc(BITS)
    # the full-rate, full-allocation genome: equal to its ADC-only twin
    genome = np.ones((1, tsearch.genome_len(16, BITS, frontend=FE)),
                     np.uint8)
    genome[0, 64:68] = [1, 0, 1, 0]
    genome[0, 68:70] = 0
    acc = tsearch.evaluate_population_acc(genome, vdata, sizes, cfg,
                                          device=CPU)
    assert row["accuracy"] == 1.0 - float(np.float32(1.0) - acc[0])
    data0 = dict(vdata, x_train=vdata["x_train"][0],
                 x_test=vdata["x_test"][0])
    cfg0 = tsearch.SearchConfig.for_spec(spec, pop_size=4, train_steps=10,
                                         model=kind)
    assert tsearch.full_adc_baseline(data0, sizes, cfg0,
                                     device=CPU)["accuracy"] == row[
                                         "accuracy"]


# ------------------------------------------------------------------ api
def test_api_cosearch_deploy_serve(sliced):
    front = api.cosearch(sliced, FE, bits=BITS, pop_size=4, generations=1,
                         train_steps=10, seed=0, device=CPU)
    assert front.genomes.shape[1] == tsearch.genome_len(16, BITS,
                                                        frontend=FE)
    assert front.config.frontend == FE and front.device == "cpu"
    bank = api.deploy(front)
    out = api.serve(bank, sliced["x_test"], device=CPU)
    assert out.shape == (len(bank), 80, 3)
    np.testing.assert_array_equal(
        bank.accuracies(sliced["x_test"], sliced["y_test"], device=CPU),
        front.accuracies.astype(np.float32))


@pytest.mark.parametrize("entry", ["cosearch.run", "api.cosearch",
                                   "stack_variants", "make_bank_fn",
                                   "logits"])
def test_streaming_entry_points_need_a_card(trun, sliced, entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    pg, _, _, trained, cfg, vdata, sizes, _ = trun
    designs = tdeploy.export_front(pg, vdata, sizes, cfg, trained=trained,
                                   device=CPU)
    calls = {
        "cosearch.run": lambda: tcosearch.run(sliced, FE, bits=BITS, **KW),
        "api.cosearch": lambda: api.cosearch(sliced, FE, bits=BITS, **KW),
        "stack_variants": lambda: tfeature.stack_variants(
            sliced["x_test"], FE),
        "make_bank_fn": lambda: tdeploy.make_bank_fn(designs),
        "logits": lambda: designs[0].logits(sliced["x_test"])}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
