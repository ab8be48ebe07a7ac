"""Port parity, the fault-tolerance slice: repro_torch.faulttol (spec,
majority-vote draw fold, gene decode, calibration), the FT pricing, the
FT genome decode, the FT search and the calibrated deployment paths
against the JAX package, on the CPU at small sizes, with the reference's
redundant draws injected as numpy arrays.

What is bitwise and what is not:

* The spec JSON, ``effective_draws`` (every vote case), ``decode_genes``,
  ``calibrated_value_rows``, ``mc_operands_ft``, the transistor counts
  and ``decode_population_faulttol``: bitwise (integer work, and float32
  steps taken one operation at a time as the reference's eager path).
* The fixture fronts given TMR genes and the calibrate gene, through
  ``evaluate_robustness`` in both packages with injected draws: the
  operands bitwise; uncalibrated designs' instance accuracies bitwise
  (dyadic tables, power-of-two weights: every logit is exact); calibrated
  designs reconstruct through measured midpoints that are not dyadic, so
  the logit sums round in each package's order, and their instance
  accuracies agree within 1 test sample per instance.
* Inside the port: the FT search's yield column is reproduced bit for bit
  by ``evaluate_robustness`` on the exported front, and calibration at
  zero sigma gives back the nominal table of an unpruned design.
"""
import pytest

torch = pytest.importorskip("torch")

from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import area as jarea  # noqa: E402
from repro.core import deploy as jdeploy  # noqa: E402
from repro.core import nonideal as jni  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.data import tabular as jtab  # noqa: E402
from repro.faulttol import calibrate as jcal  # noqa: E402
from repro.faulttol import redundancy as jred  # noqa: E402
from repro.faulttol import spec as jftspec  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import area as tarea  # noqa: E402
from repro_torch.core import deploy as tdeploy  # noqa: E402
from repro_torch.core import nonideal as tni  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core.spec import AdcSpec  # noqa: E402
from repro_torch.faulttol import calibrate as tcal  # noqa: E402
from repro_torch.faulttol import redundancy as tred  # noqa: E402
from repro_torch.faulttol.spec import FaultTolSpec  # noqa: E402
from repro_torch.kernels import mc_eval  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "fronts"
SIZES = (7, 3, 3)
FT_SPECS = [dict(), dict(max_spares=1), dict(tmr=False, max_spares=3),
            dict(calibrate=False), dict(tmr=True, max_spares=0,
                                        calibrate=False)]


@pytest.fixture(scope="module")
def seeds():
    return jtab.make_dataset("seeds")


@pytest.fixture(scope="module")
def cardio():
    return jtab.make_dataset("cardio")


def _np(draws):
    return tuple(np.asarray(a) for a in draws)


def _t_rd(jrd):
    return tred.RedundantDraws(*_np(jrd))


# ------------------------------------------------------------------ the spec
@pytest.mark.parametrize("kw", FT_SPECS)
def test_spec_json_and_layout_match_reference(kw):
    t, j = FaultTolSpec(**kw), jftspec.FaultTolSpec(**kw)
    assert t.to_meta() == j.to_meta()
    assert FaultTolSpec.from_meta(j.to_meta()) == t
    assert jftspec.FaultTolSpec.from_meta(t.to_meta()) == j
    assert (t.spare_bits, t.gene_bits(7), t.describe()) == (
        j.spare_bits, j.gene_bits(7), j.describe())
    hash(t)


def test_spec_validation():
    with pytest.raises(ValueError):
        FaultTolSpec(max_spares=-1)
    with pytest.raises(ValueError, match="every action disabled"):
        FaultTolSpec(tmr=False, max_spares=0, calibrate=False)
    with pytest.raises(ValueError, match="robustness objective"):
        tsearch.SearchConfig(faulttol=FaultTolSpec())


# ---------------------------------------------------------- majority vote
def _vote_case_draws(rng, s=2, c=3, bits=3):
    """Redundant draws in which every vote case occurs at fault_rate 0.5:
    no fault, one stuck high, one stuck low, one of each, two alike
    (high, low), all three stuck; replica order varies."""
    k = 2 ** bits - 1
    healthy, stuck = 0.9, 0.1
    cases = [((healthy,) * 3, (0, 0, 0)),
             ((stuck, healthy, healthy), (1, 0, 0)),
             ((healthy, stuck, healthy), (0, 0, 0)),
             ((stuck, healthy, stuck), (1, 0, 0)),
             ((stuck, stuck, healthy), (1, 1, 0)),
             ((healthy, stuck, stuck), (0, 0, 0)),
             ((stuck, stuck, stuck), (1, 0, 1))]
    fu = np.empty((s, c, k, 3), np.float32)
    hi = np.empty((s, c, k, 3), bool)
    for idx in np.ndindex(s, c, k):
        f, h = cases[(sum(idx) + idx[2]) % len(cases)]
        fu[idx], hi[idx] = f, h
    eps = rng.normal(size=(s, c, k, 3)).astype(np.float32)
    drift = rng.normal(size=(s, c, 2)).astype(np.float32)
    return eps, fu, hi, drift


@pytest.mark.parametrize("tmr_shape", ["channel", "population"])
def test_effective_draws_every_vote_case(tmr_shape):
    rng = np.random.default_rng(4)
    rd = _vote_case_draws(rng)
    ni_t = tni.NonIdealSpec(sigma_offset=0.3, fault_rate=0.5)
    ni_j = jni.NonIdealSpec(sigma_offset=0.3, fault_rate=0.5)
    tmr = (np.array([1, 0, 1], np.int32) if tmr_shape == "channel"
           else np.array([[1, 1, 1], [0, 1, 0], [0, 0, 0]], np.int32))
    want = jred.effective_draws(
        jred.RedundantDraws(*(jnp.asarray(a) for a in rd)),
        jnp.asarray(tmr), ni_j)
    got = tred.effective_draws(tred.RedundantDraws(*rd), tmr, ni_t)
    for a, b in zip(want, got):
        assert tuple(b.shape) == np.shape(a)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the median is (e0 + e1) + e2 - max - min, not torch.median
    e = torch.from_numpy(rd[0])
    med = ((e[..., 0] + e[..., 1]) + e[..., 2]) - e.amax(-1) - e.amin(-1)
    healthy = (torch.from_numpy(rd[1]) >= 0.5).all(-1)
    sel = torch.as_tensor(tmr).bool()[..., None, :, None].expand_as(got.eps)
    assert torch.equal(got.eps[sel & healthy.expand_as(got.eps)],
                       med.expand_as(got.eps)[sel & healthy.expand_as(
                           got.eps)])


def test_redundant_draw_stream():
    ni = tni.NonIdealSpec(0.5, 0.02, 0.1, seed=5)
    rd = tred.draw_redundant(3, 4, 6, ni)
    assert rd.eps.shape == (6, 4, 7, 3) and rd.drift.shape == (6, 4, 2)
    assert rd.samples == 6 and rd.stuck_hi.dtype == torch.bool
    again = tred.draw_redundant(3, 4, 6, ni)
    assert all(torch.equal(a, b) for a, b in zip(rd, again))
    gen = torch.Generator().manual_seed(5)
    assert torch.equal(rd.eps, torch.randn((6, 4, 7, 3), generator=gen))


@pytest.mark.parametrize("kw", FT_SPECS)
def test_decode_genes_bitwise(kw):
    rng = np.random.default_rng(11)
    ft = FaultTolSpec(**kw)
    genes = (rng.random((9, ft.gene_bits(7))) < 0.5).astype(np.uint8)
    genes[0] = 1                              # the spare count clips
    want = jred.decode_genes(jnp.asarray(genes), 7,
                             jftspec.FaultTolSpec(**kw))
    got = tred.decode_genes(genes, 7, ft)
    for a, b in zip(want, got):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    with pytest.raises(ValueError, match="gene slice"):
        tred.decode_genes(genes[:, :-1], 7, ft)


# ------------------------------------------------------------ calibration
@pytest.mark.parametrize("bits", [2, 4, 6])
def test_calibrated_value_rows_and_operands_bitwise(bits):
    rng = np.random.default_rng(30 + bits)
    c, n = 5, 2 ** bits
    lo_r = rng.uniform(-1, 0.5, size=c)
    kw = dict(vmin=tuple(lo_r), vmax=tuple(lo_r + rng.uniform(0.5, 2, c)))
    for spec_kw in ({}, kw):
        js = jspec.AdcSpec(bits=bits, **spec_kw)
        ts = AdcSpec(bits=bits, **spec_kw)
        for knobs in ((0.0, 0.0, 0.0), (0.5, 0.02, 0.1), (0.0, 0.0, 1.0)):
            jn = jni.NonIdealSpec(*knobs, seed=8)
            tn = tni.NonIdealSpec(*knobs, seed=8)
            jrd = jred.draw_redundant(bits, c, 4, jn)
            masks = (rng.random((3, c, n)) < 0.6).astype(np.int32)
            tmr = (rng.random((3, c)) < 0.5).astype(np.int32)
            cal = np.array([1, 0, 1], np.int32)
            want = jcal.mc_operands_ft(js, jn, jnp.asarray(masks),
                                       jnp.asarray(tmr), jnp.asarray(cal),
                                       jrd)
            got = tcal.mc_operands_ft(ts, tn, masks, tmr, cal, _t_rd(jrd))
            for a, b in zip(want, got):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            one_w = jcal.mc_operands_ft(js, jn, jnp.asarray(masks[0]),
                                        jnp.asarray(tmr[0]),
                                        jnp.asarray(cal[0]), jrd)
            one_g = tcal.mc_operands_ft(ts, tn, masks[0], tmr[0], cal[0],
                                        _t_rd(jrd))
            for a, b in zip(one_w, one_g):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            lb, ub, _, lo, scale = (np.asarray(a) for a in want)
            np.testing.assert_array_equal(
                tcal.calibrated_value_rows(*(torch.from_numpy(np.array(a))
                                             for a in (lb, ub, lo, scale)),
                                           bits).numpy(),
                np.asarray(jcal.calibrated_value_rows(lb, ub, lo, scale,
                                                      bits)))


# ---------------------------------------------------------------- pricing
@pytest.mark.parametrize("bits", [2, 3, 4, 6])
def test_faulttol_pricing_is_exact(bits):
    rng = np.random.default_rng(bits)
    masks = (rng.random((30, 2 ** bits)) < rng.uniform(0.05, 0.95, (30, 1))
             ).astype(np.int32)
    masks[0], masks[1] = 1, 0
    masks[2] = 0
    masks[2, 3 % 2 ** bits] = 1                   # one kept level
    for m in masks:
        assert tarea.pruned_comparator_count(m) == \
            jarea.pruned_comparator_count(m)
        assert tarea.tmr_tc(m) == jarea.tmr_tc(m)
        assert tarea.calibration_tc(m) == jarea.calibration_tc(m)
    for _ in range(5):
        ch = masks[rng.choice(30, size=7)]
        tmr = (rng.random(7) < 0.5).astype(np.int32)
        for cal in (False, True):
            assert tarea.faulttol_tc(ch, tmr, cal) == jarea.faulttol_tc(
                ch, tmr, cal)
    assert (tarea.VOTER_TC, tarea.CALIBRATION_TC_FIXED,
            tarea.CALIBRATION_TC_PER_LEVEL) == (
        jarea.VOTER_TC, jarea.CALIBRATION_TC_FIXED,
        jarea.CALIBRATION_TC_PER_LEVEL)


# -------------------------------------------------------------- FT genome
@pytest.mark.parametrize("kw", FT_SPECS[:3])
def test_decode_population_faulttol_and_areas_bitwise(kw):
    rng = np.random.default_rng(17)
    ft, jft = FaultTolSpec(**kw), jftspec.FaultTolSpec(**kw)
    glen = tsearch.genome_len(7, 3, ft)
    assert glen == jsearch.genome_len(7, 3, faulttol=jft)
    g = (rng.random((8, glen)) < 0.5).astype(np.uint8)
    g[1, :56] = 0
    want = jsearch.decode_population_faulttol(jnp.asarray(g), 7, 3, 2, jft)
    got = tsearch.decode_population_faulttol(g, 7, 3, 2, ft)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    one = tsearch.decode_genome_faulttol(g[3], 7, 3, 2, ft)
    for a, b in zip(want, one):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a)[3])
    ni_t, ni_j = tni.NonIdealSpec(fault_rate=0.1), jni.NonIdealSpec(
        fault_rate=0.1)
    tcfg = tsearch.SearchConfig(bits=3, nonideal=ni_t, mc_samples=2,
                                faulttol=ft)
    jcfg = jsearch.SearchConfig(bits=3, nonideal=ni_j, mc_samples=2,
                                faulttol=jft)
    np.testing.assert_array_equal(tsearch.population_areas(g, 7, tcfg),
                                  jsearch.population_areas(g, 7, jcfg))


# ------------------------------------- FT variants of the fixture fronts
def _ft_front(designs, rng):
    """The fixture front with TMR genes on random channels and the
    calibrate gene on every other design."""
    import dataclasses
    return [dataclasses.replace(
        d, tmr=(rng.random(d.channels) < 0.5).astype(np.int32),
        calibrated=bool(i % 2)) for i, d in enumerate(designs)]


@pytest.mark.parametrize("kind", ["mlp", "svm"])
def test_ft_fixture_fronts_across_packages(cardio, kind):
    directory = FIXTURES / f"cardio_{kind}"
    rng = np.random.default_rng(3)
    jd = _ft_front(jdeploy.load_front(directory), rng)
    rng = np.random.default_rng(3)
    td = _ft_front(tdeploy.load_front(directory), rng)
    jn = jni.NonIdealSpec(0.5, 0.01, 0.05, seed=2)
    tn = tni.NonIdealSpec(0.5, 0.01, 0.05, seed=2)
    s = 6
    jrd = jred.draw_redundant(td[0].bits, td[0].channels, s, jn)
    # the operands, bitwise
    masks = np.stack([d.mask for d in td])
    tmr = np.stack([d.tmr for d in td])
    cal = np.array([int(d.calibrated) for d in td], np.int32)
    want_ops = jcal.mc_operands_ft(jd[0].spec, jn, jnp.asarray(masks),
                                   jnp.asarray(tmr), jnp.asarray(cal), jrd)
    got_ops = tcal.mc_operands_ft(td[0].spec, tn, masks, tmr, cal,
                                  _t_rd(jrd))
    for a, b in zip(want_ops, got_ops):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    x, y = cardio["x_test"], cardio["y_test"]
    want = jdeploy._mc_instance_accuracies(jd, jn, x, y, draws=jrd)
    got = tdeploy._mc_instance_accuracies(td, tn, x, y, draws=_t_rd(jrd),
                                          device="cpu")
    assert got.shape == want.shape == (len(td), s)
    plain = cal == 0
    np.testing.assert_array_equal(got[plain], np.asarray(want)[plain])
    # calibrated designs: non-dyadic values, logits round in each
    # package's summation order (module docstring)
    m = len(y)
    assert np.abs(got[~plain] - np.asarray(want)[~plain]).max() \
        <= 1.0 / m + 1e-7
    rep = tdeploy.evaluate_robustness(td, tn, x, y, draws=_t_rd(jrd),
                                      device="cpu")
    assert [r["instance_accuracies"] for r in rep["designs"]] == \
        got.tolist()


def test_calibrate_front_at_zero_sigma_gives_the_nominal_table(cardio):
    designs = tdeploy.load_front(FIXTURES / "cardio_mlp")
    import dataclasses
    spec = designs[0].spec
    full = np.ones_like(designs[0].mask)
    unpruned = dataclasses.replace(
        designs[0], mask=full,
        table=spec.value_table(torch.from_numpy(full)).numpy())
    out = tdeploy.calibrate_front([unpruned], tni.NonIdealSpec(),
                                  device="cpu")
    np.testing.assert_array_equal(out[0].table, unpruned.table)
    assert out[0].calibrated and out[0].vmin == (0.0,) * 21
    # and as the reference re-bakes a real front, on a perturbed instance
    jn = jni.NonIdealSpec(0.5, 0.02, 0.05, seed=1)
    tn = tni.NonIdealSpec(0.5, 0.02, 0.05, seed=1)
    jd = jdeploy.load_front(FIXTURES / "cardio_mlp")
    got = tdeploy.calibrate_front(designs, tn, instance=2, samples=4,
                                  device="cpu")
    # the port draws its own stream: hold the operands of one measured
    # instance against the reference's, the same draws injected
    jrd = jred.draw_redundant(4, 21, 4, jn)
    spec_j = jd[0].spec
    masks = np.stack([d.mask for d in designs])
    ops_t = tdeploy._measured_instance(designs, tn, 2, 4, "cpu")[1]
    assert ops_t[0].shape == (len(designs), 1, 21, 16)
    one = jred.RedundantDraws(*(a[2:3] for a in jrd))
    ops_j = jcal.mc_operands_ft(spec_j, jn, jnp.asarray(masks),
                                jnp.zeros((len(designs), 21), jnp.int32),
                                jnp.ones(len(designs), jnp.int32), one)
    ops_p = tcal.mc_operands_ft(designs[0].spec, tn, masks,
                                np.zeros((len(designs), 21), np.int32),
                                np.ones(len(designs), np.int32),
                                tred.RedundantDraws(*_np(one)))
    for a, b in zip(ops_j, ops_p):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert all(d.calibrated for d in got)
    assert len({d.vmin for d in got}) == 1


# ----------------------------------------------------------- the FT search
def _reference_init(kind):
    params, _ = jsearch._init_model(SIZES, jsearch.SearchConfig(model=kind))
    params = jax.tree_util.tree_map(np.asarray, params)
    return tuple(params) if kind == "svm" else params


def test_ft_fitness_against_batched_reference(seeds):
    rng = np.random.default_rng(9)
    kw = dict(bits=3, pop_size=5, train_steps=12, model="svm",
              mc_samples=5, robust_objective="yield")
    jft, ft = jftspec.FaultTolSpec(), FaultTolSpec()
    g = (rng.random((5, tsearch.genome_len(7, 3, ft))) < 0.5).astype(
        np.uint8)
    assert len(np.unique(g, axis=0)) == len(g)   # no dedup in either engine
    jn = jni.NonIdealSpec(0.5, 0.01, 0.05, seed=2)
    jrd = jred.draw_redundant(3, 7, 5, jn)
    jcfg = jsearch.SearchConfig(**kw, nonideal=jn, faulttol=jft)
    tcfg = tsearch.SearchConfig(
        **kw, nonideal=tni.NonIdealSpec(0.5, 0.01, 0.05, seed=2),
        faulttol=ft)
    init = _reference_init("svm")
    want = jsearch.evaluate_population(g, seeds, SIZES, jcfg, draws=jrd)
    got = tsearch.evaluate_population(g, seeds, SIZES, tcfg, device="cpu",
                                      init_params=init, draws=_np(jrd))
    assert got.shape == want.shape == (5, 3)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    m = len(seeds["y_test"])
    assert np.abs(got[:, 0] - want[:, 0]).max() <= 2.0 / m + 1e-6
    # the yield column counts whole instances, so it is held through the
    # raw (P, S) per-instance accuracies it is reduced from: each within 2
    # test samples (the trained weights part at roundoff, as the accuracy
    # column's), and each package's column is the shared f64 reduction of
    # its own accuracies, bitwise
    params0, opt0 = jsearch._stacked_init(len(g), SIZES, jcfg)
    jout = jsearch._train_and_score_jit()(
        jnp.asarray(g, jnp.uint8), params0, opt0,
        {k: jnp.asarray(v) for k, v in seeds.items()}, tuple(SIZES), jcfg,
        draws=jrd)
    data = tsearch.device_data(seeds, "cpu")
    tdraws = tsearch._as_search_draws(_np(jrd), tcfg, SIZES[0],
                                      data["x_test"].device)
    tout = tsearch._fixed_lanes(g, data, SIZES, tcfg, init, draws=tdraws)
    j_acc, j_mc = np.asarray(jout["acc"]), np.asarray(jout["mc_accs"])
    assert tout["mc_accs"].shape == j_mc.shape == (5, 5)
    assert np.abs(tout["mc_accs"] - j_mc).max() <= 2.0 / m + 1e-6
    np.testing.assert_array_equal(got[:, 2], tni.robust_objective(
        tout["acc"], tout["mc_accs"], "yield", margin=tcfg.yield_margin))
    np.testing.assert_array_equal(want[:, 2], tni.robust_objective(
        j_acc, j_mc, "yield", margin=tcfg.yield_margin))


@pytest.fixture(scope="module")
def ft_front(seeds):
    ni = tni.NonIdealSpec(0.5, 0.01, 0.05, seed=4)
    cfg = tsearch.SearchConfig(bits=3, pop_size=6, generations=2,
                               train_steps=12, model="svm", nonideal=ni,
                               mc_samples=8, robust_objective="yield",
                               faulttol=FaultTolSpec())
    pg, pf, decode, trained = tsearch.run_search(seeds, SIZES, cfg,
                                                 return_trained=True,
                                                 device="cpu")
    designs = tdeploy.export_front(pg, seeds, SIZES, cfg, trained=trained,
                                   device="cpu")
    return cfg, pg, pf, decode, designs


def test_ft_search_export_reproduces_yield_column(seeds, ft_front,
                                                  tmp_path):
    cfg, pg, pf, decode, designs = ft_front
    assert pf.shape[1] == 3
    assert all(d.tmr is not None for d in designs)
    for d, g in zip(designs, pg):
        mask, dp, tmr, spares, cal = decode(g)
        np.testing.assert_array_equal(d.mask, mask.numpy())
        np.testing.assert_array_equal(d.tmr, tmr.numpy())
        assert d.calibrated == bool(int(cal))
        assert d.area_tc == tarea.system_tc(d.mask) + tarea.faulttol_tc(
            d.mask, d.tmr, d.calibrated)
    tdeploy.save_front(tmp_path, designs)
    loaded = tdeploy.load_front(tmp_path)
    for a, b in zip(loaded, designs):
        np.testing.assert_array_equal(a.tmr, b.tmr)
        assert a.calibrated == b.calibrated
    rep = tdeploy.evaluate_robustness(loaded, cfg.nonideal, seeds["x_test"],
                                      seeds["y_test"], samples=8,
                                      yield_margins=(cfg.yield_margin,),
                                      device="cpu")
    for i, row in enumerate(rep["designs"]):
        assert 1.0 - row["yield"]["0.01"] == pf[i, 2]
    assert tdeploy.verify_front_parity(designs, pg, seeds, SIZES, cfg,
                                       device="cpu")
    # the JAX package loads the port's FT front with its provenance
    jd = jdeploy.load_front(tmp_path)
    for a, b in zip(jd, designs):
        np.testing.assert_array_equal(a.tmr, b.tmr)
        assert a.calibrated == b.calibrated and a.area_tc == b.area_tc


def test_ft_reference_engine_close_to_batched(seeds, ft_front):
    cfg, pg, pf, _, _ = ft_front
    import dataclasses
    mc_eval.reset_launches()
    ref = tsearch.evaluate_population_reference(
        pg, seeds, SIZES, dataclasses.replace(cfg, engine="reference"),
        device="cpu")
    np.testing.assert_allclose(ref, pf, rtol=0, atol=1e-6)


def test_calibrated_serving(seeds, ft_front):
    cfg, _, _, _, designs = ft_front
    fn = tdeploy.make_calibrated_bank_fn(designs, cfg.nonideal, instance=3,
                                         samples=8, device="cpu")
    logits = fn(seeds["x_test"])
    assert logits.shape == (len(designs), len(seeds["y_test"]), 3)
    assert torch.isfinite(logits).all()
    bank = api.calibrate(designs, cfg.nonideal, instance=3, samples=8,
                         device="cpu")
    acc = bank.accuracies(seeds["x_test"], seeds["y_test"], device="cpu")
    assert acc.shape == (len(designs),) and all(d.calibrated
                                                for d in bank.designs)


def test_serve_cli_calibrates(capsys):
    from repro_torch.launch import serve_classifier as tserve
    rep = tserve.main(["--front-dir", str(FIXTURES / "cardio_svm"),
                       "--dataset", "cardio", "--device", "cpu",
                       "--requests", "8", "--fault-rate", "0.05",
                       "--calibrate", "--mc-samples", "4"])
    assert "calibrated=" in capsys.readouterr().out
    assert len(rep["calibrated_accuracies"]) == rep["num_designs"]


def test_train_cli_faulttol_writes_robustness_report(tmp_path, capsys):
    from repro_torch.launch import train as ttrain
    pf = ttrain.main(["--adc-search", "--dataset", "seeds", "--bits", "2",
                      "--pop", "4", "--generations", "1", "--train-steps",
                      "6", "--device", "cpu", "--mc-samples", "4",
                      "--fault-rate", "0.1", "--faulttol", "--max-spares",
                      "1", "--robust-objective", "yield", "--export-front",
                      "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "fault-tolerance genome: tmr+spares<=1+calibrate" in out
    rep = tdeploy.load_robustness(tmp_path / "front")
    designs = tdeploy.load_front(tmp_path / "front")
    assert rep["num_designs"] == len(designs) == len(pf)
    assert all(d.tmr is not None for d in designs)


@pytest.mark.parametrize("call", ["calibrate_front",
                                  "make_calibrated_bank_fn"])
def test_calibration_entry_points_default_to_cuda(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    designs = tdeploy.load_front(FIXTURES / "cardio_svm")
    ni = tni.NonIdealSpec(fault_rate=0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tdeploy, call)(designs, ni)
