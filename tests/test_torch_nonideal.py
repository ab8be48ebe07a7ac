"""Port parity, the robustness slice (non-ideal hardware): repro_torch's
core.nonideal, the four Monte-Carlo plain versions, the 3-objective
search and the deployed robustness report against the JAX package, on
the CPU at small sizes, with the reference's draws (``jax.random``)
injected as numpy arrays.

What is bitwise and what is not:

* The operand compilation (``instance_bounds``, ``instance_rows``,
  ``level_value_rows``, ``mc_operands``) against the reference's EAGER
  call: every float32 step is one operation in both. (The reference's
  jitted search fuses ``mid + sigma * eps`` into one multiply-add, so its
  in-search tables can differ from these by an ulp.)
* The four plain versions against ``repro.kernels.ref.mc_adc_eval*``,
  NaN, +-inf and on-bound inputs included: a selected value is copied.
* The host-side f64 reductions, and the whole robustness report of both
  fixture fronts (exit test 3): their tables are dyadic and their weights
  powers of two, so every logit is exact in any summation order.
* The 3-objective fitness against the reference's batched engine: the
  area column bitwise; accuracy and robustness within 2 test samples
  (2/63), the bound of the 2-objective search (test_torch_search.py),
  because QAT trajectories part in the last ulp across packages.
* Inside the port (exit test 4): search -> export -> evaluate_robustness
  reproduces the third column bitwise, serving one sampled instance
  reproduces its listed accuracy, and zero sigma reproduces the ideal
  quantizer and the exported accuracies.
"""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import deploy as jdeploy  # noqa: E402
from repro.core import nonideal as jni  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.data import tabular as jtab  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import deploy as tdeploy  # noqa: E402
from repro_torch.core import nonideal as tni  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core.adc import repair_mask  # noqa: E402
from repro_torch.core.spec import AdcSpec  # noqa: E402
from repro_torch.kernels import envelope, mc_eval, ops, ref  # noqa: E402
from repro_torch.launch import serve_classifier as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "fronts"
SIZES = (7, 3, 3)            # seeds: 7 features, hidden 3, 3 classes
# (sigma_offset, sigma_range, fault_rate): ideal, offset only, drift
# only, faults only (and every comparator faulty), all three
SPECS = [(0.0, 0.0, 0.0), (0.4, 0.0, 0.0), (0.0, 0.03, 0.0),
         (0.0, 0.0, 0.1), (0.0, 0.0, 1.0), (0.4, 0.03, 0.05)]
PLAIN = {"mc_adc_eval": (ref.mc_adc_eval_ref, jref.mc_adc_eval_ref),
         "mc_adc_eval_population": (ref.mc_adc_eval_ref_population,
                                    jref.mc_adc_eval_ref_population),
         "mc_adc_eval_cal": (ref.mc_adc_eval_cal_ref,
                             jref.mc_adc_eval_cal_ref),
         "mc_adc_eval_cal_population": (
             ref.mc_adc_eval_cal_ref_population,
             jref.mc_adc_eval_cal_ref_population)}


@pytest.fixture(scope="module")
def seeds():
    return jtab.make_dataset("seeds")


@pytest.fixture(scope="module")
def cardio():
    return jtab.make_dataset("cardio")


def _np(draws):
    return tuple(np.asarray(a) for a in draws)


def _specs(bits, per_channel, rng, c):
    if not per_channel:
        return jspec.AdcSpec(bits=bits), AdcSpec(bits=bits)
    lo = rng.uniform(-1.0, 0.5, size=c)
    kw = dict(vmin=tuple(lo), vmax=tuple(lo + rng.uniform(0.5, 2.0, size=c)))
    return jspec.AdcSpec(bits=bits, **kw), AdcSpec(bits=bits, **kw)


# ------------------------------------------------------------------ the spec
@pytest.mark.parametrize("knobs", SPECS)
def test_spec_json_both_directions(knobs):
    t = tni.NonIdealSpec(*knobs, seed=7)
    j = jni.NonIdealSpec(*knobs, seed=7)
    assert t.to_meta() == j.to_meta()
    assert json.dumps(t.to_meta()) == json.dumps(j.to_meta())
    assert jni.NonIdealSpec.from_meta(t.to_meta()) == j
    assert tni.NonIdealSpec.from_meta(j.to_meta()) == t
    assert t.ideal == j.ideal and t.describe() == j.describe()
    assert t.replace(seed=1).seed == 1


def test_spec_validation_and_objective_names():
    for bad in (dict(sigma_offset=-1.0), dict(sigma_range=-0.1),
                dict(fault_rate=1.5)):
        with pytest.raises(ValueError):
            tni.NonIdealSpec(**bad)
    with pytest.raises(ValueError, match="robust_objective"):
        tni.robust_objective_name("median")
    assert tni.ROBUST_OBJECTIVES == jni.ROBUST_OBJECTIVES


# ----------------------------------------------------- operand compilation
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6])
def test_operands_bitwise_against_eager_reference(bits, per_channel):
    """instance_bounds, instance_rows, level_value_rows and mc_operands,
    for a (C, 2^N) and a (P, C, 2^N) mask, every spec, with the
    reference's draws injected: bitwise, shapes and dtypes included."""
    rng = np.random.default_rng(100 + bits + 10 * per_channel)
    c, s, n = 5, 6, 2 ** bits
    js, ts = _specs(bits, per_channel, rng, c)
    for knobs in SPECS:
        jn, tn = jni.NonIdealSpec(*knobs, seed=3), tni.NonIdealSpec(*knobs,
                                                                   seed=3)
        jd = jni.draw(bits, c, s, jn)
        masks = (rng.random((4, c, n)) < 0.5).astype(np.int32)
        masks[0] = 1                                  # unpruned design
        masks[1, 0] = 0                               # an all-dead channel
        for m in (masks, masks[2]):
            jlb, jub = jni.instance_bounds(jnp.asarray(m), bits, jd, jn)
            tlb, tub = tni.instance_bounds(m, bits, _np(jd), tn)
            np.testing.assert_array_equal(tlb.numpy(), np.asarray(jlb))
            np.testing.assert_array_equal(tub.numpy(), np.asarray(jub))
            jops = jni.mc_operands(js, jn, jnp.asarray(m), draws=jd)
            tops = tni.mc_operands(ts, tn, m, draws=_np(jd))
            for a, b in zip(jops, tops):
                assert b.dtype == torch.float32 and b.is_contiguous()
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        jlo, jsc = jni.instance_rows(js, c, jd, jn)
        tlo, tsc = tni.instance_rows(ts, c, _np(jd), tn)
        np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
        np.testing.assert_array_equal(
            tni.level_value_rows(ts, c).numpy(),
            np.asarray(jni.level_value_rows(js, c)))


def test_ideal_intervals_are_the_code_boundaries():
    """All-zero spec: the unpruned design's leaf k is exactly [k, k+1),
    the outer leaves half-infinite; the rows are the ideal rows."""
    spec = AdcSpec(bits=3)
    d = tni.draw(3, 4, 5, tni.NonIdealSpec(seed=2))
    lb, ub = tni.instance_bounds(np.ones((4, 8), np.int32), 3, d,
                                 tni.NonIdealSpec())
    k = torch.arange(8, dtype=torch.float32)
    want_lb = torch.where(k == 0, -torch.inf, k)
    want_ub = torch.where(k == 7, torch.inf, k + 1)
    assert torch.equal(lb, want_lb.expand_as(lb))
    assert torch.equal(ub, want_ub.expand_as(ub))
    lo, scale = tni.instance_rows(spec, 4, d, tni.NonIdealSpec())
    rlo, rsc = spec.range_rows(4)
    assert torch.equal(lo, torch.from_numpy(rlo).expand(5, 4))
    assert torch.equal(scale, torch.from_numpy(rsc).expand(5, 4))


def test_draw_stream_is_the_documented_generator():
    """draw is a pure function of (seed, bits, channels, samples): eps,
    fault_u, stuck_hi, drift from one CPU generator, in that order."""
    ni = tni.NonIdealSpec(0.5, 0.1, 0.1, seed=11)
    d = tni.draw(3, 4, 6, ni)
    gen = torch.Generator().manual_seed(11)
    eps = torch.randn((6, 4, 7), generator=gen)
    fu = torch.rand((6, 4, 7), generator=gen)
    sh = torch.rand((6, 4, 7), generator=gen) < 0.5
    dr = torch.randn((6, 4, 2), generator=gen)
    for a, b in zip(d, (eps, fu, sh, dr)):
        assert torch.equal(a, b)
    assert d.samples == 6 and d.stuck_hi.dtype == torch.bool
    again = tni.draw(3, 4, 6, ni)
    assert all(torch.equal(a, b) for a, b in zip(d, again))
    other = tni.draw(3, 4, 6, ni.replace(seed=12))
    assert not torch.equal(d.eps, other.eps)
    with pytest.raises(ValueError, match="MC sample"):
        tni.draw(3, 4, 0, ni)


# --------------------------------------------------------- plain versions
def _mc_case(rng, entry, bits=3, c=5, s=4, p=3, m=40, special=False):
    """Operands from the reference's own compiler (eager), so the plain
    versions see real interval tables; ``special`` adds NaN, +-inf and
    code positions exactly on a bound."""
    js = jspec.AdcSpec(bits=bits)
    jn = jni.NonIdealSpec(0.4, 0.02, 0.1, seed=5)
    n = 2 ** bits
    masks = (rng.random((p, c, n)) < 0.6).astype(np.int32)
    masks = np.asarray(repair_mask(torch.from_numpy(masks)))
    lb, ub, values, lo, scale = (np.asarray(a) for a in jni.mc_operands(
        js, jn, jnp.asarray(masks), samples=s))
    x = rng.uniform(-0.2, 1.2, size=(m, c)).astype(np.float32)
    if special:
        x[0, :] = np.nan
        x[1, :] = np.inf
        x[2, :] = -np.inf
        # u exactly on a finite bound of instance 0: x = lo + t / scale,
        # then nudge until (x - lo) * scale lands on t in float32
        fin = np.isfinite(lb[0, 0]) & (lb[0, 0] > 0)
        for ch in range(c):
            ks = np.nonzero(fin[ch])[0]
            if len(ks):
                t = lb[0, 0, ch, ks[0]]
                xv = np.float32(lo[0, ch] + t / scale[0, ch])
                for _ in range(8):
                    u = np.float32(np.float32(xv - lo[0, ch]) * scale[0, ch])
                    if u == t:
                        break
                    xv = np.nextafter(xv, np.float32(np.inf if u < t
                                                     else -np.inf))
                x[3, ch] = xv
    if "_cal" in entry:
        values = (rng.uniform(-1, 1, size=lb.shape).astype(np.float32))
        values[..., 0] = -0.0
    if not entry.endswith("_population"):
        lb, ub = lb[0], ub[0]
        if "_cal" in entry:
            values = values[0]
    return x, lb, ub, values, lo, scale


def _overlapping_case(rng, entry, bits=4, c=21, s=8, p=5, m=1000):
    """Operands whose intervals are no partition: random lb/ub (0 to 3
    codes wide, some empty or reversed, a few NaN), so that several leaves
    are live at some code positions; values of mixed signs with some
    -0.0; NaN and +inf rows in x."""
    n = 2 ** bits
    shape = (s, c, n) if entry in ("mc_adc_eval", "mc_adc_eval_cal") \
        else (p, s, c, n)
    lb = rng.uniform(-1.0, n + 1.0, size=shape).astype(np.float32)
    ub = (lb + rng.uniform(-0.6, 3.0, size=shape)).astype(np.float32)
    lb[rng.random(shape) < 0.02] = np.nan
    ub[rng.random(shape) < 0.02] = np.nan
    lb[..., 0], ub[..., -1] = -np.inf, np.inf
    values = rng.uniform(-2.0, 2.0, size=shape if "_cal" in entry
                         else (c, n)).astype(np.float32)
    values[rng.random(values.shape) < 0.1] = -0.0
    lo = rng.uniform(-0.1, 0.1, size=(s, c)).astype(np.float32)
    scale = (n * rng.uniform(0.9, 1.1, size=(s, c))).astype(np.float32)
    x = rng.uniform(-0.1, 1.1, size=(m, c)).astype(np.float32)
    x[0], x[1] = np.nan, np.inf
    return x, lb, ub, values, lo, scale


@pytest.mark.parametrize("entry", list(PLAIN))
def test_plain_selection_sum_is_in_order_on_overlapping_intervals(entry):
    """The port's plain version (the kernel's yardstick on the card) on
    interval tables that are no partition: from 0.0, each live value
    added in k order, one float32 rounding an add, as a numpy loop."""
    rng = np.random.default_rng(23)
    x, lb, ub, values, lo, scale = _overlapping_case(rng, entry, bits=3,
                                                     c=4, s=3, p=2, m=50)
    got = getattr(mc_eval, entry)(*(torch.from_numpy(a) for a in (
        x, lb, ub, values, lo, scale))).numpy()
    u = (x[None] - lo[:, None]) * scale[:, None]                 # (S, M, C)
    lead = lb.shape[:-3]
    vals = np.broadcast_to(values, lb.shape)
    want = np.zeros(lead + u.shape, np.float32)
    live = np.zeros(lead + u.shape, np.int64)
    for k in range(lb.shape[-1]):
        sel = ((u >= lb[..., None, :, k]) & (u < ub[..., None, :, k]))
        want = np.where(sel, want + vals[..., None, :, k], want)
        live += sel
    assert (live >= 2).any() and (live == 0).any()
    np.testing.assert_array_equal(got, want)
    assert not np.signbit(got[got == 0.0]).any()


@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("entry", list(PLAIN))
def test_plain_versions_match_reference(entry, special):
    rng = np.random.default_rng(7 + 3 * special)
    ops_np = _mc_case(rng, entry, special=special)
    tfn, jfn = PLAIN[entry]
    got = tfn(*(torch.from_numpy(np.array(a)) for a in ops_np))
    want = np.asarray(jfn(*(jnp.asarray(a) for a in ops_np)))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # and through the wrapper on a CPU tensor: the plain version, no launch
    mc_eval.reset_launches()
    wrapped = getattr(mc_eval, entry)(
        *(torch.from_numpy(np.array(a)) for a in ops_np))
    assert torch.equal(wrapped, got)
    assert sum(mc_eval.launches.values()) == 0
    if special:
        assert float(got.reshape(-1, *got.shape[-2:])[0, 0, 0]) == 0.0
        assert not torch.isnan(got).any()


def test_wrapper_checks_shapes_and_envelope():
    rng = np.random.default_rng(3)
    x, lb, ub, values, lo, scale = (torch.from_numpy(np.array(a))
                                    for a in _mc_case(rng, "mc_adc_eval"))
    with pytest.raises(ValueError, match=r"lb \(P, S, C, 2\^N\)"):
        mc_eval.mc_adc_eval_population(x, lb, ub, values, lo, scale)
    with pytest.raises(ValueError, match="channels"):
        mc_eval.mc_adc_eval(x[:, :4], lb, ub, values, lo, scale)
    with pytest.raises(ValueError, match="values"):
        mc_eval.mc_adc_eval(x, lb, ub, lb, lo, scale)
    with pytest.raises(ValueError, match="lo"):
        mc_eval.mc_adc_eval(x, lb, ub, values, lo[:2], scale)
    assert mc_eval.mc_adc_eval(x[:0], lb, ub, values, lo, scale).shape == (
        lb.shape[0], 0, 5)
    assert envelope.mc_smem_bytes(21, 16) == 12 * 21 * 16
    assert envelope.outside_mc_envelope(200, 64) is None      # 150 KB
    assert "232448" in envelope.outside_mc_envelope(400, 64)
    assert set(mc_eval.launches) == set(PLAIN)


# ------------------------------------------------------ host reductions
@pytest.mark.parametrize("kind", ["expected", "worst", "yield"])
def test_robust_objective_and_yield_bitwise(kind):
    rng = np.random.default_rng(12)
    m = 63
    accs = (rng.integers(0, m + 1, size=9) / np.float32(m)).astype(np.float32)
    mc = (rng.integers(0, m + 1, size=(9, 32)) / np.float32(m)).astype(
        np.float32)
    mc[0] = accs[0]                                   # identical instances
    for margin in (0.0, 0.01, 0.05):
        np.testing.assert_array_equal(
            tni.robust_objective(accs, mc, kind, margin=margin),
            jni.robust_objective(accs, mc, kind, margin=margin))
        np.testing.assert_array_equal(
            tni.yield_fraction(accs, mc, margin),
            jni.yield_fraction(accs, mc, margin))
    np.testing.assert_array_equal(tni.mc_mean_accuracy(mc),
                                  jni.mc_mean_accuracy(mc))
    assert tni.mc_mean_accuracy(mc)[0] == np.float64(accs[0])


# ------------------------------------------------ exit test 3: the fixtures
@pytest.mark.parametrize("kind", ["mlp", "svm"])
def test_fixture_front_robustness_report_across_packages(cardio, kind):
    """Both packages evaluate the committed fixture front under the same
    injected draws: every report field, the per-instance accuracies
    included, is equal; and at zero sigma every instance is the exported
    accuracy."""
    directory = FIXTURES / f"cardio_{kind}"
    jd = jdeploy.load_front(directory)
    td = tdeploy.load_front(directory)
    jn = jni.NonIdealSpec(0.5, 0.01, 0.02, seed=4)
    tn = tni.NonIdealSpec(0.5, 0.01, 0.02, seed=4)
    draws = jni.draw(td[0].bits, td[0].channels, 8, jn)
    x, y = cardio["x_test"], cardio["y_test"]
    want = jdeploy.evaluate_robustness(jd, jn, x, y, draws=draws,
                                       yield_margins=(0.0, 0.01, 0.05))
    got = tdeploy.evaluate_robustness(td, tn, x, y, draws=_np(draws),
                                      yield_margins=(0.0, 0.01, 0.05),
                                      device="cpu")
    assert got == want
    zero = tdeploy.evaluate_robustness(td, tni.NonIdealSpec(), x, y,
                                       samples=3, device="cpu")
    for d, row in zip(td, zero["designs"]):
        assert row["instance_accuracies"] == [d.accuracy] * 3
        assert row["expected_drop"] == 0.0


@pytest.mark.parametrize("bits", [1, 3, 5])
def test_zero_sigma_mc_is_the_ideal_quantizer(bits):
    """With the port's own draws at zero sigma, the MC entries equal the
    ideal population quantizer bit for bit, on every instance."""
    rng = np.random.default_rng(bits)
    spec = AdcSpec(bits=bits)
    masks = repair_mask(torch.from_numpy(
        (rng.random((4, 6, 2 ** bits)) < 0.5).astype(np.int32)))
    x = torch.from_numpy(rng.uniform(-0.2, 1.2, (50, 6)).astype(np.float32))
    ideal = ops.adc_quantize_population(x, masks, spec=spec)
    ni = tni.NonIdealSpec(seed=9)
    mc = tni.mc_quantize(x, masks, spec, ni, samples=5)
    assert mc.shape == (4, 5, 50, 6)
    assert torch.equal(mc, ideal[:, None].expand_as(mc))
    one = tni.mc_quantize(x, masks[1], spec, ni, samples=2)
    assert torch.equal(one, ideal[1][None].expand_as(one))
    assert torch.equal(ops.adc_quantize(x, masks[1], spec=spec), ideal[1])


# ------------------------------------------------- the 3-objective search
def _reference_init(kind):
    params, _ = jsearch._init_model(SIZES, jsearch.SearchConfig(model=kind))
    params = jax.tree_util.tree_map(np.asarray, params)
    return tuple(params) if kind == "svm" else params


def _genomes(rng, p, bits=3, channels=7):
    g = (rng.random((p, channels * 2 ** bits + 4)) < 0.5).astype(np.uint8)
    g[0] = 1
    return g


@pytest.mark.parametrize("kind, objective", [("mlp", "expected"),
                                             ("svm", "worst")])
def test_three_objective_fitness_against_batched_reference(seeds, kind,
                                                           objective):
    rng = np.random.default_rng(21)
    g = _genomes(rng, 5)
    g[4] = g[2]                                      # a duplicate
    kw = dict(bits=3, pop_size=5, train_steps=15, model=kind, mc_samples=6,
              robust_objective=objective)
    jn = jni.NonIdealSpec(0.5, 0.01, 0.02, seed=2)
    jcfg = jsearch.SearchConfig(**kw, nonideal=jn)
    draws = jni.draw(3, 7, 6, jn)
    want = jsearch.evaluate_population(g, seeds, SIZES, jcfg, draws=draws)
    cfg = tsearch.SearchConfig(**kw, nonideal=tni.NonIdealSpec(
        0.5, 0.01, 0.02, seed=2))
    got = tsearch.evaluate_population(g, seeds, SIZES, cfg, device="cpu",
                                      init_params=_reference_init(kind),
                                      draws=_np(draws))
    assert got.shape == want.shape == (5, 3)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    m_test = len(seeds["y_test"])
    # QAT parts in the last ulp across packages (module docstring)
    assert np.abs(got[:, 0] - want[:, 0]).max() <= 2.0 / m_test + 1e-6
    assert np.abs(got[:, 2] - want[:, 2]).max() <= 2.0 / m_test + 1e-6


def test_reference_engine_and_dedup_agree(seeds):
    rng = np.random.default_rng(5)
    g = _genomes(rng, 4)
    g[3] = g[1]
    ni = tni.NonIdealSpec(0.6, 0.0, 0.05, seed=1)
    kw = dict(bits=3, pop_size=4, train_steps=10, mc_samples=5, nonideal=ni)
    batched = tsearch.evaluate_population(g, seeds, SIZES,
                                          tsearch.SearchConfig(**kw),
                                          device="cpu")
    nodedup = tsearch.evaluate_population(
        g, seeds, SIZES, tsearch.SearchConfig(**kw, dedup=False),
        device="cpu")
    np.testing.assert_array_equal(nodedup, batched)
    mc_eval.reset_launches()
    reference = tsearch.evaluate_population_reference(
        g, seeds, SIZES, tsearch.SearchConfig(**kw, engine="reference"),
        device="cpu")
    assert sum(mc_eval.launches.values()) == 0       # CPU: plain versions
    # the reference engine trains one lane at a time: on the CPU its
    # lanes equal the batched ones here; its columns are float64
    np.testing.assert_allclose(reference, batched, rtol=0, atol=1e-6)


def test_mc_rescore_is_independent_of_lane_count(seeds):
    """mc_accuracies gives each design the same result whether it is
    scored alone, among padded copies, or in a permuted front."""
    spec = AdcSpec(bits=3)
    rng = np.random.default_rng(8)
    masks = repair_mask(torch.from_numpy(
        (rng.random((5, 7, 8)) < 0.5).astype(np.int32)))
    params = [(torch.from_numpy(rng.normal(size=(5, 7, 3)).astype(
                   np.float32)), torch.zeros(5, 3)),
              (torch.from_numpy(rng.normal(size=(5, 3, 3)).astype(
                   np.float32)), torch.zeros(5, 3))]
    dps = torch.tensor([-1.0, 0.0, -2.0, 1.0, 0.0])
    x = torch.from_numpy(seeds["x_test"].astype(np.float32))
    y = torch.from_numpy(seeds["y_test"].astype(np.int64))
    ni = tni.NonIdealSpec(0.5, 0.02, 0.05, seed=3)
    draws = tni.draw(3, 7, 6, ni)
    whole = tsearch.mc_accuracies(
        "mlp", params, dps, tni.mc_quantize(x, masks, spec, ni, draws=draws),
        y)
    order = [3, 0, 4, 4, 1, 2, 2, 0]
    perm = tsearch.mc_accuracies(
        "mlp", [(w[order], b[order]) for w, b in params], dps[order],
        tni.mc_quantize(x, masks[order], spec, ni, draws=draws), y)
    assert torch.equal(perm, whole[order])
    for i in (0, 3):
        alone = tsearch.mc_accuracies(
            "mlp", [(w[i:i + 1], b[i:i + 1]) for w, b in params],
            dps[i:i + 1], tni.mc_quantize(x, masks[i:i + 1], spec, ni,
                                          draws=draws), y)
        assert torch.equal(alone[0], whole[i])
    # fewer instances: the first S' of the same stream, sliced
    fewer = tsearch.mc_accuracies(
        "mlp", params, dps, tni.mc_quantize(
            x, masks, spec, ni, draws=tuple(a[:2] for a in draws)), y)
    assert torch.equal(fewer, whole[:, :2])


@pytest.fixture(scope="module")
def robust_fronts(seeds):
    """A robust front per objective, searched and exported by the port on
    the CPU: {objective: (cfg, pg, pf, designs)}."""
    out = {}
    for kind, objective in (("mlp", "expected"), ("svm", "worst"),
                            ("mlp", "yield")):
        ni = tni.NonIdealSpec(0.5, 0.01, 0.02, seed=6)
        cfg = tsearch.SearchConfig(bits=3, pop_size=6, generations=2,
                                   train_steps=12, model=kind, nonideal=ni,
                                   mc_samples=8, robust_objective=objective)
        pg, pf, _, trained = tsearch.run_search(seeds, SIZES, cfg,
                                                return_trained=True,
                                                device="cpu")
        designs = tdeploy.export_front(pg, seeds, SIZES, cfg,
                                       trained=trained, device="cpu")
        out[objective] = (cfg, pg, pf, designs)
    return out


@pytest.mark.parametrize("objective", ["expected", "worst", "yield"])
def test_search_export_reproduces_third_column(seeds, robust_fronts,
                                               objective, tmp_path):
    """Exit test 4: evaluate_robustness on the exported (and saved and
    loaded) front gives the searched third column bit for bit."""
    cfg, pg, pf, designs = robust_fronts[objective]
    assert pf.shape[1] == 3 and cfg.n_objectives == 3
    tdeploy.save_front(tmp_path, designs)
    loaded = tdeploy.load_front(tmp_path)
    rep = tdeploy.evaluate_robustness(loaded, cfg.nonideal, seeds["x_test"],
                                      seeds["y_test"],
                                      samples=cfg.mc_samples,
                                      yield_margins=(cfg.yield_margin,),
                                      device="cpu")
    key = {"expected": "expected_drop", "worst": "worst_case_error"}
    for i, row in enumerate(rep["designs"]):
        col = (1.0 - row["yield"][f"{cfg.yield_margin:g}"]
               if objective == "yield" else row[key[objective]])
        assert col == pf[i, 2]
    assert tdeploy.verify_front_parity(designs, pg, seeds, SIZES, cfg,
                                       device="cpu")
    tdeploy.save_robustness(tmp_path, rep)
    assert tdeploy.load_robustness(tmp_path) == json.loads(json.dumps(rep))


@pytest.mark.parametrize("instance", [0, 7])
def test_nonideal_bank_serves_the_listed_instance(seeds, robust_fronts,
                                                  instance):
    cfg, _, _, designs = robust_fronts["expected"]
    rep = tdeploy.evaluate_robustness(designs, cfg.nonideal,
                                      seeds["x_test"], seeds["y_test"],
                                      samples=8, device="cpu")
    fn = tdeploy.make_nonideal_bank_fn(designs, cfg.nonideal,
                                       instance=instance, samples=8,
                                       device="cpu")
    logits = fn(seeds["x_test"])
    assert logits.shape == (len(designs), len(seeds["y_test"]), 3)
    y = torch.from_numpy(seeds["y_test"].astype(np.int64))
    served = tdeploy._mean_acc(torch.argmax(logits, -1) == y[None]).numpy()
    want = np.array([r["instance_accuracies"][instance]
                     for r in rep["designs"]], np.float32)
    np.testing.assert_array_equal(served, want)
    with pytest.raises(ValueError, match="outside"):
        tdeploy.make_nonideal_bank_fn(designs, cfg.nonideal, instance=8,
                                      samples=8, device="cpu")


def test_zero_sigma_report_is_the_exported_accuracy(seeds, robust_fronts):
    cfg, _, _, designs = robust_fronts["expected"]
    rep = tdeploy.evaluate_robustness(designs, tni.NonIdealSpec(seed=5),
                                      seeds["x_test"], seeds["y_test"],
                                      samples=4, device="cpu")
    for d, row in zip(designs, rep["designs"]):
        assert row["instance_accuracies"] == [d.accuracy] * 4
        assert row["mean_accuracy"] == d.accuracy
        assert row["yield"] == {"0.01": 1.0, "0.05": 1.0}
    curve = tdeploy.robustness_curve(designs, seeds["x_test"],
                                     seeds["y_test"], [0.0, 1.0],
                                     samples=4, device="cpu")
    assert curve["mean_accuracy"][0] == [d.accuracy for d in designs]
    assert len(curve["points"]) == 2


# ------------------------------------------------------- api and the CLIs
def test_api_verbs(seeds):
    spec = AdcSpec(bits=2)
    ni = api.NonIdealSpec(sigma_offset=0.5, seed=1)
    front = api.search(spec, seeds, sizes=SIZES, pop_size=4, generations=1,
                       train_steps=6, nonideal=ni, mc_samples=4,
                       robust_objective="worst", device="cpu")
    assert front.fitness.shape[1] == 3
    bank = api.deploy(front)
    rep = api.evaluate_robustness(bank, ni, seeds["x_test"],
                                  seeds["y_test"], samples=4, device="cpu")
    assert rep == bank.evaluate_robustness(ni, seeds["x_test"],
                                           seeds["y_test"], 4, device="cpu")
    for i, row in enumerate(rep["designs"]):
        assert row["worst_case_error"] == front.fitness[i, 2]
    curve = api.robustness_curve(bank, seeds["x_test"], seeds["y_test"],
                                 [0.0, 0.5], samples=2, device="cpu")
    assert curve["sigma_offset"] == [0.0, 0.5]


@pytest.mark.parametrize("argv, msg", [
    (["--nonideal-sigma", "0.5"], "need --mc-samples"),
    (["--mc-samples", "4"], "without any non-ideality knob"),
    (["--mc-samples", "4", "--nonideal-sigma", "0.5", "--yield-margins",
      "2"], "yield-margins"),
    (["--faulttol"], "--faulttol extends")])
def test_train_cli_checks(argv, msg, capsys):
    with pytest.raises(SystemExit) as exc:
        ttrain.main(["--adc-search", "--device", "cpu"] + argv)
    assert exc.value.code == 2
    assert msg in capsys.readouterr().err


def test_train_cli_writes_robustness_report(tmp_path, capsys):
    pf = ttrain.main(["--adc-search", "--dataset", "seeds", "--bits", "2",
                      "--pop", "4", "--generations", "1", "--train-steps",
                      "6", "--device", "cpu", "--mc-samples", "4",
                      "--nonideal-sigma", "0.5", "--robust-objective",
                      "worst", "--export-front", "--ckpt-dir",
                      str(tmp_path)])
    out = capsys.readouterr().out
    assert pf.shape[1] == 3 and "best-robust" in out
    rep = tdeploy.load_robustness(tmp_path / "front")
    assert rep["samples"] == 4 and rep["nonideal"]["sigma_offset"] == 0.5
    for i, row in enumerate(rep["designs"]):
        assert row["worst_case_error"] in set(pf[:, 2])


def test_serve_cli_serves_a_sampled_instance(cardio, capsys):
    rep = tserve.main(["--front-dir", str(FIXTURES / "cardio_mlp"),
                       "--dataset", "cardio", "--device", "cpu",
                       "--requests", "8", "--nonideal-sigma", "0.5",
                       "--mc-samples", "4", "--nonideal-instance", "2"])
    out = capsys.readouterr().out
    assert "served a sampled non-ideal instance" in out
    designs = tdeploy.load_front(FIXTURES / "cardio_mlp")
    full = tdeploy.evaluate_robustness(
        designs, tni.NonIdealSpec(sigma_offset=0.5), cardio["x_test"],
        cardio["y_test"], samples=4, device="cpu")
    assert rep["served_accuracies"] == [
        r["instance_accuracies"][2] for r in full["designs"]]
    assert len(rep["yield"]) == len(designs)


def test_serve_cli_refuses(capsys):
    base = ["--front-dir", str(FIXTURES / "cardio_mlp"), "--dataset",
            "cardio", "--device", "cpu"]
    with pytest.raises(SystemExit):
        tserve.main(base + ["--calibrate"])
    assert "needs --nonideal-sigma" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        tserve.main(base + ["--driver", "async", "--nonideal-sigma", "0.5"])
    assert "--nonideal-* needs --driver batch, or add --calibrate" in \
        capsys.readouterr().err


def test_serve_cli_async_calibrates_every_tenant(cardio, capsys):
    """--driver async with --nonideal-* --calibrate: the tenant serves the
    calibrated tables of measured instance 0 (one calibration, no
    recovery), and the post-run parity of the exported front holds."""
    rep = tserve.main(["--front-dir", str(FIXTURES / "cardio_svm"),
                       "--driver", "async", "--device", "cpu",
                       "--requests", "6", "--rate", "2000",
                       "--nonideal-sigma", "0.3", "--fault-rate", "0.05",
                       "--calibrate"])
    out = capsys.readouterr().out
    assert "calibrations: cardio: 1" in out and "parity OK" in out
    assert rep["calibrations"] == {"cardio": 1} and rep["recoveries"] == 0
    designs = tdeploy.calibrate_front(
        tdeploy.load_front(FIXTURES / "cardio_svm"),
        tni.NonIdealSpec(sigma_offset=0.3, fault_rate=0.05), instance=0,
        device="cpu")
    from repro_torch.launch import loadgen
    wl = loadgen.make_workload(cardio["x_test"], 6, tenant="cardio",
                               rate_rps=2000.0)
    for req in wl:
        got = rep["responses"][req.rid]
        if got is not None:
            want = tdeploy.serve_bank(designs, req.x, device="cpu")
            np.testing.assert_array_equal(got, want.argmax(-1).numpy())


@pytest.mark.parametrize("call", ["evaluate_robustness", "robustness_curve",
                                  "make_nonideal_bank_fn"])
def test_entry_points_default_to_cuda(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    designs = tdeploy.load_front(FIXTURES / "cardio_svm")
    x = np.zeros((4, designs[0].channels), np.float32)
    y = np.zeros(4, np.int64)
    ni = tni.NonIdealSpec(sigma_offset=0.5)
    fn = {"evaluate_robustness": lambda: tdeploy.evaluate_robustness(
              designs, ni, x, y, samples=2),
          "robustness_curve": lambda: tdeploy.robustness_curve(
              designs, x, y, [0.0], samples=2),
          "make_nonideal_bank_fn": lambda: tdeploy.make_nonideal_bank_fn(
              designs, ni)}[call]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()


def test_config_robustness_fields():
    ni = tni.NonIdealSpec(sigma_offset=0.5)
    assert tsearch.SearchConfig().n_objectives == 2
    cfg = tsearch.SearchConfig(nonideal=ni, mc_samples=4)
    assert cfg.wants_robustness and cfg.n_objectives == 3
    assert not tsearch.SearchConfig(nonideal=ni).wants_robustness
    with pytest.raises(ValueError, match="robust_objective"):
        tsearch.SearchConfig(robust_objective="median")
    with pytest.raises(ValueError, match="mc_samples"):
        tsearch.SearchConfig(mc_samples=-1)
    with pytest.raises(ValueError, match="yield_margin"):
        tsearch.SearchConfig(yield_margin=1.0)
    assert tsearch.search_draws(tsearch.SearchConfig(), 7) is None
    d = tsearch.search_draws(cfg, 7)
    assert d.eps.shape == (4, 7, 15)


# ------------------------------------------------------------- on the card
@pytest.mark.gpu
@pytest.mark.parametrize("case", ["compiled", "overlapping",
                                  "overlapping 2^N=128"])
@pytest.mark.parametrize("entry", list(PLAIN))
def test_kernel_matches_plain_version_on_card(entry, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(17)
    dev = torch.device("cuda")
    if case == "compiled":
        ops_np = _mc_case(rng, entry, bits=4, c=21, s=8, p=5, m=1000,
                          special=True)
    else:
        bits, c = (7, 8) if "128" in case else (4, 21)
        ops_np = _overlapping_case(rng, entry, bits=bits, c=c)
    operands = tuple(torch.from_numpy(np.array(a)).to(dev)
                     for a in ops_np)
    before = mc_eval.launches[entry]
    got = getattr(mc_eval, entry)(*operands)
    want = PLAIN[entry][0](*operands)
    torch.cuda.synchronize()
    assert mc_eval.launches[entry] == before + 1
    assert torch.equal(got, want)
