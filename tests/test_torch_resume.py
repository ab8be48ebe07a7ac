"""Port parity, search checkpoint/resume and the Table 5 baseline:
repro_torch.checkpoint.manager, core.search.{search_state_tree,
restore_search_state, run_search(ckpt=, resume=), full_adc_baseline,
evaluate_population_acc} and the launch.train CLI, against the JAX
package on the CPU at small sizes (the seeds dataset, SIZES = (7, 4, 3),
2-bit ADC, pop 4).

* Checkpoints cross packages both ways: a search state (plain, and
  screened with the surrogate's leaves) written by either package
  restores in the other to the identical EvolveState (genomes, fitness,
  generation, the Generator's stream) and surrogate leaves, bitwise; a
  search resumed in the port from the reference's checkpoint equals the
  port continuing that same state.
* A search killed after a generation and resumed equals the
  uninterrupted one bitwise: plain, screened (screen_factor=2) and
  robust (3 objectives, whose Monte-Carlo draws are a pure function of
  the config).
* The baseline: areas bitwise; accuracy within 2 test samples of the
  reference's with the reference's initial weights injected (the
  cross-package QAT rule of tests/test_torch_search.py).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import manager as jmanager  # noqa: E402
from repro.core import nsga2 as jnsga2  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core import surrogate as jsur  # noqa: E402
from repro.data import tabular as jtab  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.checkpoint import manager as tmanager  # noqa: E402
from repro_torch.core import adc as tadc  # noqa: E402
from repro_torch.core import nsga2 as tnsga2  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core import surrogate as tsur  # noqa: E402
from repro_torch.core.nonideal import NonIdealSpec  # noqa: E402
from repro_torch.core.spec import AdcSpec  # noqa: E402
from repro_torch.faulttol import FaultTolSpec  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

SIZES = (7, 4, 3)
KINDS = ["mlp", "svm"]
G = tsearch.genome_len(7, 2)


@pytest.fixture(scope="module")
def seeds():
    return jtab.make_dataset("seeds")


def small(**kw):
    base = dict(bits=2, pop_size=4, generations=3, train_steps=10, seed=0)
    base.update(kw)
    return tsearch.SearchConfig(**base)


# ----------------------------------------------------------- the manager
def test_manager_keeps_the_newest_steps(tmp_path):
    ckpt = tmanager.CheckpointManager(tmp_path, keep=2)
    assert ckpt.latest_step() is None and ckpt.all_steps() == []
    for step in (3, 1, 7, 5):
        ckpt.save(step, {"a": np.full(2, step, np.int64)})
    assert ckpt.all_steps() == [5, 7] and ckpt.latest_step() == 7
    (tmp_path / "step_9.tmp").mkdir()           # an interrupted save
    (tmp_path / "step_x").mkdir()
    assert ckpt.all_steps() == [5, 7]
    # the format is the reference's: either manager reads the other's
    ref = jmanager.CheckpointManager(tmp_path, keep=2)
    assert ref.latest_step() == 7
    np.testing.assert_array_equal(ref.restore_flat(7)["a"], [7, 7])
    ref.save(8, {"b": {"c": np.arange(3, dtype=np.float32)}},
             blocking=True)
    assert ckpt.all_steps() == [7, 8]
    np.testing.assert_array_equal(ckpt.restore_flat(8)["b/c"],
                                  np.arange(3, dtype=np.float32))
    assert tadc.init_full_mask(2).tolist() == [1, 1, 1, 1]
    assert tadc.init_full_mask(3, 5).shape == (5, 8)
    assert tadc.init_full_mask(3, 5).dtype == torch.int32


# ----------------------------------------------------- cross-package state
def _state(rng, fit_cols=2, generation=1):
    r = np.random.default_rng(42)
    r.random(17)                                 # a stream mid-way
    return tnsga2.EvolveState(
        pop=(rng.random((4, G)) < 0.5).astype(np.uint8),
        fit=rng.random((4, fit_cols)), generation=generation, rng=r)


def _same_state(a, b):
    np.testing.assert_array_equal(a.pop, b.pop)
    np.testing.assert_array_equal(a.fit, b.fit)
    assert a.pop.dtype == np.uint8 and a.fit.dtype == np.float64
    assert a.generation == b.generation
    assert a.rng.bit_generator.state == b.rng.bit_generator.state
    np.testing.assert_array_equal(a.rng.random(5), b.rng.random(5))


def _ref_surrogate(pop, fit):
    return jsur.observe(jsur.init(G, fit.shape[1], hidden=8, seed=3), pop,
                        fit, steps=4)


@pytest.mark.parametrize("screened", [False, True])
def test_reference_checkpoint_restores_in_port(tmp_path, screened):
    st = _state(np.random.default_rng(1), generation=2)
    ref_sur = _ref_surrogate(st.pop, st.fit) if screened else None
    jmanager.CheckpointManager(tmp_path).save(
        2, jsearch.search_state_tree(st, ref_sur), blocking=True)
    ckpt = tmanager.CheckpointManager(tmp_path)
    like = tsur.init(G, 2, hidden=8, device="cpu") if screened else None
    out = tsearch.restore_search_state(ckpt, 2, 4, G, n_obj=2,
                                       surrogate_like=like)
    got, sur = out if screened else (out, None)
    _same_state(got, _state(np.random.default_rng(1), generation=2))
    if screened:
        want = [np.asarray(a) for a in jax.tree_util.tree_leaves(ref_sur)]
        got_leaves = tsur.leaves(sur)
        assert len(got_leaves) == len(want)
        for a, b in zip(got_leaves, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="genomes of shape"):
        tsearch.restore_search_state(ckpt, 2, 5, G)
    with pytest.raises(ValueError, match="fitness of shape"):
        tsearch.restore_search_state(ckpt, 2, 4, G, n_obj=3)
    if not screened:
        with pytest.raises(ValueError, match="no surrogate state"):
            tsearch.restore_search_state(ckpt, 2, 4, G,
                                         surrogate_like=tsur.init(G, 2,
                                                                device="cpu"))


@pytest.mark.parametrize("screened", [False, True])
def test_port_checkpoint_restores_in_reference(tmp_path, screened):
    rng = np.random.default_rng(2)
    st = _state(rng, fit_cols=3, generation=5)
    sur = None
    if screened:
        sur = tsur.state_from_numpy(
            [np.asarray(a) for a in jax.tree_util.tree_leaves(
                jsur.init(G, 3, hidden=8, seed=1))], device="cpu")
        sur = tsur.observe(sur, st.pop, st.fit, steps=4)
    tmanager.CheckpointManager(tmp_path).save(
        5, tsearch.search_state_tree(st, sur))
    ckpt = jmanager.CheckpointManager(tmp_path)
    out = jsearch.restore_search_state(
        ckpt, 5, 4, G, n_obj=3,
        surrogate_like=jsur.init(G, 3, hidden=8) if screened else None)
    got, jsur_state = out if screened else (out, None)
    _same_state(got, _state(np.random.default_rng(2), 3, 5))
    if screened:
        for a, b in zip(tsur.leaves(sur),
                        jax.tree_util.tree_leaves(jsur_state)):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("screened", [False, True])
def test_search_resumes_from_a_reference_checkpoint(seeds, tmp_path,
                                                    screened):
    """The reference writes generation 1 of a search; the port resumes
    it to generation 3, equal bitwise to the port continuing the same
    state, surrogate included."""
    cfg = small(screen_factor=2 if screened else 1)
    data = tsearch.device_data(seeds, "cpu")
    eval_fn = tsearch.make_eval_fn(data, SIZES, cfg)
    rng = np.random.default_rng(3)
    pop = (rng.random((4, G)) < 0.5).astype(np.uint8)
    fit = eval_fn(pop)
    ref_sur = None
    if screened:
        ref_sur = jsur.observe(jsur.init(G, 2, seed=cfg.seed), pop, fit,
                               steps=cfg.surrogate_steps)
    jmanager.CheckpointManager(tmp_path).save(
        1, jsearch.search_state_tree(jnsga2.EvolveState(
            pop, fit, 1, np.random.default_rng(5)), ref_sur), blocking=True)
    pg, pf, _ = tsearch.run_search(
        seeds, SIZES, cfg, ckpt=tmanager.CheckpointManager(tmp_path),
        resume=True, device="cpu")
    kw = {}
    if screened:
        sur = [tsur.state_from_numpy(
            [np.asarray(a) for a in jax.tree_util.tree_leaves(ref_sur)],
            device="cpu")]

        def on_eval(g, f):
            sur[0] = tsur.observe(sur[0], g, f, steps=cfg.surrogate_steps)

        kw = dict(offspring_factor=2, on_evaluated=on_eval,
                  screen_fn=lambda c: tsur.screen(sur[0], c, 4))
    want = tnsga2.pareto_front(*tnsga2.evolve(
        eval_fn, G, pop_size=4, generations=3,
        state=tnsga2.EvolveState(pop, fit, 1, np.random.default_rng(5)),
        **kw))
    np.testing.assert_array_equal(pg, want[0])
    np.testing.assert_array_equal(pf, want[1])


# ----------------------------------------------------- killed and resumed
class Killed(RuntimeError):
    pass


def _killed_then_resumed(seeds, cfg, tmp_path):
    """Run ``cfg`` with its save hook raising after generation 1, then
    resume it from the checkpoint."""
    ckpt = tmanager.CheckpointManager(tmp_path / "search", keep=2)
    orig = ckpt.save

    def save_then_die(step, tree):
        orig(step, tree)
        if step == 1:
            raise Killed()

    ckpt.save = save_then_die
    with pytest.raises(Killed):
        tsearch.run_search(seeds, SIZES, cfg, ckpt=ckpt, device="cpu")
    ckpt.save = orig
    assert ckpt.all_steps() == [0, 1]
    out = tsearch.run_search(seeds, SIZES, cfg, ckpt=ckpt, resume=True,
                             return_trained=True, device="cpu")
    assert ckpt.all_steps() == [cfg.generations - 1, cfg.generations]
    return out


@pytest.mark.parametrize("case", ["plain", "screened", "robust"])
def test_killed_search_resumes_bit_identically(seeds, tmp_path, case):
    kw = {"plain": {}, "screened": dict(screen_factor=2),
          "robust": dict(nonideal=NonIdealSpec(sigma_offset=0.5,
                                               fault_rate=0.02),
                         mc_samples=4, robust_objective="worst")}[case]
    cfg = small(**kw)
    pg, pf, _, trained = tsearch.run_search(seeds, SIZES, cfg,
                                            return_trained=True,
                                            device="cpu")
    rg, rf, _, rtrained = _killed_then_resumed(seeds, cfg, tmp_path)
    np.testing.assert_array_equal(rg, pg)
    np.testing.assert_array_equal(rf, pf)
    np.testing.assert_array_equal(rtrained[0], trained[0])
    assert pf.shape[1] == (3 if case == "robust" else 2)
    # the re-train reproduces the fitness of a resumed front too
    np.testing.assert_array_equal(
        (1.0 - rtrained[0].astype(np.float32)).astype(np.float64), rf[:, 0])


def test_screen_factor_one_is_the_unscreened_search(seeds):
    cfg = small(generations=2)
    pg, pf, _ = tsearch.run_search(seeds, SIZES, cfg, device="cpu")
    pop, fit = tnsga2.evolve(
        tsearch.make_eval_fn(seeds, SIZES, cfg, device="cpu"), G,
        pop_size=4, generations=2, seed=0)
    want = tnsga2.pareto_front(pop, fit)
    np.testing.assert_array_equal(pg, want[0])
    np.testing.assert_array_equal(pf, want[1])


def test_screened_front_reproduces_and_is_deterministic(seeds):
    cfg = small(screen_factor=3, generations=2)
    pg, pf, _ = tsearch.run_search(seeds, SIZES, cfg, device="cpu")
    np.testing.assert_array_equal(
        tsearch.evaluate_population(pg, seeds, SIZES, cfg, device="cpu"), pf)
    assert (tnsga2.fast_non_dominated_sort(pf) == 0).all()
    pg2, pf2, _ = tsearch.run_search(seeds, SIZES, cfg, device="cpu")
    np.testing.assert_array_equal(pg, pg2)
    np.testing.assert_array_equal(pf, pf2)
    with pytest.raises(ValueError, match="grad_lambda"):
        tsearch.SearchConfig(grad_lambda_lo=0.0)
    with pytest.raises(ValueError, match="grad_polish"):
        tsearch.SearchConfig(grad_polish_evals=0)


def test_api_search_takes_a_checkpoint(seeds, tmp_path):
    spec = AdcSpec(bits=2)
    ckpt = tmanager.CheckpointManager(tmp_path)
    front = api.search(spec, seeds, sizes=SIZES, pop_size=4, generations=2,
                       train_steps=6, ckpt=ckpt, device="cpu")
    assert ckpt.all_steps() == [0, 1, 2]
    again = api.search(spec, seeds, sizes=SIZES, pop_size=4, generations=2,
                       train_steps=6, ckpt=ckpt, resume=True, device="cpu")
    np.testing.assert_array_equal(again.genomes, front.genomes)
    np.testing.assert_array_equal(again.fitness, front.fitness)


# ------------------------------------------------------------- baseline
def _reference_init(kind):
    params, _ = jsearch._init_model(SIZES, jsearch.SearchConfig(model=kind))
    params = jax.tree_util.tree_map(np.asarray, params)
    return tuple(params) if kind == "svm" else params


@pytest.mark.parametrize("kind", KINDS)
def test_full_adc_baseline_matches_reference(seeds, kind):
    kw = dict(bits=2, pop_size=4, train_steps=10, model=kind)
    want = jsearch.full_adc_baseline(seeds, SIZES, jsearch.SearchConfig(**kw))
    cfg = tsearch.SearchConfig(**kw)
    got = tsearch.full_adc_baseline(seeds, SIZES, cfg, device="cpu",
                                    init_params=_reference_init(kind))
    assert sorted(got) == sorted(want)
    for key in ("area_flash_tc", "area_binary_baseline_tc",
                "area_binary_ours_tc"):
        assert got[key] == want[key] and type(got[key]) is int
    assert abs(got["accuracy"] - want["accuracy"]) <= (
        2.0 / len(seeds["y_test"]) + 1e-6)
    # the port's own column: the all-ones, dp = -3 genome through the
    # fixed-lane QAT, equal to evaluate_population_acc bitwise
    genome = np.ones((1, G), np.uint8)
    genome[0, 28:32] = [1, 0, 1, 0]
    acc = tsearch.evaluate_population_acc(genome, seeds, SIZES, cfg,
                                          device="cpu")
    assert acc.dtype == np.float32 and acc.shape == (1,)
    mine = tsearch.full_adc_baseline(seeds, SIZES, cfg, device="cpu")
    assert mine["accuracy"] == 1.0 - float(np.float32(1.0) - acc[0])


def test_faulttol_baseline_has_no_redundancy(seeds):
    """With a FaultTolSpec the baseline's redundancy genes are zeroed: its
    accuracy is the plain baseline's, bitwise."""
    cfg = tsearch.SearchConfig(bits=2, pop_size=4, train_steps=10)
    plain = tsearch.full_adc_baseline(seeds, SIZES, cfg, device="cpu")
    ft = dataclasses.replace(cfg, nonideal=NonIdealSpec(sigma_offset=0.5),
                             mc_samples=4, faulttol=FaultTolSpec())
    got = tsearch.full_adc_baseline(seeds, SIZES, ft, device="cpu")
    assert got == plain


# ------------------------------------------------------------------ CLI
def test_cli_gradient_screened_and_resumed_on_cpu(tmp_path, capsys):
    base = ["--adc-search", "--dataset", "seeds", "--bits", "2",
            "--pop", "4", "--train-steps", "4", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    pf = ttrain.main(base + ["--engine", "gradient", "--generations", "0"])
    out = capsys.readouterr().out
    assert "gate family + exact re-score" in out and pf.shape[1] == 2
    assert (tmp_path / "adc_search").is_dir()   # gate-train chunks
    pf = ttrain.main(base + ["--screen-factor", "2", "--generations", "2"])
    out = capsys.readouterr().out
    assert "surrogate screening: 2x offspring" in out and "gen  1" in out
    # a fresh start removed the gradient run's steps first
    assert tmanager.CheckpointManager(
        tmp_path / "adc_search").all_steps() == [1, 2]
    whole = ttrain.main(base + ["--generations", "3"])
    ttrain.main(base + ["--generations", "1"])
    capsys.readouterr()
    resumed = ttrain.main(base + ["--generations", "3", "--resume"])
    assert "resuming from step 1" in capsys.readouterr().out
    np.testing.assert_array_equal(resumed, whole)
