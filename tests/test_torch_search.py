"""Port parity, the search slice: repro_torch.core.{nsga2,area,search},
core.deploy.export_front / verify_front_parity, the api verbs and the
launch.train CLI against the JAX package, on the CPU at small sizes (the
seeds dataset, pop <= 8, <= 20 QAT steps).

What is bitwise and what is not:

* nsga2, the area model, genome decode and the area column: bitwise
  (numpy copies and integer work).
* The accuracy column against the reference, both packages trained from
  the same injected initial weights: within 2 test samples (2/63) per
  individual; in every case measured at these sizes they are equal. It
  cannot be bitwise in general: the matmuls, log_softmax and means round
  in other orders, and Adam divides each gradient by its own magnitude,
  so a roundoff-level gradient component (1e-11, a cancellation residue)
  becomes an lr-sized step whose sign is noise. On cardio's MLP the two
  packages' trajectories split within about 5 steps.
* Inside the port, bitwise: search fitness == re-trained accuracy ==
  exported accuracy == served accuracy, in either package's server. The
  batched and reference engines agree within 1e-6, as the reference's own
  engines are held (the reference engine's column is computed in float64,
  the batched one's in float32).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import area as jarea  # noqa: E402
from repro.core import deploy as jdeploy  # noqa: E402
from repro.core import nsga2 as jnsga2  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.data import tabular as jtab  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import area as tarea  # noqa: E402
from repro_torch.core import deploy as tdeploy  # noqa: E402
from repro_torch.core import nsga2 as tnsga2  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core.spec import AdcSpec  # noqa: E402
from repro_torch.launch import serve_classifier as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

SIZES = (7, 3, 3)        # seeds: 7 features, hidden 3, 3 classes
KINDS = ["mlp", "svm"]


@pytest.fixture(scope="module")
def seeds():
    return jtab.make_dataset("seeds")


def _genomes(rng, p, bits=3, channels=7):
    g = (rng.random((p, channels * 2 ** bits + 4)) < 0.5).astype(np.uint8)
    g[0] = 1                                   # the full design
    return g


def _toy_fitness(pop):
    """A deterministic two-objective function of the genome bits."""
    g = pop.astype(np.float64)
    w = np.cos(np.arange(g.shape[1]))
    return np.stack([g.mean(1), (1.0 - g) @ np.abs(w) / len(w)], axis=1)


def test_nsga2_copy_is_bitwise():
    kw = dict(genome_len=37, pop_size=10, generations=4, seed=3)
    logs = {"j": [], "t": []}
    jp, jf = jnsga2.evolve(_toy_fitness, log=lambda g, p, f: logs["j"].append(
        (g, p.copy(), f.copy())), **kw)
    tp, tf = tnsga2.evolve(_toy_fitness, log=lambda g, p, f: logs["t"].append(
        (g, p.copy(), f.copy())), **kw)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tf, jf)
    for (a, pa, fa), (b, pb, fb) in zip(logs["j"], logs["t"]):
        assert a == b
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(fa, fb)
    rng = np.random.default_rng(0)
    F = rng.integers(0, 5, size=(40, 2)).astype(np.float64)
    rank = tnsga2.fast_non_dominated_sort(F)
    np.testing.assert_array_equal(rank, jnsga2.fast_non_dominated_sort(F))
    np.testing.assert_array_equal(tnsga2.crowding_distance(F, rank),
                                  jnsga2.crowding_distance(F, rank))
    for a, b in zip(tnsga2.pareto_front(jp, jf), jnsga2.pareto_front(jp, jf)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6])
def test_area_copy_is_bitwise(bits):
    rng = np.random.default_rng(bits)
    masks = (rng.random((40, 2 ** bits)) < rng.uniform(0.05, 0.95, (40, 1))
             ).astype(np.int32)
    masks[0] = 1
    masks[1] = 0
    for fn in ("flash_full_tc", "ours_full_tc", "baseline_binary_tc",
               "flash_encoder_tc"):
        assert getattr(tarea, fn)(bits) == getattr(jarea, fn)(bits)
    for m in masks:
        for fn in ("pruned_binary_tc", "pruned_flash_tc",
                   "pruned_baseline_tc"):
            assert getattr(tarea, fn)(m) == getattr(jarea, fn)(m)
    for design in ("ours", "flash", "baseline"):
        assert tarea.system_tc(masks, design) == jarea.system_tc(masks,
                                                                 design)


@pytest.mark.parametrize("bits", [2, 3, 4])
def test_decode_and_population_areas_are_bitwise(bits):
    rng = np.random.default_rng(10 + bits)
    g = _genomes(rng, 12, bits)
    g[1, :7 * 2 ** bits] = 0                  # every channel repaired
    assert tsearch.genome_len(7, bits) == jsearch.genome_len(7, bits)
    tm, td = tsearch.decode_population(g, 7, bits, 2)
    jm, jd = jsearch.decode_population(jax.numpy.asarray(g), 7, bits, 2)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert td.dtype == torch.float32 and tm.dtype == torch.int32
    m1, d1 = tsearch.decode_genome(g[3], 7, bits)
    np.testing.assert_array_equal(m1.numpy(), np.asarray(jm[3]))
    assert float(d1) == float(jd[3])
    for design in ("ours", "baseline"):
        tcfg = tsearch.SearchConfig(bits=bits, design=design)
        jcfg = jsearch.SearchConfig(bits=bits, design=design)
        np.testing.assert_array_equal(
            tsearch.population_areas(g, 7, tcfg),
            jsearch.population_areas(g, 7, jcfg))


def _reference_init(kind):
    """The reference's initial params as numpy arrays (its layout)."""
    params, _ = jsearch._init_model(SIZES, jsearch.SearchConfig(model=kind))
    params = jax.tree_util.tree_map(np.asarray, params)
    return tuple(params) if kind == "svm" else params


@pytest.mark.parametrize("kind", KINDS)
def test_fitness_matches_reference_with_injected_init(seeds, kind):
    rng = np.random.default_rng(1 if kind == "mlp" else 2)
    g = _genomes(rng, 8)
    g[5] = g[2]                                # a duplicate: one lane
    kw = dict(bits=3, pop_size=8, train_steps=20, model=kind)
    want = jsearch.evaluate_population(g, seeds, SIZES,
                                       jsearch.SearchConfig(**kw))
    init = _reference_init(kind)
    cfg = tsearch.SearchConfig(**kw)
    got = tsearch.evaluate_population(g, seeds, SIZES, cfg, device="cpu",
                                      init_params=init)
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    m_test = len(seeds["y_test"])
    assert np.abs(got[:, 0] - want[:, 0]).max() <= 2.0 / m_test + 1e-6
    # the port's engines: dedup on/off and the per-individual reference
    nodedup = tsearch.SearchConfig(**kw, dedup=False)
    np.testing.assert_array_equal(
        tsearch.evaluate_population(g, seeds, SIZES, nodedup, device="cpu",
                                    init_params=init), got)
    ref = tsearch.evaluate_population_reference(
        g, seeds, SIZES, tsearch.SearchConfig(**kw, engine="reference"),
        device="cpu", init_params=init)
    np.testing.assert_allclose(ref, got, rtol=0, atol=1e-6)


def test_fixed_lane_count_pads_and_chunks(seeds):
    """Any batch size trains at the fixed lane count: 11 genomes at
    pop_size 4 run as three chunks, and each lane's accuracy equals its
    own single-genome evaluation and its evaluation in another order."""
    rng = np.random.default_rng(4)
    g = _genomes(rng, 11)
    cfg = tsearch.SearchConfig(bits=3, pop_size=4, train_steps=10)
    data = tsearch.device_data(seeds, "cpu")
    whole = tsearch._fixed_lanes(g, data, SIZES, cfg)["acc"]
    assert whole.shape == (11,) and whole.dtype == np.float32
    order = rng.permutation(11)
    np.testing.assert_array_equal(
        tsearch._fixed_lanes(g[order], data, SIZES, cfg)["acc"],
        whole[order])
    for i in (0, 6, 10):
        np.testing.assert_array_equal(
            tsearch._fixed_lanes(g[i:i + 1], data, SIZES, cfg)["acc"],
            whole[i:i + 1])


@pytest.fixture(scope="module")
def port_fronts(seeds):
    """A front per kind searched and exported by the port on the CPU."""
    out = {}
    for kind in KINDS:
        cfg = tsearch.SearchConfig(bits=3, pop_size=6, generations=2,
                                   train_steps=15, model=kind)
        pg, pf, decode, trained = tsearch.run_search(
            seeds, SIZES, cfg, return_trained=True, device="cpu")
        designs = tdeploy.export_front(pg, seeds, SIZES, cfg,
                                       trained=trained, device="cpu")
        out[kind] = (cfg, pg, pf, decode, trained, designs)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_lane_purity_and_front_parity(seeds, port_fronts, kind):
    """The front re-trained, reversed and mixed with other genomes,
    reproduces its search fitness bitwise; export == re-train == serve."""
    cfg, pg, pf, decode, trained, designs = port_fronts[kind]
    accs = trained[0]
    np.testing.assert_array_equal(
        (1.0 - accs.astype(np.float32)).astype(np.float64), pf[:, 0])
    rng = np.random.default_rng(8)
    mixed = np.concatenate([_genomes(rng, 3), pg[::-1]])
    again = tsearch.train_pareto_front(mixed, seeds, SIZES, cfg,
                                       device="cpu")[0]
    np.testing.assert_array_equal(again[3:], accs[::-1])
    assert tdeploy.verify_front_parity(designs, pg, seeds, SIZES, cfg,
                                       device="cpu")
    assert [d.accuracy for d in designs] == [float(a) for a in accs]
    served = tdeploy.served_accuracies(designs, seeds["x_test"],
                                       seeds["y_test"], device="cpu")
    np.testing.assert_array_equal(served, accs.astype(np.float32))
    mask, dp = decode(pg[0])
    np.testing.assert_array_equal(mask.numpy(), designs[0].mask)
    assert float(dp) == designs[0].dp
    # a wrong accuracy breaks the parity check
    import dataclasses
    bad = [dataclasses.replace(designs[0], accuracy=designs[0].accuracy
                               + 1e-3)] + designs[1:]
    assert not tdeploy.verify_front_parity(bad, pg, seeds, SIZES, cfg,
                                           device="cpu")


@pytest.mark.parametrize("kind", KINDS)
def test_port_front_serves_in_the_reference(seeds, port_fronts, kind,
                                            tmp_path):
    """Cross-package round trip: a front the port exported and saved loads
    in repro.core.deploy.load_front and serves there at its recorded
    accuracies, with the same baked tables, weights and areas."""
    cfg, pg, _, _, _, designs = port_fronts[kind]
    api.save_front(tmp_path, designs, extra_meta={"dataset": "seeds"})
    loaded = jdeploy.load_front(tmp_path)
    assert len(loaded) == len(designs)
    for t, j in zip(designs, loaded):
        assert (t.kind, t.dp, t.area_tc, t.accuracy) == (
            j.kind, j.dp, j.area_tc, j.accuracy)
        np.testing.assert_array_equal(t.table, j.table)
        for a, b in zip(t.weights, j.weights):
            np.testing.assert_array_equal(a, b)
        assert j.area_tc == jarea.system_tc(j.mask, cfg.design)
    served = jdeploy.served_accuracies(loaded, seeds["x_test"],
                                       seeds["y_test"])
    np.testing.assert_array_equal(
        served, np.array([d.accuracy for d in designs], np.float32))


def test_api_verbs_end_to_end_on_cpu(seeds, tmp_path):
    spec = AdcSpec(bits=3)
    front = api.search(spec, seeds, sizes=SIZES, pop_size=4, generations=1,
                       train_steps=8, device="cpu")
    assert len(front) == len(front.genomes) >= 1
    assert front.config.pop_size == 4 and front.device == "cpu"
    np.testing.assert_array_equal(front.accuracies,
                                  1.0 - front.fitness[:, 0])
    bank = api.deploy(front)
    assert len(bank) == len(front) and bank.spec == spec
    logits = api.serve(bank, seeds["x_test"], device="cpu")
    assert logits.shape == (len(bank), len(seeds["x_test"]), 3)
    acc = bank.accuracies(seeds["x_test"], seeds["y_test"], device="cpu")
    np.testing.assert_array_equal(
        acc, np.array([d.accuracy for d in bank.designs], np.float32))
    api.save_front(tmp_path, bank)
    again = api.load_front(tmp_path)
    assert torch.equal(again.predict(seeds["x_test"], device="cpu"),
                       bank.predict(seeds["x_test"], device="cpu"))
    # sizes inferred from the data with the default 4 hidden units
    inferred = api.search(spec, seeds, pop_size=2, generations=0,
                          train_steps=2, device="cpu")
    assert inferred.sizes == (7, 4, 3)


def test_cli_search_export_and_serve_on_cpu(tmp_path, capsys):
    pf = ttrain.main(["--adc-search", "--dataset", "seeds", "--bits", "3",
                      "--pop", "4", "--generations", "2",
                      "--train-steps", "8", "--device", "cpu",
                      "--export-front", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "individuals/s" in out and "pareto points" in out
    assert "python -m repro_torch.launch.serve_classifier" in out
    assert pf.shape[1] == 2
    front = tmp_path / "front"
    meta = tdeploy.front_meta(front)
    assert meta["dataset"] == "seeds" and meta["sizes"] == [7, 3, 3]
    rep = tserve.main(["--front-dir", str(front), "--dataset", "seeds",
                       "--device", "cpu", "--requests", "8"])
    assert len(rep["served_accuracies"]) == meta["num_designs"]
    ttrain.main(["--adc-search", "--dataset", "seeds", "--bits", "2",
                 "--pop", "3", "--generations", "1", "--train-steps", "4",
                 "--engine", "reference", "--model", "svm",
                 "--device", "cpu", "--ckpt-dir", str(tmp_path / "svm")])
    assert "reference svm" in capsys.readouterr().out


@pytest.mark.parametrize("argv, item", [
    (["--arch", "gemma2-2b"], "A11"), ([], "--adc-search")])
def test_cli_refuses_later_slices(argv, item, capsys):
    base = ["--adc-search"] if argv else []
    with pytest.raises(SystemExit) as exc:
        ttrain.main(base + argv + ["--device", "cpu"])
    assert exc.value.code == 2
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("field, item", [
    (dict(engine="sharded"), "A9"), (dict(frontend=object()), "A8")])
def test_config_refuses_later_slices(field, item):
    with pytest.raises(NotImplementedError, match=item):
        tsearch.SearchConfig(**field)


def test_config_checks_and_checkpoint_refused(seeds):
    with pytest.raises(ValueError, match="engine"):
        tsearch.SearchConfig(engine="pymoo")
    with pytest.raises(ValueError, match="model"):
        tsearch.SearchConfig(model="tree")
    with pytest.raises(ValueError, match="screen_factor"):
        tsearch.SearchConfig(screen_factor=0)
    cfg = tsearch.SearchConfig(vmin=[0.0] * 7, vmax=np.ones(7))
    assert cfg.vmin == (0.0,) * 7 and cfg.adc_spec.channels == 7
    assert tsearch.SearchConfig.for_spec(AdcSpec(bits=2), pop_size=3
                                         ).adc_spec == AdcSpec(bits=2)
