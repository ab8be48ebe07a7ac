"""Port parity, the serving slice end to end: fronts exported and saved by
the JAX package load in repro_torch and serve (on the CPU, through the
plain versions) at exactly their exported accuracies, with logits bitwise
equal to repro.core.deploy.serve_bank; fronts saved by the port load in
the JAX package; the port's batch driver answers every request as
repro.launch.serve_classifier does. Exported fronts have dyadic tables,
power-of-two weights and fixed-point biases, so bitwise is the contract."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import manager as jmanager  # noqa: E402
from repro.core import deploy as jdeploy  # noqa: E402
from repro.core import search  # noqa: E402
from repro.data import tabular as jtab  # noqa: E402
from repro.launch import loadgen as jloadgen  # noqa: E402
from repro.launch import serve_classifier as jserve  # noqa: E402
from repro_torch.checkpoint import manager as tmanager  # noqa: E402
from repro_torch.core import deploy as tdeploy  # noqa: E402
from repro_torch.data import tabular as ttab  # noqa: E402
from repro_torch.launch import serve_classifier as tserve  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "fronts"
SIZES = (7, 4, 3)
KINDS = ["mlp", "svm"]


@pytest.fixture(scope="module")
def jax_fronts(tmp_path_factory):
    """A small front per kind, searched, exported and saved by the JAX
    package: {kind: (directory, designs)}, plus the seeds dataset."""
    data = jtab.make_dataset("seeds")
    fronts = {}
    for kind in KINDS:
        cfg = search.SearchConfig(bits=3, pop_size=6, generations=1,
                                  train_steps=30, model=kind)
        pg, _, _, trained = search.run_search(data, SIZES, cfg,
                                              return_trained=True)
        designs = jdeploy.export_front(pg, data, SIZES, cfg,
                                       trained=trained)
        out = tmp_path_factory.mktemp(f"front_{kind}")
        jdeploy.save_front(out, designs, extra_meta={"dataset": "seeds"})
        fronts[kind] = (out, designs)
    return data, fronts


def _assert_same_design(t, j):
    assert (t.kind, t.bits, t.mode, t.vmin, t.vmax) == (
        j.kind, j.bits, j.mode, j.vmin, j.vmax)
    assert (t.dp, t.area_tc, t.accuracy, t.calibrated) == (
        j.dp, j.area_tc, j.accuracy, j.calibrated)
    np.testing.assert_array_equal(t.mask, j.mask)
    np.testing.assert_array_equal(t.table, j.table)
    assert t.table.dtype == np.float32
    assert len(t.weights) == len(j.weights)
    for a, b in zip(t.weights, j.weights):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_front_serves_exactly_in_port(jax_fronts, kind):
    data, fronts = jax_fronts
    directory, jdesigns = fronts[kind]
    designs = tdeploy.load_front(directory)
    assert len(designs) == len(jdesigns)
    for t, j in zip(designs, jdesigns):
        _assert_same_design(t, j)
    x, y = data["x_test"], data["y_test"]
    served = tdeploy.served_accuracies(designs, x, y, device="cpu")
    exported = np.array([d.accuracy for d in jdesigns])
    assert served.dtype == np.float32
    np.testing.assert_array_equal(served, exported)
    got = tdeploy.serve_bank(designs, x, device="cpu").numpy()
    np.testing.assert_array_equal(got, jdeploy.serve_bank(jdesigns, x))
    d0, j0 = designs[0], jdesigns[0]
    np.testing.assert_array_equal(d0.logits(x, device="cpu").numpy(),
                                  j0.logits(x))
    np.testing.assert_array_equal(d0.predict(x, device="cpu").numpy(),
                                  j0.predict(x))
    assert d0.accuracy_on(x, y, device="cpu") == j0.accuracy_on(x, y)
    assert tdeploy.front_meta(directory) == jdeploy.front_meta(directory)


@pytest.mark.parametrize("kind", KINDS)
def test_weight_carry_from_numpy(jax_fronts, kind):
    """from_numpy carries a JAX design's arrays into the port, checked."""
    _, fronts = jax_fronts
    j = fronts[kind][1][0]
    meta = j.spec.to_meta()
    t = tdeploy.from_numpy(kind, meta, j.table, j.weights, mask=j.mask,
                           dp=j.dp, area_tc=j.area_tc, accuracy=j.accuracy)
    _assert_same_design(t, j)
    with pytest.raises(ValueError, match="float32"):
        tdeploy.from_numpy(kind, meta, j.table.astype(np.float64), j.weights,
                           mask=j.mask, dp=0, area_tc=0, accuracy=0)
    with pytest.raises(ValueError, match="must be"):
        tdeploy.from_numpy(kind, meta, j.table, (j.weights[0][:, :1],)
                           + tuple(j.weights[1:]), mask=j.mask, dp=0,
                           area_tc=0, accuracy=0)
    with pytest.raises(ValueError, match="needs weights"):
        tdeploy.from_numpy(kind, meta, j.table, j.weights[:1], mask=j.mask,
                           dp=0, area_tc=0, accuracy=0)
    with pytest.raises(ValueError, match="unknown classifier kind"):
        tdeploy.from_numpy("tree", meta, j.table, j.weights, mask=j.mask,
                           dp=0, area_tc=0, accuracy=0)


@pytest.mark.parametrize("kind", KINDS)
def test_port_saved_front_loads_in_jax(jax_fronts, kind, tmp_path):
    data, fronts = jax_fronts
    designs = tdeploy.load_front(fronts[kind][0])
    tdeploy.save_front(tmp_path, designs, extra_meta={"dataset": "seeds"})
    back = jdeploy.load_front(tmp_path)
    for t, j in zip(designs, back):
        _assert_same_design(t, j)
    assert jdeploy.front_meta(tmp_path) == tdeploy.front_meta(tmp_path)
    served = jdeploy.served_accuracies(back, data["x_test"], data["y_test"])
    np.testing.assert_array_equal(served, [d.accuracy for d in designs])
    again = tdeploy.load_front(tmp_path)
    for a, b in zip(again, designs):
        _assert_same_design(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_batch_driver_matches_reference_driver(jax_fronts, kind):
    data, fronts = jax_fronts
    directory, jdesigns = fronts[kind]
    designs = tdeploy.load_front(directory)
    reqs = tserve.make_request_stream(data["x_test"], 21, 5, seed=3)
    jreqs = jserve.make_request_stream(data["x_test"], 21, 5, seed=3)
    for (rt, xt), (rj, xj) in zip(reqs, jreqs):
        assert rt == rj
        np.testing.assert_array_equal(xt, xj)
    rep = tserve.serve(designs, reqs, 16, device="cpu")
    jrep = jserve.serve(jdesigns, jreqs, 16)
    for key in ("num_designs", "kind", "bits", "batch", "requests",
                "samples", "batches", "pad_fraction"):
        assert rep[key] == jrep[key], key
    assert rep["device"] == "cpu"
    for rid, preds in jrep["responses"].items():
        np.testing.assert_array_equal(rep["responses"][rid], preds)


@pytest.mark.parametrize("kind", KINDS)
def test_fixture_fronts_serve_at_recorded_accuracies(kind):
    """The committed cardio fronts (written by the JAX package through
    tools/make_port_fixture_fronts.py) serve at their recorded accuracies
    in both packages."""
    directory = FIXTURES / f"cardio_{kind}"
    meta = tdeploy.front_meta(directory)
    assert meta["dataset"] == "cardio" and meta["kind"] == kind
    assert meta["search_config"]["bits"] == 4
    assert meta["search_config"]["pop_size"] == 16
    data = ttab.make_dataset("cardio")
    designs = tdeploy.load_front(directory)
    assert designs[0].channels == ttab.SPECS["cardio"].features == 21
    recorded = np.array([d.accuracy for d in designs])
    np.testing.assert_array_equal(
        tdeploy.served_accuracies(designs, data["x_test"], data["y_test"],
                                  device="cpu"), recorded)
    jdesigns = jdeploy.load_front(directory)
    np.testing.assert_array_equal(
        jdeploy.served_accuracies(jdesigns, data["x_test"], data["y_test"]),
        recorded)


def test_cli_serves_fixture_with_parity():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_classifier",
         "--front-dir", str(FIXTURES / "cardio_mlp"), "--dataset", "cardio",
         "--requests", "32", "--batch", "64", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "parity OK: served == exported accuracy for every design" in \
        out.stdout
    rep = tserve.main(["--front-dir", str(FIXTURES / "cardio_svm"),
                       "--dataset", "cardio", "--requests", "8",
                       "--device", "cpu"])
    assert rep["num_designs"] == 3 and len(rep["served_accuracies"]) == 3


@pytest.mark.parametrize("driver", ["batch", "async"])
def test_cli_sharded_serves_at_parity(driver, capsys):
    """--sharded on both drivers: the batch driver serves through
    default_search_mesh (one CPU entry here), the async engine's pool is
    sharded (one entry: no live mesh); the answers are the unsharded
    run's, with the parity printed."""
    argv = ["--front-dir", str(FIXTURES / "cardio_mlp"), "--dataset",
            "cardio", "--device", "cpu", "--requests", "16", "--driver",
            driver]
    plain = tserve.main(argv)
    rep = tserve.main(argv + ["--sharded"])
    out = capsys.readouterr().out
    assert "sharded=True" in out and "parity OK" in out
    assert rep["responses"].keys() == plain["responses"].keys()
    for rid, got in rep["responses"].items():
        np.testing.assert_array_equal(got, plain["responses"][rid])
    if driver == "async":
        assert rep["devices"]["sharded"] is False
    else:
        assert rep["served_accuracies"] == plain["served_accuracies"]


def test_cli_refuses_sharded_with_nonideal(capsys):
    """The reference's refusal: the batch driver's --sharded and a
    sampled non-ideal instance are mutually exclusive."""
    argv = ["--front-dir", str(FIXTURES / "cardio_mlp"), "--dataset",
            "cardio", "--device", "cpu", "--sharded", "--nonideal-sigma",
            "0.5"]
    with pytest.raises(SystemExit) as exc:
        tserve.main(argv)
    assert exc.value.code == 2
    assert "--sharded and --nonideal-* are mutually exclusive" in \
        capsys.readouterr().err
    with pytest.raises(ValueError, match="mutually exclusive"):
        tserve.serve(tdeploy.load_front(FIXTURES / "cardio_mlp"), [], 8,
                     mesh=object(), bank_fn=lambda xb: xb)


def test_cli_async_smoke_prints_parity(capsys):
    """--driver async --smoke: the tiny front served through the engine,
    16 requests of 4 rows, parity per tenant."""
    rep = tserve.main(["--driver", "async", "--smoke", "--dataset", "seeds",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "parity OK: served == exported accuracy for every tenant" in out
    assert "driver=async tenants=['seeds']" in out
    slo = rep["tenants"]["seeds"]
    assert slo["completed"] + slo["shed"] == 16 and slo["rejected"] == 0
    assert rep["batch_sizes"]["seeds"]["quantum"] == 32


def test_cli_async_serves_two_fronts_as_two_tenants(jax_fronts, capsys):
    """Two --front-dir: one tenant per front, named by its front_meta
    dataset, each answered through its own bank; the batch driver still
    refuses a second front."""
    _, fronts = jax_fronts
    argv = ["--front-dir", str(FIXTURES / "cardio_svm"), "--front-dir",
            str(fronts["mlp"][0]), "--device", "cpu", "--requests", "6",
            "--rate", "2000", "--traffic", "bursty", "--deadline-ms",
            "5000", "--max-batch", "64", "--seed", "3"]
    rep = tserve.main(argv + ["--driver", "async"])
    out = capsys.readouterr().out
    assert "tenants=['cardio', 'seeds']" in out
    assert "parity OK: served == exported accuracy for every tenant" in out
    assert {n: s["completed"] + s["shed"]
            for n, s in rep["tenants"].items()} == {"cardio": 6, "seeds": 6}
    wl = jloadgen.merge_workloads(*(
        jloadgen.make_workload(jtab.make_dataset(n)["x_test"], 6, tenant=n,
                               rate_rps=2000.0, deadline_ms=5000.0,
                               shape="bursty", seed=3)
        for n in ("cardio", "seeds")))
    banks = {"cardio": tdeploy.load_front(FIXTURES / "cardio_svm"),
             "seeds": tdeploy.load_front(fronts["mlp"][0])}
    for req in wl:
        got = rep["responses"][req.rid]
        if got is not None:
            want = tdeploy.serve_bank(banks[req.tenant], req.x,
                                      device="cpu").argmax(-1).numpy()
            np.testing.assert_array_equal(got, want)
    with pytest.raises(SystemExit) as exc:
        tserve.main(argv)
    assert exc.value.code == 2
    assert "--driver batch serves one front" in capsys.readouterr().err


def test_cli_async_fail_device_needs_a_second_entry(capsys):
    """The CLI's pool is the one --device: a loss there exhausts it (the
    reference's error on one device), and a loss after the stream ends
    is refused as a recovery that never ran."""
    argv = ["--driver", "async", "--front-dir", str(FIXTURES / "cardio_mlp"),
            "--device", "cpu", "--requests", "8", "--rate", "2000"]
    with pytest.raises(RuntimeError, match="device pool exhausted"):
        tserve.main(argv + ["--fail-device-at", "1"])
    with pytest.raises(SystemExit, match="no recovery ran"):
        tserve.main(argv + ["--fail-device-at", "100000"])


def test_cli_smoke_searches_exports_and_serves(capsys):
    """--smoke needs no front on disk: the port searches and exports a
    tiny front of the dataset, serves it, and served == exported."""
    rep = tserve.main(["--smoke", "--dataset", "seeds", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "parity OK: served == exported accuracy for every design" in out
    assert rep["requests"] == 16 and rep["samples"] == 64
    assert rep["num_designs"] >= 1 and rep["bits"] == 2
    assert len(rep["served_accuracies"]) == rep["num_designs"]


def test_smoke_front_serves_in_the_reference(tmp_path):
    """The port's smoke front (the reference's smoke config: 2 bits, pop
    6, one generation, 30 QAT steps) saved by the port serves in the JAX
    package at exactly its exported accuracies, with the same bank
    logits."""
    designs, data = tserve._smoke_front("seeds", "cpu")
    cfg = search.SearchConfig(bits=2, pop_size=6, generations=1,
                              train_steps=30)
    assert designs[0].bits == cfg.bits and designs[0].spec.vmin == cfg.vmin
    tdeploy.save_front(tmp_path, designs, extra_meta={"dataset": "seeds"})
    jdesigns = jdeploy.load_front(tmp_path)
    exported = np.array([d.accuracy for d in designs])
    np.testing.assert_array_equal(
        jdeploy.served_accuracies(jdesigns, data["x_test"], data["y_test"]),
        exported)
    np.testing.assert_array_equal(
        tdeploy.served_accuracies(designs, data["x_test"], data["y_test"],
                                  device="cpu"), exported)


def test_cli_needs_a_front_or_smoke(capsys):
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--dataset", "seeds", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--front-dir is required unless --smoke" in \
        capsys.readouterr().err


def test_cli_rejects_wrong_domain(capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--front-dir", str(FIXTURES / "cardio_mlp"),
                     "--dataset", "seeds", "--device", "cpu"])
    assert "wrong-domain" in capsys.readouterr().err


def test_mean_acc_is_jnp_mean():
    """Every count 0..M at several M: the port's accuracy mean equals
    jnp.mean's bitwise, while a true division differs for some counts
    (the trap the reciprocal form avoids)."""
    differs = 0
    for m in (63, 210, 636, 638, 1000):
        correct = np.arange(m + 1)[:, None] > np.arange(m)[None, :]
        want = np.asarray(jnp.mean(jnp.asarray(correct), axis=-1))
        got = tdeploy._mean_acc(torch.from_numpy(correct)).numpy()
        np.testing.assert_array_equal(got, want)
        true_div = (torch.from_numpy(correct).float().sum(-1) / m).numpy()
        differs += int((true_div != want).sum())
    assert differs > 0


def test_streaming_front_is_left_to_a_later_slice(jax_fronts, tmp_path):
    """The streaming slice is ported now: a front in the reference's
    streaming format (the base FeatureSpec in the meta, each design's
    baked subsample/alloc as leaves), saved by the JAX package, loads in
    the port and serves raw windows as the JAX package serves them; a
    front mixing feature-baked and tabular designs, or two base
    FeatureSpecs, is refused with the reference's messages. The name is
    the one this test had while it held the refusal of streaming fronts,
    kept so the test's record runs on unbroken."""
    import dataclasses

    from repro.timeseries.feature import FeatureSpec as JFeatureSpec
    from repro_torch.timeseries.feature import FeatureSpec
    data, fronts = jax_fronts
    _, jdesigns = fronts["mlp"]
    fe = JFeatureSpec(channels=7, window=8, features=("mean",),
                      sub_grid=(1, 2))
    baked = [dataclasses.replace(d, feature=fe.bake(1 + i % 2, [3] * 7))
             for i, d in enumerate(jdesigns)]
    jdeploy.save_front(tmp_path, baked, extra_meta={"dataset": "seeds"})
    designs = tdeploy.load_front(tmp_path)
    assert [d.feature.to_meta() for d in designs] == [
        d.feature.to_meta() for d in baked]
    assert designs[0].sample_shape == (8, 7)
    rng = np.random.default_rng(0)
    x = np.asarray(data["x_test"], np.float32)
    windows = (x[:, None, :] + rng.normal(0.0, 0.02, (len(x), 8, 7))
               ).astype(np.float32)
    want = jdeploy.served_accuracies(baked, windows, data["y_test"])
    got = tdeploy.served_accuracies(designs, windows, data["y_test"],
                                    device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(
        tdeploy.serve_bank(designs, windows, device="cpu").numpy(),
        np.asarray(jdeploy.serve_bank(baked, windows)), rtol=1e-6,
        atol=1e-6)
    tabular = tdeploy.load_front(fronts["mlp"][0])
    with pytest.raises(ValueError, match="mixed feature/tabular"):
        tdeploy.make_bank_fn([designs[0], tabular[0]], device="cpu")
    with pytest.raises(ValueError, match="mixed fronts unsupported"):
        tdeploy.save_front(tmp_path / "mixed", [designs[0], tabular[0]])
    other = dataclasses.replace(designs[0], feature=FeatureSpec(
        channels=7, window=16, features=("mean",), sub_grid=(1, 2)).bake(
            1, [3] * 7))
    with pytest.raises(ValueError, match="one base FeatureSpec"):
        tdeploy.serve_bank([designs[0], other], windows, device="cpu")


def test_checkpoint_format_is_shared(tmp_path):
    tree = {"meta": tmanager.pack_json({"a": [1, 2], "b": None}),
            "design_000": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                           "acc": np.float64(0.125), "n": np.int64(7)},
            "skip": None}
    port = tmanager.CheckpointManager(tmp_path / "port")
    port.save(1, {"stale": np.zeros(2)})
    port.save(1, tree)                           # replaces the first save
    assert not (tmp_path / "port" / "step_1.tmp").exists()
    from_jax = jmanager.CheckpointManager(tmp_path / "port").restore_flat(1)
    from_port = port.restore_flat(1)
    assert sorted(from_jax) == sorted(from_port) == [
        "design_000/acc", "design_000/n", "design_000/w", "meta"]
    for k in from_port:
        np.testing.assert_array_equal(from_port[k], from_jax[k])
        assert from_port[k].dtype == from_jax[k].dtype
    assert tmanager.unpack_json(from_port["meta"]) == {"a": [1, 2],
                                                       "b": None}
    jmanager.CheckpointManager(tmp_path / "jax").save(
        0, {k: v for k, v in tree.items() if v is not None}, blocking=True)
    back = tmanager.CheckpointManager(tmp_path / "jax").restore_flat(0)
    for k in from_port:
        np.testing.assert_array_equal(back[k], from_port[k])
    meta = json.loads((tmp_path / "port" / "step_1" /
                       "metadata.json").read_text())
    assert meta["leaves"]["design_000/w"] == {"shape": [2, 3],
                                              "dtype": "float32"}


def test_tabular_copy_matches_reference():
    assert ttab.SPECS == {k: ttab.TabularSpec(**vars(v))
                          for k, v in jtab.SPECS.items()}
    for name in ("seeds", "cardio"):
        a, b = ttab.make_dataset(name, seed=1), jtab.make_dataset(name,
                                                                  seed=1)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
