"""Port parity, sharded search and sharded banks (DESIGN.md §7): the
port's mesh, axis rules, elastic meshes, sharded quantizer and bank
entries, sharded engine and its search -> export -> serve path against
repro and against the port's own unsharded paths, on the CPU (plain
versions) with two-entry meshes of the one CPU device.

* The axis rules, ``plan_mesh`` and areas: exact.
* Sharded quantizer and banks: bitwise against the unsharded entries
  and the reference's sharded entries on its default mesh, on the
  committed fixture fronts (dyadic tables, po2 weights).
* The sharded engine: bitwise against the port's batched engine in
  every config (each shard pads its slice to ``pop_size`` lanes, the
  fixed lane count); against the reference's sharded engine within 2
  test samples, the cross-package QAT rule (ROADMAP §C).
* A mesh of one device twice gives two shards: the spies count them and
  check the device each shard's tensors lie on.
"""
import pytest

torch = pytest.importorskip("torch")

from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import deploy as jdeploy  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core.spec import AdcSpec as JAdcSpec  # noqa: E402
from repro.data import tabular as jtab  # noqa: E402
from repro.distributed import elastic as jelastic  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core import deploy as tdeploy  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core.nonideal import NonIdealSpec  # noqa: E402
from repro_torch.core.spec import AdcSpec  # noqa: E402
from repro_torch.distributed import elastic as telastic  # noqa: E402
from repro_torch.distributed import sharding as tsharding  # noqa: E402
from repro_torch.faulttol.spec import FaultTolSpec  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.optim.adamw import tree_leaves as adamw_leaves  # noqa: E402
from repro_torch.timeseries import cosearch as tcosearch  # noqa: E402
from repro_torch.timeseries import feature as tfeature  # noqa: E402
from repro_torch.timeseries import stream as tstream  # noqa: E402
from repro_torch.timeseries.feature import FeatureSpec  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "fronts"
CPU = torch.device("cpu")
SIZES = (7, 3, 3)        # seeds: 7 features, hidden 3, 3 classes
KINDS = ["mlp", "svm"]


def _mesh2():
    return tmesh.make_mesh((2, 1), ("data", "model"), devices=["cpu", "cpu"])


def _mesh4():
    """A (2, 2) mesh of the CPU: its smallest rule covers 2 shards, so an
    odd leading axis falls back to the unsharded path."""
    return tmesh.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)


@pytest.fixture(scope="module")
def seeds():
    return jtab.make_dataset("seeds")


@pytest.fixture(scope="module")
def fixture_fronts():
    """{kind: (port designs, reference designs)} of the fixture fronts."""
    return {k: (tdeploy.load_front(FIXTURES / f"cardio_{k}"),
                jdeploy.load_front(FIXTURES / f"cardio_{k}"))
            for k in KINDS}


@pytest.fixture(scope="module")
def cardio():
    return jtab.make_dataset("cardio")


def _genomes(rng, p, glen):
    g = (rng.random((p, glen)) < 0.5).astype(np.uint8)
    g[0] = 1
    return g


class Killed(RuntimeError):
    pass


def _reference_init(kind):
    params, _ = jsearch._init_model(SIZES, jsearch.SearchConfig(model=kind))
    params = jax.tree_util.tree_map(np.asarray, params)
    return tuple(params) if kind == "svm" else params


# ------------------------------------------------------------- axis rules
_SHAPES = [(("data", "model"), (d, m)) for d in (1, 2, 3, 4, 8)
           for m in (1, 2, 4)] + [
    (("pod", "data", "model"), (p, d, m)) for p in (1, 2)
    for d in (1, 2, 4) for m in (1, 2)] + [
    (("data",), (2,)), (("model",), (3,)), (("pod", "data"), (2, 2))]


@pytest.mark.parametrize("names, shape", _SHAPES,
                         ids=lambda v: "x".join(map(str, v)))
def test_axis_rules_equal_the_reference(names, shape):
    mesh = SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))
    assert tsharding.RULES_POPULATION == jsharding.RULES_POPULATION
    assert tsharding.dp_axes(mesh) == jsharding.dp_axes(mesh)
    for p in range(1, 65):
        assert tsharding.population_axes(mesh, p) == \
            jsharding.population_axes(mesh, p), p
        assert tsharding.design_bank_axes(mesh, p) == \
            jsharding.design_bank_axes(mesh, p), p


@pytest.mark.parametrize("model", [16, 4, 1])
def test_plan_mesh_equals_the_reference(model):
    for n in range(1, 601):
        assert telastic.plan_mesh(n, model=model) == \
            jelastic.plan_mesh(n, model=model), n


def test_rules_take_the_ports_mesh_as_the_reference_takes_jaxs():
    mesh = _mesh4()
    jmesh = SimpleNamespace(axis_names=mesh.axis_names, shape=mesh.shape)
    for p in range(1, 17):
        assert tsharding.population_axes(mesh, p) == \
            jsharding.population_axes(jmesh, p)
    assert tsharding.population_axes(mesh, 7) is None


# ------------------------------------------------------------------ meshes
def test_make_mesh_holds_devices_axes_and_shape():
    mesh = tmesh.make_mesh((2, 2), ("data", "model"),
                           devices=["cpu", torch.device("cpu")] * 2)
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.axis_names == ("data", "model") and mesh.size == 4
    assert mesh.devices.shape == (2, 2) and mesh.devices.dtype == object
    assert all(d == CPU for d in mesh.devices.reshape(-1))
    assert mesh.first_device == CPU
    assert tmesh.describe(mesh) == "mesh(shape={'data': 2, 'model': 2}, " \
                                   "devices=4)"
    host = tmesh.make_host_mesh(2, 1, device="cpu")
    assert host.shape == {"data": 2, "model": 1}
    assert list(host.devices.reshape(-1)) == [CPU, CPU]
    with pytest.raises(ValueError, match="needs 4 devices"):
        tmesh.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="does not fit"):
        tmesh.make_mesh((2,), ("data", "model"), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="unsupported device"):
        tmesh.make_mesh((1,), ("data",), devices=["meta"])
    prod = tmesh.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and prod.size == 256
    assert tmesh.make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    assert {d.type for d in prod.devices.reshape(-1)} == {"meta"}


def test_elastic_meshes_over_device_lists(tmp_path):
    pool = telastic.bank_pool_mesh(["cpu"] * 3)
    assert pool.shape == {"data": 3, "model": 1}
    assert list(pool.devices.reshape(-1)) == [CPU] * 3
    with pytest.raises(ValueError, match="at least one device"):
        telastic.bank_pool_mesh([])
    for n in (1, 2, 3, 5, 8, 20, 40):
        mesh = telastic.make_elastic_mesh(["cpu"] * n, model=4)
        pods, data, tp = telastic.plan_mesh(n, model=4)
        want = (pods, data, tp) if pods > 1 else (data, tp)
        assert mesh.devices.shape == want and mesh.size <= n
        assert mesh.axis_names == (("pod", "data", "model") if pods > 1
                                   else ("data", "model"))
    pods = telastic.make_elastic_mesh(["cpu"] * 520, model=16)
    assert pods.shape == {"pod": 2, "data": 16, "model": 16}
    assert pods.size == 512                   # 8 remainder devices wait
    # reshard_state restores an LM train state onto a new mesh (the
    # dp-size cases, int8 rows included: tests/test_torch_dp_train.py)
    from repro_torch.configs import smoke_config
    from repro_torch.models import steps
    cfg = smoke_config("deepseek-7b")
    state = steps.init_state(cfg, seed=3, device="cpu")
    CheckpointManager(tmp_path).save(5, state)
    got = telastic.reshard_state(CheckpointManager(tmp_path), 5, state,
                                 pool, cfg)
    assert got.err is None and int(got.opt.step) == 0
    for a, b in zip(adamw_leaves(got.params), adamw_leaves(state.params)):
        assert a.device == CPU and torch.equal(a, b)


def test_shard_plan_follows_shard_map_block_order():
    """Shard k runs on the first device of the k-th slice along the axes,
    major to minor in the axes' order; other axes replicate."""
    grid = np.empty((2, 3), dtype=object)
    grid[:] = [[f"d{i}{j}" for j in range(3)] for i in range(2)]
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 2, "model": 3}, devices=grid)
    plan = tsharding.shard_plan(mesh, ("data", "model"), 12)
    assert [d for d, _ in plan] == ["d00", "d01", "d02", "d10", "d11",
                                    "d12"]
    assert [(s.start, s.stop) for _, s in plan] == [
        (0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 12)]
    assert [d for d, _ in tsharding.shard_plan(mesh, ("model",), 3)] == [
        "d00", "d01", "d02"]
    assert [d for d, _ in tsharding.shard_plan(mesh, ("data",), 4)] == [
        "d00", "d10"]
    assert [d for d, _ in tsharding.shard_plan(
        mesh, ("model", "data"), 6)] == ["d00", "d10", "d01", "d11", "d02",
                                        "d12"]
    assert tsharding.shard_plan(mesh, None, 5) == [("d00", slice(0, 5))]
    with pytest.raises(ValueError, match="does not split"):
        tsharding.shard_plan(mesh, ("data",), 5)
    with pytest.raises(ValueError, match="not distinct axes"):
        tsharding.shard_plan(mesh, ("pod",), 4)


# --------------------------------------------------------------------- ops
def _spy(monkeypatch, module, name, calls):
    orig = getattr(module, name)

    def spy(x, *args, **kw):
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        for a in args:
            if isinstance(a, tuple):
                tensors += [t for t in a if isinstance(t, torch.Tensor)]
        assert all(t.device == x.device for t in tensors), name
        calls.append((x.device, tuple(tensors[0].shape)))
        return orig(x, *args, **kw)

    monkeypatch.setattr(module, name, spy)


def test_sharded_quantizer_equals_unsharded_and_reference(monkeypatch):
    rng = np.random.default_rng(3)
    x = rng.random((40, 5)).astype(np.float32)
    masks = (rng.random((6, 5, 8)) < 0.6).astype(np.int32)
    masks[..., 0] = masks[..., -1] = 1
    spec, jspec = AdcSpec(bits=3), JAdcSpec(bits=3)
    want = tops.adc_quantize_population(torch.from_numpy(x), masks, spec=spec)
    jwant = jops.adc_quantize_population_sharded(
        jnp.asarray(x), jnp.asarray(masks), mesh=jsearch.default_search_mesh(),
        spec=jspec)
    np.testing.assert_array_equal(want.numpy(), np.asarray(jwant))
    calls = []
    _spy(monkeypatch, tops, "adc_quantize_population", calls)
    for mesh, shards in ((_mesh2(), 2), (_mesh4(), 2)):
        calls.clear()
        got = tops.adc_quantize_population_sharded(
            torch.from_numpy(x), masks, mesh=mesh, spec=spec)
        assert torch.equal(got, want)
        assert [s for _, s in calls] == [(6 // shards, 5, 8)] * shards
    calls.clear()
    odd = tops.adc_quantize_population_sharded(
        torch.from_numpy(x), masks[:5], mesh=_mesh4(), spec=spec)
    assert torch.equal(odd, want[:5]) and len(calls) == 1   # unsharded
    with pytest.raises(ValueError, match="does not split"):
        tops.adc_quantize_population_sharded(
            torch.from_numpy(x), masks[:5], mesh=_mesh2(), spec=spec,
            axes=("data",))


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_bank_equals_unsharded_and_reference(fixture_fronts, cardio,
                                                     kind, monkeypatch):
    designs, jdesigns = fixture_fronts[kind]
    x = cardio["x_test"].astype(np.float32)
    tables, weights = tdeploy.bank_arrays(designs)
    spec = designs[0].spec
    d = len(designs)
    want = tops.classifier_bank(torch.from_numpy(x),
                                torch.from_numpy(tables),
                                tuple(torch.from_numpy(w) for w in weights),
                                kind=kind, spec=spec)
    jt, jw = jdeploy.bank_arrays(jdesigns)
    jwant = jops.classifier_bank_sharded(
        jnp.asarray(x), jnp.asarray(jt), tuple(jnp.asarray(w) for w in jw),
        mesh=jsearch.default_search_mesh(), kind=kind, spec=jdesigns[0].spec)
    np.testing.assert_array_equal(want.numpy(), np.asarray(jwant))
    calls = []
    _spy(monkeypatch, tops, "classifier_bank", calls)
    # shards per (front, mesh): the MLP front holds 6 designs, the SVM
    # front 3 (on the (2, 2) mesh no rule divides 3: unsharded)
    shards = {"mlp": {("front", 2): 2, ("wide", 2): 2, ("front", 4): 2,
                      ("wide", 4): 4},
              "svm": {("front", 2): 1, ("wide", 2): 2, ("front", 4): 1,
                      ("wide", 4): 2}}[kind]
    fronts = {"front": (designs, want), "wide": (designs * 2,
                                                 torch.cat([want, want]))}
    for (which, n), count in shards.items():
        front, ref = fronts[which]
        mesh = _mesh2() if n == 2 else _mesh4()
        t, w = tdeploy.bank_arrays(front)
        calls.clear()
        got = tops.classifier_bank_sharded(torch.from_numpy(x), t, w,
                                           mesh=mesh, kind=kind, spec=spec)
        assert torch.equal(got, ref) and len(calls) == count, (which, n)
        assert sum(s[0] for _, s in calls) == len(front)
        fn = tdeploy.make_bank_fn(front, mesh=mesh)
        calls.clear()
        assert torch.equal(fn(x), ref) and len(calls) == count
        np.testing.assert_array_equal(
            tdeploy.served_accuracies(front, x, cardio["y_test"], mesh=mesh),
            np.array([dd.accuracy for dd in front], np.float32))


# ------------------------------------------------------------------ engine
def _engine_cases(seeds):
    ni = NonIdealSpec(sigma_offset=0.5, sigma_range=0.01, fault_rate=0.02)
    base = dict(bits=3, pop_size=6, train_steps=12)
    return {
        "mlp": (tsearch.SearchConfig(model="mlp", **base), None),
        "svm": (tsearch.SearchConfig(model="svm", **base), None),
        "robust": (tsearch.SearchConfig(model="mlp", nonideal=ni,
                                        mc_samples=4, **base), None),
        "ft": (tsearch.SearchConfig(model="svm", nonideal=ni, mc_samples=4,
                                    robust_objective="yield",
                                    faulttol=FaultTolSpec(), **base), None),
    }


@pytest.fixture(scope="module")
def stress_cut():
    d = tstream.make_stream("stress")
    cut = {"x_train": d["x_train"][:150], "y_train": d["y_train"][:150],
           "x_test": d["x_test"][:80], "y_test": d["y_test"][:80]}
    fe = FeatureSpec(channels=4, window=32)
    vdata, sizes, spec = tcosearch.build_search_inputs(cut, fe, bits=2,
                                                       device="cpu")
    return cut, fe, vdata, sizes, spec


@pytest.mark.parametrize("case", ["mlp", "svm", "robust", "ft", "cosearch"])
def test_sharded_engine_equals_batched_bitwise(seeds, stress_cut, case):
    """8 genomes with a duplicate (7 unique: the (2, 1) mesh's size-1
    'model' rule takes them as one trivial shard), 6 unique ones (two
    shards of 3, each padded to ``pop_size`` lanes) and, on the (2, 2)
    mesh, the 7 unique genomes that no rule divides (the batched
    fallback)."""
    rng = np.random.default_rng(hash(case) % 1000)
    if case == "cosearch":
        _, fe, data, sizes, spec = stress_cut
        cfg = tsearch.SearchConfig.for_spec(spec, frontend=fe, pop_size=4,
                                            train_steps=8)
    else:
        data, sizes = seeds, SIZES
        cfg = _engine_cases(seeds)[case][0]
    glen = tsearch.genome_len(sizes[0], cfg.bits, cfg.faulttol,
                              frontend=cfg.frontend)
    g = _genomes(rng, 8, glen)
    g[5] = g[2]
    six = g[[0, 1, 2, 3, 4, 6]]
    for pop, mesh in ((g, _mesh2()), (six, _mesh2()), (g, _mesh4())):
        want = tsearch.evaluate_population(pop, data, sizes, cfg,
                                           device="cpu")
        got = tsearch.evaluate_population_sharded(pop, data, sizes, cfg,
                                                  mesh)
        assert got.shape == want.shape == (len(pop), cfg.n_objectives)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_engine_against_the_reference(seeds, kind):
    rng = np.random.default_rng(21 if kind == "mlp" else 22)
    kw = dict(bits=3, pop_size=6, train_steps=15, model=kind)
    g = _genomes(rng, 6, tsearch.genome_len(7, 3))
    g[4] = g[1]
    want = jsearch.evaluate_population_sharded(
        g, seeds, SIZES, jsearch.SearchConfig(engine="sharded", **kw))
    got = tsearch.evaluate_population_sharded(
        g, seeds, SIZES, tsearch.SearchConfig(engine="sharded", **kw),
        _mesh2(), init_params=_reference_init(kind))
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    assert np.abs(got[:, 0] - want[:, 0]).max() <= \
        2.0 / len(seeds["y_test"]) + 1e-6


def test_each_shard_runs_on_its_device_with_its_slice(seeds, monkeypatch):
    """Spies on the per-shard evaluation and on the kernel entries: on
    the (2, 1) mesh of the CPU twice, shard k gets rows [3k, 3k + 3) of
    the unique genomes, the mesh device k's dataset and draw replica
    (built once per search, never per generation), and every tensor a
    kernel entry receives lies on x's device."""
    ni = NonIdealSpec(sigma_offset=0.5, fault_rate=0.02)
    cfg = tsearch.SearchConfig(bits=3, pop_size=6, train_steps=5,
                               nonideal=ni, mc_samples=3, engine="sharded")
    mesh = _mesh2()
    built, shards, entries = [], [], []
    orig_rep, orig_lanes = tsearch._mesh_replicas, tsearch._fixed_lanes

    def replicas(*a, **kw):
        out = orig_rep(*a, **kw)
        built.append(out)
        return out

    def lanes(genomes, data, sizes, cfg, init_params=None,
              return_params=False, draws=None):
        dev = data["x_train"].device
        assert all(t.device == dev for t in data.values())
        assert all(t.device == dev for t in draws)
        rep_data, rep_draws = built[-1][dev]
        assert data is rep_data and draws is rep_draws
        shards.append((dev, genomes.copy()))
        return orig_lanes(genomes, data, sizes, cfg, init_params,
                          return_params, draws)

    monkeypatch.setattr(tsearch, "_mesh_replicas", replicas)
    monkeypatch.setattr(tsearch, "_fixed_lanes", lanes)
    for name in ("adc_quantize_population", "mc_eval_population"):
        _spy(monkeypatch, tsearch.ops, name, entries)
    fn = tsearch.make_eval_fn(seeds, SIZES, cfg, mesh=mesh)
    rng = np.random.default_rng(5)
    for _ in range(2):                       # two generations
        g = np.unique(_genomes(rng, 6, tsearch.genome_len(7, 3)), axis=0)
        shards.clear()
        fn(g)
        assert [d for d, _ in shards] == list(mesh.devices.reshape(-1))
        np.testing.assert_array_equal(
            np.concatenate([s for _, s in shards]), g)
        assert [len(s) for _, s in shards] == [3, 3]
    assert len(built) == 1 and list(built[0]) == [CPU]
    # 2 generations x 2 shards x (train, test quantizer + 1 MC entry)
    assert len(entries) == 2 * 2 * 3


def test_default_search_mesh_and_config():
    mesh = tsearch.default_search_mesh("cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.first_device == CPU
    assert tsearch.SearchConfig(engine="sharded").engine == "sharded"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsearch.default_search_mesh()


def test_work_device_is_the_meshs_first_device():
    mesh = _mesh2()
    assert tmesh.work_device("cpu") == CPU
    assert tmesh.work_device(None, mesh) == CPU
    assert tmesh.work_device("cpu", mesh) == CPU
    assert tsearch.search_device("sharded", "cpu") == CPU
    assert tsearch.search_device("batched", "cpu", mesh) == CPU
    assert tsearch.search_mesh("batched", "cpu", mesh) is None
    assert tsearch.search_mesh("sharded", None, mesh) is mesh


# a mesh whose work runs on a card no CPU caller can mean
_ELSEWHERE = SimpleNamespace(first_device=torch.device("cuda", 1))


@pytest.mark.parametrize("entry", [
    "work_device", "make_bank_fn", "serve", "run_search", "cosearch",
    "api.search"])
def test_a_device_beside_a_conflicting_mesh_raises(entry, fixture_fronts):
    """Every entry that takes both ``device`` and ``mesh`` resolves them
    through ``launch.mesh.work_device``: a device that is not the mesh's
    first device raises instead of being ignored."""
    from repro_torch.launch import serve_classifier
    designs = fixture_fronts["mlp"][0]
    data = {"x_train": np.zeros((4, 7), np.float32)}
    calls = {
        "work_device": lambda: tmesh.work_device("cpu", _ELSEWHERE),
        "make_bank_fn": lambda: tdeploy.make_bank_fn(
            designs, device="cpu", mesh=_ELSEWHERE),
        "serve": lambda: serve_classifier.serve(
            designs, [], 8, device="cpu", mesh=_ELSEWHERE),
        "run_search": lambda: tsearch.run_search(
            data, SIZES, tsearch.SearchConfig(engine="sharded"),
            device="cpu", mesh=_ELSEWHERE),
        "cosearch": lambda: tcosearch.run(
            data, FeatureSpec(channels=2, window=16), device="cpu",
            mesh=_ELSEWHERE, engine="sharded"),
        "api.search": lambda: api.search(
            AdcSpec(bits=3), data, SIZES, engine="sharded", device="cpu",
            mesh=_ELSEWHERE)}
    with pytest.raises(ValueError, match="conflicts with the mesh"):
        calls[entry]()


# --------------------------------------------------------- search to serve
def test_sharded_search_resumes_exports_and_serves(seeds, tmp_path):
    """run_search(engine='sharded') on the (2, 1) mesh: equal to the
    batched search bitwise, a run killed after generation 1 resumes to
    the uninterrupted one, and the front exports, verifies and serves
    design-sharded at its fitness."""
    kw = dict(bits=3, pop_size=6, generations=2, train_steps=10)
    mesh = _mesh2()
    cfg = tsearch.SearchConfig(engine="sharded", **kw)
    pg, pf, _, trained = tsearch.run_search(seeds, SIZES, cfg, mesh=mesh,
                                            return_trained=True,
                                            ckpt=CheckpointManager(
                                                tmp_path / "whole"))
    bg, bf, _ = tsearch.run_search(seeds, SIZES,
                                   tsearch.SearchConfig(**kw), device="cpu")
    np.testing.assert_array_equal(pg, bg)
    np.testing.assert_array_equal(pf, bf)
    parted = CheckpointManager(tmp_path / "parted")
    orig = parted.save

    def save(step, tree):
        orig(step, tree)
        if step == 1:
            raise Killed()

    parted.save = save
    with pytest.raises(Killed):
        tsearch.run_search(seeds, SIZES, cfg, mesh=mesh, ckpt=parted)
    parted.save = orig
    rg, rf, _ = tsearch.run_search(seeds, SIZES, cfg, mesh=mesh, ckpt=parted,
                                   resume=True)
    np.testing.assert_array_equal(rg, pg)
    np.testing.assert_array_equal(rf, pf)
    designs = tdeploy.export_front(pg, seeds, SIZES, cfg, trained=trained,
                                   device="cpu")
    assert tdeploy.verify_front_parity(designs, pg, seeds, SIZES, cfg,
                                       device="cpu")
    exported = np.array([d.accuracy for d in designs], np.float32)
    np.testing.assert_array_equal(
        (1.0 - pf[:, 0]).astype(np.float32), exported)
    wide = designs * 2
    for front in (designs, wide):
        np.testing.assert_array_equal(
            tdeploy.served_accuracies(front, seeds["x_test"],
                                      seeds["y_test"], mesh=mesh),
            np.array([d.accuracy for d in front], np.float32))
    bank = api.Bank(designs=tuple(wide))
    assert torch.equal(bank.logits(seeds["x_test"], mesh=mesh),
                       bank.logits(seeds["x_test"], device="cpu"))
    np.testing.assert_array_equal(
        bank.accuracies(seeds["x_test"], seeds["y_test"], mesh=mesh),
        np.concatenate([exported, exported]))
    assert torch.equal(api.serve(bank, seeds["x_test"], mesh=mesh),
                       api.serve(bank, seeds["x_test"], device="cpu"))


def test_api_sharded_search_and_cosearch(seeds, stress_cut):
    mesh = _mesh2()
    spec = AdcSpec(bits=3)
    kw = dict(pop_size=6, generations=1, train_steps=8)
    front = api.search(spec, seeds, SIZES, engine="sharded", mesh=mesh, **kw)
    batched = api.search(spec, seeds, SIZES, device="cpu", **kw)
    assert front.device == "cpu" and front.config.engine == "sharded"
    np.testing.assert_array_equal(front.fitness, batched.fitness)
    cut, fe = stress_cut[0], stress_cut[1]
    ckw = dict(bits=2, pop_size=4, generations=1, train_steps=8)
    cs = api.cosearch(cut, fe, engine="sharded", mesh=mesh, **ckw)
    cb = api.cosearch(cut, fe, device="cpu", **ckw)
    np.testing.assert_array_equal(cs.genomes, cb.genomes)
    np.testing.assert_array_equal(cs.fitness, cb.fitness)


def test_feature_bank_shards_within_each_subsample_group(stress_cut,
                                                         monkeypatch):
    """A feature-baked front of 2 + 2 + 1 designs over three subsample
    groups: the (2, 1) mesh splits the even groups in two and takes the
    odd one as a trivial shard; the (2, 2) mesh runs the odd group
    unsharded. The logits scatter back into front order, bitwise."""
    cut, fe, vdata, sizes, spec = stress_cut
    c = fe.feature_channels
    rng = np.random.default_rng(13)
    g = (rng.random((5, tsearch.genome_len(c, 2, frontend=fe))) < 0.6
         ).astype(np.uint8)
    base = c * 4 + tsearch.DP_BITS
    for i, sub in enumerate((0, 1, 0, 1, 2)):
        g[i, base:] = tfeature.encode_genes(fe, sub, rng.integers(0, 4, c))
    cfg = tsearch.SearchConfig.for_spec(spec, frontend=fe, pop_size=5,
                                        train_steps=6)
    designs = tdeploy.export_front(g, vdata, sizes, cfg, device="cpu")
    groups = tdeploy._feature_groups(designs)
    assert sorted(len(v) for v in groups.values()) == [1, 2, 2]
    want = tdeploy.serve_bank(designs, cut["x_test"], device="cpu")
    calls = []
    _spy(monkeypatch, tops, "classifier_bank", calls)
    for mesh, launches in ((_mesh2(), 5), (_mesh4(), 5)):
        calls.clear()
        got = tdeploy.serve_bank(designs, cut["x_test"], mesh=mesh)
        assert torch.equal(got, want) and len(calls) == launches
    np.testing.assert_array_equal(
        tdeploy.served_accuracies(designs, cut["x_test"], cut["y_test"],
                                  mesh=_mesh2()),
        np.array([d.accuracy for d in designs], np.float32))
