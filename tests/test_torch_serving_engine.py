"""Port parity, the async serving tier (DESIGN.md §12): the port's load
generator, fault module and serving engine held against repro's on the
same inputs, on the CPU (plain versions). Traces are bitwise; the
controller's ladder and history equal on the same latency sequence;
both engines answer every request identically on the committed cardio
fixture fronts (dyadic tables and po2 weights, so logits are bitwise),
with shedding counted, routing and wrong-domain rejection, closed loop,
a device loss on a two-entry pool of one device (bitwise parity after
recovery; the last entry's loss raises), calibrate-on-recovery (which
the reference can only run on two devices) and a raw-window tenant.
Latencies, batch counts and trajectories depend on the clock, so no
test compares them across packages."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import math  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import deploy as jdeploy  # noqa: E402
from repro.core import nonideal as jnonideal  # noqa: E402
from repro.distributed import fault as jfault  # noqa: E402
from repro.launch import loadgen as jloadgen  # noqa: E402
from repro.launch import serving_engine as jse  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import deploy as tdeploy  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core.nonideal import NonIdealSpec  # noqa: E402
from repro_torch.data import tabular as ttab  # noqa: E402
from repro_torch.distributed import fault as tfault  # noqa: E402
from repro_torch.launch import loadgen as tloadgen  # noqa: E402
from repro_torch.launch import serving_engine as tse  # noqa: E402
from repro_torch.timeseries import cosearch as tcosearch  # noqa: E402
from repro_torch.timeseries import feature as tfeature  # noqa: E402
from repro_torch.timeseries import stream as tstream  # noqa: E402
from repro_torch.timeseries.feature import FeatureSpec  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures" / "fronts"
KINDS = ["mlp", "svm"]
CPU = "cpu"
POOL2 = [CPU, CPU]


@pytest.fixture(scope="module")
def cardio():
    return ttab.make_dataset("cardio")


@pytest.fixture(scope="module")
def fronts():
    """{kind: (port designs, reference designs)} of the fixture fronts."""
    return {k: (tdeploy.load_front(FIXTURES / f"cardio_{k}"),
                jdeploy.load_front(FIXTURES / f"cardio_{k}"))
            for k in KINDS}


def _x(data):
    return data["x_test"].astype(np.float32)


def _direct(designs, x):
    return tdeploy.serve_bank(designs, x, device=CPU).argmax(-1).numpy()


def _same_responses(a, b):
    assert a.keys() == b.keys()
    for rid in a:
        if a[rid] is None or b[rid] is None:
            assert a[rid] is None and b[rid] is None, rid
        else:
            assert a[rid].dtype == b[rid].dtype
            np.testing.assert_array_equal(a[rid], b[rid])


# ------------------------------------------------------------------ loadgen
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("shape", tloadgen.TRAFFIC_SHAPES)
def test_loadgen_traces_are_the_reference_bitwise(shape, seed):
    x = np.random.default_rng(3).random((64, 21))
    kw = dict(tenant="t", rate_rps=800.0, request_size=5, deadline_ms=50.0,
              shape=shape, seed=seed)
    got = tloadgen.make_workload(x, 40, **kw)
    want = jloadgen.make_workload(x, 40, **kw)
    assert [(r.rid, r.tenant, r.arrival_s, r.deadline_s) for r in got] == [
        (r.rid, r.tenant, r.arrival_s, r.deadline_s) for r in want]
    for g, w in zip(got, want):
        assert g.x.dtype == w.x.dtype == np.float32 and g.rows == w.rows
        np.testing.assert_array_equal(g.x, w.x)
    env = dict(period_s=2.0, burst_factor=4.0, burst_fraction=0.2,
               diurnal_amplitude=0.5)
    np.testing.assert_array_equal(
        tloadgen.arrival_times(50, 300.0, shape, seed=seed, **env),
        jloadgen.arrival_times(50, 300.0, shape, seed=seed, **env))
    t = np.linspace(0.0, 4.0, 1000)
    np.testing.assert_array_equal(tloadgen.rate_envelope(t, 200.0, shape),
                                  jloadgen.rate_envelope(t, 200.0, shape))
    assert tloadgen.describe(got) == jloadgen.describe(want)


def test_merge_closed_loop_and_validation_match_the_reference():
    x = np.random.default_rng(4).random((32, 7)).astype(np.float32)
    t = [tloadgen.make_workload(x, 8, tenant=n, rate_rps=300.0, seed=s)
         for n, s in (("a", 0), ("b", 1))]
    j = [jloadgen.make_workload(x, 8, tenant=n, rate_rps=300.0, seed=s)
         for n, s in (("a", 0), ("b", 1))]
    tm, jm = tloadgen.merge_workloads(*t), jloadgen.merge_workloads(*j)
    assert [(r.rid, r.tenant, r.arrival_s) for r in tm] == [
        (r.rid, r.tenant, r.arrival_s) for r in jm]
    assert [r.rid for r in tm] == list(range(16))
    tc = tloadgen.closed_loop_payloads(x, 3, 4, tenant="c", request_size=3,
                                       deadline_ms=20.0, seed=5)
    jc = jloadgen.closed_loop_payloads(x, 3, 4, tenant="c", request_size=3,
                                       deadline_ms=20.0, seed=5)
    assert len(tc) == len(jc) == 3
    for tr, jr in zip(tc, jc):
        for a, b in zip(tr, jr):
            assert (a.rid, a.tenant, a.arrival_s, a.deadline_s) == (
                b.rid, b.tenant, b.arrival_s, b.deadline_s)
            np.testing.assert_array_equal(a.x, b.x)
    assert tloadgen.describe([]) == jloadgen.describe([])
    for mod in (tloadgen, jloadgen):
        with pytest.raises(ValueError, match="infeasible"):
            mod.arrival_times(4, 100.0, "bursty", burst_factor=10.0,
                              burst_fraction=0.5)
        with pytest.raises(ValueError, match="unknown traffic shape"):
            mod.make_workload(x, 4, shape="square")
        with pytest.raises(ValueError, match="rate_rps must be positive"):
            mod.arrival_times(4, 0.0)


# ------------------------------------------------------ SLOs and controller
def test_percentile_and_slo_snapshot_match_the_reference():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 3, 17, 100):
        vals = list(rng.random(n))
        for q in (0, 1, 50, 95, 99, 99.9, 100):
            a, b = tse.percentile(vals, q), jse.percentile(vals, q)
            assert a == b or (math.isnan(a) and math.isnan(b))
    trackers = (tse.SLOTracker(), jse.SLOTracker())
    for tr in trackers:
        for i, ms in enumerate((12.5, 3.0, 40.0, 7.25, 19.0)):
            tr.record("a", ms / 1e3, rows=8 + i)
        tr.shed("a", 2)
        tr.reject("b")
        tr.record("c", 0.002, rows=4)
    snaps = [tr.snapshot(wall_s=1.5) for tr in trackers]
    assert snaps[0].keys() == snaps[1].keys() == {"a", "b", "c"}
    for tenant in snaps[0]:
        a, b = snaps[0][tenant], snaps[1][tenant]
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])), k
    assert trackers[0].latencies("a") == trackers[1].latencies("a")


@pytest.mark.parametrize("quantum,max_batch", [(32, 256), (32, 512),
                                               (24, 100), (32, 32),
                                               (64, 16)])
def test_adaptive_batcher_follows_the_reference(quantum, max_batch):
    """Fed the same latency/queue sequence, both controllers build the
    same ladder and take the same steps."""
    rng = np.random.default_rng(quantum + max_batch)
    obs = [(float(lat), int(q)) for lat, q in zip(
        rng.choice([1e-4, 2e-3, 0.02, 0.2, 1.0], 60),
        rng.integers(0, 2 * max_batch, 60))]
    t = tse.AdaptiveBatcher(quantum=quantum, max_batch=max_batch,
                            target_latency_s=0.025)
    j = jse.AdaptiveBatcher(quantum=quantum, max_batch=max_batch,
                            target_latency_s=0.025)
    assert t.sizes == j.sizes and t.batch == j.batch
    assert [t.observe(*o) for o in obs] == [j.observe(*o) for o in obs]
    assert t.history == j.history and t.latency_ewma == j.latency_ewma
    for mod in (tse, jse):
        with pytest.raises(ValueError, match="quantum must be >= 1"):
            mod.AdaptiveBatcher(quantum=0)


@pytest.mark.parametrize("max_batch", [256, 512])
@pytest.mark.parametrize("kind", KINDS)
def test_bank_quantum_is_the_reference_default(fronts, kind, max_batch):
    designs, jdesigns = fronts[kind]
    assert tse.bank_quantum(designs, max_batch) == (32, "default")
    assert jse.bank_quantum(jdesigns, max_batch) == (32, "default")


# ------------------------------------------------------------ engine paths
@pytest.mark.parametrize("kind", KINDS)
def test_engines_answer_every_request_identically(fronts, cardio, kind):
    """Requests larger than the first rung (carry), diurnal traffic and a
    ladder up to 64 rows: every response equals the direct bank's
    prediction and the reference engine's, per rid."""
    designs, jdesigns = fronts[kind]
    wl = tloadgen.make_workload(_x(cardio), 12, tenant="cardio",
                                rate_rps=3000.0, request_size=20,
                                deadline_ms=5000.0, shape="diurnal", seed=3)
    jwl = jloadgen.make_workload(_x(cardio), 12, tenant="cardio",
                                 rate_rps=3000.0, request_size=20,
                                 deadline_ms=5000.0, shape="diurnal", seed=3)
    parity = (cardio["x_test"], cardio["y_test"])
    rep = tse.run_workload([tse.Tenant("cardio", designs, parity)], wl,
                           devices=[CPU], target_latency_ms=50.0,
                           max_batch=64)
    jrep = jse.run_workload([jse.Tenant("cardio", jdesigns, parity)], jwl,
                            target_latency_ms=50.0, max_batch=64)
    slo = rep["tenants"]["cardio"]
    assert slo["completed"] == len(wl) and slo["shed"] == 0
    assert 0.0 <= rep["pad_fraction"] < 1.0 and rep["batches"] >= 1
    for k in ("p50_ms", "p95_ms", "p99_ms", "requests_per_s",
              "samples_per_s"):
        assert np.isfinite(slo[k])
    _same_responses(rep["responses"], jrep["responses"])
    for req in wl:
        np.testing.assert_array_equal(rep["responses"][req.rid],
                                      _direct(designs, req.x))
    bs, jbs = rep["batch_sizes"]["cardio"], jrep["batch_sizes"]["cardio"]
    assert (bs["quantum"], bs["quantum_source"], bs["ladder"]) == (
        jbs["quantum"], jbs["quantum_source"], jbs["ladder"])
    assert rep.keys() == jrep.keys()
    assert rep["devices"] == jrep["devices"] == {
        "alive": 1, "lost": 0, "sharded": False}


def test_deadline_shedding_is_counted_not_dropped(fronts, cardio):
    designs, jdesigns = fronts["mlp"]
    reps = []
    for loadgen, se, d in ((tloadgen, tse, designs),
                           (jloadgen, jse, jdesigns)):
        wl = loadgen.make_workload(_x(cardio), 6, tenant="cardio",
                                   rate_rps=5000.0, request_size=4,
                                   deadline_ms=1000.0, seed=0)
        expired = [dataclasses.replace(r, deadline_s=-1.0)
                   if r.rid % 2 == 0 else r for r in wl]
        kw = {"devices": [CPU]} if se is tse else {}
        reps.append(se.run_workload([se.Tenant("cardio", d)], expired,
                                    target_latency_ms=50.0,
                                    gather_window_s=0.0, **kw))
    rep = reps[0]
    slo = rep["tenants"]["cardio"]
    assert slo["shed"] == 3 and slo["completed"] == 3
    assert slo["requests"] == 6                  # every request accounted
    for rid in range(6):
        resp = rep["responses"][rid]
        assert (resp is None) == (rid % 2 == 0)
        if resp is not None:
            assert resp.shape == (len(designs), 4)
    _same_responses(rep["responses"], reps[1]["responses"])


def test_multi_tenant_routing_and_wrong_domain_rejection(fronts, cardio):
    x = _x(cardio)
    mlp, svm = fronts["mlp"][0], fronts["svm"][0]
    wl_a = tloadgen.make_workload(x, 4, tenant="a", rate_rps=2000.0,
                                  request_size=4, deadline_ms=2000.0, seed=0)
    wl_b = tloadgen.make_workload(x, 4, tenant="b", rate_rps=2000.0,
                                  request_size=4, deadline_ms=2000.0, seed=1)
    stray = tloadgen.Request(rid=0, tenant="zzz", arrival_s=0.0,
                             deadline_s=9.0, x=x[:4])
    narrow = tloadgen.Request(rid=0, tenant="a", arrival_s=0.0,
                              deadline_s=9.0, x=np.zeros((4, 3), np.float32))
    wl = tloadgen.merge_workloads(wl_a, wl_b, [stray, narrow])
    tenants = [tse.Tenant(name="a", designs=mlp),
               tse.Tenant(name="b", designs=svm[:1])]
    rep = tse.run_workload(tenants, wl, devices=[CPU],
                           target_latency_ms=100.0)
    assert rep["tenants"]["a"]["completed"] == 4
    assert rep["tenants"]["a"]["rejected"] == 1          # channel mismatch
    assert rep["tenants"]["b"]["completed"] == 4
    assert rep["tenants"]["zzz"]["rejected"] == 1        # unknown tenant
    for req in wl:
        resp = rep["responses"][req.rid]
        if req.tenant == "zzz" or req.x.shape[1] != 21:
            assert resp is None
        else:
            bank = mlp if req.tenant == "a" else svm[:1]
            np.testing.assert_array_equal(resp, _direct(bank, req.x))
    with pytest.raises(ValueError, match="duplicate tenant names"):
        tse.ServingEngine([tenants[0], tenants[0]], devices=[CPU])
    with pytest.raises(ValueError, match="at least one tenant"):
        tse.ServingEngine([], devices=[CPU])


def test_closed_loop_serves_every_request(fronts, cardio):
    designs = fronts["svm"][0]
    payloads = tloadgen.closed_loop_payloads(_x(cardio), clients=3,
                                             requests_per_client=4,
                                             tenant="cardio",
                                             request_size=4,
                                             deadline_ms=5000.0, seed=0)
    rep = tse.run_closed_loop([tse.Tenant("cardio", designs)], payloads,
                              devices=[CPU], target_latency_ms=50.0)
    slo = rep["tenants"]["cardio"]
    assert slo["completed"] == 12 and slo["shed"] == 0
    assert slo["samples"] == 48 and "responses" not in rep


# ---------------------------------------------------------- fault tolerance
def test_device_loss_on_a_two_entry_pool_recovers_with_parity(fronts,
                                                              cardio):
    """A loss injected into bank launch 1: the entry is dropped, the bank
    rebuilt on the survivor with parity re-asserted, the microbatch
    re-dispatched; every request completes with the direct bank's answer
    and the reference engine's (two entries of its one CPU device)."""
    designs, jdesigns = fronts["mlp"]
    parity = (cardio["x_test"], cardio["y_test"])
    kw = dict(tenant="cardio", rate_rps=400.0, request_size=8,
              deadline_ms=30000.0, shape="bursty", seed=0)
    wl = tloadgen.make_workload(_x(cardio), 24, **kw)
    inject = lambda launch: 0 if launch == 1 else None   # noqa: E731
    rep = tse.run_workload([tse.Tenant("cardio", designs, parity)], wl,
                           devices=POOL2, target_latency_ms=25.0,
                           inject_device_failure=inject)
    jrep = jse.run_workload(
        [jse.Tenant("cardio", jdesigns, parity)],
        jloadgen.make_workload(_x(cardio), 24, **kw),
        devices=[jax.devices()[0]] * 2, target_latency_ms=25.0,
        inject_device_failure=inject)
    slo = rep["tenants"]["cardio"]
    assert rep["recoveries"] == jrep["recoveries"] == 1
    assert rep["devices"] == jrep["devices"] == {
        "alive": 1, "lost": 1, "sharded": False}
    assert slo["completed"] == len(wl)
    assert slo["shed"] == 0 and slo["rejected"] == 0
    _same_responses(rep["responses"], jrep["responses"])
    for req in wl:
        np.testing.assert_array_equal(rep["responses"][req.rid],
                                      _direct(designs, req.x))
    np.testing.assert_array_equal(
        tdeploy.served_accuracies(designs, *parity, device=CPU),
        np.array([d.accuracy for d in designs]))


@pytest.mark.parametrize("pool,max_recoveries,match", [
    ([CPU], 3, "exhausted"), (POOL2, 3, "exhausted"),
    ([CPU] * 3, 1, "max_recoveries")])
def test_losing_the_last_entry_raises(fronts, cardio, pool, max_recoveries,
                                      match):
    wl = tloadgen.make_workload(_x(cardio), 4, tenant="cardio",
                                rate_rps=2000.0, request_size=4,
                                deadline_ms=30000.0, seed=0)
    with pytest.raises(RuntimeError, match=match):
        tse.run_workload([tse.Tenant("cardio", fronts["svm"][0])], wl,
                         devices=pool, max_recoveries=max_recoveries,
                         inject_device_failure=lambda launch: 0)


def test_pool_fail_and_mesh():
    pool = tse.DevicePool(POOL2)
    assert pool.devices == [torch.device(CPU)] * 2 and pool.mesh() is None
    with pytest.raises(ValueError, match="no alive device"):
        pool.fail(5)
    pool.fail(1)
    assert pool.alive == 1 and pool.lost == [torch.device(CPU)]
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.fail(0)
    with pytest.raises(ValueError, match="at least one device"):
        tse.DevicePool([])


@pytest.mark.parametrize("calibration", ["port", "reference"])
def test_calibrate_on_recovery(fronts, cardio, monkeypatch, calibration):
    """A tenant on measured non-ideal hardware serves instance 0's
    calibrated tables until the device loss and instance 1's after it,
    with the parity re-asserted against the calibrated reference (the
    reference runs this only with two devices). Every request arrives
    at 0, so the whole trace is queued before launch 0, which serves
    exactly the first quantum's rows; the failing launch 1 re-dispatches
    the rest on instance 1. 'reference': the port's engine calibrates
    through the reference's calibrate_front (the packages draw their
    instances from different generators), so both engines serve the
    same instances and their responses are compared per rid."""
    designs, jdesigns = fronts["svm"]
    ni = NonIdealSpec(sigma_offset=0.3, fault_rate=0.05, seed=0)
    jni = jnonideal.NonIdealSpec(sigma_offset=0.3, fault_rate=0.05, seed=0)
    parity = (cardio["x_test"], cardio["y_test"])
    size, first = 4, 32 // 4          # rows a request; requests in launch 0
    kw = dict(tenant="cardio", rate_rps=400.0, request_size=size, seed=0)
    at_zero = lambda wl: [dataclasses.replace(  # noqa: E731
        r, arrival_s=0.0, deadline_s=5.0) for r in wl]
    wl = at_zero(tloadgen.make_workload(_x(cardio), 16, **kw))
    inject = lambda b: 0 if b == 1 else None  # noqa: E731
    if calibration == "reference":
        def from_reference(front, nonideal, *, instance, samples, device):
            jcal = jdeploy.calibrate_front(jdesigns, jni, instance=instance,
                                           samples=samples)
            return [dataclasses.replace(
                d, table=np.asarray(j.table), vmin=j.vmin, vmax=j.vmax,
                calibrated=True) for d, j in zip(front, jcal)]
        monkeypatch.setattr(tse.deploy, "calibrate_front", from_reference)
    cal = [tse.deploy.calibrate_front(designs, ni, instance=k,
                                      samples=k + 1, device=CPU)
           for k in (0, 1)]
    rep = tse.run_workload(
        [tse.Tenant("cardio", designs, parity, nonideal=ni)], wl,
        devices=POOL2, target_latency_ms=25.0, max_batch=64,
        inject_device_failure=inject)
    assert rep["recoveries"] == 1
    assert rep["calibrations"] == {"cardio": 2}      # startup + recovery
    slo = rep["tenants"]["cardio"]
    assert slo["completed"] == len(wl) and slo["shed"] == 0
    assert slo["rejected"] == 0
    preds = [[_direct(c, req.x) for req in wl] for c in cal]
    for i, req in enumerate(wl):
        np.testing.assert_array_equal(rep["responses"][req.rid],
                                      preds[i >= first][i])
    # the two instances answer differently before and after the loss,
    # so serving the wrong one at either side fails the check above
    for part in (slice(0, first), slice(first, None)):
        assert any(not np.array_equal(a, b)
                   for a, b in zip(preds[0][part], preds[1][part]))
    if calibration == "reference":
        jrep = jse.run_workload(
            [jse.Tenant("cardio", jdesigns, parity, nonideal=jni)],
            at_zero(jloadgen.make_workload(_x(cardio), 16, **kw)),
            devices=[jax.devices()[0]] * 2, target_latency_ms=25.0,
            max_batch=64, inject_device_failure=inject)
        assert jrep["recoveries"] == 1
        assert jrep["calibrations"] == {"cardio": 2}
        _same_responses(rep["responses"], jrep["responses"])


def test_run_with_recovery_matches_the_reference(monkeypatch):
    """The training-loop recovery contract against an in-memory
    checkpoint: the same failures replay from the same checkpoints to
    the same state, in both packages. The step watchdog times each step
    on the wall clock, where a microsecond step's scheduler jitter alone
    can flag a straggler in one package and not the other; both run on
    one fake clock instead, each step lasting exactly 1 s (the watchdog
    itself is held against the reference by the next test)."""

    class Clock:
        def __init__(self):
            self.now = 0.0

        def time(self):
            self.now += 1.0
            return self.now

    for mod in (tfault, jfault):
        monkeypatch.setattr(mod, "time", Clock())

    class MemCkpt:
        def __init__(self):
            self.saved, self.restores, self.waits = {}, [], 0

        def latest_step(self):
            return max(self.saved) if self.saved else None

        def restore(self, step, state, shardings=None):
            self.restores.append(step)
            return self.saved[step]

        def save(self, step, state):
            self.saved[step] = state

        def wait(self):
            self.waits += 1

    def run(mod, fail_at, **kw):
        ckpt, seen, metrics = MemCkpt(), set(), []

        def inject(step):
            hit = step in fail_at and step not in seen
            seen.add(step)
            return hit

        state, stats = mod.run_with_recovery(
            lambda s, b, step: (s + b, {"step": step}), 0,
            lambda step: step * step, num_steps=10, ckpt=ckpt,
            ckpt_every=3, inject_failure=inject,
            on_metrics=lambda step, m: metrics.append(step), **kw)
        return state, stats, ckpt.saved, ckpt.restores, ckpt.waits, metrics

    for fail_at in ({2}, {4, 7}, {1, 5, 8}):
        got, want = run(tfault, fail_at), run(jfault, fail_at)
        assert got == want
        assert got[1]["failures"] == len(fail_at)
    # failures after the first checkpoint replay from it exactly
    assert run(tfault, {4, 7})[0] == sum(s * s for s in range(10))
    for mod in (tfault, jfault):
        with pytest.raises(RuntimeError, match="injected failure"):
            run(mod, {1, 2, 4, 5}, max_failures=3)
        ckpt = MemCkpt()
        ckpt.saved[6] = 100
        state, stats = mod.run_with_recovery(
            lambda s, b, step: (s + b, {}), 0, lambda step: 1,
            num_steps=8, ckpt=ckpt)
        assert (state, stats["final_step"]) == (102, 8)


def test_step_watchdog_flags_stragglers_as_the_reference():
    durations = [0.01] * 6 + [0.5, 0.011, 0.2, 0.01] * 4
    t, j = tfault.StepWatchdog(window=8), jfault.StepWatchdog(window=8)
    assert [t.observe(d) for d in durations] == [j.observe(d)
                                                 for d in durations]
    assert t.stragglers == j.stragglers > 0
    e = tfault.DeviceLoss(1)
    assert e.device_index == 1 and "device 1 lost" in str(e)
    assert isinstance(e, RuntimeError)


# -------------------------------------------------------------- raw windows
FE = FeatureSpec(channels=4, window=32)


@pytest.fixture(scope="module")
def windows():
    """A feature-baked front of the cut stress stream over every
    subsample factor (one bank per group), and its test windows."""
    d = tstream.make_stream("stress")
    cut = {"x_train": d["x_train"][:150], "y_train": d["y_train"][:150],
           "x_test": d["x_test"][:80], "y_test": d["y_test"][:80]}
    vdata, sizes, spec = tcosearch.build_search_inputs(cut, FE, bits=2,
                                                       device=CPU)
    c = FE.feature_channels
    rng = np.random.default_rng(13)
    g = (rng.random((4, tsearch.genome_len(c, 2, frontend=FE))) < 0.6
         ).astype(np.uint8)
    base = c * 4 + tsearch.DP_BITS
    for i in range(4):
        g[i, base:] = tfeature.encode_genes(FE, i % len(FE.sub_grid),
                                            rng.integers(0, 4, c))
    cfg = tsearch.SearchConfig.for_spec(spec, frontend=FE, pop_size=4,
                                        train_steps=10)
    return tdeploy.export_front(g, vdata, sizes, cfg, device=CPU), cut


def test_raw_window_tenant_serves_windows(windows, fronts, cardio):
    designs, cut = windows
    assert len(tdeploy._feature_groups(designs)) > 1
    assert tse.Tenant("stress", designs).sample_shape == (32, 4)
    wl = tloadgen.merge_workloads(
        tloadgen.make_workload(cut["x_test"], 10, tenant="stress",
                               rate_rps=3000.0, request_size=7,
                               deadline_ms=5000.0, seed=2),
        tloadgen.make_workload(_x(cardio), 4, tenant="cardio",
                               rate_rps=3000.0, request_size=4,
                               deadline_ms=5000.0, seed=3),
        [tloadgen.Request(rid=0, tenant="stress", arrival_s=0.0,
                          deadline_s=9.0, x=_x(cardio)[:4, :16]),
         tloadgen.Request(rid=0, tenant="cardio", arrival_s=0.0,
                          deadline_s=9.0, x=cut["x_test"][:2])])
    parity = {"stress": (cut["x_test"], cut["y_test"]),
              "cardio": (cardio["x_test"], cardio["y_test"])}
    rep = api.serve_stream({"stress": designs, "cardio": fronts["mlp"][0]},
                           wl, parity_data=parity, devices=POOL2,
                           max_batch=32, gather_window_s=0.0,
                           inject_device_failure=lambda b: (
                               0 if b == 2 else None))
    assert rep["recoveries"] == 1
    assert rep["tenants"]["stress"]["completed"] == 10
    assert rep["tenants"]["stress"]["rejected"] == 1    # tabular rows
    assert rep["tenants"]["cardio"]["rejected"] == 1    # windows
    for req in wl:
        got = rep["responses"][req.rid]
        if req.x.shape[1:] == (32, 4) and req.tenant == "stress":
            np.testing.assert_array_equal(got, _direct(designs, req.x))
        elif req.x.shape[1:] == (21,) and req.tenant == "cardio":
            np.testing.assert_array_equal(got,
                                          _direct(fronts["mlp"][0], req.x))
        else:
            assert got is None
    np.testing.assert_array_equal(
        tdeploy.served_accuracies(designs, cut["x_test"], cut["y_test"],
                                  device=CPU),
        np.array([d.accuracy for d in designs]))


# ---------------------------------------------------------------- the API
def test_api_serve_stream_facade(fronts, cardio):
    bank = api.Bank(designs=tuple(fronts["mlp"][0]))
    x = _x(cardio)
    trace = api.make_workload(x, 6, tenant="cardio", rate_rps=2000.0,
                              request_size=4, deadline_ms=5000.0, seed=0)
    want = jloadgen.make_workload(x, 6, tenant="cardio", rate_rps=2000.0,
                                  request_size=4, deadline_ms=5000.0, seed=0)
    assert [r.arrival_s for r in trace] == [r.arrival_s for r in want]
    rep = api.serve_stream(bank, trace, devices=[CPU],
                           parity_data=(cardio["x_test"], cardio["y_test"]))
    assert rep["tenants"]["cardio"]["completed"] == 6
    for req in trace:
        np.testing.assert_array_equal(rep["responses"][req.rid],
                                      _direct(bank.designs, req.x))
    with pytest.raises(ValueError, match="single-tenant"):
        mixed = trace + [dataclasses.replace(trace[0], tenant="other")]
        api.serve_stream(bank, mixed, devices=[CPU])
    assert {"make_workload", "serve_stream"} <= set(api.__all__)


# ----------------------------------------------------------- sharded pool
def test_sharded_pool_meshes_over_its_survivors():
    """A sharded pool owns a (n, 1) mesh over its survivors while two are
    alive, as the reference's does; an unsharded pool never has one."""
    pool = tse.DevicePool([CPU] * 3, sharded=True)
    assert pool.sharded and pool.mesh().shape == {"data": 3, "model": 1}
    pool.fail(0)
    assert pool.mesh().shape == {"data": 2, "model": 1}
    assert list(pool.mesh().devices.reshape(-1)) == [torch.device(CPU)] * 2
    pool.fail(0)
    assert pool.alive == 1 and pool.mesh() is None
    assert tse.DevicePool(POOL2).mesh() is None
    assert tse.DevicePool([CPU], sharded=True).mesh() is None


def _bank_launches(monkeypatch):
    """Count the bank entry's calls (one per shard) and the D of each."""
    calls = []
    orig = tdeploy.ops.classifier_bank

    def spy(x, tables, weights, **kw):
        assert tables.device == x.device
        calls.append(tables.shape[0])
        return orig(x, tables, weights, **kw)

    monkeypatch.setattr(tdeploy.ops, "classifier_bank", spy)
    return calls


@pytest.mark.parametrize("pool, shards", [(POOL2, [2, 1]),
                                          ([CPU] * 3, [3, 2])],
                         ids=["two-entries", "three-entries"])
def test_sharded_pool_re_meshes_on_a_device_loss(fronts, cardio, pool,
                                                 shards, monkeypatch):
    """The MLP fixture front (D=6) on a sharded pool: every launch runs
    one bank per shard (``shards[0]`` before the loss at launch 1,
    ``shards[1]`` after it), the recovery re-meshes over the survivors
    and re-asserts parity, and every response equals the plain route's
    and the unsharded engine's."""
    designs = fronts["mlp"][0]
    parity = (cardio["x_test"], cardio["y_test"])
    wl = tloadgen.make_workload(_x(cardio), 24, tenant="cardio",
                                rate_rps=400.0, request_size=8,
                                deadline_ms=30000.0, shape="bursty", seed=0)
    engine = tse.ServingEngine([tse.Tenant("cardio", designs, parity)],
                               devices=pool, sharded=True,
                               target_latency_ms=25.0)
    assert engine.pool.mesh().size == len(pool)
    calls = _bank_launches(monkeypatch)
    rep = tse.asyncio.run(engine.serve(
        wl, inject_device_failure=lambda b: 0 if b == 1 else None))
    assert rep["recoveries"] == 1
    assert rep["devices"] == {"alive": len(pool) - 1, "lost": 1,
                              "sharded": shards[1] > 1}
    # the warm-up before the loss, the last launch after it
    assert calls[:shards[0]] == [6 // shards[0]] * shards[0]
    assert calls[-shards[1]:] == [6 // shards[1]] * shards[1]
    assert sum(calls) % 6 == 0
    assert rep["tenants"]["cardio"]["completed"] == len(wl)
    plain = tse.run_workload([tse.Tenant("cardio", designs, parity)], wl,
                             devices=POOL2, target_latency_ms=25.0,
                             inject_device_failure=lambda b: (
                                 0 if b == 1 else None))
    _same_responses(rep["responses"], plain["responses"])
    for req in wl:
        np.testing.assert_array_equal(rep["responses"][req.rid],
                                      _direct(designs, req.x))


def test_calibrated_tenant_through_a_sharded_pool(fronts, cardio):
    """Calibrate-on-recovery on a sharded pool of three entries (the SVM
    front tiled to D=6 so the mesh splits it): instance 0 before the
    loss, 1 after, parity held against the plain route's accuracies of
    the calibrated front (not dyadic), every response the plain
    route's."""
    designs = list(fronts["svm"][0]) * 2
    ni = NonIdealSpec(sigma_offset=0.3, fault_rate=0.05, seed=0)
    parity = (cardio["x_test"], cardio["y_test"])
    first = 32 // 4
    wl = [dataclasses.replace(r, arrival_s=0.0, deadline_s=5.0)
          for r in tloadgen.make_workload(_x(cardio), 16, tenant="cardio",
                                          rate_rps=400.0, request_size=4,
                                          seed=0)]
    rep = tse.run_workload(
        [tse.Tenant("cardio", designs, parity, nonideal=ni)], wl,
        devices=[CPU] * 3, sharded=True, target_latency_ms=25.0,
        max_batch=64, inject_device_failure=lambda b: 0 if b == 1 else None)
    assert rep["recoveries"] == 1 and rep["calibrations"] == {"cardio": 2}
    assert rep["devices"]["sharded"] is True
    cal = [tdeploy.calibrate_front(designs, ni, instance=k, samples=k + 1,
                                   device=CPU) for k in (0, 1)]
    for i, req in enumerate(wl):
        np.testing.assert_array_equal(rep["responses"][req.rid],
                                      _direct(cal[i >= first], req.x))


def test_sharded_raw_window_tenant_and_facade(windows, fronts, cardio):
    """A feature-baked tenant (one bank per subsample group, each split
    within its group) beside a tabular one through api.serve_stream on a
    sharded pool of two entries, with a loss at launch 2."""
    designs, cut = windows
    wl = tloadgen.merge_workloads(
        tloadgen.make_workload(cut["x_test"], 10, tenant="stress",
                               rate_rps=3000.0, request_size=7,
                               deadline_ms=5000.0, seed=2),
        tloadgen.make_workload(_x(cardio), 6, tenant="cardio",
                               rate_rps=3000.0, request_size=4,
                               deadline_ms=5000.0, seed=3))
    parity = {"stress": (cut["x_test"], cut["y_test"]),
              "cardio": (cardio["x_test"], cardio["y_test"])}
    rep = api.serve_stream({"stress": designs, "cardio": fronts["mlp"][0]},
                           wl, parity_data=parity, devices=POOL2,
                           sharded=True, max_batch=32, gather_window_s=0.0,
                           inject_device_failure=lambda b: (
                               0 if b == 2 else None))
    assert rep["recoveries"] == 1
    assert rep["devices"] == {"alive": 1, "lost": 1, "sharded": False}
    for req in wl:
        want = designs if req.tenant == "stress" else fronts["mlp"][0]
        np.testing.assert_array_equal(rep["responses"][req.rid],
                                      _direct(want, req.x))


def test_engine_needs_a_card_unless_asked_for_cpu(fronts, cardio):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    designs = fronts["svm"][0]
    trace = api.make_workload(_x(cardio), 2, tenant="cardio", seed=0)
    calls = [lambda: tse.DevicePool(),
             lambda: tse.DevicePool(["cuda"]),
             lambda: tse.ServingEngine([tse.Tenant("cardio", designs)]),
             lambda: tse.run_workload([tse.Tenant("cardio", designs)],
                                      trace),
             lambda: api.serve_stream(designs, trace)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    engine = tse.ServingEngine([tse.Tenant("cardio", designs)],
                               devices=[CPU])
    assert engine.pool.devices == [torch.device(CPU)]
