"""The port's perf layer (src/repro_torch/perf) on the CPU: the workload
vocabulary against the JAX package's, the cost model priced from the hand
kernels (its bound column equal to PERF.md's kernel table, its matmul
share equal to the reference's and to PyTorch's FLOP counter over the
plain versions), the autotuner with injected measurements, the tuned
dispatch policy and the serving engine's tuned quantum. Counterparts of
tests/test_perf_model.py and tests/test_autotune.py. Tuning on the card
itself is chip_smoke.py's phase autotune."""
import pytest

torch = pytest.importorskip("torch")

import json  # noqa: E402
import logging  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.perf import cost_model as jcost  # noqa: E402
from repro.perf import workload as jworkload  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import deploy  # noqa: E402
from repro_torch.kernels import dispatch, ops, ref  # noqa: E402
from repro_torch.launch import serving_engine as se  # noqa: E402
from repro_torch.perf import (Workload, autotune, cost_model,  # noqa: E402
                              shape_class, workload_of)
from repro_torch.perf.workload import ENTRIES  # noqa: E402
from tests.hypothesis_compat import given, settings, st  # noqa: E402

# one small workload per entry, batch-like axes > 1 wherever the entry
# has them, so the monotonicity sweeps exercise them
WORKLOADS = {
    "adc_quantize": Workload("adc_quantize", m=32, c=4, bits=3),
    "adc_quantize_population":
        Workload("adc_quantize_population", m=32, c=4, bits=3, p=3),
    "mc_eval": Workload("mc_eval", m=32, c=4, bits=3, s=3),
    "mc_eval_population":
        Workload("mc_eval_population", m=32, c=4, bits=3, p=3, s=2),
    "mc_eval_cal": Workload("mc_eval_cal", m=32, c=4, bits=3, s=3),
    "mc_eval_cal_population":
        Workload("mc_eval_cal_population", m=32, c=4, bits=3, p=3, s=2),
    "bespoke_mlp": Workload("bespoke_mlp", m=32, c=4, bits=3, h=5, o=3),
    "bespoke_svm": Workload("bespoke_svm", m=32, c=4, bits=3, o=3),
    "classifier_bank_mlp":
        Workload("classifier_bank_mlp", m=32, c=4, bits=3, d=3, h=5, o=3),
    "classifier_bank_svm":
        Workload("classifier_bank_svm", m=32, c=4, bits=3, d=3, o=3),
}
CLASSIFIERS = ("bespoke_mlp", "bespoke_svm", "classifier_bank_mlp",
               "classifier_bank_svm")


@pytest.fixture(autouse=True)
def _clean_policy():
    """Every test starts with no tuned policy and ends with the default
    table lookup restored."""
    dispatch.set_tuned_policy(None)
    yield
    dispatch.reset_tuned_policy()


def _fake_cuda(shape):
    """Stand-in for a CUDA tensor: resolution reads only device and
    shape."""
    return types.SimpleNamespace(device=torch.device("cuda", 0), shape=shape,
                                 ndim=len(shape))


def _meas(prefer: int):
    """A deterministic measurement: ``prefer`` wins, every other tile is
    monotone in its size, so the ranking is unambiguous."""
    return lambda entry, w, bm: 1.0 if bm == prefer else 10.0 + bm


# ---------------------------------------------------------------- workload
def test_entries_are_the_registry_and_the_reference_vocabulary():
    assert set(ENTRIES) == set(dispatch.entries()) == set(WORKLOADS)
    assert set(dispatch.PERF_ENTRY.values()) == set(ENTRIES)
    for name in ENTRIES:
        entry = dispatch.get(name)
        assert entry.name == name and callable(entry.kernel)
        assert callable(entry.plain)
    with pytest.raises(ValueError, match="no kernel entry"):
        dispatch.get("flash_attention")


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_and_shape_class_equal_the_reference(name):
    w = WORKLOADS[name]
    for m, p, d, s in ((32, 3, 3, 2), (33, 1, 6, 32), (1024, 16, 64, 5),
                       (1, 17, 1, 1)):
        wp = w.replace(m=m, p=p if w.p > 1 else 1, d=d if w.d > 1 else 1,
                       s=s if w.s > 1 else 1)
        jw = jworkload.Workload(**wp.to_meta())
        assert shape_class(wp) == jworkload.shape_class(jw)
        assert wp.to_meta() == jw.to_meta()
        assert Workload.from_meta(json.loads(json.dumps(wp.to_meta()))) == wp


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_of_equals_the_reference(name):
    """The operand shapes of each entry (the autotuner's operands built on
    the CPU) read back to the same Workload in both packages."""
    w = WORKLOADS[name]
    (x, tables, *weights), _ = autotune.tuning_operands(w, device="cpu")
    shapes = (tuple(x.shape), tuple(tables.shape),
              tuple(tuple(t.shape) for t in weights), w.bits)
    assert workload_of(name, *shapes) == w
    assert workload_of(name, *shapes).to_meta() == \
        jworkload.workload_of(name, *shapes).to_meta()
    with pytest.raises(ValueError, match="no workload rule"):
        workload_of("flash_attention", *shapes)


def test_workload_validates_and_buckets():
    with pytest.raises(ValueError, match="must be >= 1"):
        Workload("adc_quantize", m=0, c=4, bits=3)
    w = Workload("adc_quantize", m=33, c=4, bits=3)
    assert shape_class(w) == shape_class(w.replace(m=64))
    assert shape_class(w) != shape_class(w.replace(m=65))
    assert shape_class(w) != shape_class(w.replace(c=5))
    assert shape_class(w) != shape_class(w.replace(bits=4))
    assert w.levels == 8


# -------------------------------------------------------------- cost model
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_counts_positive(name):
    c = cost_model.cost(WORKLOADS[name])
    assert c.flops > 0 and c.hbm_bytes > 0 and c.smem_bytes > 0
    assert c.dot_flops >= 0 and c.blocks >= 1
    assert c.arithmetic_intensity > 0
    assert c.to_meta()["arithmetic_intensity"] == c.arithmetic_intensity


@pytest.mark.parametrize("name", sorted(WORKLOADS))
@pytest.mark.parametrize("axis", ["m", "p", "s", "d"])
def test_counts_monotone_in_batch_axes(name, axis):
    w = WORKLOADS[name]
    lo = cost_model.cost(w)
    for factor in (2, 5, 16):
        hi = cost_model.cost(w.replace(**{axis: getattr(w, axis) * factor}))
        assert hi.flops >= lo.flops and hi.hbm_bytes >= lo.hbm_bytes
        lo = hi


@settings(max_examples=25, deadline=None)
@given(m=st.integers(1, 2048), c=st.integers(1, 64), bits=st.integers(1, 6),
       p=st.integers(1, 16), s=st.integers(1, 16), d=st.integers(1, 16),
       factor=st.integers(2, 8))
def test_property_costs_positive_and_monotone(m, c, bits, p, s, d, factor):
    """Positivity and monotonicity in M, P, S and D across the envelope,
    not only at the fixture shapes."""
    for name in ("adc_quantize_population", "mc_eval_population",
                 "mc_eval_cal_population", "classifier_bank_mlp",
                 "classifier_bank_svm"):
        w = Workload(name, m=m, c=c, bits=bits, p=p, s=s, d=d,
                     h=5 if name.endswith("mlp") else 0,
                     o=3 if "bank" in name else 0)
        base = cost_model.cost(w)
        assert base.flops > 0 and base.hbm_bytes > 0
        for axis in ("m", "p", "s", "d"):
            grown = cost_model.cost(
                w.replace(**{axis: getattr(w, axis) * factor}))
            assert grown.flops >= base.flops
            assert grown.hbm_bytes >= base.hbm_bytes


@pytest.mark.parametrize("name", CLASSIFIERS)
def test_dot_flops_equal_the_reference_and_the_flop_counter(name):
    """The matmul share equals the reference cost model's for the same
    Workload, and PyTorch's FLOP counter over the plain bank version
    (kernels/ref.py) at the same shapes: bias adds, ReLU and the ADC
    count nothing there."""
    w = WORKLOADS[name]
    got = cost_model.cost(w).dot_flops
    assert got == jcost.cost(jworkload.Workload(**w.to_meta())).dot_flops
    wb = w if name.startswith("classifier") else w.replace(d=1)
    (x, tables, *weights), spec = autotune.tuning_operands(
        wb.replace(entry="classifier_bank_" + name[-3:]), device="cpu")
    plain = (ref.bespoke_mlp_bank_ref if name.endswith("mlp")
             else ref.bespoke_svm_bank_ref)
    with FlopCounterMode(display=False) as counter:
        plain(x, tables, spec.bits, *weights, spec.vmin, spec.vmax)
    assert counter.get_total_flops() == got > 0


@pytest.mark.parametrize("name", ["adc_quantize", "adc_quantize_population",
                                  "mc_eval", "mc_eval_population",
                                  "mc_eval_cal", "mc_eval_cal_population"])
def test_elementwise_entries_have_no_dot_flops(name):
    assert cost_model.cost(WORKLOADS[name]).dot_flops == 0.0
    assert jcost.cost(jworkload.Workload(
        **WORKLOADS[name].to_meta())).dot_flops == 0.0


# PERF.md's kernel table: each row's shape and its printed bound (us)
TABLE_BOUNDS = [
    (Workload("adc_quantize", m=636, c=21, bits=4), 0.032),
    (Workload("adc_quantize_population", m=1488, c=21, bits=4, p=16), 0.641),
    (Workload("bespoke_mlp", m=1024, c=21, bits=4, h=5, o=3), 0.030),
    (Workload("bespoke_svm", m=1024, c=21, bits=4, o=3), 0.030),
    (Workload("classifier_bank_mlp", m=1024, c=21, bits=4, d=6, h=5, o=3),
     0.051),
    (Workload("classifier_bank_svm", m=1024, c=21, bits=4, d=3, o=3), 0.038),
    (Workload("mc_eval", m=636, c=21, bits=4, s=32), 0.554),
    (Workload("mc_eval_population", m=636, c=21, bits=4, p=16, s=32), 8.594),
    (Workload("mc_eval_cal", m=636, c=21, bits=4, s=32), 0.566),
    (Workload("mc_eval_cal_population", m=636, c=21, bits=4, p=16, s=32),
     8.799),
    # row 2 at the co-search shapes and the --smoke shape
    (Workload("adc_quantize_population", m=1980, c=16, bits=3, p=16), 0.646),
    (Workload("adc_quantize_population", m=1680, c=24, bits=3, p=16), 0.822),
    (Workload("adc_quantize_population", m=600, c=16, bits=2, p=8), 0.104),
]


@pytest.mark.parametrize("w,bound_us", TABLE_BOUNDS,
                         ids=lambda v: getattr(v, "entry", str(v)))
def test_roofline_reproduces_the_kernel_table_bounds(w, bound_us):
    rec = cost_model.roofline_estimate(w)
    assert round(rec["bound_s"] * 1e6, 3) == bound_us
    assert rec["bound_s"] == max(rec["compute_s"], rec["memory_s"])
    assert rec["bound_by"] == "bytes"
    b = cost_model.bound(w)
    assert (b["bound_s"], b["bound_by"]) == (rec["bound_s"], "bytes")


def test_roofline_record_shape_and_overhead():
    """The reference's record keys; a zero collective term (one card);
    the overhead is the launch term plus the wave term per wave beyond
    the first, so ``estimated_s`` grows with the waves a tile makes."""
    mm = cost_model.machine_model("cuda")
    for name, w in WORKLOADS.items():
        r = cost_model.roofline_estimate(w, backend="cuda")
        for key in ("compute_s", "memory_s", "collective_s", "dominant",
                    "model_flops_global", "useful_flops_ratio",
                    "roofline_fraction", "estimated_s", "cost", "waves",
                    "block_m", "machine", "overhead_s"):
            assert key in r, f"{name}: missing {key}"
        assert r["collective_s"] == 0.0
        assert r["dominant"] in ("compute", "memory", "overhead")
        assert 0.0 < r["roofline_fraction"] <= 1.0
        assert r["overhead_s"] == pytest.approx(
            mm.launch_s + (r["waves"] - 1) * mm.wave_s)
        assert r["estimated_s"] >= max(r["compute_s"], r["memory_s"])
        assert r["block_m"] == cost_model.heuristic_block_m(w)
    w = Workload("adc_quantize_population", m=1488, c=21, bits=4, p=16)
    small, big = (cost_model.roofline_estimate(w, bm) for bm in (1, 195))
    assert small["waves"] > big["waves"] == 1
    assert small["estimated_s"] > big["estimated_s"]
    assert small["bound_s"] == big["bound_s"]


def test_machine_model_lookup():
    h100 = cost_model.machine_model("cuda")
    assert (h100.hbm_bw, h100.peak_flops) == (3.35e12, 67e12)
    assert cost_model.machine_model() == h100
    assert cost_model.machine_model("cpu").name == "cpu-host"
    assert cost_model.machine_model("no-such-backend").name == "cpu-host"
    assert cost_model.machine_model(device="cpu").name == "cpu-host"
    assert set(cost_model.MACHINE_MODELS) == {"cuda", "cpu"}
    assert not any("tpu" in m.name for m in
                   cost_model.MACHINE_MODELS.values())


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_heuristic_is_the_geometry_of_today(name):
    """heuristic_block_m is the rows of the kernel's own launch
    (block_m=None); for the bank and the Monte-Carlo kernel that tile
    gives exactly that launch back."""
    w = WORKLOADS[name]
    g = cost_model.geometry(w)
    h = cost_model.heuristic_block_m(w)
    fam = cost_model.family(name)
    if fam == "bank":
        assert h == g.rows
        assert cost_model.geometry(w, h) == g
    elif fam == "mc":
        assert h == g.chunk_rows
        assert cost_model.geometry(w, h) == g
    else:
        assert h == max(1, g.span // w.c)
        assert cost_model.geometry(w, h).span <= g.span


# ---------------------------------------------------------------- autotune
W_ADC = Workload("adc_quantize", m=32, c=4, bits=3)
W_POP = Workload("adc_quantize_population", m=32, c=4, bits=3, p=2)
W_BANK = Workload("classifier_bank_mlp", m=256, c=21, bits=4, d=6, h=5, o=3)


@pytest.mark.parametrize("w", list(WORKLOADS.values())
                         + list(autotune.default_workloads()),
                         ids=lambda w: f"{w.entry}-{shape_class(w)}")
def test_candidates_cover_the_heuristic_and_are_valid(w):
    cands = autotune.candidate_block_ms(w)
    assert cands == tuple(sorted(set(cands))) and cands
    assert cost_model.heuristic_block_m(w) in cands
    for bm in cands:
        cost_model.geometry(w, bm)            # the kernel takes every one


def test_candidates_per_family():
    assert autotune.candidate_block_ms(W_BANK) == (4, 8, 16, 32, 64, 128,
                                                   256)
    mc = Workload("mc_eval_population", m=636, c=21, bits=4, p=16, s=32)
    assert autotune.candidate_block_ms(mc) == (48, 96, 192, 384, 672)
    q = Workload("adc_quantize_population", m=1488, c=21, bits=4, p=16)
    assert autotune.candidate_block_ms(q) == (1, 2, 4, 8, 16, 32, 64, 87,
                                              128, 195)
    # one row longer than a quantizer block: no tile, nothing to tune
    wide = Workload("adc_quantize", m=5, c=5000, bits=2)
    assert autotune.candidate_block_ms(wide) == ()
    table = autotune.tune([wide], measure_fn=_meas(1), backend="cpu")
    assert table["entries"] == {}


def test_default_workloads_are_the_paths_shapes():
    ws = autotune.default_workloads()
    assert {w.entry for w in ws} == set(ENTRIES)
    assert len({(w.entry, shape_class(w)) for w in ws}) == len(ws)
    assert Workload("adc_quantize_population", m=1488, c=21, bits=4,
                    p=16) in ws
    assert Workload("classifier_bank_mlp", m=256, c=21, bits=4, d=6, h=5,
                    o=3) in ws
    assert Workload("mc_eval_cal_population", m=636, c=21, bits=4, p=16,
                    s=32) in ws


def test_tables_are_deterministic():
    """The same workloads and measurements give byte-identical JSON, in
    any workload order."""
    kw = dict(measure_fn=_meas(16), backend="cpu")
    a = autotune.tune([W_ADC, W_POP], **kw)
    b = autotune.tune([W_POP, W_ADC], **kw)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert a["entries"]["adc_quantize"][shape_class(W_ADC)]["block_m"] == 16
    assert a["version"] == autotune.TABLE_VERSION
    assert (a["backend"], a["device"]) == ("cpu", None)


def test_tie_breaks_toward_the_smaller_tile():
    table = autotune.tune([W_ADC, W_BANK], measure_fn=lambda e, w, bm: 1.0,
                          backend="cpu")
    for w in (W_ADC, W_BANK):
        rec = table["entries"][w.entry][shape_class(w)]
        assert rec["block_m"] == min(autotune.candidate_block_ms(w))


def test_winner_never_loses_to_the_heuristic():
    meas = lambda e, w, bm: float((bm * 2654435761) % 1000) + 1.0  # noqa
    table = autotune.tune(list(WORKLOADS.values()), measure_fn=meas,
                          backend="cpu")
    assert set(table["entries"]) == set(ENTRIES)
    for entry in table["entries"].values():
        for rec in entry.values():
            assert rec["us"] <= rec["heuristic_us"]
            assert rec["us"] == min(rec["candidates_us"].values())
            assert str(rec["heuristic_block_m"]) in rec["candidates_us"]


def test_tuning_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: tuning measures on it")
    with pytest.raises(RuntimeError, match="CUDA device"):
        autotune.tune([W_ADC])
    with pytest.raises(RuntimeError, match="CUDA device"):
        api.autotune([W_ADC], write=False)


def test_json_round_trip(tmp_path):
    p = tmp_path / "tuned.json"
    table = autotune.tune([W_ADC, W_BANK], measure_fn=_meas(8),
                          backend="cpu")
    autotune.save_table(table, p)
    loaded = autotune.load_table(p)
    assert loaded == json.loads(json.dumps(table))
    autotune.save_table(loaded, p)
    assert autotune.load_table(p) == loaded
    assert not list(tmp_path.glob("*.tmp"))


def test_corrupt_table_falls_back(tmp_path, caplog):
    p = tmp_path / "tuned.json"
    p.write_text("{not json")
    with caplog.at_level(logging.WARNING, logger="repro_torch.perf.autotune"):
        assert autotune.load_table(p) is None
        assert autotune.load_policy(p) is None
    assert "corrupt" in caplog.text
    assert autotune.load_table(tmp_path / "missing.json") is None


def test_wrong_schema_and_version_fall_back(tmp_path, caplog):
    p = tmp_path / "tuned.json"
    with caplog.at_level(logging.WARNING, logger="repro_torch.perf.autotune"):
        here = autotune.current_backend()
        p.write_text(json.dumps({"version": 999, "backend": here,
                                 "entries": {}}))
        assert autotune.load_table(p) is None
        p.write_text(json.dumps(["not", "a", "table"]))
        assert autotune.load_table(p) is None
        p.write_text(json.dumps({"version": autotune.TABLE_VERSION,
                                 "backend": here}))
        assert autotune.load_table(p) is None
    assert caplog.text.count("unknown schema or version") == 3


def test_stale_backend_falls_back(tmp_path, caplog):
    """A table tuned on another backend does not apply here, and the
    dispatch layer keeps the heuristic."""
    p = tmp_path / "tuned.json"
    table = autotune.tune([W_BANK], measure_fn=_meas(16),
                          backend="definitely-not-this-backend")
    p.write_text(json.dumps(table))
    with caplog.at_level(logging.WARNING, logger="repro_torch.perf.autotune"):
        assert autotune.load_table(p) is None
    assert "stale" in caplog.text
    dispatch.set_tuned_policy(autotune.load_policy(p))
    assert dispatch.tuned_block_m(W_BANK.entry, W_BANK) == (None,
                                                            "heuristic")


def test_the_committed_table_is_the_cards():
    """kernels/tuned_tables.json was written by api.autotune() on the
    card: stamped cuda with the card's name and power limit, covering
    every default workload with a tile the kernel takes. On a machine
    without a card it is stale, and the port resolves the heuristic."""
    table = json.loads(autotune.DEFAULT_TABLE_PATH.read_text())
    assert (table["version"], table["backend"]) == (autotune.TABLE_VERSION,
                                                    "cuda")
    assert table["device"]["name"] and table["device"]["power_limit"]
    for w in autotune.default_workloads():
        rec = table["entries"][w.entry][shape_class(w)]
        assert rec["block_m"] in autotune.candidate_block_ms(w)
        assert rec["us"] <= rec["heuristic_us"]
        assert Workload.from_meta(rec["workload"]) == w
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the table may apply")
    dispatch.reset_tuned_policy()
    w = autotune.default_workloads()[7]
    assert dispatch.tuned_block_m(w.entry, w) == (None, "heuristic")


def test_api_autotune_end_to_end(tmp_path):
    """api.autotune tunes, persists and activates in one call."""
    assert "autotune" in api.__all__
    p = tmp_path / "tuned.json"
    table = api.autotune([W_ADC, W_BANK], measure_fn=_meas(16), path=p,
                         backend=autotune.current_backend())
    assert p.exists() and autotune.load_table(p) == table
    assert dispatch.tuned_block_m(W_BANK.entry, W_BANK) == (16, "tuned")
    assert table["entries"]["adc_quantize"][shape_class(W_ADC)]["block_m"] \
        == 16
    dry = api.autotune([W_ADC], measure_fn=_meas(8), write=False,
                       path=tmp_path / "no.json", backend="cpu")
    assert not (tmp_path / "no.json").exists()
    assert dry["entries"]["adc_quantize"][shape_class(W_ADC)]["block_m"] == 8


def test_port_api_lists_every_reference_verb():
    from repro import api as japi
    assert set(japi.__all__) <= set(api.__all__)


# ------------------------------------------------------- tuned dispatch
def _bank_call(d=6, m=256, f=21, n=16, h=5, o=3):
    return (_fake_cuda((m, f)), _fake_cuda((d, f, n)),
            [_fake_cuda(s) for s in ((d, f, h), (d, h), (d, h, o), (d, o))])


def test_resolve_stamps_the_tuned_tile(caplog):
    table = autotune.tune([W_BANK], measure_fn=_meas(16), backend="cpu")
    dispatch.set_tuned_policy(autotune.TablePolicy(table))
    x, t, ws = _bank_call()
    dispatch._LOGGED.clear()
    with caplog.at_level(logging.DEBUG, logger="repro_torch.kernels.dispatch"):
        res = dispatch.resolve("qmlp_mlp_bank", "mlp", x, t, ws)
        again = dispatch.resolve("qmlp_mlp_bank", "mlp", x, t, ws)
    assert (res.path, res.block_m, res.block_m_source) == ("kernel", 16,
                                                            "tuned")
    assert again == res and res.as_dict()["block_m"] == 16
    infos = [r for r in caplog.records if "block_m=16:tuned" in r.getMessage()]
    assert [r.levelno for r in infos] == [logging.INFO, logging.DEBUG]
    # another M in the same shape class (129..256 rows) takes it too
    x2, t2, ws2 = _bank_call(m=200)
    assert dispatch.resolve("qmlp_mlp_bank", "mlp", x2, t2,
                            ws2).block_m == 16
    # an unmatched shape class, a CPU tensor: no tile
    x3, t3, ws3 = _bank_call(m=4096)
    res3 = dispatch.resolve("qmlp_mlp_bank", "mlp", x3, t3, ws3)
    assert (res3.block_m, res3.block_m_source) == (None, "heuristic")
    cpu = dispatch.resolve("qmlp_mlp_bank", "mlp", torch.zeros(256, 21),
                           torch.zeros(6, 21, 16),
                           [torch.zeros(s) for s in ((6, 21, 5), (6, 5),
                                                     (6, 5, 3), (6, 3))])
    assert (cpu.path, cpu.block_m, cpu.block_m_source) == ("plain", None,
                                                           None)


def test_resolve_without_a_policy_is_the_heuristic():
    x, t, ws = _bank_call()
    res = dispatch.resolve("qmlp_mlp_bank", "mlp", x, t, ws)
    assert (res.path, res.block_m, res.block_m_source) == ("kernel", None,
                                                            "heuristic")
    q = dispatch.resolve_quantize("adc_quantize_population",
                                  _fake_cuda((1488, 21)),
                                  _fake_cuda((16, 21, 16)))
    assert (q.block_m, q.block_m_source) == (None, "heuristic")
    mc = dispatch.resolve_mc("mc_adc_eval_population", _fake_cuda((636, 21)),
                             _fake_cuda((16, 32, 21, 16)))
    assert (mc.block_m, mc.block_m_source) == (None, "heuristic")
    fa = dispatch.resolve_flash("flash_attention", torch.zeros(1, 4, 2, 64))
    assert (fa.block_m, fa.block_m_source) == (None, None)


def test_resolve_per_family_and_tiles_that_do_not_fit():
    """Each family reads its workload off the call; a tuned tile this
    exact shape cannot take (a shape class spans several M and D)
    resolves to the heuristic."""
    seen = []

    def policy(entry, w):
        seen.append((entry, w))
        return {"adc_quantize_population": 195, "mc_eval_population": 96,
                "classifier_bank_svm": 6}.get(entry)

    dispatch.set_tuned_policy(policy)
    q = dispatch.resolve_quantize("adc_quantize_population",
                                  _fake_cuda((1488, 21)),
                                  _fake_cuda((16, 21, 16)))
    assert (q.block_m, q.block_m_source) == (195, "tuned")
    mc = dispatch.resolve_mc("mc_adc_eval_population", _fake_cuda((636, 21)),
                             _fake_cuda((16, 32, 21, 16)))
    assert (mc.block_m, mc.block_m_source) == (96, "tuned")
    # 96 rows are no whole number of batches at C=24 (5 lanes x 8 rows)
    mc24 = dispatch.resolve_mc("mc_adc_eval_population",
                               _fake_cuda((636, 24)),
                               _fake_cuda((16, 32, 24, 16)))
    assert (mc24.block_m, mc24.block_m_source) == (None, "heuristic")
    # the padded bank takes multiples of 4 rows only
    x, t, _ = _bank_call(d=3, o=3)
    svm = dispatch.resolve("qmlp_svm_bank", "svm", x, t,
                           [_fake_cuda((3, 21, 3)), _fake_cuda((3, 3))])
    assert (svm.block_m, svm.block_m_source) == (None, "heuristic")
    assert ("adc_quantize_population",
            Workload("adc_quantize_population", m=1488, c=21, bits=4,
                     p=16)) in seen
    assert ("mc_eval_population",
            Workload("mc_eval_population", m=636, c=21, bits=4, p=16,
                     s=32)) in seen


def test_a_tile_never_changes_the_plain_result():
    """On the CPU the wrappers run the plain versions whatever the tile;
    a tile the kernel cannot take raises on any device, naming its
    limit."""
    rng = np.random.default_rng(3)
    w = Workload("classifier_bank_mlp", m=64, c=21, bits=4, d=3, h=5, o=3)
    (x, t, *ws), spec = autotune.tuning_operands(w, device="cpu")
    base = ops.classifier_bank(x, t, ws, kind="mlp", spec=spec)
    for bm in autotune.candidate_block_ms(w):
        got = ops.classifier_bank(x, t, ws, kind="mlp", spec=spec,
                                  block_m=bm)
        assert torch.equal(got, base)
    with pytest.raises(ValueError, match="BANK_ROWS_PER_THREAD"):
        ops.classifier_bank(x, t, ws, kind="mlp", spec=spec, block_m=6)
    masks = (rng.random((3, 21, 16)) < 0.5).astype(np.int32)
    masks[..., 0] = 1
    q = ops.adc_quantize_population(x, masks, spec=spec)
    assert torch.equal(q, ops.adc_quantize_population(x, masks, spec=spec,
                                                      block_m=7))
    with pytest.raises(ValueError, match="Q_SPAN_MAX"):
        ops.adc_quantize_population(x, masks, spec=spec, block_m=500)
    (x2, *mc), _ = autotune.tuning_operands(
        Workload("mc_eval_population", m=64, c=21, bits=4, p=2, s=3),
        device="cpu")
    want = ops.mc_eval_population(x2, *mc, spec=spec)
    assert torch.equal(want, ops.mc_eval_population(x2, *mc, spec=spec,
                                                    block_m=48))
    with pytest.raises(ValueError, match="MC_BATCH"):
        ops.mc_eval_population(x2, *mc, spec=spec, block_m=50)


# ------------------------------------------------------ serving quantum
@pytest.fixture(scope="module")
def cardio_fronts():
    from pathlib import Path
    root = Path(__file__).resolve().parent / "fixtures" / "fronts"
    return {k: deploy.load_front(root / f"cardio_{k}") for k in ("mlp",
                                                                 "svm")}


@pytest.mark.parametrize("kind", ["mlp", "svm"])
def test_bank_quantum_reads_the_tuned_rows(cardio_fronts, kind):
    designs = cardio_fronts[kind]
    d = designs[0]
    w = Workload(f"classifier_bank_{kind}", m=256, c=21, bits=d.bits,
                 d=len(designs), h=5 if kind == "mlp" else 0, o=3)
    assert se.bank_quantum(designs, 256) == (32, "default")
    table = autotune.tune([w], measure_fn=_meas(16), backend="cpu")
    dispatch.set_tuned_policy(autotune.TablePolicy(table))
    assert se.bank_quantum(designs, 256) == (16, "tuned")
    assert se.bank_quantum(designs, 256, device="cuda") == (16, "tuned")
    # the plain version on a CPU pool has no tile; another max_batch is
    # another shape class
    assert se.bank_quantum(designs, 256, device="cpu") == (32, "default")
    assert se.bank_quantum(designs, 1024) == (32, "default")
    assert se.bank_quantum(designs, 256, default=64,
                           device="cpu") == (64, "default")
