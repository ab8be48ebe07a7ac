"""Port parity, the search CLI: ``repro_torch.core.spec.AdcSpec.from_data``
equals the JAX package's bit for bit, and the port's
``launch.train.adc_search_config`` turns the reference's own argv cases
(tests/test_cli_roundtrip.py: comma lists, a scalar range, a channel
mismatch, ``--auto-range`` with ``--auto-range-pct 1.0``, both conflict
refusals, the non-ideality and fault-tolerance flags) into the same
AdcSpec meta, the same shared SearchConfig fields and the same refusals
as ``repro.launch.train.adc_search_config``. The launcher then runs
auto-ranged and per-channel searches on the CPU."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro.core.spec import AdcSpec as JSpec  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch.core import deploy as tdeploy  # noqa: E402
from repro_torch.core.spec import AdcSpec as TSpec  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402


def _bits64(values):
    return np.asarray(values, np.float64).view(np.uint64)


def _data(seed=0, shape=(400, 4)):
    """Seeded channels of very different scales, one of them constant."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, shape) * np.array([1.0, 10.0, 0.1, 0.0])
    x[..., 3] = 2.5
    return x


@pytest.mark.parametrize("pct", [0.0, 0.5, 1.0, 5.0, 49.0])
@pytest.mark.parametrize("shape", [(400, 4), (30, 7, 4)])
def test_from_data_is_the_reference_bit_for_bit(pct, shape):
    x = _data(shape=shape)
    got = TSpec.from_data(x, bits=3, pct=pct)
    want = JSpec.from_data(x, bits=3, pct=pct)
    np.testing.assert_array_equal(_bits64(got.vmin), _bits64(want.vmin))
    np.testing.assert_array_equal(_bits64(got.vmax), _bits64(want.vmax))
    assert got.to_meta() == want.to_meta() and got.channels == 4
    # the constant channel widened by the relative epsilon
    assert got.vmax[3] > got.vmin[3] == 2.5


def test_from_data_refuses_what_the_reference_refuses():
    for pct in (-0.1, 50.0):
        with pytest.raises(ValueError, match="pct"):
            JSpec.from_data(_data(), bits=2, pct=pct)
        with pytest.raises(ValueError, match="pct"):
            TSpec.from_data(_data(), bits=2, pct=pct)


# (argv, channels, data) of tests/test_cli_roundtrip.py
_AUTO = np.random.default_rng(0).normal(0.0, 1.0, (400, 3)) \
    * np.array([1.0, 10.0, 0.1])
CASES = {
    "comma lists": (["--bits", "3", "--vmin", "0.0,-1.0,0.25", "--vmax",
                     "1.0,2.0,4.75"], 3, None),
    "scalar": (["--bits", "2", "--vmin", "-0.5", "--vmax", "1.5"], 7, None),
    "auto-range pct 1.0": (["--bits", "3", "--auto-range",
                            "--auto-range-pct", "1.0"], 3,
                           {"x_train": _AUTO}),
    "auto-range default pct": (["--bits", "4", "--auto-range"], 3,
                               {"x_train": _AUTO}),
    "defaults": ([], 7, None),
    "non-ideality flags": (["--mc-samples", "8", "--nonideal-sigma", "0.5",
                            "--fault-rate", "0.02", "--range-drift", "0.01",
                            "--nonideal-seed", "7", "--robust-objective",
                            "worst"], 7, None),
    "fault tolerance": (["--mc-samples", "4", "--fault-rate", "0.05",
                         "--faulttol", "--max-spares", "1",
                         "--robust-objective", "yield"], 7, None),
}
REFUSED = {
    "channel mismatch": (["--bits", "2", "--vmin", "0.0,0.0", "--vmax",
                          "1.0,1.0"], 7, None, "channel"),
    "auto-range beside --vmin/--vmax": (
        ["--auto-range", "--vmin", "0.0,0.0", "--vmax", "1.0,2.0"], 2,
        {"x_train": np.zeros((8, 2)) + [[0.0, 1.0]]}, "auto-range"),
    "auto-range without data": (["--auto-range"], 2, None, "dataset"),
    "knob without --mc-samples": (["--nonideal-sigma", "0.5"], 7, None,
                                  "mc-samples"),
    "--mc-samples without a knob": (["--mc-samples", "8"], 7, None, "knob"),
}


def _both(argv, channels, data):
    base = ["--adc-search"] + argv
    t = ttrain.adc_search_config(ttrain.build_parser().parse_args(base),
                                 channels, data=data)
    j = jtrain.adc_search_config(jtrain.build_parser().parse_args(base),
                                 channels, data=data)
    return t, j


def _meta(v):
    return None if v is None else v.to_meta()


@pytest.mark.parametrize("case", sorted(CASES))
def test_adc_search_config_is_the_reference(case):
    (tspec, tcfg), (jspec, jcfg) = _both(*CASES[case])
    assert tspec.to_meta() == jspec.to_meta()
    np.testing.assert_array_equal(_bits64(tspec.vmin), _bits64(jspec.vmin))
    np.testing.assert_array_equal(_bits64(tspec.vmax), _bits64(jspec.vmax))
    assert tcfg.adc_spec.to_meta() == jcfg.adc_spec.to_meta()
    shared = ({f.name for f in dataclasses.fields(tcfg)}
              & {f.name for f in dataclasses.fields(jcfg)})
    assert {"bits", "vmin", "vmax", "pop_size", "generations",
            "train_steps", "engine", "nonideal", "mc_samples",
            "robust_objective", "yield_margin", "faulttol"} <= shared
    for name in sorted(shared):
        got, want = getattr(tcfg, name), getattr(jcfg, name)
        if name in ("nonideal", "faulttol"):
            assert _meta(got) == _meta(want), name
        else:
            assert got == want, name


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_adc_search_config_refuses_as_the_reference(case):
    argv, channels, data, match = REFUSED[case]
    base = ["--adc-search"] + argv
    with pytest.raises(ValueError, match=match) as want:
        jtrain.adc_search_config(jtrain.build_parser().parse_args(base),
                                 channels, data=data)
    with pytest.raises(ValueError, match=match) as got:
        ttrain.adc_search_config(ttrain.build_parser().parse_args(base),
                                 channels, data=data)
    assert str(got.value) == str(want.value)


def test_flags_and_defaults_are_the_reference():
    tp, jp = ttrain.build_parser(), jtrain.build_parser()
    for flag in ("--vmin", "--vmax", "--auto-range", "--auto-range-pct"):
        ta = next(a for a in tp._actions if flag in a.option_strings)
        ja = next(a for a in jp._actions if flag in a.option_strings)
        assert (ta.default, ta.help, type(ta)) == \
            (ja.default, ja.help, type(ja)), flag


def test_cli_auto_range_search_on_cpu(tmp_path, capsys):
    """--auto-range on cardio: the search runs on the data-derived
    21-channel spec, not the scalar [0, 1]."""
    pf = ttrain.main(["--adc-search", "--dataset", "cardio", "--auto-range",
                      "--bits", "2", "--pop", "3", "--generations", "1",
                      "--train-steps", "4", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "2-bit tree ADC, 21-channel ranges" in out
    assert pf.ndim == 2 and pf.shape[1] == 2


def test_cli_comma_list_search_exports_the_ranges(tmp_path, capsys):
    vmin = "0.0,0.0,0.0,0.0,0.0,0.0,-0.25"
    vmax = "1.0,1.0,1.0,1.0,1.0,2.0,1.25"
    ttrain.main(["--adc-search", "--dataset", "seeds", "--bits", "2",
                 "--vmin", vmin, "--vmax", vmax, "--pop", "3",
                 "--generations", "1", "--train-steps", "4",
                 "--device", "cpu", "--export-front",
                 "--ckpt-dir", str(tmp_path)])
    assert "7-channel ranges" in capsys.readouterr().out
    designs = tdeploy.load_front(tmp_path / "front")
    want = TSpec(bits=2, vmin=tuple(map(float, vmin.split(","))),
                 vmax=tuple(map(float, vmax.split(","))))
    assert designs[0].spec == want


@pytest.mark.parametrize("argv, msg", [
    (["--vmin", "0,0", "--vmax", "1,1"], "channel"),
    (["--auto-range", "--vmax", "2.0"], "auto-range")])
def test_cli_refuses_bad_ranges(argv, msg, capsys):
    with pytest.raises(SystemExit) as exc:
        ttrain.main(["--adc-search", "--dataset", "seeds", "--device",
                     "cpu"] + argv)
    assert exc.value.code == 2
    assert msg in capsys.readouterr().err
