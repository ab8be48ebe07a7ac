"""Port parity, the population quantizer: the plain versions behind
repro_torch.kernels.adc_quantize against the JAX package's Pallas kernels
(adc_quantize_pallas, adc_quantize_pallas_population) run in interpret
mode with a small block_m, plus the wrapper's routing, checks, dispatch
record, envelope and the ops / api entries. A quantizer copies table
values selected by integer codes, so every comparison is bitwise."""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402
import types  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.spec import AdcSpec as JSpec  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.adc_quantize import (  # noqa: E402
    adc_quantize_pallas, adc_quantize_pallas_population)
from repro_torch import api  # noqa: E402
from repro_torch.core.spec import AdcSpec  # noqa: E402
from repro_torch.kernels import (adc_quantize, dispatch,  # noqa: E402
                                 envelope, ops, ref)


def _inputs(rng, p, m, c, bits, per_channel):
    """x (M, C) straying outside the range, masks (P, C, 2^N) with the
    min-kept edge cases, and the range."""
    n = 2 ** bits
    if per_channel:
        lo = rng.uniform(-1.0, 0.5, size=c)
        vmin, vmax = tuple(lo), tuple(lo + rng.uniform(0.5, 2.0, size=c))
        x = rng.uniform(lo - 0.3, lo + 2.3, size=(m, c))
    else:
        vmin, vmax = 0.0, 1.0
        x = rng.uniform(-0.2, 1.2, size=(m, c))
    masks = (rng.random((p, c, n)) < 0.5).astype(np.int32)
    masks[0, 0] = 0
    masks[0, 0, rng.integers(n)] = 1             # a single kept level
    if c > 1:
        masks[0, 1] = 0                          # nothing kept
    return x.astype(np.float32), masks, vmin, vmax


@functools.partial(jax.jit, static_argnames=("bits", "vmin", "vmax"))
def _pallas(x, tables, *, bits, vmin, vmax):
    kw = dict(bits=bits, vmin=vmin, vmax=vmax, block_m=8, interpret=True)
    return (adc_quantize_pallas_population(x, tables, **kw),
            adc_quantize_pallas(x, tables[0], **kw))


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("per_channel", [False, True])
def test_plain_quantizer_matches_pallas_interpret(bits, per_channel):
    """P=3 tables, ragged M=21 against block_m=8: the port's population
    wrapper (CPU: the plain version) and its P=1 entry against both Pallas
    kernels, bitwise."""
    rng = np.random.default_rng(100 + bits + 10 * per_channel)
    x, masks, vmin, vmax = _inputs(rng, 3, 21, 5, bits, per_channel)
    spec = AdcSpec(bits=bits, vmin=vmin, vmax=vmax)
    tables = spec.value_table(torch.from_numpy(masks))
    want_pop, want_one = _pallas(jnp.asarray(x), jnp.asarray(tables.numpy()),
                                 bits=bits, vmin=spec.vmin, vmax=spec.vmax)
    xt = torch.from_numpy(x)
    got_pop = adc_quantize.adc_quantize_population(xt, tables, spec=spec)
    got_one = adc_quantize.adc_quantize(xt, tables[0], spec=spec)
    np.testing.assert_array_equal(got_pop.numpy(), np.asarray(want_pop))
    np.testing.assert_array_equal(got_one.numpy(), np.asarray(want_one))


@pytest.mark.parametrize("per_channel", [False, True])
def test_plain_quantizer_matches_reference_on_nan_and_inf(per_channel):
    """NaN has code 0 and +-inf the end codes in the reference's oracle
    (XLA casts NaN to 0); the port's plain quantizer and its codes agree,
    bitwise, with x also on both sides of every code boundary."""
    from repro.core import adc as jadc
    from repro.kernels import ref as jref
    from repro_torch.core import adc as tadc
    rng = np.random.default_rng(5 + per_channel)
    x, masks, vmin, vmax = _inputs(rng, 3, 40, 5, 3, per_channel)
    spec = AdcSpec(bits=3, vmin=vmin, vmax=vmax)
    lo, scale = tadc.range_rows(3, spec.vmin, spec.vmax, 5)
    x[0], x[1], x[2] = np.nan, np.inf, -np.inf
    x[3, :2] = np.nan
    for k in range(8):                 # the floats around each boundary
        edge = (lo[0] + np.float32(k) / scale[0]).astype(np.float32)
        x[4 + 2 * k] = edge
        x[5 + 2 * k] = np.nextafter(edge, np.float32(-np.inf))
    tables = spec.value_table(torch.from_numpy(masks))
    xt = torch.from_numpy(x)
    want = np.asarray(jref.adc_quantize_ref_population(
        jnp.asarray(x), jnp.asarray(tables.numpy()), 3, spec.vmin,
        spec.vmax))
    got = adc_quantize.adc_quantize_population(xt, tables, spec=spec)
    np.testing.assert_array_equal(got.numpy(), want)
    codes = tadc.encode(xt, 3, spec.vmin, spec.vmax)
    assert codes[0].eq(0).all() and codes[1].eq(7).all()
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jadc.encode(jnp.asarray(x), 3, spec.vmin,
                                              spec.vmax)))


@pytest.mark.parametrize("per_channel", [False, True])
def test_mask_entries_match_reference_ops(per_channel):
    """ops.adc_quantize{,_population} bake the tables from masks as the
    reference's ops do (the registry routes the reference side)."""
    rng = np.random.default_rng(77 + per_channel)
    x, masks, vmin, vmax = _inputs(rng, 3, 17, 5, 4, per_channel)
    spec = AdcSpec(bits=4, vmin=vmin, vmax=vmax)
    jspec = JSpec(bits=4, vmin=vmin, vmax=vmax)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        ops.adc_quantize_population(xt, torch.from_numpy(masks),
                                    spec=spec).numpy(),
        np.asarray(jops.adc_quantize_population(
            jnp.asarray(x), jnp.asarray(masks), spec=jspec)))
    np.testing.assert_array_equal(
        ops.adc_quantize(xt, torch.from_numpy(masks[1]), spec=spec).numpy(),
        np.asarray(jops.adc_quantize(jnp.asarray(x), jnp.asarray(masks[1]),
                                     spec=jspec)))


def test_wrapper_on_cpu_counts_nothing_and_checks_shapes():
    rng = np.random.default_rng(5)
    x, masks, _, _ = _inputs(rng, 4, 13, 6, 3, False)
    spec = AdcSpec(bits=3)
    tables = spec.value_table(torch.from_numpy(masks))
    xt = torch.from_numpy(x)
    adc_quantize.reset_launches()
    got = adc_quantize.adc_quantize_population(xt, tables, spec=spec)
    assert torch.equal(got, ref.adc_quantize_ref_population(xt, tables, 3))
    assert adc_quantize.launches == {"adc_quantize_population": 0,
                                     "adc_quantize": 0}
    assert adc_quantize.adc_quantize_population(
        xt[:0], tables, spec=spec).shape == (4, 0, 6)
    with pytest.raises(ValueError, match="channels"):
        adc_quantize.adc_quantize_population(xt[:, :5], tables, spec=spec)
    with pytest.raises(ValueError, match="levels"):
        adc_quantize.adc_quantize_population(xt, tables,
                                             spec=AdcSpec(bits=2))
    with pytest.raises(ValueError, match=r"tables \(P, C, 2\^N\)"):
        adc_quantize.adc_quantize_population(xt, tables[0], spec=spec)
    with pytest.raises(ValueError, match="pins"):
        adc_quantize.adc_quantize_population(
            xt, tables, spec=AdcSpec(bits=3, vmin=(0.0,) * 2,
                                     vmax=(1.0,) * 2))


def _fake_cuda(shape):
    """Stand-in for a CUDA tensor: resolve_quantize reads device and
    shape only."""
    return types.SimpleNamespace(device=torch.device("cuda", 0), shape=shape)


def test_quantizer_dispatch_and_envelope():
    res = dispatch.resolve_quantize("adc_quantize_population",
                                    torch.zeros(4, 21),
                                    torch.zeros(16, 21, 16))
    assert (res.path, res.device) == ("plain", "cpu")
    res = dispatch.resolve_quantize("adc_quantize_population",
                                    _fake_cuda((1488, 21)),
                                    _fake_cuda((32, 21, 16)))
    assert (res.path, res.device) == ("kernel", "cuda:0")
    assert res.as_dict()["entry"] == "adc_quantize_population"
    with pytest.raises(ValueError, match="shared memory"):
        dispatch.resolve_quantize("adc_quantize_population",
                                  _fake_cuda((8, 1000)),
                                  _fake_cuda((2, 1000, 64)))
    with pytest.raises(ValueError, match="grid"):
        dispatch.resolve_quantize(
            "adc_quantize_population", _fake_cuda((8, 21)),
            _fake_cuda((envelope.MAX_DESIGNS + 1, 21, 16)))
    # meta (the dry run): the kernel path without a launch; any other
    # device but cpu and cuda is refused
    assert dispatch.resolve_quantize("adc_quantize_population",
                                     torch.zeros(4, 21, device="meta"),
                                     torch.zeros(2, 21, 16)).path == "meta"
    with pytest.raises(ValueError, match="unsupported device"):
        dispatch.resolve_quantize("adc_quantize_population",
                                  types.SimpleNamespace(
                                      device=torch.device("xpu"),
                                      shape=(4, 21)),
                                  torch.zeros(2, 21, 16))
    # cardio's search shape needs 1512 bytes; F=200 at 6 bits passes 48 KB
    assert envelope.quantize_smem_bytes(21, 16) == 4 * (21 * 16 + 2 * 21)
    assert envelope.quantize_smem_bytes(200, 64) > envelope.SMEM_DEFAULT_BYTES
    assert envelope.outside_quantize_envelope(200, 64, 3) is None
    assert envelope.outside_quantize_envelope(880, 64, 1) is None
    assert "shared memory" in envelope.outside_quantize_envelope(900, 64, 1)


def test_api_quantize_routes_both_ranks():
    rng = np.random.default_rng(9)
    x, masks, _, _ = _inputs(rng, 3, 11, 4, 2, False)
    spec = AdcSpec(bits=2)
    pop = api.quantize(x, masks, spec, device="cpu")
    one = api.quantize(x, masks[2], spec, device="cpu")
    assert pop.shape == (3, 11, 4) and one.shape == (11, 4)
    assert torch.equal(pop[2], one)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [1, 4, 6])
def test_quantizer_kernel_matches_plain_on_card(bits):
    """On the card: the CUDA population quantizer against its plain
    version, bitwise, ragged M, with the launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(41 + bits)
    x, masks, _, _ = _inputs(rng, 9, 1000, 21, bits, False)
    spec = AdcSpec(bits=bits)
    dev = torch.device("cuda")
    xt = torch.from_numpy(x).to(dev)
    tables = spec.value_table(torch.from_numpy(masks).to(dev)).contiguous()
    before = adc_quantize.launches["adc_quantize_population"]
    got = adc_quantize.adc_quantize_population(xt, tables, spec=spec)
    want = ref.adc_quantize_ref_population(xt, tables, bits)
    torch.cuda.synchronize()
    assert adc_quantize.launches["adc_quantize_population"] == before + 1
    assert torch.equal(got, want)
