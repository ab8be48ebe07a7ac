"""Port parity, ADC semantics: repro_torch.core.{spec,adc} and the table /
quantizer plain versions of repro_torch.kernels.ref against the JAX
package on the same numpy inputs. All integer or gather work, so every
comparison is bitwise."""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import adc as jadc  # noqa: E402
from repro.core import spec as jspec  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import adc as tadc  # noqa: E402
from repro_torch.core import spec as tspec  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

BITS = [1, 2, 3, 4, 5, 6]


# Each test's reference side is one jitted program: eager JAX compiles every
# op of the LUT walk per shape, and a compile per call would be most of
# these tests' time.
@functools.partial(jax.jit, static_argnames=("bits", "vmin", "vmax"))
def j_tables(masks, shared, *, bits, vmin, vmax):
    """Every table the port rebuilds, for (P, C, n) masks and a (n,) one."""
    return (jadc.tree_lut(masks), jadc._nearest_lut(masks),
            jref.value_table(masks, bits, vmin, vmax, "tree"),
            jref.value_table(masks, bits, vmin, vmax, "nearest"),
            jadc.tree_lut(shared), jadc._nearest_lut(shared),
            jref.value_table(shared, bits, vmin, vmax, "tree"),
            jadc.level_values(bits, vmin, vmax), jadc.level_values(bits))


@functools.partial(jax.jit, static_argnames=("bits", "vmin", "vmax"))
def j_codes(x, xp, m1, m2, m3, tables, *, bits, vmin, vmax):
    """Raw codes, kept-level codes for every mask rank and mode, and both
    quantizers, on x (M, C) and its population stack xp (P, M, C)."""
    kw = dict(bits=bits, vmin=vmin, vmax=vmax)
    kept = [jadc.adc_codes(xx, mk, mode=mode, **kw)
            for mode in ("tree", "nearest")
            for xx, mk in ((x, m1), (x, m2), (xp, m3))]
    return (jadc.encode(x, **kw), jref._codes(x, **kw), *kept,
            jref.adc_quantize_ref(x, tables[0], **kw),
            jref.adc_quantize_ref_population(x, tables, **kw))


@jax.jit
def j_levels(m, extra, one):
    return (jadc.add_levels(m, extra),
            *(jadc.repair_mask(m, k) for k in (1, 2, 3)),
            jadc.repair_mask(one))


def _same(port, reference):
    """Bitwise equality of a port tensor and a reference array."""
    got = np.asarray(port.cpu().numpy() if hasattr(port, "cpu") else port)
    want = np.asarray(reference)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got.astype(want.dtype), want)


def _masks(rng, lead, n):
    """Random masks plus the min-kept edge cases: a single kept level, two
    kept levels, and an all-zero row."""
    m = (rng.random(lead + (n,)) < 0.5).astype(np.int32)
    flat = m.reshape(-1, n)
    flat[0] = 0
    flat[0, rng.integers(n)] = 1                 # one kept level
    if len(flat) > 1 and n > 1:
        flat[1] = 0
        flat[1, rng.choice(n, 2, replace=False)] = 1
    if len(flat) > 2:
        flat[2] = 0                              # nothing kept
    return m


def _ranges(rng, c, per_channel):
    if not per_channel:
        return -0.3, 1.7
    lo = rng.uniform(-1.0, 0.5, size=c)
    return tuple(lo), tuple(lo + rng.uniform(0.1, 3.0, size=c))


SPECS = [dict(bits=3), dict(bits=5, mode="nearest"),
         dict(bits=2, vmin=-1.0, vmax=2.5),
         dict(bits=4, vmin=(0.0, -1.0, 0.2), vmax=(1.0, 1.0, 3.0)),
         dict(bits=1, vmin=[0.5], vmax=np.array([0.75]))]


@pytest.mark.parametrize("kw", SPECS)
def test_spec_meta_and_ranges_agree(kw):
    j, t = jspec.AdcSpec(**kw), tspec.AdcSpec(**kw)
    assert t.to_meta() == j.to_meta()
    assert tspec.AdcSpec.from_meta(j.to_meta()).to_meta() == j.to_meta()
    assert jspec.AdcSpec.from_meta(t.to_meta()) == j
    assert (t.levels, t.per_channel, t.channels, t.describe()) == (
        j.levels, j.per_channel, j.channels, j.describe())
    c = t.channels or 7
    for a, b in zip(t.range_rows(c), j.range_rows(c)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_spec_helpers_agree():
    for s in ("0.25", "0.0,-1.0,0.2", "-3"):
        assert tspec.parse_range(s) == jspec.parse_range(s)
    for v in (0, 1.5, [1, 2], (3.0,), np.array([0.5, 0.25])):
        assert tspec.normalize_range(v) == jspec.normalize_range(v)
    s = tspec.as_spec(bits=3, vmin=-1.0)
    assert s.to_meta() == jspec.as_spec(bits=3, vmin=-1.0).to_meta()
    with pytest.raises(TypeError):
        tspec.as_spec(s, bits=3)
    with pytest.raises(ValueError):
        tspec.AdcSpec(bits=0)
    with pytest.raises(ValueError):
        tspec.AdcSpec(bits=2, vmin=1.0, vmax=0.5)
    with pytest.raises(ValueError):
        tspec.AdcSpec(bits=2, vmin=(0.0, 0.0), vmax=1.0).validate_channels(3)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("per_channel", [False, True])
def test_rows_levels_luts_and_value_tables_bitwise(bits, per_channel):
    """range_rows, level_values, tree/nearest LUTs and value tables for
    (P, C, n) population masks with min-kept rows and a 1-D shared mask,
    scalar or per-channel ranges."""
    rng = np.random.default_rng(bits + 10 * per_channel)
    p, c, n = 3, 5, 2 ** bits
    vmin, vmax = _ranges(rng, c, per_channel)
    for a, b in zip(tadc.range_rows(bits, vmin, vmax, c),
                    jadc.range_rows(bits, vmin, vmax, c)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    masks, shared = _masks(rng, (p, c), n), _masks(rng, (), n)
    want = j_tables(jnp.asarray(masks), jnp.asarray(shared), bits=bits,
                    vmin=vmin, vmax=vmax)
    mt, st = torch.from_numpy(masks), torch.from_numpy(shared)
    got = (tadc.tree_lut(mt), tadc._nearest_lut(mt),
           tref.value_table(mt, bits, vmin, vmax, "tree"),
           tref.value_table(mt, bits, vmin, vmax, "nearest"),
           tadc.tree_lut(st), tadc._nearest_lut(st),
           tref.value_table(st, bits, vmin, vmax, "tree"),
           tadc.level_values(bits, vmin, vmax), tadc.level_values(bits))
    for g, w in zip(got, want):
        _same(g, w)
    spec = tspec.AdcSpec(bits=bits, mode="nearest", vmin=vmin, vmax=vmax)
    _same(spec.value_table(masks), want[3])
    _same(spec.level_values(c), want[7])


@pytest.mark.parametrize("bits", [1, 3, 6])
@pytest.mark.parametrize("per_channel", [False, True])
def test_codes_and_quantizers_bitwise(bits, per_channel):
    """encode, _codes, adc_codes for (n,), (C, n) and (P, C, n) masks in
    both modes, and the single and population quantizers; x strays
    outside the range to hit the clamps."""
    rng = np.random.default_rng(300 + bits)
    m_rows, c, p, n = 37, 6, 3, 2 ** bits
    vmin, vmax = _ranges(rng, c, per_channel)
    lo = np.min(np.asarray(vmin)) - 0.5
    hi = np.max(np.asarray(vmax)) + 0.5
    x = rng.uniform(lo, hi, size=(m_rows, c)).astype(np.float32)
    xp = np.stack([x] * p)
    m1, m2, m3 = _masks(rng, (), n), _masks(rng, (c,), n), _masks(rng, (p, c),
                                                                  n)
    tables_t = tref.value_table(torch.from_numpy(m3), bits, vmin, vmax)
    want = j_codes(*(jnp.asarray(a) for a in (x, xp, m1, m2, m3)),
                   jnp.asarray(tables_t.numpy()), bits=bits, vmin=vmin,
                   vmax=vmax)
    xt = torch.from_numpy(x)
    kw = dict(bits=bits, vmin=vmin, vmax=vmax)
    kept = [tadc.adc_codes(torch.from_numpy(xx), torch.from_numpy(mk),
                           mode=mode, **kw)
            for mode in ("tree", "nearest")
            for xx, mk in ((x, m1), (x, m2), (xp, m3))]
    got = (tadc.encode(xt, bits, vmin, vmax),
           tref._codes(xt, bits, vmin, vmax), *kept,
           tref.adc_quantize_ref(xt, tables_t[0], bits, vmin, vmax),
           tref.adc_quantize_ref_population(xt, tables_t, bits, vmin, vmax))
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("bits", [2, 4])
def test_add_levels_and_repair_mask_bitwise(bits):
    rng = np.random.default_rng(400 + bits)
    n = 2 ** bits
    m = _masks(rng, (7,), n)
    extra = rng.integers(0, n + 2, size=7)
    one = _masks(rng, (), n)
    want = j_levels(jnp.asarray(m), jnp.asarray(extra), jnp.asarray(one))
    got = (tadc.add_levels(torch.from_numpy(m), torch.from_numpy(extra)),
           *(tadc.repair_mask(torch.from_numpy(m), k) for k in (1, 2, 3)),
           tadc.repair_mask(torch.from_numpy(one)))
    for g, w in zip(got, want):
        _same(g, w)
