"""Port parity, fused classifier kernels: the plain versions behind
repro_torch.kernels.qmlp against the JAX package's Pallas kernels run in
interpret mode, plus the wrappers' routing, checks, dispatch records,
envelope and build. Bitwise on dyadic inputs (scalar range, power-of-two
weights, fixed-point biases: every partial sum is exact, so summation
order cannot matter); atol=1e-6 with float weights or per-channel ranges,
where the reference and the port sum in different orders."""
import pytest

torch = pytest.importorskip("torch")

import types  # noqa: E402
from pathlib import Path  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.spec import AdcSpec as JSpec  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.qmlp import (bespoke_mlp_bank_pallas,  # noqa: E402
                                bespoke_mlp_pallas, bespoke_svm_bank_pallas,
                                bespoke_svm_pallas)
from repro_torch.core.spec import AdcSpec  # noqa: E402
from repro_torch.kernels import (_build, dispatch, envelope, ops,  # noqa
                                 qmlp, ref)

REPO = Path(__file__).resolve().parents[1]


def _inputs(rng, kind, d, m, f, h, o, bits, *, dyadic, per_channel=False):
    """Numpy inputs shared by both packages: x (M, F) straying outside the
    range, pruned masks (D, F, n), weights stacked over D."""
    n = 2 ** bits
    if per_channel:
        lo = rng.uniform(-1.0, 0.5, size=f)
        vmin, vmax = tuple(lo), tuple(lo + rng.uniform(0.5, 2.0, size=f))
        x = rng.uniform(lo - 0.2, lo + 2.2, size=(m, f))
    else:
        vmin, vmax = 0.0, 1.0
        x = rng.uniform(-0.1, 1.1, size=(m, f))
    masks = (rng.random((d, f, n)) < 0.5).astype(np.int32)
    masks[..., 0] = 1

    def w(*shape):
        if dyadic:
            return (rng.choice([-1.0, 0.0, 1.0], size=shape)
                    * np.exp2(rng.integers(-3, 1, size=shape)))
        return rng.normal(size=shape)

    def b(*shape):
        return (rng.integers(-16, 17, size=shape) / 16.0 if dyadic
                else rng.normal(size=shape))

    weights = ((w(d, f, h), b(d, h), w(d, h, o), b(d, o)) if kind == "mlp"
               else (w(d, f, o), b(d, o)))
    return (x.astype(np.float32), masks,
            tuple(a.astype(np.float32) for a in weights), vmin, vmax)


def _pallas_bank(kind, x, tables, weights, bits, vmin, vmax):
    fn = bespoke_mlp_bank_pallas if kind == "mlp" else bespoke_svm_bank_pallas
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(tables),
                         *map(jnp.asarray, weights), bits=bits, vmin=vmin,
                         vmax=vmax, block_m=16, interpret=True))


def _compare(got, want, exact):
    got = got.numpy()
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["mlp", "svm"])
@pytest.mark.parametrize("case", ["dyadic", "float", "per_channel"])
def test_bank_plain_matches_pallas_interpret(kind, case):
    """The port's bank (CPU: the plain version) against the Pallas bank
    kernel, D=3 designs, ragged M=37 against block_m=16."""
    rng = np.random.default_rng(7 + len(case) + len(kind))
    bits = 4 if case != "per_channel" else 3
    x, masks, weights, vmin, vmax = _inputs(
        rng, kind, 3, 37, 6, 5, 3, bits, dyadic=case == "dyadic",
        per_channel=case == "per_channel")
    spec = AdcSpec(bits=bits, vmin=vmin, vmax=vmax)
    tables = spec.value_table(masks)
    want = _pallas_bank(kind, x, tables.numpy(), weights, bits, vmin, vmax)
    got = ops.classifier_bank(torch.from_numpy(x), tables,
                              tuple(map(torch.from_numpy, weights)),
                              kind=kind, spec=spec)
    _compare(got, want, exact=case == "dyadic")


@pytest.mark.parametrize("kind", ["mlp", "svm"])
def test_single_design_plain_matches_pallas_interpret(kind):
    """bespoke_mlp / bespoke_svm (the D=1 bank call) against the
    single-design Pallas kernels, bitwise, ragged M=45."""
    rng = np.random.default_rng(11 if kind == "mlp" else 12)
    bits = 3
    x, masks, weights, _, _ = _inputs(rng, kind, 1, 45, 7, 4, 2, bits,
                                      dyadic=True)
    spec = AdcSpec(bits=bits)
    table = spec.value_table(masks[0])
    one = tuple(w[0] for w in weights)
    fn = bespoke_mlp_pallas if kind == "mlp" else bespoke_svm_pallas
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(table.numpy()),
                         *map(jnp.asarray, one), bits=bits, block_m=16,
                         interpret=True))
    wrapper = qmlp.bespoke_mlp if kind == "mlp" else qmlp.bespoke_svm
    got = wrapper(torch.from_numpy(x), table, *map(torch.from_numpy, one),
                  spec=spec)
    _compare(got, want, exact=True)
    # the mask-taking entry bakes the same table
    port_ops = ops.bespoke_mlp if kind == "mlp" else ops.bespoke_svm
    ref_ops = jops.bespoke_mlp if kind == "mlp" else jops.bespoke_svm
    via_mask = port_ops(torch.from_numpy(x), torch.from_numpy(masks[0]),
                        *map(torch.from_numpy, one), spec=spec)
    want_ops = ref_ops(jnp.asarray(x), jnp.asarray(masks[0]),
                       *map(jnp.asarray, one), spec=JSpec(bits=bits))
    _compare(via_mask, np.asarray(want_ops), exact=True)


@pytest.mark.parametrize("kind", ["mlp", "svm"])
def test_wrappers_on_cpu_run_the_plain_version_and_count_nothing(kind):
    rng = np.random.default_rng(21)
    x, masks, weights, _, _ = _inputs(rng, kind, 2, 19, 5, 3, 4, 2,
                                      dyadic=False)
    spec = AdcSpec(bits=2)
    tables = spec.value_table(masks)
    xt, wt = torch.from_numpy(x), tuple(map(torch.from_numpy, weights))
    qmlp.reset_launches()
    bank = qmlp.bespoke_mlp_bank if kind == "mlp" else qmlp.bespoke_svm_bank
    plain = (ref.bespoke_mlp_bank_ref if kind == "mlp"
             else ref.bespoke_svm_bank_ref)
    got = bank(xt, tables, *wt, spec=spec)
    assert torch.equal(got, plain(xt, tables, 2, *wt))
    assert qmlp.launches == {"qmlp_mlp_bank": 0, "qmlp_svm_bank": 0,
                             "bespoke_mlp": 0, "bespoke_svm": 0}
    # each design row equals the single-design plain version
    single = ref.bespoke_mlp_ref if kind == "mlp" else ref.bespoke_svm_ref
    for d in range(2):
        torch.testing.assert_close(
            got[d], single(xt, tables[d], 2, *(w[d] for w in wt)),
            rtol=0, atol=1e-6)
    # empty batch: (D, 0, O)
    assert bank(xt[:0], tables, *wt, spec=spec).shape == (2, 0, 4)


def test_wrappers_reject_bad_shapes():
    rng = np.random.default_rng(22)
    x, masks, weights, _, _ = _inputs(rng, "mlp", 2, 8, 5, 3, 2, 2,
                                      dyadic=True)
    spec = AdcSpec(bits=2)
    tables = spec.value_table(masks)
    xt, wt = torch.from_numpy(x), list(map(torch.from_numpy, weights))
    with pytest.raises(ValueError, match="channels"):
        qmlp.bespoke_mlp_bank(xt[:, :4], tables, *wt, spec=spec)
    with pytest.raises(ValueError, match="b1"):
        qmlp.bespoke_mlp_bank(xt, tables, wt[0], wt[1][:, :2], wt[2], wt[3],
                              spec=spec)
    with pytest.raises(ValueError, match="levels"):
        qmlp.bespoke_mlp_bank(xt, tables, *wt, spec=AdcSpec(bits=3))
    with pytest.raises(ValueError, match="unknown classifier kind"):
        ops.classifier_bank(xt, tables, wt, kind="tree", spec=spec)
    with pytest.raises(ValueError, match="pins"):
        qmlp.bespoke_mlp_bank(xt, tables, *wt,
                              spec=AdcSpec(bits=2, vmin=(0.0,) * 3,
                                           vmax=(1.0,) * 3))


def _fake_cuda(shape):
    """Stand-in for a CUDA tensor: resolve() reads only device and shape."""
    return types.SimpleNamespace(device=torch.device("cuda", 0), shape=shape)


def test_dispatch_rules():
    x = torch.zeros(4, 21)
    tables = torch.zeros(6, 21, 16)
    mlp_w = (torch.zeros(6, 21, 5), torch.zeros(6, 5), torch.zeros(6, 5, 3),
             torch.zeros(6, 3))
    res = dispatch.resolve("qmlp_mlp_bank", "mlp", x, tables, mlp_w)
    assert (res.path, res.device) == ("plain", "cpu")
    assert res.as_dict()["entry"] == "qmlp_mlp_bank"
    fake = [_fake_cuda(t.shape) for t in mlp_w]
    res = dispatch.resolve("qmlp_mlp_bank", "mlp", _fake_cuda((4, 21)),
                           _fake_cuda((6, 21, 16)), fake)
    assert (res.path, res.device) == ("kernel", "cuda:0")
    svm_w = (_fake_cuda((6, 1000, 3)), _fake_cuda((6, 3)))
    with pytest.raises(ValueError, match="shared memory"):
        dispatch.resolve("qmlp_svm_bank", "svm", _fake_cuda((4, 1000)),
                         _fake_cuda((6, 1000, 64)), svm_w)
    # meta (the dry run): the kernel path without a launch; any other
    # device but cpu and cuda is refused
    assert dispatch.resolve("qmlp_mlp_bank", "mlp", x.to("meta"), tables,
                            mlp_w).path == "meta"
    with pytest.raises(ValueError, match="unsupported device"):
        dispatch.resolve("qmlp_mlp_bank", "mlp", types.SimpleNamespace(
            device=torch.device("xpu"), shape=x.shape), tables, mlp_w)


def test_envelope_is_shared_memory():
    # cardio at its published width fits the default 48 KB
    assert envelope.smem_bytes("mlp", 21, 16, 5, 3) == 4 * (
        21 * 16 + 21 * 5 + 5 + 5 * 3 + 3 + 2 * 21)
    assert envelope.smem_bytes("svm", 21, 16, 0, 3) == 4 * (
        21 * 16 + 21 * 3 + 3 + 2 * 21)
    assert envelope.outside_envelope("mlp", 21, 16, 5, 3, 6) is None
    # above 48 KB (dynamic shared memory) but inside 227 KB
    assert envelope.smem_bytes("mlp", 200, 64, 8, 4) > \
        envelope.SMEM_DEFAULT_BYTES
    assert envelope.outside_envelope("mlp", 200, 64, 8, 4, 2) is None
    # bits or channels beyond the TPU envelope are fine while they fit
    assert envelope.outside_envelope("svm", 4000, 8, 0, 2, 1) is None
    assert envelope.SMEM_MAX_BYTES == 227 * 1024
    assert "shared memory" in envelope.outside_envelope(
        "svm", 1000, 64, 0, 3, 1)
    assert "grid" in envelope.outside_envelope(
        "svm", 21, 16, 0, 3, envelope.MAX_DESIGNS + 1)
    with pytest.raises(ValueError):
        envelope.resident_floats("tree", 1, 2, 3, 4)


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """A missing compiler is an error, never a fallback."""
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(["qmlp_bank"])
    path = _build.library_path("qmlp_bank")
    assert path.parent == tmp_path and path.name.startswith("libqmlp_bank-")
    assert "build/" in (REPO / ".gitignore").read_text().split()
    flags = " ".join(_build.NVCC_FLAGS)
    assert "sm_90a" in flags and "fast-math" not in flags


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mlp", "svm"])
def test_bank_kernel_matches_plain_on_card(kind):
    """On the card: the CUDA bank kernel against its plain version,
    bitwise on dyadic inputs, with the launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(31)
    x, masks, weights, _, _ = _inputs(rng, kind, 5, 1000, 21, 5, 3, 4,
                                      dyadic=True)
    spec = AdcSpec(bits=4)
    dev = torch.device("cuda")
    tables = spec.value_table(masks).to(dev)
    xt = torch.from_numpy(x).to(dev)
    wt = tuple(torch.from_numpy(w).to(dev) for w in weights)
    name = f"qmlp_{kind}_bank"
    before = qmlp.launches[name]
    got = ops.classifier_bank(xt, tables, wt, kind=kind, spec=spec)
    plain = (ref.bespoke_mlp_bank_ref if kind == "mlp"
             else ref.bespoke_svm_bank_ref)
    want = plain(xt, tables, 4, *wt)
    torch.cuda.synchronize()
    assert qmlp.launches[name] == before + 1
    assert torch.equal(got, want)
