"""Port parity, int8 error-feedback gradient compression
(``repro_torch/optim/compression.py``) against the JAX package's
``repro/optim/compression.py``.

The reference's collectives run under ``shard_map`` over real devices,
and JAX fixes its device count when it starts, so one subprocess with 8
forced host devices (tests/torch_dp_reference.py) computes every
reference result (the ring at n = 2, 3 and 8, the pod 2 x data 2 mean, 8
steps of ``sync_grads``, the moe family's int8 step at dp = 2, the
reference step's error at dp = 2) into one ``.npz``; ``_quant`` runs in
this process, jitted, as the reference's steps run it. The port runs the
same inputs with every rank on the CPU.

Tolerances. ``_quant``, the error rows and every output at n = 2 are
bitwise: the scale is an exact max times float32(1 / 127) (XLA rewrites
the division by the constant 127 into that product, and the mean's
``/ n`` likewise; the port writes the products), rounding is half to
even in both packages. Where the ring has a reduce-scatter hop of its
own (n >= 3) and in the partner exchange, XLA's CPU fusion contracts
``q * s + x`` into one fused multiply-add; the port rounds the product
and the sum apart, as the reference's source does and as the card does
(chip_smoke.py's phase dp_train holds the card bitwise to the CPU). There
the outputs agree within 2 ulps of the vector's largest element
(measured: 1 ulp, 1.2e-7, on 29 % to 49 % of the elements). The ring's
error against the true mean is bounded by ``(n + 1) / 4`` of the inputs'
int8 step (n - 1 reduce-scatter hops whose partials grow to (t + 1)
max|x|, each off by half its own step and divided by n, plus half a step
in the all-gather): the mean itself, with no extra division by n (the
reference test's ``/ 8`` hides a factor of 8)."""
import pytest

torch = pytest.importorskip("torch")


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import compression as jcompression  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from torch_dp_checks import (assert_int8_state, assert_metrics,  # noqa: E402
                             reference, run_port)

RING_NS = (2, 3, 8)
EF_STEPS = 8
EF_RANKS = 4

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """tests/torch_dp_reference.py's parts ``ring`` (every collective's
    output), ``pinned`` and ``moe_int8_dp2``, in one subprocess."""
    return reference(tmp_path_factory.mktemp("compression"), "ring",
                     "pinned", "moe_int8_dp2")


def _xs():
    return np.random.default_rng(0).normal(size=(8, 1000)).astype(np.float32)


def _bf16(bits):
    return torch.from_numpy(np.ascontiguousarray(bits)).view(torch.bfloat16)


def _quant_cases():
    rng = np.random.default_rng(3)
    return {
        # amax 127: the scale is 1 (1e-30 vanishes), so x / scale is x and
        # every .5 is an exact tie, rounded to the even neighbour
        "ties": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5,
                          -126.5, 3.5], np.float32),
        "zeros": np.zeros(17, np.float32),
        # the largest elements land on +-127 and q must not wrap in int8;
        # the clamp itself is unreachable for finite x (|x| / s <= 127 plus
        # two ulps). Magnitudes near FLT_MAX are left out: there XLA's
        # vectorised division is not IEEE (fmax / 2 in a vector lane gives
        # 63.5, and -3e38 in the tail -127, where x / s is -111.97)
        "clipping": np.array([1e30, -1e30, 5e29, 1e-45, -9.9e29, 2.5e29],
                             np.float32),
        "subnormal": np.array([1e-40, -3e-41, 0.0, 5e-45], np.float32),
        "normal": rng.normal(size=4096).astype(np.float32),
    }


@pytest.mark.parametrize("case", list(_quant_cases()))
def test_quant_matches_the_reference_bitwise(case):
    x = _quant_cases()[case]
    jq, js = jax.jit(jcompression._quant)(jnp.asarray(x))
    q, s = compression._quant(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.ndim == 0
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    # the reference's own bound, in float64: within half a step of x, and
    # the rounding of x / s in float32 (127 ulps of 2^-24 at most)
    err = np.abs(q.numpy() * np.float64(s) - x.astype(np.float64))
    assert (err <= np.float64(s) * (0.5 + 127 * 2.0 ** -24)).all()
    if case == "ties":
        np.testing.assert_array_equal(
            q.numpy(), [127, 0, 2, 2, 0, -2, -2, 126, -126, 4])
    if case == "clipping":
        np.testing.assert_array_equal(q.numpy(), [127, -127, 64, 0, -126, 32])


def _assert_ring_close(got, want, *, exact, msg):
    """Bitwise where XLA does not fuse q * s + x, else within 2 ulps of
    the vector's largest element (the module docstring)."""
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        atol = 2 * np.spacing(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=msg)


@pytest.mark.parametrize("n", RING_NS)
def test_ring_matches_the_reference(ref, n):
    xs = _xs()[:n]
    got = compression.ring_allreduce_int8(
        [torch.from_numpy(x.copy()) for x in xs], n)
    assert len(got) == n and all(g.shape == (1000,) for g in got)
    for r in range(n):
        _assert_ring_close(got[r].numpy(), ref[f"ring{n}"][r], exact=n == 2,
                           msg=f"rank {r}")
        np.testing.assert_array_equal(got[r].numpy(), got[0].numpy())
    scale = np.abs(xs).max() / 127.0
    err = np.abs(got[0].numpy() - xs.mean(0)).max()
    assert err <= (n + 1) / 4 * scale, (err, scale)
    # the mean, not the mean / n the reference test compares with
    assert np.corrcoef(got[0].numpy(), xs.mean(0))[0, 1] > 0.999


def test_single_rank_is_the_identity():
    x = torch.from_numpy(_xs()[0])
    assert compression.ring_allreduce_int8([x], 1)[0] is x
    assert compression.compressed_mean([x], ("data",), (1,))[0] is x
    with pytest.raises(ValueError, match="2 vectors for a ring of 3"):
        compression.ring_allreduce_int8([x, x], 3)


def test_pod_exchange_matches_the_reference(ref):
    xs = _xs()[:4]
    got = compression.compressed_mean(
        [torch.from_numpy(x.copy()) for x in xs], ("pod", "data"), (2, 2))
    want = ref["pod2data2"].reshape(4, -1)
    for r in range(4):
        _assert_ring_close(got[r].numpy(), want[r], exact=False,
                           msg=f"rank {r} (pod-major)")
    # equal inside a pod; across pods not (each keeps its own exact pod
    # mean and adds the other's quantized one), as in the reference
    for pod in (0, 2):
        np.testing.assert_array_equal(got[pod + 1].numpy(),
                                      got[pod].numpy())
    np.testing.assert_array_equal(want[1], want[0])
    assert not np.array_equal(want[2], want[0])
    scale = np.abs(xs).max() / 127.0
    for r in (0, 2):
        assert np.abs(got[r].numpy() - xs.mean(0)).max() <= 2 * scale


def test_a_pod_count_other_than_two_is_refused():
    xs = [torch.from_numpy(x) for x in _xs()[:6]]
    with pytest.raises(NotImplementedError, match="2 pods.*ROADMAP C"):
        compression.compressed_mean(xs, ("pod", "data"), (3, 2))
    with pytest.raises(ValueError, match="6 vectors"):
        compression.compressed_mean(xs, ("pod", "data"), (2, 2))


def _ef_inputs(ref):
    """The subprocess's gradients, per rank, in their insertion order."""
    def leaf(key):
        a = ref[f"in/{key}"]
        return [(_bf16(a[r]) if a.dtype == np.uint16
                 else torch.from_numpy(a[r].copy())) for r in range(EF_RANKS)]
    w, b = leaf("['w']"), leaf("['b']")
    z, c = leaf("['a']['z']"), leaf("['a']['c']")
    return [{"w": w[r], "b": b[r], "a": {"z": z[r], "c": c[r]}}
            for r in range(EF_RANKS)]


def _sync_eight(grads, zero_err):
    n_el = sum(t.numel() for t in (grads[0]["w"], grads[0]["b"],
                                   grads[0]["a"]["z"], grads[0]["a"]["c"]))
    err = compression.init_error_buffer(grads[0], EF_RANKS)
    assert [e.shape for e in err] == [(n_el,)] * EF_RANKS
    outs = []
    for _ in range(EF_STEPS):
        if zero_err:
            err = [torch.zeros_like(e) for e in err]
        o, err = compression.sync_grads(grads, err, ("data",), (EF_RANKS,))
        outs.append((o, err))
    return outs


def test_sync_grads_eight_steps_match_the_reference(ref):
    """4 ranks: the error rows bitwise at every step, the synced leaves as
    the ring's outputs (bitwise in bf16, which the ulps do not reach)."""
    grads = _ef_inputs(ref)
    outs = _sync_eight(grads, zero_err=False)
    for step, (o, err) in enumerate(outs):
        np.testing.assert_array_equal(
            np.stack([e.view(torch.int16).numpy() for e in err]),
            ref[f"err{step}"].view(np.int16), err_msg=f"err {step}")
        for r in range(EF_RANKS):
            # the port's tree keeps the insertion order and each dtype
            assert list(o[r]) == ["w", "b", "a"] and list(o[r]["a"]) == [
                "z", "c"]
            for key, got in (("['w']", o[r]["w"]), ("['b']", o[r]["b"]),
                             ("['a']['z']", o[r]["a"]["z"]),
                             ("['a']['c']", o[r]["a"]["c"])):
                want = ref[f"out{step}/{key}"][r]
                if want.dtype == np.uint16:
                    assert got.dtype == torch.bfloat16
                    np.testing.assert_array_equal(
                        got.view(torch.int16).numpy().view(np.uint16), want,
                        err_msg=f"step {step} rank {r} {key}")
                else:
                    _assert_ring_close(got.numpy(), want, exact=False,
                                       msg=f"step {step} rank {r} {key}")


def _ef_errors(grads, outs):
    """(the first sync's max error against the true mean, the 8 syncs'
    average's), float32 leaf w."""
    want = torch.stack([g["w"] for g in grads]).mean(0).numpy()
    first = outs[0][0][0]["w"].numpy()
    avg = np.mean([o[0]["w"].numpy() for o, _ in outs], axis=0)
    return np.abs(first - want).max(), np.abs(avg - want).max()


@pytest.mark.parametrize("zero_err", [False, True],
                         ids=["error feedback", "control: err zeroed"])
def test_error_feedback_removes_the_bias_over_steps(ref, zero_err):
    """The reference test's check: over 8 syncs of the same gradients the
    average's error falls below the first sync's. Zeroing err before
    every sync (the control) makes every sync the first, so the check
    must fail there."""
    grads = _ef_inputs(ref)
    base, ef = _ef_errors(grads, _sync_eight(grads, zero_err))
    if zero_err:
        assert not ef < base, (ef, base)
    else:
        assert ef < base, (ef, base)


def test_error_rows_live_on_their_ranks_devices():
    params = {"b": torch.zeros(3), "a": {"x": torch.zeros(2, 5)}}
    rows = compression.init_error_buffer(params, 2, ["cpu", "cpu"])
    assert [(r.shape, r.dtype, r.device.type) for r in rows] == [
        ((13,), torch.bfloat16, "cpu")] * 2
    with pytest.raises(ValueError, match="1 devices for 2 dp ranks"):
        compression.init_error_buffer(params, 2, ["cpu"])
    g = {"b": torch.tensor([0.0, 2.0, 254.0]), "a": {"x": torch.ones(2, 5)}}
    flat, new = compression.local_quantize(g, rows[0], length=16)
    assert flat.shape == (16,) and (flat[13:] == 0).all()
    # sorted leaf order: a/x first, then b (these leaves dequantize
    # exactly: each is q times its scale, which rounds to 1 / 127 of it)
    np.testing.assert_array_equal(flat[:13].numpy(),
                                  [1.0] * 10 + [0.0, 2.0, 254.0])
    assert (new == 0).all()
    flat2, none = compression.local_quantize(g, None)
    assert none is None and torch.equal(flat2, flat[:13])


def test_the_reference_int8_step_raises_at_dp_2(ref):
    """Pinned: the reference's own int8 step fails on a (2, 1) mesh
    (transformer.constrain_batch's sharding constraint names the 'data'
    axis inside the shard_map that is manual over it), so the port's dp =
    2 int8 step is held against the reference's pieces composed
    (tests/torch_dp_reference.py). A JAX upgrade that changes this shows
    here."""
    msg = str(ref["pinned_error"])
    assert "contains a manual axes ('data',)" in msg, msg


def test_moe_int8_step_at_dp_2_matches_the_composed_body(ref):
    """The moe family under int8: each rank routes, drops by capacity and
    takes the Switch aux loss over its own rows, the reference's shard_map
    semantics (uncompressed it is refused: tests/test_torch_dp_train.py).
    kimi-k2's smoke config, 2 steps, tolerances of
    tests/torch_dp_checks.py."""
    cfg = smoke_config("kimi-k2-1t-a32b").replace(grad_compression="int8")
    mesh = tmesh.make_host_mesh(2, 1, device="cpu")
    state, metrics, grads = run_port(ref, "moe_int8_dp2", cfg, mesh,
                                     n_steps=2)
    assert_metrics(ref, "moe_int8_dp2", metrics)
    assert_int8_state(ref, "moe_int8_dp2", state, grads)


@pytest.mark.parametrize("n", (2, 3))
def test_reusing_the_inputs_gives_the_same_results(n):
    """The ring consumes its inputs: a vector already padded to a
    multiple of n (the train step pads so) receives the rank's result in
    place, bitwise the result of the unpadded vector, whose own storage
    the ring leaves untouched (it works in a fresh pad); the padding
    dequantizes to 0."""
    xs = _xs()[:n, :997]
    pad = -(-997 // n) * n
    unpadded = [torch.from_numpy(x.copy()) for x in xs]
    want = compression.ring_allreduce_int8(unpadded, n)
    for u, x in zip(unpadded, xs):
        assert torch.equal(u, torch.from_numpy(x))
    mine = [torch.zeros(pad) for _ in range(n)]
    for m, x in zip(mine, xs):
        m[:997] = torch.from_numpy(x)
    got = compression.ring_allreduce_int8(mine, n)
    for g, m, w in zip(got, mine, want):
        assert g.data_ptr() == m.data_ptr() and g.shape == (pad,)
        assert torch.equal(g[:997], w) and (g[997:] == 0).all()
