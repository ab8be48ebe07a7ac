"""Port parity, QAT building blocks: repro_torch.core.qat, the STE module
form of core.adc.adc_quantize, the MLP/SVM functional forms and the
hand-rolled AdamW against the JAX package on shared numpy inputs.

Where the comparison is bitwise and where it is not:

* quantize_fixed, and every forward on dyadic inputs (tables, power-of-
  two weights, fixed-point biases): bitwise; every step is an exact
  float32 operation or a half-to-even round (same exp2 exception as
  below).
* quantize_po2: bitwise, with two measured exceptions of the reference's
  float32 transcendental functions on the CPU (jax 0.9.0), not of the
  port's arithmetic:
  - ``round(log2(|w|))`` within an ulp of sqrt(2) * 2^k (the float32
    nearest it and its two neighbours): the two log2s land on opposite
    sides of, or on, the half-integer (XLA -0.50000006, torch -0.5 for
    0.70710677), so the two round to adjacent powers of two there, and
    only there;
  - ``exp2`` at integer exponents <= -13: XLA returns 3.0517593e-05 for
    2^-15, torch the exact power. Where the exponent window reaches that
    low (dp - (bits - 1) <= -13) the reference's values are off by up to
    5e-7 relative; the port's stay exact powers of two and exact
    fixed-point multiples, which the test checks instead.
* loss and gradients with float weights: rtol=1e-5, atol=1e-8. The
  matmuls, log_softmax and the means sum in different orders (XLA vs
  PyTorch), so they round differently; 1e-8 covers gradient components
  that are pure roundoff (1e-11 cancellation residues).
* AdamW on identical gradients, after 1 and 10 steps: rtol=1e-6,
  atol=1e-7 on the parameters and moments. Same operations, same order;
  the bias correction's float32 pow and sqrt may differ by an ulp.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import adc as jadc  # noqa: E402
from repro.core import qat as jqat  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import svm as jsvm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.core import adc as tadc  # noqa: E402
from repro_torch.core import qat as tqat  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import svm as tsvm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402


def _weights(rng, shape):
    """Random, saturating, underflowing and tie inputs for the weight
    quantizers: normals at three scales, large magnitudes, values far
    below the smallest power, the float32 neighbours of sqrt(2) * 2^k
    (round(log2) near a half-integer), exact powers of two, fixed-point
    ties (k + 1/2) * step, and zeros."""
    parts = [rng.normal(size=shape) * s for s in (0.05, 1.0, 20.0)]
    k = rng.integers(-10, 6, size=shape)
    root2 = (np.sqrt(2.0) * np.exp2(k)).astype(np.float32)
    parts += [np.nextafter(root2, np.float32(0)), root2,
              np.nextafter(root2, np.float32(np.inf)),
              np.exp2(k) * rng.choice([-1, 1], size=shape),
              (rng.integers(-40, 40, size=shape) + 0.5) * np.exp2(-7.0),
              rng.normal(size=shape) * 1e-6, np.zeros(shape),
              rng.normal(size=shape) * 3e4]
    return np.concatenate([np.asarray(p, np.float32).reshape(-1)
                           for p in parts])


# _weights' blocks 3..5: float32(sqrt(2) * 2^k) and its two neighbours
ROOT2 = slice(3 * 64, 6 * 64)


@pytest.mark.parametrize("dp,bits", [(-8, 4), (-3, 4), (0, 4), (2, 4),
                                     (7, 4), (-5, 8), (-3, 8), (0, 8),
                                     (2, 8), (7, 8)])
def test_quantizers_bitwise(dp, bits):
    """Exponent window >= 2^-12: bitwise, except po2 at sqrt(2) * 2^k
    (module docstring), where the two differ by exactly one power of
    two."""
    rng = np.random.default_rng(dp + 20 * bits)
    w = _weights(rng, (64,))
    tie = np.zeros(len(w), bool)
    tie[ROOT2] = True
    want = np.asarray(jqat.quantize_fixed(jnp.asarray(w), dp, bits))
    got = tqat.quantize_fixed(torch.from_numpy(w), dp, bits).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jqat.quantize_po2(jnp.asarray(w), dp, bits))
    got = tqat.quantize_po2(torch.from_numpy(w), dp, bits).numpy()
    np.testing.assert_array_equal(got[~tie], want[~tie])
    diff = tie & (got != want)
    assert set(np.abs(got[diff] / want[diff]).tolist()) <= {0.5, 2.0}


@pytest.mark.parametrize("dp", [-8, -6])
def test_quantizers_at_small_exponents(dp):
    """dp - 7 <= -13: the reference's exp2 is inexact there (module
    docstring), so its values agree to rtol=1e-6; the port's are exact
    powers of two (po2) and exact multiples of 2^(dp - 7) (fixed)."""
    rng = np.random.default_rng(60 - dp)
    w = _weights(rng, (64,))
    step = np.float64(2.0) ** (dp - 7)
    fixed = tqat.quantize_fixed(torch.from_numpy(w), dp).numpy()
    np.testing.assert_allclose(
        fixed, np.asarray(jqat.quantize_fixed(jnp.asarray(w), dp)),
        rtol=1e-6, atol=0)
    k = fixed.astype(np.float64) / step
    np.testing.assert_array_equal(k, np.round(k))
    assert np.abs(k).max() <= 2 ** 7
    po2 = tqat.quantize_po2(torch.from_numpy(w), dp).numpy()
    keep = np.ones(len(w), bool)
    keep[ROOT2] = False
    np.testing.assert_allclose(
        po2[keep], np.asarray(jqat.quantize_po2(jnp.asarray(w), dp))[keep],
        rtol=1e-6, atol=0)
    # where |w| is far above the window, w + (q - w) rounds (the STE's
    # stored value, as in the reference); elsewhere it is q exactly
    mag = np.abs(po2[(po2 != 0) & (np.abs(w) < 1e3)]).astype(np.float64)
    np.testing.assert_array_equal(np.exp2(np.round(np.log2(mag))), mag)
    assert mag.min() >= 2.0 ** (dp - 7) and mag.max() <= 2.0 ** dp


def test_quantizers_per_lane_dp_and_ste_gradient():
    """A (P,) dp broadcasts over each lane's leading axis; the STE
    gradient is the identity, and the forward value is x + (q - x)."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(4, 5, 3)).astype(np.float32)
    dps = np.array([-3.0, 0.0, 1.0, 4.0], np.float32)
    for jfn, tfn in ((jqat.quantize_po2, tqat.quantize_po2),
                     (jqat.quantize_fixed, tqat.quantize_fixed)):
        got = tfn(torch.from_numpy(w), torch.from_numpy(dps)).numpy()
        for p in range(4):
            np.testing.assert_array_equal(
                got[p], np.asarray(jfn(jnp.asarray(w[p]), dps[p])))
        wt = torch.from_numpy(w).requires_grad_()
        (g,) = torch.autograd.grad(
            (tfn(wt, torch.from_numpy(dps)) * 3.0).sum(), wt)
        assert torch.equal(g, torch.full_like(wt, 3.0))
    tree = tqat.quantize_tree([(torch.from_numpy(w[0]),
                                torch.from_numpy(w[0, 0]))], 1.0)
    np.testing.assert_array_equal(
        tree[0][1].numpy(), np.asarray(jqat.quantize_po2(w[0, 0], 1.0)))


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_adc_quantize_module_and_ste(rank):
    rng = np.random.default_rng(rank)
    bits, c = 3, 4
    n = 2 ** bits
    x = rng.uniform(-0.2, 1.2, size=(2, 9, c)).astype(np.float32)
    mask = (rng.random({1: (n,), 2: (c, n), 3: (2, c, n)}[rank]) < 0.5
            ).astype(np.int32)
    mask[..., 0] = 1
    for ste in (False, True):
        want = np.asarray(jadc.adc_quantize(jnp.asarray(x), jnp.asarray(mask),
                                            bits=bits, ste=ste))
        got = tadc.adc_quantize(torch.from_numpy(x), torch.from_numpy(mask),
                                bits=bits, ste=ste)
        np.testing.assert_array_equal(got.numpy(), want)
    xt = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(
        tadc.adc_quantize(xt, torch.from_numpy(mask), bits=bits).sum(), xt)
    assert torch.equal(g, torch.ones_like(xt))
    # no mask: the full ADC
    np.testing.assert_array_equal(
        tadc.adc_quantize(torch.from_numpy(x[0]), bits=bits,
                          ste=False).numpy(),
        np.asarray(jadc.adc_quantize(jnp.asarray(x[0]), bits=bits,
                                     ste=False)))


def _dyadic_case(rng, m=40, f=6, h=4, o=3, bits=3):
    x = ((rng.integers(0, 2 ** bits, size=(m, f)) + 0.5)
         / 2 ** bits).astype(np.float32)
    mlp = [(rng.normal(size=(f, h)).astype(np.float32),
            rng.normal(size=h).astype(np.float32)),
           (rng.normal(size=(h, o)).astype(np.float32),
            rng.normal(size=o).astype(np.float32))]
    svm = (rng.normal(size=(f, o)).astype(np.float32),
           rng.normal(size=o).astype(np.float32))
    y = rng.integers(0, o, size=m)
    return x, mlp, svm, y


def _t(params):
    if isinstance(params, tuple):
        return tuple(torch.from_numpy(a).requires_grad_() for a in params)
    return [tuple(torch.from_numpy(a).requires_grad_() for a in layer)
            for layer in params]


def _leaves(params):
    if isinstance(params, tuple):
        return list(params)
    return [a for layer in params for a in layer]


@pytest.mark.parametrize("dp", [-2.0, 1.0])
def test_forward_bitwise_on_dyadic_inputs(dp):
    """QAT forwards quantize to powers of two and fixed point, and the
    inputs are level midpoints: every product and partial sum is exact,
    so logits and accuracies are bitwise in both models."""
    rng = np.random.default_rng(int(dp) + 10)
    x, mlp, svm, y = _dyadic_case(rng)
    jm = [tuple(map(jnp.asarray, layer)) for layer in mlp]
    want = np.asarray(jmlp.apply_mlp(jm, jnp.asarray(x), dp))
    got = tmlp.apply_mlp(_t(mlp), torch.from_numpy(x), dp).detach().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tmlp.accuracy(_t(mlp), torch.from_numpy(x), torch.from_numpy(y),
                      dp).numpy(),
        np.asarray(jmlp.accuracy(jm, jnp.asarray(x), jnp.asarray(y), dp)))
    js = tuple(map(jnp.asarray, svm))
    np.testing.assert_array_equal(
        tsvm.apply_svm(_t(svm), torch.from_numpy(x), dp).detach().numpy(),
        np.asarray(jsvm.apply_svm(js, jnp.asarray(x), dp)))
    np.testing.assert_array_equal(
        tsvm.accuracy(_t(svm), torch.from_numpy(x), torch.from_numpy(y),
                      dp).numpy(),
        np.asarray(jsvm.accuracy(js, jnp.asarray(x), jnp.asarray(y), dp)))
    # a population stack: lane p is the unstacked forward of lane p
    stack = [tuple(torch.from_numpy(np.stack([a, a * 2])) for a in layer)
             for layer in mlp]
    lanes = tmlp.apply_mlp(stack, torch.from_numpy(np.stack([x, x])),
                           torch.tensor([dp, dp - 1.0]))
    np.testing.assert_array_equal(lanes[0].numpy(), got)
    np.testing.assert_array_equal(
        lanes[1].numpy(), np.asarray(jmlp.apply_mlp(
            [tuple(jnp.asarray(a * 2) for a in layer) for layer in mlp],
            jnp.asarray(x), dp - 1.0)))


@pytest.mark.parametrize("model", ["mlp", "svm"])
def test_loss_and_gradients_close(model):
    rng = np.random.default_rng(42 if model == "mlp" else 43)
    x, mlp, svm, y = _dyadic_case(rng, m=147)
    x = rng.uniform(0, 1, size=x.shape).astype(np.float32)
    dp = 0.0
    if model == "mlp":
        onehot = np.eye(3, dtype=np.float32)[y]

        def jloss(p):
            logp = jax.nn.log_softmax(jmlp.apply_mlp(p, jnp.asarray(x), dp))
            return -(jnp.asarray(onehot) * logp).sum(-1).mean()

        params = mlp
        tp = _t(params)
        tl = tmlp.cross_entropy(tp, torch.from_numpy(x),
                                torch.from_numpy(onehot), dp)
    else:
        def jloss(p):
            return jsvm.svm_loss(p, jnp.asarray(x), jnp.asarray(y), dp)

        params = svm
        tp = _t(params)
        tl = tsvm.svm_loss(tp, torch.from_numpy(x), torch.from_numpy(y), dp)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jl, jg = jax.value_and_grad(jloss)(jp)
    tg = torch.autograd.grad(tl, _leaves(tp))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    for a, b in zip(tg, jax.tree_util.tree_leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-8)


@pytest.mark.parametrize("steps", [1, 10])
def test_adamw_matches_reference(steps):
    """Both optimizers take the same numpy gradients, step by step."""
    rng = np.random.default_rng(steps)
    shapes = [(6, 4), (4,), (4, 3), (3,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.integers(-9, 1)
               ).astype(np.float32) for s in shapes] for _ in range(steps)]
    jp = [jnp.asarray(a) for a in params]
    js = jadamw.init(jp)
    tp = [torch.from_numpy(a.copy()) for a in params]
    ts = tadamw.init(tp)
    for g in grads:
        jp, js = jadamw.update([jnp.asarray(a) for a in g], js, jp, lr=5e-2)
        tadamw.update_(tp, [torch.from_numpy(a) for a in g], ts, lr=5e-2)
    assert float(ts.step) == float(js.step) == steps
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_init_is_a_seeded_torch_stream():
    """The port's initial weights: the reference's recipe (He scale,
    zero-mean columns, biases 0.1; SVM 0.1 * normal, zero bias) from a
    torch Generator, the same for the same seed."""
    sizes = (7, 3, 3)
    a = tmlp.init_mlp(torch.Generator().manual_seed(5), sizes)
    b = tmlp.init_mlp(torch.Generator().manual_seed(5), sizes)
    for (wa, ba), (wb, bb) in zip(a, b):
        assert torch.equal(wa, wb) and torch.equal(ba, bb)
        assert wa.dtype == torch.float32
        torch.testing.assert_close(wa.mean(0), torch.zeros(wa.shape[1]),
                                   rtol=0, atol=1e-6)
        assert torch.equal(ba, torch.full_like(ba, 0.1))
    w, bias = tsvm.init_svm(torch.Generator().manual_seed(5), 7, 3)
    assert w.shape == (7, 3) and torch.equal(bias, torch.zeros(3))
