"""Port parity, the online surrogate: repro_torch.core.surrogate against
the JAX package's ``repro.core.surrogate``, on the CPU.

* A reference ``SurrogateState`` flattened to numpy goes into the port
  through ``state_from_numpy`` bitwise, and the port's ``leaves`` come
  back in the reference's order, shapes and dtypes (a screened search
  checkpoint crosses packages).
* From the same injected state, ``observe`` then ``predict`` agree with
  the reference within ``PRED_ATOL`` = 1e-5 (the largest difference
  measured is 1.9e-7 after 64 steps: XLA and ATen sum the masked MSE and
  the matmuls in other orders); the ring buffer (x, y, count, ptr) is
  bitwise. One step fewer misses the limit by more than 100x.
* ``screen`` is bitwise when both packages get the same predictions: its
  order is a sort of predictions, so predictions that differ by ulps may
  swap near-ties, and it is held on shared predictions instead.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import surrogate as jsur  # noqa: E402
from repro_torch.core import surrogate as tsur  # noqa: E402

PRED_ATOL = 1e-5


def _ref_leaves(state):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(state)]


def _batch(seed, rows=16, glen=20, n_obj=2):
    rng = np.random.default_rng(seed)
    return ((rng.random((rows, glen)) < 0.5).astype(np.uint8),
            rng.random((rows, n_obj)))


@pytest.mark.parametrize("n_obj", [2, 3])
def test_leaves_cross_packages_bitwise(n_obj):
    """Reference state -> port -> leaves is the identity, bitwise, and
    the port's own init has the reference's layout."""
    ref = jsur.init(20, n_obj, hidden=8, seed=5)
    ref = jsur.observe(ref, *_batch(1, n_obj=n_obj), steps=3)
    want = _ref_leaves(ref)
    got = tsur.leaves(tsur.state_from_numpy(want, "cpu"))
    assert len(got) == len(want) == 17
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    mine = tsur.leaves(tsur.init(20, n_obj, hidden=8, seed=5,
                                   device="cpu"))
    assert [(a.shape, a.dtype) for a in mine] == [(b.shape, b.dtype)
                                                  for b in _ref_leaves(
                                                      jsur.init(20, n_obj,
                                                                hidden=8))]
    with pytest.raises(ValueError, match="surrogate state"):
        tsur.state_from_numpy(want[:-1], "cpu")


@pytest.mark.parametrize("steps", [16, 64])
def test_observe_and_predict_match_reference(steps):
    g, f = _batch(3)
    ref0 = jsur.init(20, 2, seed=5)
    port0 = tsur.state_from_numpy(_ref_leaves(ref0), "cpu")
    ref1 = jsur.observe(ref0, g, f, steps=steps)
    port1 = tsur.observe(port0, g, f, steps=steps)
    g2, f2 = _batch(4, rows=9)
    ref2 = jsur.observe(ref1, g2, f2, steps=steps)
    port2 = tsur.observe(port1, g2, f2, steps=steps)
    allg = np.concatenate([g, g2])
    want = jsur.predict(ref2, allg)
    got = tsur.predict(port2, allg)
    assert got.dtype == np.float64 and got.shape == (25, 2)
    assert np.abs(got - want).max() <= PRED_ATOL
    ring_got, ring_want = tsur.leaves(port2)[-4:], _ref_leaves(ref2)[-4:]
    for a, b in zip(ring_got, ring_want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tsur.leaves(port2)[:13], _ref_leaves(ref2)[:13]):
        assert np.abs(a.astype(np.float64) - b).max() <= PRED_ATOL
    # control: one step fewer misses the limit
    short = tsur.observe(tsur.observe(port0, g, f, steps=steps), g2, f2,
                         steps=steps - 1)
    assert np.abs(tsur.predict(short, allg) - want).max() > 100 * PRED_ATOL


def test_observe_is_deterministic_and_pure():
    g, f = _batch(3)
    s0 = tsur.init(20, 2, seed=5, device="cpu")
    before = tsur.leaves(s0)
    s1 = tsur.observe(s0, g, f, steps=16)
    s2 = tsur.observe(s0, g, f, steps=16)
    np.testing.assert_array_equal(tsur.predict(s1, g), tsur.predict(s2, g))
    for a, b in zip(tsur.leaves(s0), before):
        np.testing.assert_array_equal(a, b)     # the argument is untouched
    s3 = tsur.observe(tsur.init(20, 2, seed=6, device="cpu"), g, f, steps=16)
    assert not np.array_equal(tsur.predict(s3, g), tsur.predict(s1, g))


def test_ring_buffer_counts_and_wrap():
    """count/ptr as the reference's; a batch longer than the ring keeps
    its last CAPACITY rows, as the reference's scatter does."""
    s = tsur.init(10, 2, device="cpu")
    z, zf = np.zeros((5, 10), np.uint8), np.zeros((5, 2))
    s = tsur.observe(s, z, zf, steps=1)
    assert (s.count, s.ptr) == (5, 5)
    s = tsur.observe(s, z, zf, steps=1)
    assert (s.count, s.ptr) == (10, 10)
    g, f = _batch(7, rows=1100)
    ref = jsur.observe(jsur.init(20, 2), g, f, steps=1)
    port = tsur.observe(
        tsur.state_from_numpy(_ref_leaves(jsur.init(20, 2)), "cpu"),
        g, f, steps=1)
    assert (port.count, port.ptr) == (int(ref.count), int(ref.ptr)) == (
        tsur.CAPACITY, 1100 % tsur.CAPACITY)
    np.testing.assert_array_equal(port.x.numpy(), np.asarray(ref.x))
    np.testing.assert_array_equal(port.y.numpy(), np.asarray(ref.y))


def test_screen_is_bitwise_on_shared_predictions(monkeypatch):
    rng = np.random.default_rng(9)
    cands = (rng.random((40, 12)) < 0.5).astype(np.uint8)
    pred = np.round(rng.random((40, 2)), 2)       # ties on purpose
    monkeypatch.setattr(jsur, "predict", lambda s, c: pred.copy())
    monkeypatch.setattr(tsur, "predict", lambda s, c: pred.copy())
    exact = rng.random(40)
    for keep, cols in ((8, None), (40, None), (50, None), (8, {1: exact})):
        np.testing.assert_array_equal(
            tsur.screen(None, cands, keep, override_cols=cols),
            jsur.screen(None, cands, keep, override_cols=cols))


def test_screen_override_cols_respected():
    """With every column overridden the prediction is ignored: the
    single dominating candidate comes first; one overridden column
    equals predict-then-patch."""
    from repro_torch.core import nsga2
    rng = np.random.default_rng(9)
    cands = (rng.random((6, 12)) < 0.5).astype(np.uint8)
    s = tsur.init(12, 2, seed=0, device="cpu")
    exact = np.array([[0.5, 0.5], [0.4, 0.6], [0.1, 0.1],
                      [0.6, 0.4], [0.9, 0.2], [0.2, 0.9]])
    order = tsur.screen(s, cands, keep=3,
                        override_cols={0: exact[:, 0], 1: exact[:, 1]})
    assert len(order) == 3 and order[0] == 2
    pred = tsur.predict(s, cands)
    pred[:, 1] = exact[:, 1]
    rank = nsga2.fast_non_dominated_sort(pred)
    dist = nsga2.crowding_distance(pred, rank)
    np.testing.assert_array_equal(
        tsur.screen(s, cands, keep=3, override_cols={1: exact[:, 1]}),
        np.lexsort((-dist, rank))[:3])
