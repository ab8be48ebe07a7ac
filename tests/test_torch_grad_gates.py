"""Port parity, the gradient engine: repro_torch.core.grad_gates and
search.run_gradient_search against the JAX package, on the CPU at small
sizes (the seeds dataset, SIZES = (7, 4, 3), 2-bit ADC, 4 lanes).

What is bitwise and what is not:

* The relaxations at binary corners and the numpy steps
  (``lambda_sweep``, ``snap_to_genomes``, the chunk bounds,
  ``hard_mask``): bitwise. The float32 τ schedule: within one ulp (the
  two frameworks' float32 ``pow`` differ in the last bit for a few
  exponents).
* One gate-train chunk (10 steps) from the reference's own
  ``init_lanes`` start, injected through ``lanes_from_numpy``: every
  trained leaf within ``CHUNK_ATOL`` = 1e-4 of the reference (the
  largest difference measured is 8.0e-6, an MLP weight). It cannot be
  bitwise: the reference runs the chunk under ``jax.jit``, where XLA
  contracts ``c + a*b`` and computes ``exp``, ``pow`` and the reductions
  in its own order. The limit has teeth: the same chunk with λ = 0, or
  with a τ schedule ending at 0.3 instead of 0.25, misses it by more
  than 100x. Snapped genomes are compared where the reference's logit is
  clear of 0 by ``SNAP_MARGIN``, and the count inside it is reported.
* Inside the port, bitwise: the gradient front re-scores and re-trains
  to its fitness, the engine is deterministic, ``run_search`` routes to
  it, and a gate train killed after a chunk resumes to the same
  snapshots.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import area as jarea  # noqa: E402
from repro.core import grad_gates as jgg  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.data import tabular as jtab  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core import area as tarea  # noqa: E402
from repro_torch.core import grad_gates as tgg  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core.spec import AdcSpec  # noqa: E402
from repro_torch.faulttol import FaultTolSpec  # noqa: E402
from repro_torch.core.nonideal import NonIdealSpec  # noqa: E402

SIZES = (7, 4, 3)
KINDS = ["mlp", "svm"]
CPU = torch.device("cpu")
CHUNK_ATOL = 1e-4
SNAP_MARGIN = 1e-3


@pytest.fixture(scope="module")
def seeds():
    return jtab.make_dataset("seeds")


def tiny(**kw):
    """The reference's own tiny gradient config (tests/test_grad_gates)."""
    base = dict(bits=2, pop_size=4, generations=0, train_steps=10, seed=0,
                engine="gradient", grad_train_steps=20, grad_snapshots=2,
                grad_points=4, grad_polish_rounds=1, grad_polish_evals=32)
    base.update(kw)
    return tsearch.SearchConfig(**base), jsearch.SearchConfig(**base)


# ------------------------------------------------------------ relaxations
@pytest.mark.parametrize("bits", [2, 3, 4])
def test_relaxed_area_exact_at_binary_corners(bits):
    """At every 0/1 corner the proxy is area.pruned_binary_tc exactly,
    and equals the reference's proxy bitwise."""
    rng = np.random.default_rng(bits)
    masks = (rng.random((64, 2 ** bits)) < 0.5).astype(np.float32)
    masks[0] = 1.0
    masks[1] = 0.0
    got = tgg.relaxed_area(torch.from_numpy(masks)).numpy()
    want = [tarea.pruned_binary_tc(m.astype(np.uint8)) for m in masks]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    np.testing.assert_array_equal(
        got, np.asarray(jgg.relaxed_area(jnp.asarray(masks))))
    assert want == [jarea.pruned_binary_tc(m.astype(np.uint8))
                    for m in masks]


@pytest.mark.parametrize("bits", [2, 3])
def test_relaxed_area_monotone_and_near_reference(bits):
    """Raising any one gate never lowers the proxy; between corners the
    proxy is the reference's within float32 rounding."""
    rng = np.random.default_rng(10 + bits)
    n = 2 ** bits
    g = rng.random((16, n)).astype(np.float32)
    base = tgg.relaxed_area(torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(
        base, np.asarray(jgg.relaxed_area(jnp.asarray(g))), rtol=1e-6,
        atol=1e-5)
    for j in range(n):
        up = g.copy()
        up[:, j] = np.minimum(up[:, j] + 0.25, 1.0)
        bumped = tgg.relaxed_area(torch.from_numpy(up)).numpy()
        assert (bumped >= base - 1e-5).all()


def test_relaxed_area_norm_matches_fitness_column():
    """The normalized proxy at a binary corner equals the exact area
    column of the search fitness for that genome."""
    cfg, _ = tiny()
    rng = np.random.default_rng(2)
    g = (rng.random((8, tsearch.genome_len(7, 2))) < 0.7).astype(np.uint8)
    g[0] = 1
    masks = tsearch.decode_population(g, 7, 2, cfg.min_levels)[0]
    got = tgg.relaxed_area_norm(masks.float(), 2).numpy()
    np.testing.assert_allclose(got, tsearch.population_areas(g, 7, cfg),
                               rtol=0, atol=1e-7)


def test_soft_table_and_gates_match_reference():
    rng = np.random.default_rng(3)
    g = rng.random((5, 7, 8)).astype(np.float32)
    values = np.linspace(0.05, 0.95, 8, dtype=np.float32)
    values = np.broadcast_to(values, (7, 8)).copy()
    got = tgg.soft_value_table(torch.from_numpy(g), torch.from_numpy(values),
                               2.0).numpy()
    want = np.asarray(jgg.soft_value_table(jnp.asarray(g),
                                           jnp.asarray(values), 2.0))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    logits = rng.normal(size=(5, 7, 8)).astype(np.float32)
    logits[0, 0, :2] = 0.0                      # exactly on the threshold
    tau = np.float32(0.7)
    np.testing.assert_array_equal(
        tgg.gate_soft(torch.from_numpy(logits), torch.tensor(tau)).numpy(),
        np.asarray(jgg.gate_soft(jnp.asarray(logits), jnp.asarray(tau))))
    np.testing.assert_array_equal(
        tgg.hard_mask(torch.from_numpy(logits), 2).numpy(),
        np.asarray(jgg.hard_mask(jnp.asarray(logits), 2)))


def test_numpy_steps_are_bitwise():
    """lambda_sweep, snap_to_genomes, the chunk bounds and the grids are
    the reference's bit for bit; the τ schedule within one ulp."""
    tcfg, jcfg = tiny()
    for lanes in (1, 4, 64):
        np.testing.assert_array_equal(tgg.lambda_sweep(tcfg, lanes),
                                      jgg.lambda_sweep(jcfg, lanes))
    for steps, chunks in ((20, 2), (800, 4), (7, 3), (0, 2)):
        np.testing.assert_array_equal(tgg._chunk_bounds(steps, chunks),
                                      jgg._chunk_bounds(steps, chunks))
    assert tgg.DP_INIT_GRID == jgg.DP_INIT_GRID
    assert tgg.DENSITY_GRID == jgg.DENSITY_GRID
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(6, 7, 4)).astype(np.float32)
    logits[0, 0, 0] = 0.0
    dp = np.array([-9.2, -3.5, -0.5, 0.5, 2.5, 7.6], np.float32)
    np.testing.assert_array_equal(tgg.snap_to_genomes(logits, dp, 7, 2),
                                  jgg.snap_to_genomes(logits, dp, 7, 2))
    for total in (20, 800, 1):
        taus = tgg.tau_schedule(tcfg, total).numpy()
        denom = float(max(total - 1, 1))
        frac = jnp.arange(total).astype(jnp.float32) / denom
        want = np.asarray(jcfg.grad_tau0 * (jcfg.grad_tau1 / jcfg.grad_tau0)
                          ** frac)
        # the float32 power of XLA and of ATen differ in the last ulp
        # for a few exponents (7 of 800); every input to it is bitwise
        np.testing.assert_array_max_ulp(taus, want, maxulp=1)
        assert taus.dtype == np.float32


# -------------------------------------------------------------- one chunk
def _reference_start(jcfg, lanes=4):
    bundle, opt = jgg.init_lanes(SIZES, jcfg, lanes)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return bundle, opt, to_np(bundle), tuple(to_np(opt))


def _reference_chunk(seeds, jcfg, bundle, opt, steps, total):
    fn = jgg._chunk_fn(steps, total, SIZES, jcfg)
    values = np.broadcast_to(np.asarray(jgg.adc.level_values(
        jcfg.bits, jcfg.vmin, jcfg.vmax), np.float32), (SIZES[0],
                                                        2 ** jcfg.bits))
    xcodes = jgg.adc.encode(jnp.asarray(seeds["x_train"], jnp.float32),
                            jcfg.bits, jcfg.vmin, jcfg.vmax)
    b, _ = fn(bundle, opt, jnp.asarray(jgg.lambda_sweep(jcfg, 4)),
              jnp.asarray(0), xcodes, jnp.asarray(seeds["y_train"]),
              jnp.asarray(values))
    return [np.asarray(b["dp"]), np.asarray(b["logits"])] + [
        np.asarray(a) for a in jax.tree_util.tree_leaves(b["params"])]


def _port_chunk(seeds, tcfg, bnp, onp, steps, total, lam_scale=1.0):
    lanes = tgg.lanes_from_numpy(bnp, onp, CPU)
    onehot, target, values = tgg.train_inputs(seeds, SIZES, tcfg, CPU)
    lams = torch.from_numpy(tgg.lambda_sweep(tcfg, 4)) * lam_scale
    tgg.run_chunk(lanes, 0, steps, tgg.tau_schedule(tcfg, total), lams,
                  onehot, target, values, tcfg)
    return lanes, [t.detach().numpy() for t in lanes.leaves()]


def _worst(got, want):
    return max(float(np.abs(a - b).max()) for a, b in zip(got, want))


@pytest.mark.parametrize("kind", KINDS)
def test_one_chunk_matches_reference_within_tolerance(seeds, kind):
    """One 10-step chunk of the 20-step schedule from the reference's
    injected init_lanes: every trained leaf within CHUNK_ATOL, snapped
    genomes equal where the reference's logit is clear of 0; the λ = 0
    and wrong-τ controls miss the limit by more than 100x."""
    tcfg, jcfg = tiny(model=kind)
    bundle, opt, bnp, onp = _reference_start(jcfg)
    want = _reference_chunk(seeds, jcfg, bundle, opt, 10, 20)
    lanes, got = _port_chunk(seeds, tcfg, bnp, onp, 10, 20)
    assert [a.shape for a in got] == [b.shape for b in want]
    assert _worst(got, want) <= CHUNK_ATOL
    clear = np.abs(want[1]) > SNAP_MARGIN
    print(f"{kind}: worst leaf difference {_worst(got, want):.3e}; "
          f"{int((~clear).sum())} of {clear.size} reference logits "
          f"within {SNAP_MARGIN} of 0")
    np.testing.assert_array_equal((got[1] > 0)[clear], (want[1] > 0)[clear])
    if clear.all():
        np.testing.assert_array_equal(
            tgg.snap_to_genomes(got[1], got[0], 7, 2),
            jgg.snap_to_genomes(want[1], want[0], 7, 2))
    _, no_area = _port_chunk(seeds, tcfg, bnp, onp, 10, 20, lam_scale=0.0)
    assert _worst(no_area, want) > 100 * CHUNK_ATOL
    _, wrong_tau = _port_chunk(seeds, dataclasses.replace(tcfg, grad_tau1=0.3),
                               bnp, onp, 10, 20)
    assert _worst(wrong_tau, want) > 100 * CHUNK_ATOL


@pytest.mark.parametrize("kind", KINDS)
def test_state_tree_matches_reference_layout(kind):
    """The gate-train checkpoint tree has the reference's keys, shapes
    and dtypes, and the injected start's leaves are the reference's
    bitwise (so its chunk checkpoints cross packages)."""
    tcfg, jcfg = tiny(model=kind)
    bundle, opt, bnp, onp = _reference_start(jcfg)
    snaps = np.ones((3, 7 * 4 + 4), np.uint8)
    want = jgg._state_tree(bundle, opt, 1, snaps)
    got = tgg._state_tree(tgg.lanes_from_numpy(bnp, onp, CPU), 1, snaps)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    # the port's own init has the same layout
    mine = tgg._state_tree(tgg.init_lanes(SIZES, tcfg, 4, CPU), 0, snaps)
    assert {k: (v.shape, v.dtype) for k, v in mine.items()} == {
        k: (np.asarray(v).shape, np.asarray(v).dtype)
        for k, v in want.items()}


def test_init_lanes_strata_and_seed():
    tcfg, _ = tiny()
    a = tgg.init_lanes(SIZES, tcfg, 10, CPU)
    b = tgg.init_lanes(SIZES, tcfg, 10, CPU)
    for x, y in zip(a.leaves(), b.leaves()):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(
        a.dp.numpy(), np.array(tgg.DP_INIT_GRID * 3, np.float32)[:10])
    density = (a.logits.numpy() > 0).mean(axis=(1, 2))
    assert density[0] > density[4]            # strata 1.0 vs 0.3
    init = tsearch._init_model(SIZES, tcfg)
    for lane in (0, 9):
        np.testing.assert_array_equal(a.params[0][0][lane].numpy(),
                                      init[0][0].numpy())
    c = tgg.init_lanes(SIZES, dataclasses.replace(tcfg, seed=1), 10,
                       CPU)
    assert not torch.equal(a.logits, c.logits)


# ------------------------------------------------------------ the engine
def test_train_gate_family_shapes_and_snap(seeds):
    cfg, _ = tiny()
    snaps, diag = tgg.train_gate_family(seeds, SIZES, cfg, lanes=4,
                                        device="cpu")
    assert snaps.shape == (4 * cfg.grad_snapshots,
                           tsearch.genome_len(7, cfg.bits))
    assert snaps.dtype == np.uint8
    assert diag["lanes"] == 4 and diag["chunks"] == 2
    assert diag["steps"] == 20 and len(diag["lambda"]) == 4
    assert len(np.unique(snaps, axis=0)) > 1


@pytest.fixture(scope="module")
def grad_front(seeds):
    cfg, _ = tiny()
    msgs = []
    out = tsearch.run_gradient_search(seeds, SIZES, cfg, device="cpu",
                                      progress=msgs.append)
    return cfg, out, msgs


def test_gradient_front_rescores_bit_for_bit(seeds, grad_front):
    """Re-scoring and re-training every returned genome through the
    exact path reproduces the reported fitness exactly."""
    cfg, (pg, pf, decode), msgs = grad_front
    assert len(pg) >= 1
    np.testing.assert_array_equal(
        tsearch.evaluate_population(pg, seeds, SIZES, cfg, device="cpu"), pf)
    accs = tsearch.train_pareto_front(pg, seeds, SIZES, cfg,
                                      device="cpu")[0]
    np.testing.assert_array_equal(
        (1.0 - accs.astype(np.float32)).astype(np.float64), pf[:, 0])
    mask, dp = decode(pg[0])
    assert mask.shape == (7, 4) and float(dp) in (-3.0, -1.0, 1.0, 3.0)
    assert msgs[0].startswith("gate-train chunk 1/2")
    assert any(m.startswith("exact re-score") for m in msgs)
    assert msgs[-1].startswith("polish round 1/1")


def test_gradient_engine_deterministic(seeds, grad_front):
    cfg, (pg, pf, _), _ = grad_front
    pg2, pf2, _ = tsearch.run_gradient_search(seeds, SIZES, cfg,
                                              device="cpu")
    np.testing.assert_array_equal(pg, pg2)
    np.testing.assert_array_equal(pf, pf2)


def test_run_search_routes_gradient_engine(seeds, grad_front):
    cfg, (pg, pf, _), _ = grad_front
    pg2, pf2, _ = tsearch.run_search(seeds, SIZES, cfg, device="cpu")
    np.testing.assert_array_equal(pg, pg2)
    np.testing.assert_array_equal(pf, pf2)
    front = api.search_gradient(AdcSpec(bits=2), seeds, sizes=SIZES,
                                pop_size=4, train_steps=10, device="cpu",
                                grad_train_steps=20, grad_snapshots=2,
                                grad_points=4, grad_polish_rounds=1,
                                grad_polish_evals=32)
    assert front.config.engine == "gradient"
    assert front.config.generations == 0
    np.testing.assert_array_equal(front.genomes, pg)
    np.testing.assert_array_equal(front.fitness, pf)
    bank = api.deploy(front)
    np.testing.assert_array_equal(
        bank.accuracies(seeds["x_test"], seeds["y_test"], device="cpu"),
        (1.0 - pf[:, 0]).astype(np.float32))


def test_gradient_engine_is_no_eval_fn(seeds):
    cfg, _ = tiny()
    with pytest.raises(ValueError, match="not a per-generation"):
        tsearch.make_eval_fn(seeds, SIZES, cfg, device="cpu")


def test_polish_disabled_still_returns_front(seeds):
    cfg, _ = tiny(grad_polish_rounds=0)
    pg, pf, _ = tsearch.run_gradient_search(seeds, SIZES, cfg, device="cpu")
    assert len(pg) >= 1
    np.testing.assert_array_equal(
        tsearch.evaluate_population(pg, seeds, SIZES, cfg, device="cpu"), pf)


def test_gradient_engine_svm_and_faulttol(seeds):
    """The SVM family, and the FT branch: snapshots carry zeroed
    redundancy genes; the front re-scores bit for bit (3 objectives)."""
    cfg, _ = tiny(model="svm", grad_polish_rounds=0)
    pg, pf, _ = tsearch.run_gradient_search(seeds, SIZES, cfg, device="cpu")
    np.testing.assert_array_equal(
        tsearch.evaluate_population(pg, seeds, SIZES, cfg, device="cpu"), pf)
    ft = FaultTolSpec()
    cfg, _ = tiny(grad_polish_rounds=1, grad_polish_evals=8,
                  nonideal=NonIdealSpec(sigma_offset=0.5), mc_samples=4,
                  faulttol=ft)
    pg, pf, decode = tsearch.run_gradient_search(seeds, SIZES, cfg,
                                                 device="cpu")
    assert pf.shape[1] == 3
    assert pg.shape[1] == tsearch.genome_len(7, 2, ft)
    np.testing.assert_array_equal(
        tsearch.evaluate_population(pg, seeds, SIZES, cfg, device="cpu"), pf)
    assert len(decode(pg[0])) == 5


def test_gate_train_chunk_resume_bit_identical(seeds, tmp_path):
    """Kill after the first chunk, resume from its checkpoint: the
    snapped family is bit-identical to the uninterrupted run."""
    cfg, _ = tiny(grad_snapshots=3)
    ref, _ = tgg.train_gate_family(seeds, SIZES, cfg, lanes=4, device="cpu")

    class Killed(RuntimeError):
        pass

    ckpt = CheckpointManager(tmp_path / "gate", keep=3)
    orig_save = ckpt.save

    def save_then_die(step, tree):
        orig_save(step, tree)
        raise Killed()

    ckpt.save = save_then_die
    with pytest.raises(Killed):
        tgg.train_gate_family(seeds, SIZES, cfg, lanes=4, ckpt=ckpt,
                              device="cpu")
    ckpt.save = orig_save
    assert ckpt.latest_step() == 1
    resumed, _ = tgg.train_gate_family(seeds, SIZES, cfg, lanes=4, ckpt=ckpt,
                                       resume=True, device="cpu")
    np.testing.assert_array_equal(resumed, ref)
    assert ckpt.all_steps() == [1, 2, 3]
