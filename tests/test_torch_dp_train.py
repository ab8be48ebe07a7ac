"""Port parity, data-parallel LM training (``models/steps.py`` over a
single-process mesh, ``launch/train.build(data_ax=2)``,
``distributed/elastic.reshard_state``, the int8 error rows in
``checkpoint/manager.py``) against the JAX package at smoke size
(deepseek-7b and musicgen-medium smoke configs, float32, batch 8 x 32 in
2 microbatches, 3 steps from the reference's ``init_state(PRNGKey(0))``
parameters).

The references, from tests/torch_dp_reference.py in one subprocess with
forced host devices:

* int8 at dp = 1: the reference's own ``make_train_step`` on a (1, 1)
  mesh;
* int8 at dp = 2: the reference's ``shard_map`` body composed of its
  pieces, because the reference's own step raises on any mesh whose
  'data' axis exceeds 1 (``transformer.constrain_batch`` inside the
  manual ``shard_map``; pinned by
  tests/test_torch_compression.py::test_the_reference_int8_step_raises_at_dp_2);
* uncompressed at dp = 2, and musicgen and hymba at data 2 x model 2
  (extra_dp, four ranks): the reference's own GSPMD step; kimi-k2
  uncompressed at dp = 2, whose moe layers route each dp shard apart (the
  reference's ``shard_map`` over ('pod', 'data')), the same, plus its
  ``loss_fn`` on one microbatch at dp 2 and dp 1.

Tolerances: tests/torch_dp_checks.py (the float bounds of
tests/test_torch_lm_train.py; for int8, the share and size of the
rounding decisions that float32 summation order flips). Port-only checks
(one rank == the one-device step, recovery,
resharding, checkpoints) are bitwise, but the uncompressed mesh step
against the one-device step: over dp > 1 it is FSDP's, each batch rank
on its own rows (tests/test_torch_fsdp.py), within the uncompressed
bounds."""
import pytest

torch = pytest.importorskip("torch")

from types import SimpleNamespace  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JCkpt  # noqa: E402
from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import lm  # noqa: E402
from repro_torch.distributed import elastic, fault, fsdp, sharding  # noqa: E402
from repro_torch.distributed import tensor_parallel as TP  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import steps, transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from torch_dp_checks import (assert_float_state, assert_int8_state,  # noqa: E402
                             assert_metrics, bf16, flat, port_state,
                             run_port, tree)

DS = smoke_config("deepseek-7b")
INT8 = DS.replace(grad_compression="int8")
SHAPE = ShapeConfig("t", 32, 8, "train")
MB = 2


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return __import__("torch_dp_checks").reference(
        tmp_path_factory.mktemp("dp"), "int8_dp1", "int8_dp2", "none_dp2",
        "musicgen_extra_dp", "hymba_extra_dp", "moe_none_dp2")


def _two():
    return tmesh.make_host_mesh(2, 1, device="cpu")


def _data(cfg, batch=8):
    return lm.SyntheticLM(lm.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=batch,
        microbatches=MB), cfg)


def test_int8_step_at_dp_1_matches_make_train_step(ref):
    state, metrics, _ = run_port(ref, "int8_dp1", INT8, None)
    assert_metrics(ref, "int8_dp1", metrics)
    assert_int8_state(ref, "int8_dp1", state)


def test_int8_step_at_dp_2_matches_the_composed_body(ref):
    state, metrics, grads = run_port(ref, "int8_dp2", INT8, _two())
    assert len(state.err) == 2
    assert_metrics(ref, "int8_dp2", metrics)
    assert_int8_state(ref, "int8_dp2", state, grads)


def test_uncompressed_step_at_dp_2_matches_the_reference(ref):
    state, metrics, _ = run_port(ref, "none_dp2", DS, _two())
    assert_metrics(ref, "none_dp2", metrics)
    assert_float_state(ref, "none_dp2", state)
    # launch.train.build takes data_ax = 2 and builds the same step
    cfg, mesh, train_step, data = ttrain.build(
        "deepseek-7b", smoke=True, seq=32, batch=8, microbatches=MB,
        data_ax=2, steps_total=30, device="cpu")
    assert mesh.shape == {"data": 2, "model": 1}
    built = port_state(ref, "none_dp2", cfg, mesh)
    _, m = train_step(built, data.device_batch(0), 0)
    assert float(m["loss"]) == float(metrics[0]["loss"])


def test_uncompressed_moe_step_at_dp_2_matches_the_reference(ref):
    """kimi-k2 uncompressed on a (2, 1) mesh: the reference's own (2, 1)
    step, whose two dp shards route apart (their own capacity, the aux
    loss their mean), within the uncompressed bounds; and one
    microbatch's ce and aux within tests/test_torch_moe.py's moe bound
    (1e-5) of the reference's (2, 1) values, where its (1, 1) aux lies
    outside that bound."""
    cfg = smoke_config("kimi-k2-1t-a32b")
    state, metrics, _ = run_port(ref, "moe_none_dp2", cfg, _two(),
                                 n_steps=2)
    assert_metrics(ref, "moe_none_dp2", metrics)
    assert_float_state(ref, "moe_none_dp2", state)
    params = transformer.params_from_numpy(tree(ref, "moe_none_dp2/init/"),
                                           cfg)
    mb = {k: v[0] for k, v in _data(cfg).device_batch(0).items()}
    _, m = transformer.loss_fn(params, mb, cfg, dp=2)
    tol = dict(rtol=1e-5, atol=1e-5)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(m[key]), float(
            ref[f"moe_none_dp2/loss_fn2x1/{key}"]), err_msg=key, **tol)
    one, two = (float(ref[f"moe_none_dp2/loss_fn{s}/aux"])
                for s in ("1x1", "2x1"))
    assert abs(one - two) > tol["atol"] + tol["rtol"] * abs(two)


def test_extra_dp_musicgen_at_data_2_model_2_matches_the_reference(ref):
    cfg = smoke_config("musicgen-medium")
    mesh = tmesh.make_host_mesh(2, 2, device="cpu")
    assert cfg.extra_dp and sharding.batch_axes(mesh, cfg, 4) == (
        "data", "model")
    state, metrics, _ = run_port(ref, "musicgen_extra_dp", cfg, mesh)
    assert_metrics(ref, "musicgen_extra_dp", metrics)
    assert_float_state(ref, "musicgen_extra_dp", state)


def test_extra_dp_hymba_at_data_2_model_2_matches_the_reference(ref):
    """hymba-1.5b (the hybrid family, extra_dp: 25 heads and 50 SSD heads
    do not split over 'model') at (2, 2): FSDP pieces over 'data', four
    (data, model) batch ranks, against the reference's own step."""
    cfg = smoke_config("hymba-1.5b")
    mesh = tmesh.make_host_mesh(2, 2, device="cpu")
    assert cfg.extra_dp and sharding.batch_axes(mesh, cfg, 4) == (
        "data", "model")
    state, metrics, _ = run_port(ref, "hymba_extra_dp", cfg, mesh)
    assert isinstance(state.params["layers"]["ssm"]["z_proj"], fsdp.Pieces)
    assert_metrics(ref, "hymba_extra_dp", metrics)
    assert_float_state(ref, "hymba_extra_dp", state)


@pytest.mark.parametrize("arch,axes", [("deepseek-7b", (2, 1)),
                                       ("musicgen-medium", (2, 2)),
                                       ("kimi-k2-1t-a32b", (2, 1))])
def test_uncompressed_dp_step_is_the_one_device_step_within_bounds(arch,
                                                                   axes):
    """Uncompressed, the reference's step is one global (GSPMD) step over
    the whole microbatch; the port's is FSDP's (``distributed/fsdp.py``):
    each batch rank (the data slices; under extra_dp, musicgen, the four
    (data, model) ranks) runs its rows on the state gathered from the
    owners' pieces, the gradients summed onto the owners and the loss the
    ranks' mean. So it is the one-device step up to float32 sum order,
    within the uncompressed bounds of tests/torch_dp_checks.py (loss rtol
    1e-4; the gradients, as the int8 checks hold float gradients, rtol
    1e-4 atol 1e-6). For moe the reference's ``shard_map`` routes each
    dp shard's rows apart, so the one-device reference is the loop with
    the dp shards passed to ``loss_fn`` (``moe_ffn``'s ``dp``), and not
    the mesh-less step (whose capacity and aux loss read the whole
    microbatch)."""
    cfg = smoke_config(arch)
    mesh = tmesh.make_host_mesh(*axes, device="cpu")
    assert sharding.batch_axes(mesh, cfg, 4) is not None
    whole = steps.init_state(cfg, seed=1, device="cpu")
    state = steps.init_state(cfg, seed=1, device="cpu", mesh=mesh)
    batch = _data(cfg).device_batch(0)
    got, loss, err = steps.make_grad_step(cfg, mesh, SHAPE, MB)(state,
                                                                batch)
    if cfg.family == "moe":
        alone, aloss, _ = steps.make_grad_step(cfg, None, SHAPE, MB)(
            whole, batch)
        assert abs(float(loss) - float(aloss)) > 1e-4 * abs(float(aloss))
        want, wloss = steps._local_grads(
            whole.params, {k: v for k, v in batch.items()}, {}, cfg, MB,
            dp=axes[0])
    else:
        want, wloss, _ = steps.make_grad_step(cfg, None, SHAPE, MB)(whole,
                                                                    batch)
    assert err is None
    np.testing.assert_allclose(float(loss), float(wloss), rtol=1e-4)
    got, want = flat(got), flat(want)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("cfg", [DS, INT8], ids=["none", "int8"])
def test_one_rank_is_the_one_device_step_bitwise(cfg):
    """A (1, 1) mesh, and an uncompressed (2, 1) mesh whose rule does not
    divide the microbatch (1 row: one rank, the state FSDP's pieces
    gathered whole a layer at a time), step as the mesh-less step."""
    shape = ShapeConfig("t", 32, 2, "train")
    data = _data(cfg, batch=2)
    meshes = [tmesh.make_host_mesh(1, 1, device="cpu")]
    if cfg.grad_compression == "none":
        meshes.append(_two())
    base = steps.make_train_step(cfg, None, shape, MB)
    s0 = steps.init_state(cfg, seed=2, device="cpu")
    s0, m0 = base(s0, data.device_batch(0), 0)
    for mesh in meshes:
        s = steps.init_state(cfg, seed=2, device="cpu", mesh=mesh)
        s, m = steps.make_train_step(cfg, mesh, shape, MB)(
            s, data.device_batch(0), 0)
        assert torch.equal(m["loss"], m0["loss"])
        for a, b in zip(adamw.tree_leaves(TP.gather_params(s.params)),
                        adamw.tree_leaves(s0.params), strict=True):
            assert torch.equal(a, b)
        for a, b in zip(s.err or [], s0.err or []):
            assert torch.equal(a, b)


def test_int8_recovery_replays_bitwise_with_its_error_rows(tmp_path):
    """run_with_recovery on [cpu, cpu] with int8: a failure at step 5
    restores step 4's checkpoint, error rows included, and replays to the
    uninterrupted run's state bitwise."""
    def run(directory, fail_at):
        mesh = _two()
        step = steps.make_train_step(INT8, mesh, SHAPE, MB, total_steps=10)
        data = _data(INT8)
        state = steps.init_state(INT8, seed=0, mesh=mesh)
        failed = []

        def inject(i):
            if i == fail_at and not failed:
                failed.append(i)
                return True
            return False
        ckpt = CheckpointManager(directory, keep=2)
        state, info = fault.run_with_recovery(
            step, state, lambda i: data.device_batch(i), num_steps=7,
            ckpt=ckpt, ckpt_every=2, inject_failure=inject)
        return state, info, ckpt

    clean, _, _ = run(tmp_path / "clean", None)
    state, info, ckpt = run(tmp_path / "failed", 5)
    assert info["failures"] == 1 and info["final_step"] == 7
    assert ckpt.leaves(7)["err"] == {"shape": [2, len(state.err[0])],
                                     "dtype": "|V2"}
    for a, b in zip(adamw.tree_leaves(state.params) + state.err,
                    adamw.tree_leaves(clean.params) + clean.err):
        assert torch.equal(a, b)


def _stepped(cfg, mesh):
    state = steps.init_state(cfg, seed=4, device="cpu", mesh=mesh)
    step = steps.make_train_step(cfg, mesh, SHAPE, MB)
    return step(state, _data(cfg).device_batch(0), 0)[0]


@pytest.mark.parametrize("move", ["dp 2 to dp 1", "dp 1 to dp 2"])
def test_reshard_state_between_dp_sizes(tmp_path, move):
    """Uncompressed states restore onto the other dp size bitwise in
    whole leaves (at dp 2 each data slice holds its FSDP pieces, at dp 1
    the leaves are whole on the first device). int8
    states restore onto their own dp size, rows on their devices; a
    change of dp size is refused (each row is one rank's unsent
    residual, ROADMAP C)."""
    one = tmesh.make_host_mesh(1, 1, device="cpu")
    src, dst = (_two(), one) if move == "dp 2 to dp 1" else (one, _two())
    for cfg in (DS, INT8):
        state = _stepped(cfg, src)
        ckpt = CheckpointManager(tmp_path / cfg.grad_compression)
        ckpt.save(1, state)
        if cfg.grad_compression == "int8":
            with pytest.raises(NotImplementedError, match="ROADMAP C"):
                elastic.reshard_state(ckpt, 1, state, dst, cfg)
            got = elastic.reshard_state(ckpt, 1, state, src, cfg)
            assert len(got.err) == len(state.err)
            for a, b in zip(got.err, state.err):
                assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        else:
            got = elastic.reshard_state(ckpt, 1, state, dst, cfg)
            assert got.err is None
        assert int(got.opt.step) == 1
        whole = TP.gather_params
        for a, b in zip(adamw.tree_leaves(whole(got.params))
                        + adamw.tree_leaves(whole(got.opt.m)),
                        adamw.tree_leaves(whole(state.params))
                        + adamw.tree_leaves(whole(state.opt.m)),
                        strict=True):
            assert torch.equal(a, b)


def test_int8_checkpoints_cross_between_the_packages(ref, tmp_path):
    """The reference's int8 TrainState, saved by its CheckpointManager
    (err as raw bf16 bytes), restores in the port, rows bitwise; the
    port's save holds the same bytes under the same names."""
    params = tree(ref, "int8_dp2/init/")
    err = ref["int8_dp2/err"]
    rows = transformer.err_from_numpy(err.view("V2"), INT8, ["cpu", "cpu"])
    assert [r.dtype for r in rows] == [torch.bfloat16] * 2
    np.testing.assert_array_equal(
        torch.stack(rows).view(torch.int16).numpy().view(np.uint16), err)
    with pytest.raises(ValueError, match="3 devices for 2 rows"):
        transformer.err_from_numpy(err.view("V2"), INT8, ["cpu"] * 3)
    with pytest.raises(ValueError, match=r"\(dp, \d+\) bfloat16"):
        transformer.err_from_numpy(err[:, :5].view("V2"), INT8)
    jparams = {k: (jnp.asarray(v) if not isinstance(v, dict) else
                   {kk: jnp.asarray(vv) for kk, vv in v.items()})
               for k, v in params.items()}
    jstate = jsteps.TrainState(jparams, jadamw.init(jparams),
                               jnp.asarray(bf16(err).float().numpy(),
                                           jnp.bfloat16))
    JCkpt(str(tmp_path / "j")).save(3, jstate, blocking=True)
    like = port_state(ref, "int8_dp2", INT8, _two())
    got = CheckpointManager(tmp_path / "j").restore(3, like)
    for a, b in zip(got.err, rows):
        assert torch.equal(a, b)
    for a, b in zip(adamw.tree_leaves(got.params),
                    adamw.tree_leaves(like.params)):
        assert torch.equal(a, b)
    CheckpointManager(tmp_path / "t").save(3, got)
    mine = CheckpointManager(tmp_path / "t").restore_flat(3)
    theirs = CheckpointManager(tmp_path / "j").restore_flat(3)
    assert set(mine) == set(theirs) and "err" in mine
    assert mine["err"].tobytes() == theirs["err"].tobytes()


def test_what_the_dp_step_refuses():
    cuda = torch.device("cuda", 0)
    mixed = SimpleNamespace(
        axis_names=("data", "model"), shape={"data": 2, "model": 1},
        size=2, devices=np.array([[torch.device("cpu")], [cuda]],
                                 dtype=object))
    with pytest.raises(NotImplementedError, match="mixing.*A11.9"):
        steps.make_train_step(DS, mixed, SHAPE, MB)
    with pytest.raises(ValueError, match="3 rows does not split"):
        steps.make_train_step(INT8, _two(), ShapeConfig("t", 32, 6, "train"),
                              MB)
    state = steps.init_state(INT8, device="cpu")             # one row
    step = steps.make_train_step(INT8, _two(), SHAPE, MB)
    with pytest.raises(ValueError, match="needs 2 error rows"):
        step(state, _data(INT8).device_batch(0), 0)
    assert flat(state.params)        # the state is untouched


SPEC_MESHES = ({"data": 2, "model": 1}, {"data": 4, "model": 2},
               {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_the_reference(arch):
    """The parameter rules (FSDP, TP-only under int8, extra_dp; training
    and inference) give the reference's spec for every leaf of every
    published config on a few meshes, and the batch rules its axes."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    shapes = jax.eval_shape(
        lambda: jtransformer.init_params(jax.random.PRNGKey(0), jcfg))
    as_tuples = jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)
    for axes in SPEC_MESHES:
        mesh = SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))
        for comp in ("none", "int8"):
            jc, c = (jcfg.replace(grad_compression=comp),
                     cfg.replace(grad_compression=comp))
            for inference in (False, True):
                want = jsharding.param_specs(shapes, mesh, jc, inference)
                got = sharding.param_specs(as_tuples, mesh, c, inference)
                wflat = jax.tree_util.tree_leaves_with_path(
                    want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
                for path, spec in wflat:
                    node = got
                    for k in path:
                        node = node[k.key]
                    assert node == tuple(spec), (axes, comp, path)
            for b in (1, 8, 64, 512):
                assert sharding.batch_axes(mesh, c, b) == \
                    jsharding.batch_axes(mesh, jc, b)
        assert sharding.batch_spec(mesh, 2) == tuple(
            jsharding.batch_spec(mesh, 2))
