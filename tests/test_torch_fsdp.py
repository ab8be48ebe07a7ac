"""FSDP over the dp axes ('pod', 'data'): ``distributed/fsdp.py``, the
uncompressed train step of ``models/steps.py`` over a mesh with dp > 1,
AdamW on pieces, ``checkpoint/manager.py``'s whole leaves,
``elastic.reshard_state`` and ``launch/train.build(data_ax=2)``, on the CPU
at smoke size. A mesh repeats the CPU (``[cpu] x n``): every slice is a
real split, all on one device.

Against the JAX package: ``sharding.dp_dims`` against the reference's
``param_specs`` for every published config on four meshes, and each
slice's bytes against the dry run's per-device bytes under the
reference's specs (``launch/dryrun.state_structs`` / ``bytes_per_device``).
The steps against the reference's own steps are
tests/test_torch_dp_train.py's (deepseek-7b and kimi-k2 at (2, 1),
musicgen-medium and hymba-1.5b at (2, 2)) and tests/test_torch_tp_ssm.py's
(mamba2-1.3b at (2, 2)).

Tolerances: bitwise for placement, gathers, repeats, remat, checkpoints,
resharding and recovery; the FSDP step against the one-device step
(each rank on its own rows, the loss and gradients the ranks' mean:
float32 sum order) within tests/torch_dp_checks.py's uncompressed
bounds (loss and grad norm rtol 1e-4, params atol 2e-5, moments m rtol
1e-3 atol 3e-7, v rtol 1e-3 atol 1e-12)."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import lm  # noqa: E402
from repro_torch.distributed import elastic, fault, fsdp  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed import tensor_parallel as TP  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import steps, transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from torch_dp_checks import FLOAT_TOL, flat  # noqa: E402

SHAPE = ShapeConfig("t", 32, 8, "train")
MB = 2
MESHES = [(2, 1), (2, 2), (4, 1), (2, 2, 1)]
SPEC_MESHES = ({"data": 2, "model": 1}, {"data": 4, "model": 2},
               {"data": 16, "model": 16},
               {"pod": 2, "data": 16, "model": 16})


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its steps are many
    small ops, which threads only slow down beside the suite's other
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(axes):
    if axes is None:
        return None
    names = ("data", "model") if len(axes) == 2 else ("pod", "data", "model")
    return tmesh.make_mesh(axes, names, devices=["cpu"] * math.prod(axes))


def _data(cfg, batch=8):
    return lm.SyntheticLM(lm.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=batch,
        microbatches=MB), cfg)


def _run(cfg, axes, n=2, seed=3, state=None):
    mesh = _mesh(axes)
    if state is None:
        state = steps.init_state(cfg, seed=seed, device="cpu", mesh=mesh)
    step = steps.make_train_step(cfg, mesh, SHAPE, MB, total_steps=30)
    data = _data(cfg)
    metrics = []
    for i in range(n):
        state, m = step(state, data.device_batch(i), i)
        metrics.append(m)
    return state, metrics


def _whole(state):
    """Every leaf of a state's parameters and moments, whole."""
    return [t for tree in (state.params, state.opt.m, state.opt.v)
            for t in adamw.tree_leaves(TP.gather_params(tree))]


def _assert_bitwise(a, b):
    for x, y in zip(_whole(a), _whole(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_dp_dims_read_the_reference_specs(arch):
    """Each parameter's dp dimension and axes are the entry of the
    reference's training spec holding 'pod' or 'data' (FSDP: ('pod',
    'data') or 'data'; extra_dp: 'data'), None where its spec has none,
    and None everywhere under int8."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    shapes = jax.eval_shape(
        lambda: jtransformer.init_params(jax.random.PRNGKey(0), jcfg))
    as_tuples = jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)
    for axes in SPEC_MESHES:
        mesh = type("M", (), {"axis_names": tuple(axes),
                              "shape": dict(axes)})()
        got = sharding.dp_dims(as_tuples, mesh, cfg)
        want = jsharding.param_specs(shapes, mesh, jcfg)
        flat_want = jax.tree_util.tree_leaves_with_path(
            want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert len(flat_want) == len(got)
        for path, spec in flat_want:
            key = tuple(k.key for k in path)
            entry = None
            for i, part in enumerate(spec):
                part = part if isinstance(part, tuple) else (part,)
                if {"pod", "data"} & set(part):
                    entry = (i, part)
                    break
            assert got[key] == entry, (axes, key)
        int8 = sharding.dp_dims(as_tuples, mesh,
                                cfg.replace(grad_compression="int8"))
        assert all(v is None for v in int8.values())


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(map(str, a)))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_each_position_holds_its_share(arch, axes):
    """``steps.init_state`` over the mesh: the first position's bytes of
    parameters, AdamW step and moments equal the dry run's per-device
    bytes under the reference's specs, no position holds more, and the
    state is placed as the plan says."""
    cfg = smoke_config(arch)
    mesh = _mesh(axes)
    state = steps.init_state(cfg, seed=1, mesh=mesh)
    plan = fsdp.plan(cfg, mesh)
    assert plan is not None
    fsdp.check_placed(state.params, plan)
    held = fsdp.held_bytes((state.params, state.opt), mesh).reshape(-1)
    want = dryrun.bytes_per_device(dryrun.state_structs(cfg, mesh)[0], mesh)
    assert held[0] == want and held.max() == held[0], (held, want)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_whole_leaves_are_the_unsharded_init(arch):
    """The pieces gathered whole are bitwise the mesh-less init's leaves,
    on a pod mesh and on a (data, model) one; the moments are zero."""
    cfg = smoke_config(arch)
    want = steps.init_state(cfg, seed=2, device="cpu")
    for axes in ((2, 2, 1), (2, 2)):
        got = steps.init_state(cfg, seed=2, mesh=_mesh(axes))
        _assert_bitwise(got, want)


def test_pieces_are_copies_and_the_gather_a_new_tensor():
    """On a repeated device a ``.to()`` is a no-op, yet each piece is a
    copy (AdamW writes it in place) and a gather a new tensor."""
    cfg = smoke_config("deepseek-7b")
    mesh = _mesh((2, 2))
    params = transformer.init_params(cfg, seed=0)
    placed = fsdp.shard_params(params, fsdp.plan(cfg, mesh))
    mine = {t.untyped_storage().data_ptr()
            for t in adamw.tree_leaves(placed)}
    theirs = {t.untyped_storage().data_ptr()
              for t in adamw.tree_leaves(params)}
    assert len(mine) == len(adamw.tree_leaves(placed)) and not mine & theirs
    q = placed["layers"]["q"]
    assert isinstance(q, fsdp.Pieces) and isinstance(q[0], TP.Shards)
    whole = fsdp.gather(fsdp.Bound(q, tuple(mesh.devices[0])))
    assert isinstance(whole, TP.Shards)
    assert all(w.untyped_storage().data_ptr() not in mine for w in whole)
    assert torch.equal(TP.gather_params(whole), params["layers"]["q"])


@pytest.mark.parametrize("split", ["pieces", "pieces of shards"])
def test_the_gather_hands_each_owner_its_piece_s_gradient(split):
    """The gather's backward: each piece's gradient is its block of the
    whole leaf's, on the piece's device."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(6, 8, generator=gen)
    c = torch.randn(6, 8, generator=gen)
    parts = [w[:, :4].clone(), w[:, 4:].clone()]
    if split == "pieces":
        pieces = fsdp.Pieces([p.requires_grad_(True) for p in parts], 1,
                             ("data",))
    else:
        pieces = fsdp.Pieces([TP.Shards([p[:3].clone().requires_grad_(True),
                                         p[3:].clone().requires_grad_(True)],
                                        0) for p in parts], 1, ("data",))
    got = fsdp.gather(fsdp.Bound(pieces, ("cpu", "cpu")))
    whole = got if split == "pieces" else torch.cat(list(got), 0)
    assert torch.equal(whole, w)
    leaves = adamw.tree_leaves(pieces)
    grads = torch.autograd.grad((whole * c).sum(), leaves)
    want = ([c[:, :4], c[:, 4:]] if split == "pieces" else
            [c[:3, :4], c[3:, :4], c[:3, 4:], c[3:, 4:]])
    for g, x in zip(grads, want, strict=True):
        assert torch.equal(g, x)


@pytest.mark.parametrize("arch,axes", [("deepseek-7b", (2, 1)),
                                       ("musicgen-medium", (2, 2)),
                                       ("gemma2-2b", (2, 2)),
                                       ("kimi-k2-1t-a32b", (2, 2, 1))])
def test_two_steps_are_bitwise_run_to_run(arch, axes):
    cfg = smoke_config(arch)
    (a, ma), (b, mb) = _run(cfg, axes), _run(cfg, axes)
    for x, y in zip(ma, mb):
        assert all(torch.equal(x[k], y[k]) for k in x)
    _assert_bitwise(a, b)
    assert isinstance(a.params["layers"]["wo" if cfg.family != "moe"
                                        else "o"], fsdp.Pieces)


@pytest.mark.parametrize("arch,axes", [("deepseek-7b", (2, 2, 1)),
                                       ("qwen2-vl-72b", (2, 2)),
                                       ("mamba2-1.3b", (4, 1)),
                                       ("hymba-1.5b", (2, 2, 1))])
def test_the_fsdp_step_is_the_one_device_step_within_bounds(arch, axes):
    """Two FSDP steps (pods: ('pod', 'data') pieces pod-major; FSDP with
    the 'model' split; four data slices; extra_dp over a pod mesh)
    against the mesh-less steps from the same init, within the
    uncompressed bounds."""
    cfg = smoke_config(arch)
    s1, m1 = _run(cfg, axes)
    s0, m0 = _run(cfg, None)
    for a, b in zip(m1, m0):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(a[key]), float(b[key]),
                                       rtol=1e-4)
    for what in ("params", "m", "v"):
        pick = (lambda s: s.params) if what == "params" else (
            lambda s, w=what: getattr(s.opt, w))
        got, want = flat(pick(s1)), flat(pick(s0))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key],
                                       err_msg=f"{what}{key}",
                                       **FLOAT_TOL[what])


def test_remat_changes_no_gradient():
    """gemma2-2b (local and global stacks, the head tied to the
    embedding) at (2, 2): each layer's pieces gathered inside its remat
    frame and again in the recomputation, the gradients bitwise those
    without remat."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got = {}
        for remat in ("full", "none"):
            cfg = smoke_config("gemma2-2b").replace(remat=remat)
            mesh = _mesh((2, 2))
            state = steps.init_state(cfg, seed=0, mesh=mesh)
            grads, loss, _ = steps.make_grad_step(cfg, mesh, SHAPE, MB)(
                state, _data(cfg).device_batch(0))
            got[remat] = [loss] + adamw.tree_leaves(grads)
    finally:
        torch.use_deterministic_algorithms(was)
    for a, b in zip(got["full"], got["none"], strict=True):
        assert torch.equal(a, b)


def test_the_step_refuses_a_state_its_plan_does_not_place():
    cfg = smoke_config("deepseek-7b")
    mesh = _mesh((2, 1))
    whole = steps.init_state(cfg, seed=0, device="cpu")
    step = steps.make_train_step(cfg, mesh, SHAPE, MB)
    with pytest.raises(ValueError, match="not placed as the mesh's plan"):
        step(whole, _data(cfg).device_batch(0), 0)
    state = steps.init_state(cfg, seed=0, mesh=mesh)
    grads, _, _ = steps.make_grad_step(cfg, mesh, SHAPE, MB)(
        state, _data(cfg).device_batch(0))
    fsdp.check_placed(grads, fsdp.plan(cfg, mesh))      # on the owners


@pytest.mark.parametrize("src", [(1, 1), (2, 1), (2, 2)],
                         ids=["1x1", "2x1", "2x2"])
def test_checkpoints_round_trip_between_meshes(tmp_path, src):
    """A stepped state saved from one mesh holds whole leaves and
    restores onto (1, 1), (2, 1) and (2, 2) bitwise in whole leaves, each
    placed as that mesh's plan places it."""
    cfg = smoke_config("kimi-k2-1t-a32b")
    state, _ = _run(cfg, src, n=1)
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(1, state)
    saved = ckpt.restore_flat(1)
    for path, leaf in transformer._flat(TP.gather_params(state.params)):
        assert np.array_equal(saved["params/" + "/".join(path)],
                              leaf.numpy())
    for dst in ((1, 1), (2, 1), (2, 2)):
        mesh = _mesh(dst)
        like = steps.init_state(cfg, seed=9, mesh=mesh)
        got = ckpt.restore(1, like)
        plan = fsdp.plan(cfg, mesh)
        if plan is not None:
            fsdp.check_placed(got.params, plan)
            fsdp.check_placed(got.opt.v, plan)
        _assert_bitwise(got, state)


@pytest.mark.parametrize("dst", [(2, 2), (2, 2, 1)], ids=["2x2", "2x2x1"])
def test_reshard_state_onto_an_fsdp_mesh(tmp_path, dst):
    """A (1, 2) tensor-parallel state resharded onto an FSDP mesh:
    bitwise in whole leaves, placed by the new mesh's plan, and a step
    from it bitwise a step from the same state placed directly."""
    cfg = smoke_config("deepseek-7b")
    state, _ = _run(cfg, (1, 2), n=1)
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(1, state)
    mesh = _mesh(dst)
    got = elastic.reshard_state(ckpt, 1, state, mesh, cfg)
    plan = fsdp.plan(cfg, mesh)
    for tree in (got.params, got.opt.m, got.opt.v):
        fsdp.check_placed(tree, plan)
    _assert_bitwise(got, state)
    assert int(got.opt.step) == 1
    whole = TP.gather_params
    direct = steps.TrainState(
        fsdp.shard_params(whole(state.params), plan), adamw.OptState(
            state.opt.step.clone(), fsdp.shard_params(whole(state.opt.m),
                                                      plan),
            fsdp.shard_params(whole(state.opt.v), plan)))
    a, ma = _run(cfg, dst, n=1, state=got)
    b, mb = _run(cfg, dst, n=1, state=direct)
    assert torch.equal(ma[0]["loss"], mb[0]["loss"])
    _assert_bitwise(a, b)


def test_a_recovered_launcher_run_is_the_uninterrupted_one(tmp_path):
    """``launch.train.build(data_ax=2)`` through ``run_with_recovery``: a
    failure at step 3 restores step 2's checkpoint (whole leaves placed
    back into the pieces) and replays to the uninterrupted run's state
    bitwise."""
    def run(directory, fail_at):
        cfg, mesh, step, data = ttrain.build(
            "deepseek-7b", smoke=True, seq=32, batch=8, microbatches=MB,
            data_ax=2, steps_total=10, device="cpu")
        assert fsdp.plan(cfg, mesh) is not None
        state = steps.init_state(cfg, seed=0, mesh=mesh)
        failed = []

        def inject(i):
            if i == fail_at and not failed:
                failed.append(i)
                return True
            return False
        state, info = fault.run_with_recovery(
            step, state, lambda i: data.device_batch(i), num_steps=5,
            ckpt=CheckpointManager(directory, keep=2), ckpt_every=2,
            inject_failure=inject)
        return state, info

    clean, _ = run(tmp_path / "clean", None)
    state, info = run(tmp_path / "failed", 3)
    assert info["failures"] == 1 and info["final_step"] == 5
    assert isinstance(state.params["layers"]["wi"], fsdp.Pieces)
    _assert_bitwise(state, clean)
