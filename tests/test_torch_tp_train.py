"""Port parity, tensor-parallel LM training (``models/steps.py`` over a
'model' axis: ``distributed/tensor_parallel.py``, AdamW on split leaves,
``checkpoint/manager.py``'s whole leaves, ``elastic.reshard_state``,
``launch/train.py --model-ax``) against the JAX package at smoke size
(deepseek-7b, gemma2-2b and kimi-k2 smoke configs, float32, batch 8 x 32
in 2 microbatches, 2 steps from the reference's ``init_state(PRNGKey(0))``
parameters), on ``[cpu, cpu]`` and ``[cpu] x 4`` meshes.

The reference, from tests/torch_tp_reference.py in one subprocess with 4
forced host devices: its own jitted ``make_train_step`` on a (1, 2) host
mesh, the state placed by ``param_shardings``, so GSPMD really splits
the weights; and int8 on a (1, 2) mesh for deepseek-7b. The port's
(2, 2) steps are held against its own (2, 1) steps, which
tests/test_torch_dp_train.py holds against the reference (the
reference's own int8 step raises at dp > 1, ROADMAP C).

Tolerances: tests/torch_dp_checks.py's, which are
tests/test_torch_lm_train.py's three-step bounds (loss and grad norm rtol
1e-4, params atol 2e-5, moments m rtol 1e-3 atol 3e-7, v rtol 1e-3 atol
1e-12), with its int8 flip allowances. Against the port's own step
without the split: loss and grad norm rtol 1e-5, params atol 2e-5 (the
split changes only the order of float sums: the partials added in rank
order, the norm's squares summed a slice at a time; measured below 3e-7
relative and 2e-6 absolute). Checkpoints and resharding are bitwise."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import lm  # noqa: E402
from repro_torch.distributed import elastic, fsdp  # noqa: E402
from repro_torch.distributed import tensor_parallel as TP  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import steps, transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from torch_dp_checks import (assert_float_state, assert_int8_state,  # noqa: E402
                             assert_metrics, bf16, flat, reference, run_port)

SHAPE = ShapeConfig("t", 32, 8, "train")
MB = 2
FLOAT_PARTS = ["train:deepseek-7b:1x2", "train:gemma2-2b:1x2",
               "train:kimi-k2-1t-a32b:1x2"]
INT8_PART = "train_int8:deepseek-7b:1x2"
SELF = dict(metrics=1e-5, params=2e-5)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(tmp_path_factory.mktemp("tp_train"), *FLOAT_PARTS,
                     INT8_PART, script="torch_tp_reference.py")


def _mesh(data, model):
    return tmesh.make_host_mesh(data, model, device="cpu")


def _cfg(part):
    kind, arch, _ = part.split(":")
    return smoke_config(arch).replace(
        grad_compression="int8" if kind == "train_int8" else "none")


def _part_mesh(part):
    return _mesh(*(int(n) for n in part.split(":")[2].split("x")))


def _data(cfg):
    return lm.SyntheticLM(lm.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
        microbatches=MB), cfg)


@pytest.mark.parametrize("part", FLOAT_PARTS)
def test_train_step_matches_the_reference(ref, part):
    cfg, mesh = _cfg(part), _part_mesh(part)
    state, metrics, _ = run_port(ref, part, cfg, mesh)
    assert TP.is_split(state.params) and TP.is_split(state.opt.m)
    assert_metrics(ref, part, metrics)
    assert_float_state(ref, part, state)


def test_int8_step_matches_the_reference(ref):
    cfg, mesh = _cfg(INT8_PART), _part_mesh(INT8_PART)
    state, metrics, _ = run_port(ref, INT8_PART, cfg, mesh)
    assert len(state.err) == 1 and TP.is_split(state.params)
    assert_metrics(ref, INT8_PART, metrics)
    assert_int8_state(ref, INT8_PART, state)


def _run(cfg, mesh, seed=3, n=2):
    state = steps.init_state(cfg, seed=seed, device="cpu", mesh=mesh)
    step = steps.make_train_step(cfg, mesh, SHAPE, MB, total_steps=30)
    data = _data(cfg)
    metrics = []
    for i in range(n):
        state, m = step(state, data.device_batch(i), i)
        metrics.append(m)
    return state, metrics


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("comp", ["none", "int8"])
def test_the_split_step_is_the_unsplit_step(arch, comp):
    """(1, 2) against the mesh-less step (int8: the (1, 1) mesh) and
    (2, 2) against (2, 1), within the float32 bounds of the module
    docstring; the same random state either way (init_params draws
    whole, then places). qwen2-vl's one kv head stays whole and each
    rank reads it; llama4-scout's moe routes each dp shard apart at
    (2, 2) as at (2, 1), its experts split."""
    cfg = smoke_config(arch).replace(grad_compression=comp)
    pairs = [((1, 2), None if comp == "none" else (1, 1)), ((2, 2), (2, 1))]
    for split, whole in pairs:
        s1, m1 = _run(cfg, _mesh(*split))
        s0, m0 = _run(cfg, None if whole is None else _mesh(*whole))
        for a, b in zip(m1, m0):
            for key in ("loss", "grad_norm"):
                np.testing.assert_allclose(float(a[key]), float(b[key]),
                                           rtol=SELF["metrics"])
        got, want = flat(s1.params), flat(s0.params)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=SELF["params"], err_msg=key)


@pytest.mark.parametrize("comp", ["none", "int8"])
def test_each_rank_holds_its_slices(comp):
    """Each split leaf of the parameters and of both moments is one slice
    a rank, on the rank's device, with 1/tp of the leaf's elements; the
    replicated leaves and the step counter sit on the first device.
    Uncompressed, the (2, 2) state is FSDP's (``distributed/fsdp.py``):
    each leaf the rules put over 'data' is ``Pieces`` of the two data
    slices, piece k of a split leaf ``Shards`` on slice k's group, each
    part 1/(2 tp) of the leaf."""
    cfg = smoke_config("gemma2-2b").replace(grad_compression=comp)
    mesh = _mesh(2, 2)
    plan = TP.tp_plan(cfg, mesh)
    over_dp = fsdp.plan(cfg, mesh)
    assert (over_dp is None) == (comp == "int8")
    groups = TP.tp_groups(mesh)
    state, _ = _run(cfg, mesh, n=1)
    shapes = dict(transformer._flat(transformer.param_shapes(cfg)))
    for tree in (state.params, state.opt.m, state.opt.v):
        for path, leaf in transformer._flat(tree):
            size = int(np.prod(shapes[path]))
            pieces = over_dp is not None and over_dp.split(path)
            assert isinstance(leaf, fsdp.Pieces) == pieces
            for k, part in enumerate(leaf if pieces else [leaf]):
                n = size // (2 if pieces else 1)
                if plan.split(path):
                    assert isinstance(part, TP.Shards) and len(part) == 2
                    assert part.devices == (list(groups[k]) if pieces
                                            else list(plan.devices))
                    for p in part:
                        assert p.numel() * 2 == n
                else:
                    assert part.device == groups[k][0] and part.numel() == n
    if comp == "int8":
        assert [r.device for r in state.err] == [g[0] for g in
                                                 TP.tp_groups(mesh)]


def test_checkpoints_hold_whole_leaves_and_restore_onto_any_mesh(tmp_path):
    """A split state saves the reference's whole leaves; it restores
    onto (1, 1), (1, 2) and (2, 2) meshes bitwise, and a step from a
    restored split state is the first state's step bitwise."""
    cfg = smoke_config("kimi-k2-1t-a32b")
    mesh = _mesh(1, 2)
    state, _ = _run(cfg, mesh, n=1)
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(1, state)
    saved = ckpt.restore_flat(1)
    whole = TP.gather_params(state.params)
    for path, leaf in transformer._flat(whole):
        assert np.array_equal(saved["params/" + "/".join(path)],
                              leaf.numpy())
    for target in ((1, 1), (1, 2), (2, 2)):
        got = elastic.reshard_state(ckpt, 1, state, _mesh(*target), cfg)
        assert TP.is_split(got.params) == (target[1] > 1)
        for a, b in zip(adamw.tree_leaves(TP.gather_params(got.params))
                        + adamw.tree_leaves(TP.gather_params(got.opt.v)),
                        adamw.tree_leaves(whole)
                        + adamw.tree_leaves(TP.gather_params(state.opt.v))):
            assert torch.equal(a, b)
    step = steps.make_train_step(cfg, mesh, SHAPE, MB, total_steps=30)
    batch = _data(cfg).device_batch(1)
    restored = elastic.reshard_state(ckpt, 1, state, mesh, cfg)
    s1, m1 = step(state, batch, 1)
    s2, m2 = step(restored, batch, 1)
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(adamw.tree_leaves(s1.params),
                    adamw.tree_leaves(s2.params)):
        assert torch.equal(a, b)


def test_err_from_numpy_places_rows_on_the_dp_ranks():
    cfg = smoke_config("deepseek-7b")
    n = sum(int(np.prod(s)) for _, s in transformer._flat(
        transformer.param_shapes(cfg)))
    err = np.arange(2 * n, dtype=np.uint16).reshape(2, n)
    mesh = _mesh(2, 2)
    rows = transformer.err_from_numpy(err.view("V2"), cfg, mesh=mesh)
    assert [r.device for r in rows] == [g[0] for g in TP.tp_groups(mesh)]
    assert torch.equal(torch.stack(rows).view(torch.int16), bf16(err).view(
        torch.int16))


def test_the_launcher_trains_tensor_parallel(capsys):
    """``launch.train --model-ax 2`` on the CPU: the (1, 2) run's losses
    within float32 sum order of the unsplit run's."""
    argv = ["--arch", "gemma2-2b", "--smoke", "--steps", "3", "--batch", "2",
            "--seq", "32", "--device", "cpu", "--log-every", "1"]

    def losses(extra, d):
        try:
            out = ttrain.main(argv + ["--ckpt-dir", str(d)] + extra)
        except AssertionError:          # the reference's "did not improve"
            out = None
        text = capsys.readouterr().out
        return out, [float(line.split()[3]) for line in text.splitlines()
                     if line.startswith("step ")], text

    import tempfile
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        _, one, _ = losses([], d1)
        _, two, text = losses(["--model-ax", "2"], d2)
    assert "'model': 2" in text and len(two) == len(one) == 3
    np.testing.assert_allclose(two, one, rtol=SELF["metrics"])


def test_moe_rows_must_divide_the_dp_shards():
    cfg = smoke_config("kimi-k2-1t-a32b")
    with pytest.raises(ValueError, match="3 rows does not split over the 2 "
                                         "dp shards"):
        steps.make_train_step(cfg, _mesh(2, 2), ShapeConfig("t", 32, 6,
                                                            "train"), MB)


def test_a_split_over_distinct_devices_recomputes_a_layer_at_its_output():
    """``remat_fn``: over slices on one device (``[cpu, cpu]``) a layer is
    rematerialised as it is; over distinct devices (stand-in slices on
    cpu and meta, read only for their devices) its outputs pass through
    the identity that makes the layer's first backward unpack, so the
    checkpoint recomputes it on the output's device. Gradients are
    bitwise the same either way, tuples of outputs included."""
    from torch.utils.checkpoint import checkpoint
    one = TP.Shards([torch.zeros(2), torch.zeros(2)], 0, (0, 1), 2)
    two = TP.Shards([torch.zeros(2), torch.zeros(2, device="meta")], 0,
                    (0, 1), 2)

    def layer(x, w):
        h = torch.tanh(x @ w)
        return h * x.sum(), (h ** 2).mean()

    assert TP.remat_fn(layer, {"embed": one}) is layer
    assert TP.remat_fn(layer, {"w": torch.zeros(2)}) is layer
    gated = TP.remat_fn(layer, {"layers": {"q": [two]}})
    assert gated is not layer
    gen = torch.Generator().manual_seed(0)
    x0 = torch.randn(4, 3, generator=gen)
    w0 = torch.randn(3, 3, generator=gen)
    grads = []
    for fn in (layer, gated):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        y, a = checkpoint(fn, x, w, use_reentrant=False)
        grads.append(torch.autograd.grad(y.sum() + a, (x, w)))
    for g, h in zip(*grads, strict=True):
        assert torch.equal(g, h)
