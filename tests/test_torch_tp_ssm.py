"""Port parity, the ssm family over a single-process 'model' axis: the
SSD split over its heads (``models/ssm.py``'s split path,
``distributed/tensor_parallel.py``), served and trained, against the
JAX package at smoke size (mamba2-1.3b's smoke config, and hymba-1.5b's
with ``extra_dp=False``, whose rules then split both its attention and
its SSD), float32, on ``[cpu, cpu]`` and ``[cpu] x 4`` meshes.

The reference, from tests/torch_tp_reference.py in one subprocess with
4 forced host devices, its parameters placed by ``param_shardings`` so
that GSPMD really splits them: ``serving.prefill`` (2 extra cache slots)
of a 4 x 32 prompt and 2 decode steps on (1, 2) and (2, 2) meshes; its
own ``make_train_step``, 2 steps at 8 x 32 in 2 microbatches, at (1, 2)
and (2, 2) for mamba2 and (1, 2) for the hymba variant; int8 at (1, 2).
The reference's own int8 step raises at data 2 (ROADMAP C), so the
port's int8 (2, 2) step is held against its own (2, 1) step, which
tests/test_torch_dp_train.py holds against the reference's pieces.

Tolerances: logits rtol = atol = 1e-4 against the reference and 1e-5
against the port's one-device serving (tests/test_torch_tensor_parallel
.py's: the split changes only the order of float sums, here also the
gated norm's mean over d_inner, a float32 sum a rank added in rank
order). Training: tests/torch_dp_checks.py's bounds (loss and grad norm
rtol 1e-4, params atol 2e-5, moments m rtol 1e-3 atol 3e-7, v rtol 1e-3
atol 1e-12); against the port's own unsplit step, loss and grad norm
rtol 1e-5 and params atol 2e-5 (tests/test_torch_tp_train.py's).
Placement, checkpoints and resharding are bitwise. At (2, 2) the
uncompressed state is FSDP's (``distributed/fsdp.py``): each leaf's
'model' slices split again over the 'data' slices."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import lm  # noqa: E402
from repro_torch.distributed import elastic, fsdp  # noqa: E402
from repro_torch.distributed import tensor_parallel as TP  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import serving, ssm, steps, transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from torch_dp_checks import (FLOAT_TOL, assert_float_state,  # noqa: E402
                             assert_int8_state, assert_metrics, flat,
                             reference, run_port, tree)

TOL = dict(rtol=1e-4, atol=1e-4)
SELF_TOL = dict(rtol=1e-5, atol=1e-5)
SELF = dict(metrics=1e-5, params=2e-5)
EXTRA = 2
SHAPE = ShapeConfig("t", 32, 8, "train")
MB = 2
# the variant names of tests/torch_tp_reference.py
VARIANTS = {"hymba-1.5b-tp": ("hymba-1.5b", {"extra_dp": False})}
SERVE = ["mamba2-1.3b", "hymba-1.5b-tp"]
FLOAT_PARTS = ["train:mamba2-1.3b:1x2", "train:mamba2-1.3b:2x2"]
INT8_PART = "train_int8:mamba2-1.3b:1x2"
# the reference's (2, 2) step doubles conv_w_bc's gradient (ROADMAP C)
CONV_BC = "['layers']['ssm']['conv_w_bc']"
SSD_SPLIT = {"z_proj": 2, "x_proj": 2, "dt_proj": 2, "conv_w_x": 2,
             "out_proj": 1}
SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(tmp_path_factory.mktemp("tp_ssm"),
                     *[f"serve:{a}" for a in SERVE], *FLOAT_PARTS,
                     INT8_PART, script="torch_tp_reference.py")


def _config(arch):
    name, change = VARIANTS.get(arch, (arch, {}))
    return smoke_config(name).replace(**change)


def _mesh(data, model):
    return tmesh.make_host_mesh(data, model, device="cpu")


def _batch(ref, arch, key):
    return {k.rsplit("/", 1)[1]: torch.from_numpy(v) for k, v in ref.items()
            if k.startswith(f"serve:{arch}/{key}/")}


def _serve(params, cfg, ref, arch, mesh):
    """Prefill then the reference's 2 decode steps: the logits, the
    cache."""
    logits, cache = serving.prefill(params, _batch(ref, arch, "prompt"), cfg,
                                    extra_slots=EXTRA, mesh=mesh)
    out = [logits]
    for i in range(2):
        logits, cache = serving.decode_step(
            params, _batch(ref, arch, f"step{i}"), cache, cfg, mesh=mesh)
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("arch", SERVE)
def test_prefill_and_decode_match_the_reference(ref, arch):
    """(1, 2) and (2, 2) serving against the reference's GSPMD serving on
    the same meshes, and (1, 2) against the port's one-device serving on
    the same weights; each rank's SSD buffers hold its columns and heads
    of the one-device cache, ``conv_bc`` whole on the first device."""
    cfg = _config(arch)
    init = tree(ref, f"serve:{arch}/init/")
    for data in (1, 2):
        mesh = _mesh(data, 2)
        plan = serving.serving_plan(cfg, mesh)
        params = transformer.params_from_numpy(init, cfg, plan=plan)
        assert isinstance(params["layers"]["ssm"]["z_proj"], TP.Shards)
        got, _ = _serve(params, cfg, ref, arch, mesh)
        for i, name in enumerate(["prefill", "decode0", "decode1"]):
            np.testing.assert_allclose(
                got[i].numpy(), ref[f"serve:{arch}/{data}x2/{name}"],
                err_msg=f"{data}x2 {name}", **TOL)
    mesh = _mesh(1, 2)
    plan = serving.serving_plan(cfg, mesh)
    got, cache = _serve(transformer.params_from_numpy(init, cfg, plan=plan),
                        cfg, ref, arch, mesh)
    whole, wcache = _serve(transformer.params_from_numpy(init, cfg), cfg,
                           ref, arch, None)
    for a, b in zip(got, whole, strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **SELF_TOL)
    for key, dim in ssm.CACHE_SPLIT_DIMS.items():
        if dim is None:
            assert not isinstance(cache[key], TP.Shards)
            np.testing.assert_allclose(cache[key].numpy(),
                                       wcache[key].numpy(), **SELF_TOL)
            continue
        buf = cache[key]
        assert isinstance(buf, TP.Shards) and buf.dim == dim + 1
        n = buf[0].shape[buf.dim]
        for r, part in enumerate(buf):
            np.testing.assert_allclose(
                part.numpy(), wcache[key].narrow(buf.dim, r * n, n).numpy(),
                err_msg=key, **SELF_TOL)


@pytest.mark.parametrize("part", FLOAT_PARTS)
def test_train_step_matches_the_reference(ref, part):
    """The port's split step against the reference's GSPMD step on the
    same mesh. At (2, 2) the reference's own step doubles the gradient of
    ``conv_w_bc`` (replicated, a depthwise conv's weight), which its
    (1, 2), (2, 1) and (1, 4) steps do not: its AdamW moments there are
    2x and 4x its (1, 2) step's, pinned here (its parameters move the
    same, AdamW's step being scale-free but for eps), so the port's
    moments of that leaf are held to the reference's (1, 2) step, the
    same global step; every other number to the (2, 2) step's."""
    kind, arch, shape = part.split(":")
    cfg = _config(arch)
    mesh = _mesh(*(int(n) for n in shape.split("x")))
    state, metrics, _ = run_port(ref, part, cfg, mesh)
    # split over 'model'; at (2, 2) also FSDP's pieces over 'data'
    out_proj = state.params["layers"]["ssm"]["out_proj"]
    assert TP.is_split(out_proj) and isinstance(
        out_proj, TP.Shards if shape == "1x2" else fsdp.Pieces)
    assert TP.is_split(state.opt.m) and TP.is_split(state.opt.v)
    assert_metrics(ref, part, metrics)
    want = dict(ref)
    if shape == "2x2":
        one = FLOAT_PARTS[0]
        for what, factor in (("m", 2.0), ("v", 4.0)):
            np.testing.assert_allclose(
                ref[f"{part}/{what}/{CONV_BC}"],
                factor * ref[f"{one}/{what}/{CONV_BC}"],
                rtol=FLOAT_TOL[what]["rtol"],
                atol=factor * FLOAT_TOL[what]["atol"])
            want[f"{part}/{what}/{CONV_BC}"] = ref[f"{one}/{what}/{CONV_BC}"]
    assert_float_state(want, part, state)


def test_int8_step_matches_the_reference(ref):
    cfg = _config("mamba2-1.3b").replace(grad_compression="int8")
    state, metrics, _ = run_port(ref, INT8_PART, cfg, _mesh(1, 2))
    assert len(state.err) == 1 and TP.is_split(state.params)
    assert_metrics(ref, INT8_PART, metrics)
    assert_int8_state(ref, INT8_PART, state)


def _run(cfg, mesh, seed=3, n=2):
    state = steps.init_state(cfg, seed=seed, device="cpu", mesh=mesh)
    step = steps.make_train_step(cfg, mesh, SHAPE, MB, total_steps=30)
    data = lm.SyntheticLM(lm.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
        microbatches=MB), cfg)
    metrics = []
    for i in range(n):
        state, m = step(state, data.device_batch(i), i)
        metrics.append(m)
    return state, metrics


def _assert_same_run(a, b):
    (s1, m1), (s0, m0) = a, b
    for x, y in zip(m1, m0, strict=True):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(x[key]), float(y[key]),
                                       rtol=SELF["metrics"])
    got, want = flat(s1.params), flat(s0.params)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=SELF["params"], err_msg=key)


def test_the_hybrid_split_step_is_the_unsplit_step():
    """hymba-1.5b's variant, its attention heads, MLP and SSD split, at
    (1, 2) against the mesh-less step, within float32 sum order (the
    unsplit step is held to the reference by
    tests/test_torch_lm_train.py)."""
    cfg = _config("hymba-1.5b-tp")
    got = _run(cfg, _mesh(1, 2))
    for key in ("q", "wi", "ssm"):
        leaf = got[0].params["layers"][key]
        assert isinstance(leaf["z_proj"] if key == "ssm" else leaf,
                          TP.Shards)
    _assert_same_run(got, _run(cfg, None))


def test_int8_2x2_step_is_the_2x1_step():
    """The int8 (2, 2) step (two dp groups of two 'model' ranks, each
    group's gradients gathered whole for the ring) against the port's
    own (2, 1) step, within float32 sum order; the error rows one a dp
    rank on its group's first device."""
    cfg = _config("mamba2-1.3b").replace(grad_compression="int8")
    split = _run(cfg, _mesh(2, 2))
    assert isinstance(split[0].params["layers"]["ssm"]["z_proj"], TP.Shards)
    assert len(split[0].err) == 2
    _assert_same_run(split, _run(cfg, _mesh(2, 1)))


def test_the_plan_splits_the_ssd_over_its_heads():
    """The reference's rules: ``z_proj``, ``x_proj``, ``dt_proj``,
    ``conv_w_x`` by columns and ``out_proj`` by rows, every other SSD
    leaf whole, at the smoke and the published widths; mamba2's tied
    50280-row embedding splits over vocab at 2, 4 and 8 and stays whole
    at 16 (50280 = 16 x 3142.5); where the SSD's heads do not divide tp
    but d_inner does (hymba's 50 heads at 4), every SSD leaf stays
    whole."""
    for cfg in (smoke_config("mamba2-1.3b"), get_config("mamba2-1.3b")):
        plan = TP.tp_plan(cfg, _mesh(1, 2))
        got = {p[-1]: d for p, d in plan.dims.items() if "ssm" in p}
        assert got == {k: SSD_SPLIT.get(k) for k in ssm.leaf_shapes(
            cfg.d_model, cfg.ssm)}
        assert plan.dims[("embed",)] == 0 and "head" not in plan.dims
    big = get_config("mamba2-1.3b")
    for tp in (2, 4, 8, 16):
        plan = TP.tp_plan(big, _mesh(1, tp))
        assert plan.dims[("embed",)] == (0 if tp < 16 else None)
        assert plan.dims[("layers", "ssm", "out_proj")] == 1
    hymba = get_config("hymba-1.5b").replace(extra_dp=False)
    plan = TP.tp_plan(hymba, _mesh(1, 2))           # 50 heads over 2
    assert plan.split(("layers", "ssm", "dt_proj")) and plan.split(
        ("layers", "q")) is False                   # 25 q heads stay whole
    plan = TP.tp_plan(hymba, _mesh(1, 4))           # 50 heads over 4
    assert not any(plan.split(p) for p in plan.dims if "ssm" in p)
    assert plan.split(("layers", "wi"))
    assert TP.tp_plan(get_config("hymba-1.5b"), _mesh(1, 2)) is None


@pytest.mark.parametrize("arch", SERVE)
def test_placement_and_cache_are_bitwise(arch):
    """``shard_params`` / ``gather_params`` and ``init_params(plan=)``
    bitwise the whole tree; an empty split cache's buffers on the ranks'
    devices with a tp-th of the columns and heads."""
    cfg = _config(arch)
    params = transformer.init_params(cfg, seed=1, device="cpu")
    for tp in (2, 4):
        plan = TP.tp_plan(cfg, _mesh(1, tp), inference=True)
        placed = TP.shard_params(params, plan)
        for (path, a), (_, b) in zip(transformer._flat(TP.gather_params(
                placed)), transformer._flat(params), strict=True):
            assert torch.equal(a, b), path
        drawn = transformer.init_params(cfg, seed=1, plan=plan)
        for (path, a), (_, b) in zip(transformer._flat(TP.gather_params(
                drawn)), transformer._flat(params), strict=True):
            assert torch.equal(a, b), path
        cache = serving.init_cache(cfg, 2, 16, plan=plan)
        whole = serving.init_cache(cfg, 2, 16)
        for key, dim in ssm.CACHE_SPLIT_DIMS.items():
            if dim is None:
                assert cache[key].shape == whole[key].shape
                continue
            assert len(cache[key]) == tp and cache[key].dim == dim + 1
            for part in cache[key]:
                assert part.numel() * tp == whole[key].numel()
                assert part.dtype == whole[key].dtype


@pytest.mark.parametrize("groups,tp", [(2, 2), (2, 4), (4, 2)])
def test_grouped_b_and_c_reach_each_rank_s_heads(groups, tp):
    """With ngroups > 1 each rank's head h reads group h // (H / G):
    whole groups a rank (narrowed, then repeated) or a group cut by the
    ranks (one select a head). The SSD block's output, decode state,
    decode step and gradients, split, against the unsplit block."""
    base = smoke_config("mamba2-1.3b")
    cfg = base.replace(ssm=dataclasses.replace(base.ssm, ngroups=groups))
    params = transformer.init_params(cfg, seed=4)
    p = transformer.layer(params, 0)["ssm"]
    plan = TP.tp_plan(cfg, _mesh(1, tp))
    sp = transformer.layer(TP.shard_params(params, plan), 0)["ssm"]
    x = torch.randn(2, 19, cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    want, wcache = ssm.ssd_prefill(p, x, cfg.d_model, cfg.ssm)
    got, cache = ssm.ssd_prefill(sp, x, cfg.d_model, cfg.ssm)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SELF_TOL)
    np.testing.assert_allclose(torch.cat(list(cache["state"]), 1).numpy(),
                               wcache["state"].numpy(), **SELF_TOL)
    step = x[:, :1] * 0.5
    want, _ = ssm.ssd_decode(p, step, wcache, cfg.d_model, cfg.ssm)
    got, _ = ssm.ssd_decode(sp, step, cache, cfg.d_model, cfg.ssm)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SELF_TOL)
    grads = []
    for q in (p, sp):
        xg = x.clone().requires_grad_(True)
        with torch.enable_grad():
            out = ssm.ssd_forward(q, xg, cfg.d_model, cfg.ssm)
            grads.append(torch.autograd.grad((out * out).sum(), xg)[0])
    np.testing.assert_allclose(grads[1].numpy(), grads[0].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_split_gradients_match_every_leaf():
    """One microbatch's gradient of every leaf, split (its slices gathered
    whole) against unsplit: the broadcast inputs (the normed input, B and
    C, the norm's summed squares, each replicated vector) summed back in
    rank order."""
    cfg = smoke_config("mamba2-1.3b")
    params = transformer.init_params(cfg, seed=2)
    batch = tserve.make_batch(cfg, 2, 16, device="cpu")
    batch["labels"] = batch["tokens"].roll(1, 1)
    out = []
    for plan in (None, TP.tp_plan(cfg, _mesh(1, 2))):
        placed = TP.shard_params(params, plan)
        live, leaves = steps._autograd_leaves(placed)
        with torch.enable_grad():
            loss, _ = transformer.loss_fn(live, batch, cfg)
            grads = torch.autograd.grad(loss, leaves)
        sums = adamw.tree_map(torch.zeros_like, placed)
        for slot, g in zip(steps._grad_slots(sums), grads, strict=True):
            slot.copy_(g)
        out.append((float(loss.detach()), flat(sums)))
    (l0, want), (l1, got) = out
    np.testing.assert_allclose(l1, l0, rtol=SELF["metrics"])
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-6, err_msg=key)


def test_checkpoints_hold_whole_leaves_and_restore_onto_any_mesh(tmp_path):
    """A split mamba2 state saves the reference's whole leaves and
    restores onto (1, 1), (1, 2) and (2, 2) bitwise; a step from the
    restored split state is the first state's step bitwise."""
    cfg = smoke_config("mamba2-1.3b")
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
        z_proj = got.params["layers"]["ssm"]["z_proj"]
        assert TP.is_split(z_proj) == (target[1] > 1)
        assert isinstance(z_proj, fsdp.Pieces) == (target[0] > 1)
        for a, b in zip(adamw.tree_leaves(TP.gather_params(got.params))
                        + adamw.tree_leaves(TP.gather_params(got.opt.m)),
                        adamw.tree_leaves(whole)
                        + adamw.tree_leaves(TP.gather_params(state.opt.m))):
            assert torch.equal(a, b)
    step = steps.make_train_step(cfg, mesh, SHAPE, MB, total_steps=30)
    data = lm.SyntheticLM(lm.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
        microbatches=MB), cfg)
    restored = elastic.reshard_state(ckpt, 1, state, mesh, cfg)
    s1, m1 = step(state, data.device_batch(1), 1)
    s2, m2 = step(restored, data.device_batch(1), 1)
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(adamw.tree_leaves(s1.params),
                    adamw.tree_leaves(s2.params)):
        assert torch.equal(a, b)


def test_the_collectives_are_metered():
    """One mamba2 smoke forward at tp 2: the embedding's all-reduce, per
    layer the output projection's all-reduce and the gated norm's (B, S,
    1) float32 sum, and the tied head's all-gather, each at the ring's
    share (2 (tp - 1) / tp of the tensor for an all-reduce, (tp - 1) /
    tp for an all-gather)."""
    cfg = smoke_config("mamba2-1.3b")
    params = TP.shard_params(transformer.init_params(cfg, seed=0),
                             TP.tp_plan(cfg, _mesh(1, 2)))
    b, s = 2, 16
    batch = tserve.make_batch(cfg, b, s, device="cpu")
    with TP.metering() as rec:
        transformer.logits_fn(params, batch, cfg)
    act = b * s * cfg.d_model * 4                   # (B, S, d) float32
    norm = b * s * 1 * 4                            # (B, S, 1) float32
    layers = cfg.num_layers
    assert rec["all-reduce"] == (1 + layers) * act + layers * norm
    assert rec["all-gather"] == b * s * cfg.vocab_size * 4 / 2
    assert rec["calls"] == 1 + 2 * layers + 1


def test_the_launcher_trains_mamba2_tensor_parallel(capsys, tmp_path):
    """``launch.train --model-ax 2`` on the CPU (a repeated device): the
    one-device run's losses within float32 sum order (``launch.serve
    --model 2``: tests/test_torch_tensor_parallel.py)."""
    from repro_torch.launch import train as ttrain
    targv = ["--arch", "mamba2-1.3b", "--smoke", "--steps", "3", "--batch",
             "2", "--seq", "32", "--device", "cpu", "--log-every", "1"]

    def losses(extra, d):
        try:
            ttrain.main(targv + ["--ckpt-dir", str(d)] + extra)
        except AssertionError:          # the reference's "did not improve"
            pass
        text = capsys.readouterr().out
        return [float(line.split()[3]) for line in text.splitlines()
                if line.startswith("step ")], text
    one_l, _ = losses([], tmp_path / "one")
    two_l, text = losses(["--model-ax", "2"], tmp_path / "two")
    assert "'model': 2" in text and len(two_l) == len(one_l) == 3
    np.testing.assert_allclose(two_l, one_l, rtol=SELF["metrics"])


def test_no_float_atomics_in_the_ssd():
    src = (SRC / "models" / "ssm.py").read_text()
    assert not re.search(r"index_add_?|scatter_add_?|index_put_|"
                         r"index_select", src)
    assert "import torch.distributed" not in src
