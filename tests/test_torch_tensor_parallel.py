"""Port parity, tensor-parallel LM serving over a single-process 'model'
axis (``distributed/tensor_parallel.py``, ``models/serving.py``'s
``mesh``, ``launch/serve.py --model``) against the JAX package at smoke
size (deepseek-7b, gemma2-2b, qwen2-vl-72b's text prompt, kimi-k2 and
llama4-scout smoke configs, float32), on ``[cpu, cpu]`` meshes.

The reference, from tests/torch_tp_reference.py in one subprocess with
4 forced host devices: ``serving.prefill`` (2 extra slots) of a 4 x 32
prompt and 2 decode steps, jitted, on (1, 2) and (2, 2) host meshes with
the parameters placed by ``param_shardings`` (inference specs), so GSPMD
really splits them. The port serves on the same meshes: on (2, 2) its
first 'data' slice's two 'model' ranks serve the whole batch, and moe's
prefill routes each dp shard's rows apart, as the reference's
``shard_map`` does (llama4-scout's smoke capacity binds there, so its
(2, 2) logits are not its (1, 2) ones, in both packages).

Tolerances: logits rtol = atol = 1e-4, as tests/test_torch_lm.py and
tests/test_torch_moe.py (float32; products and sums round in each
package's order). Against the port's own one-device serving, rtol = atol
= 1e-5: the split changes only the order of the float sums (the
projections over fewer heads, the output projection's and the MLP's
partials added in rank order; measured below 3e-6). Placement
(``shard_params`` / ``gather_params``), the moe routing and the embedding
lookup are bitwise."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import tensor_parallel as TP  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import moe, serving, steps, transformer  # noqa: E402
from torch_dp_checks import reference, tree  # noqa: E402

ARCHS = ["deepseek-7b", "gemma2-2b", "qwen2-vl-72b", "kimi-k2-1t-a32b",
         "llama4-scout-17b-a16e"]
TOL = dict(rtol=1e-4, atol=1e-4)
SELF_TOL = dict(rtol=1e-5, atol=1e-5)
EXTRA = 2
SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference(tmp_path_factory.mktemp("tp"),
                     *[f"serve:{a}" for a in ARCHS],
                     script="torch_tp_reference.py")


def _mesh(data, model):
    return tmesh.make_host_mesh(data, model, device="cpu")


def _batch(ref, arch, key):
    return {k.rsplit("/", 1)[1]: torch.from_numpy(v) for k, v in ref.items()
            if k.startswith(f"serve:{arch}/{key}/")}


def _serve(params, cfg, ref, arch, mesh):
    """Prefill then the reference's 2 decode steps: the logits."""
    logits, cache = serving.prefill(params, _batch(ref, arch, "prompt"), cfg,
                                    extra_slots=EXTRA, mesh=mesh)
    out = [logits]
    for i in range(2):
        logits, cache = serving.decode_step(
            params, _batch(ref, arch, f"step{i}"), cache, cfg, mesh=mesh)
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_the_reference(ref, arch):
    """The port's (1, 2) and (2, 2) serving against the reference's GSPMD
    serving on the same meshes, and (1, 2) against the port's one-device
    serving on the same weights; the weights carried over as shards
    (``params_from_numpy(plan=)``)."""
    cfg = smoke_config(arch)
    init = tree(ref, f"serve:{arch}/init/")
    for data in (1, 2):
        mesh = _mesh(data, 2)
        plan = serving.serving_plan(cfg, mesh)
        params = transformer.params_from_numpy(init, cfg, plan=plan)
        assert TP.is_split(params) and \
            params["layers"]["q"][0].shape[2] == cfg.num_heads // 2
        got, cache = _serve(params, cfg, ref, arch, mesh)
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
    # each rank's cache holds the kv heads its q heads read
    for key in ("k", "v", "k2", "v2", "k_pre", "v_pre"):
        if key not in cache:
            continue
        assert isinstance(cache[key], TP.Shards)
        for r, part in enumerate(cache[key]):
            heads = plan.kv_heads(r)
            np.testing.assert_allclose(
                part.numpy(), wcache[key][:, :, :, heads].numpy(),
                err_msg=key, **SELF_TOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tp", [2, 4])
def test_shards_hold_a_tp_th_of_each_split_leaf_and_gather_bitwise(arch, tp):
    cfg = smoke_config(arch)
    params = transformer.init_params(cfg, seed=1, device="cpu")
    mesh = _mesh(1, tp)
    for inference in (False, True):
        plan = TP.tp_plan(cfg, mesh, inference=inference)
        placed = TP.shard_params(params, plan)
        n_split = 0
        for (path, leaf), (_, whole) in zip(transformer._flat(placed),
                                            transformer._flat(params)):
            if plan.split(path):
                n_split += 1
                assert isinstance(leaf, TP.Shards) and len(leaf) == tp
                assert leaf.devices == list(plan.devices)
                for part in leaf:
                    assert part.numel() * tp == whole.numel()
                    assert part.data_ptr() != whole.data_ptr()
            else:
                assert isinstance(leaf, torch.Tensor)
        assert n_split >= 5
        back = TP.gather_params(placed)
        for (_, a), (_, b) in zip(transformer._flat(back),
                                  transformer._flat(params), strict=True):
            assert torch.equal(a, b)
        # drawn already placed: the same values
        drawn = transformer.init_params(cfg, seed=1, plan=plan)
        for (_, a), (_, b) in zip(transformer._flat(TP.gather_params(drawn)),
                                  transformer._flat(params), strict=True):
            assert torch.equal(a, b)


def test_the_plan_follows_the_rules_fallbacks():
    """Heads that do not divide tp stay whole; kv heads that do not
    divide tp stay whole and each rank reads its q heads' kv heads."""
    qwen = smoke_config("qwen2-vl-72b")              # 4 heads, 1 kv head
    plan = TP.tp_plan(qwen, _mesh(1, 2))
    assert plan.split(("layers", "q")) and plan.split(("layers", "o"))
    assert not plan.split(("layers", "k"))
    assert plan.kv_heads(0) == plan.kv_heads(1) == [0]
    gemma = smoke_config("gemma2-2b")                # 4 heads, 2 kv heads
    plan = TP.tp_plan(gemma, _mesh(1, 2))
    assert plan.split(("layers", "k")) and plan.split(("layers2", "v"))
    assert plan.dims[("embed",)] == 0                # the vocab split
    odd = gemma.replace(num_heads=6, num_kv_heads=2)  # 6 % 4 != 0
    plan = TP.tp_plan(odd, _mesh(1, 4))
    assert not plan.split(("layers", "q")) and plan.split(("layers", "wi"))
    # non-uniform groups: one kv head a q head
    assert TP.rank_kv_heads(12, 3, 2, 0) == [0, 0, 0, 0, 1, 1]
    assert TP.rank_kv_heads(12, 3, 2, 1) == [1, 1, 2, 2, 2, 2]
    assert TP.rank_kv_heads(64, 8, 16, 3) == [1]
    assert TP.rank_kv_heads(8, 4, 2, 1) == [2, 3]
    # extra_dp splits no weight: no plan
    assert TP.tp_plan(smoke_config("musicgen-medium"), _mesh(1, 2)) is None
    kimi = TP.tp_plan(smoke_config("kimi-k2-1t-a32b"), _mesh(1, 2))
    assert kimi.dims[("layers", "moe", "wi")] == 1
    assert kimi.dims[("layers", "moe", "router")] is None


def test_a_rank_group_per_dp_rank():
    ids = np.arange(8).reshape(2, 2, 2)
    fake = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 2, "model": 2},
                           devices=np.array([[0, 1], [2, 3]], dtype=object))
    assert TP.tp_groups(fake) == [[0, 1], [2, 3]]
    fake3 = SimpleNamespace(axis_names=("pod", "data", "model"),
                            shape={"pod": 2, "data": 2, "model": 2},
                            devices=ids.astype(object))
    assert TP.tp_groups(fake3) == [[0, 1], [2, 3], [4, 5], [6, 7]]


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "llama4-scout-17b-a16e"])
def test_moe_drops_at_tp_2_equal_tp_1(arch, monkeypatch):
    """The routing runs once, replicated: the same top-k, capacity and
    drops at tp 2 as at tp 1, prefill and decode; the prefill's moe output
    within float32 sum order of tp 1's."""
    cfg = smoke_config(arch)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    params = transformer.init_params(cfg, seed=2, device="cpu")
    seen = []
    real = moe.route

    def spy(ids, e, cap):
        r = real(ids, e, cap)
        seen.append((ids.clone(), cap, r.keep.clone()))
        return r
    monkeypatch.setattr(moe, "route", spy)
    batch = tserve.make_batch(cfg, 2, 16, device="cpu")
    mesh = _mesh(1, 2)
    runs = []
    for p, m in ((params, None), (TP.shard_params(
            params, serving.serving_plan(cfg, mesh)), mesh)):
        seen.clear()
        logits, cache = serving.prefill(p, batch, cfg, mesh=m)
        step = tserve.token_to_batch(cfg, logits.argmax(-1), 16, 2,
                                     np.random.default_rng(0), device="cpu")
        serving.decode_step(p, step, cache, cfg, mesh=m)
        runs.append((list(seen), logits))
    (one, l1), (two, l2) = runs
    assert len(one) == len(two) == 2 * transformer.scan_len(cfg)
    drops = 0
    for (i1, c1, k1), (i2, c2, k2) in zip(one, two):
        assert torch.equal(i1, i2) and c1 == c2 and torch.equal(k1, k2)
        drops += int((~k1).sum())
    assert drops > 0                       # the cut capacity binds
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), **SELF_TOL)


def test_moe_ffn_routes_each_dp_shard_apart():
    """``moe_ffn(dp=2)``: each half of the rows routed alone (its own
    capacity), outputs in block order, aux the float32 mean."""
    m = smoke_config("kimi-k2-1t-a32b").moe
    params = transformer.init_params(smoke_config("kimi-k2-1t-a32b"),
                                     seed=0)["layers"]
    p = {k: (v[0] if not isinstance(v, dict) else v)
         for k, v in params["moe"].items()}
    x = torch.randn(4, 8, 64, generator=torch.Generator().manual_seed(0))
    y, aux = moe.moe_ffn(x, p, m, dp=2)
    y0, a0 = moe.moe_ffn(x[:2], p, m)
    y1, a1 = moe.moe_ffn(x[2:], p, m)
    assert torch.equal(y, torch.cat([y0, y1])) and torch.equal(
        aux, (a0 + a1) / 2)
    with pytest.raises(ValueError, match="3 rows does not split over 2"):
        moe.moe_ffn(x[:3], p, m, dp=2)


def test_the_launcher_serves_tensor_parallel():
    """``launch.serve --model 2`` on the CPU (a repeated device): the
    one-device run's logits within float32 sum order, the same flash
    launches a rank (0 on the CPU)."""
    argv = ["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
            "--requests", "2", "--prompt-len", "16", "--gen", "3"]
    _, one = tserve.main(argv)
    _, two = tserve.main(argv + ["--model", "2"])
    for a, b in zip(two["logits"][:1], one["logits"][:1], strict=True):
        np.testing.assert_allclose(a, b, **SELF_TOL)
    assert two["prefill_flash_launches"] == one["prefill_flash_launches"]


@pytest.mark.parametrize("visible", [1, 2, 4])
def test_a_host_mesh_repeats_only_the_cpu_or_a_named_card(visible,
                                                          monkeypatch):
    """``make_host_mesh`` takes the first visible cards and raises where
    fewer are visible; the CPU and a card named by its index repeat in
    every entry. The cards are stand-ins (``torch.cuda``'s counts
    patched); no tensor is made on them. The launchers' ``--device``
    takes ``cuda:N``."""
    import argparse
    from repro_torch.device import device_arg
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cards = [torch.device("cuda", i) for i in range(4)]
    for model in (1, 2, 4):
        if model <= visible:
            got = tmesh.make_host_mesh(1, model).devices.reshape(-1)
            assert list(got) == cards[:model]
        else:
            with pytest.raises(ValueError, match=f"needs {model} cards, "
                                                 f"{visible} are visible"):
                tmesh.make_host_mesh(1, model)
        named = tmesh.make_host_mesh(1, model, device="cuda:0")
        assert list(named.devices.reshape(-1)) == [cards[0]] * model
        cpu = tmesh.make_host_mesh(model, 1, device="cpu")
        assert list(cpu.devices.reshape(-1)) == [torch.device("cpu")] * model
    assert [device_arg(t) for t in ("cuda", "cuda:3", "cpu")] == [
        "cuda", "cuda:3", "cpu"]
    for bad in ("gpu", "cuda:", "cuda:x", "tpu:0"):
        with pytest.raises(argparse.ArgumentTypeError):
            device_arg(bad)


def test_the_collectives_are_metered():
    """``metering`` sees each split block's all-reduce forward and its
    input's backward, and the head's all-gather."""
    cfg = smoke_config("deepseek-7b")
    mesh = _mesh(1, 2)
    params = TP.shard_params(transformer.init_params(cfg, seed=0),
                             TP.tp_plan(cfg, mesh))
    batch = tserve.make_batch(cfg, 2, 16, device="cpu")
    with TP.metering() as rec:
        transformer.logits_fn(params, batch, cfg)
    act = 2 * 16 * cfg.d_model * 4                 # (B, S, d) float32
    layers = cfg.num_layers
    # embed + (attention-out, MLP-out) a layer, each 2 (tp - 1) / tp
    assert rec["all-reduce"] == (1 + 2 * layers) * act
    assert rec["all-gather"] == 2 * 16 * cfg.vocab_size * 4 / 2
    assert rec["calls"] == 2 + 2 * layers


def test_no_float_atomics_in_the_new_module():
    src = (SRC / "distributed" / "tensor_parallel.py").read_text()
    assert not re.search(r"index_add_?|scatter_add_?|index_put_", src)
    assert "import torch.distributed" not in src


def test_what_stays_refused_names_a11_9():
    """The ssm family over 'model', a mesh mixing device types and the
    abstract mesh."""
    mamba = smoke_config("mamba2-1.3b")
    shape = ShapeConfig("t", 32, 4, "train")
    with pytest.raises(NotImplementedError, match="ssm family.*A11.9"):
        steps.make_train_step(mamba, _mesh(1, 2), shape, microbatches=2)
    with pytest.raises(NotImplementedError, match="ssm family.*A11.9"):
        steps.make_prefill_step(mamba, _mesh(1, 2))
    ds = smoke_config("deepseek-7b")
    mixed = SimpleNamespace(
        axis_names=("data", "model"), shape={"data": 1, "model": 2},
        size=2, devices=np.array([[torch.device("cpu"),
                                   torch.device("cuda", 0)]], dtype=object))
    with pytest.raises(NotImplementedError, match="mixing.*A11.9"):
        steps.make_train_step(ds, mixed, shape, microbatches=2)
    with pytest.raises(NotImplementedError, match="mixing.*A11.9"):
        serving.prefill({}, {}, ds, mesh=mixed)
    with pytest.raises(NotImplementedError, match="abstract mesh.*A11.9"):
        steps.make_train_step(ds, tmesh.make_production_mesh(), shape)
    with pytest.raises(NotImplementedError, match="abstract mesh.*A11.9"):
        steps.make_decode_step(ds, tmesh.make_production_mesh())
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
                     "--model", "2"])
    # a placement that is not the mesh's plan
    params = transformer.init_params(ds, seed=0)
    batch = tserve.make_batch(ds, 1, 8, device="cpu")
    with pytest.raises(ValueError, match="shard_params"):
        serving.prefill(params, batch, ds, mesh=_mesh(1, 2))
