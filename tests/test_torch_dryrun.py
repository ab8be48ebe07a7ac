"""Port parity, the dry run (``launch/dryrun.py``) and what it reads:
``launch/mesh.make_production_mesh``, ``distributed/sharding.cache_specs``
and ``models/steps.input_specs``, against the JAX package's
(``repro/launch/{dryrun,mesh}.py``, ``repro/distributed/sharding.py``,
``repro/models/steps.py``).

* Specs at the production meshes, (16, 16) and (2, 16, 16): the
  reference's ``input_specs`` on a ``jax.sharding.AbstractMesh`` (nothing
  lowered), every arch x applicable shape at its published config: the
  port's inputs have its shapes, dtypes and specs, its cache its leaves'
  too (``cache_specs``, the sequence-over-'model' fallback included), and
  ``param_specs`` and ``default_microbatches`` are its.
* ``run_cell`` on one smoke config of every family (``get_config``
  pointed at ``smoke_config``) at both meshes: ``ok``, with the record's
  keys; the ssm and hybrid families' prefill at 32768 positions is a
  4096-chunk loop at the smoke chunk of 8 (~7 s a cell) and is left to
  the CLI. A train cell whose weights split over 'model' is n_mb times
  rank 0's microbatch count in the port's tensor-parallel step (its
  slices, the replicated work whole, the metered ``reduce_sum`` /
  ``gather_cat`` collectives) plus AdamW on the device's share plus the
  dp ring, the ssm family's too (its SSD split over 'model').
* The production mesh runs no step: ``make_train_step`` refuses it
  naming A11.9; ``make_mesh(devices=["meta"])`` still refuses meta.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.distributed import sharding as jsharding  # noqa: E402
from repro.models import serving as jserving  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs import (ARCH_NAMES, SHAPES,  # noqa: E402
                                 applicable_shapes, get_config,
                                 smoke_config)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed import tensor_parallel as TP  # noqa: E402
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import steps  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
FAMILIES = {"dense": "deepseek-7b", "audio": "musicgen-medium",
            "moe": "kimi-k2-1t-a32b", "ssm": "mamba2-1.3b",
            "hybrid": "hymba-1.5b", "local_global": "gemma2-2b",
            "vlm": "qwen2-vl-72b"}
KEYS = {"arch", "shape", "mesh", "chips", "kind", "params", "roofline",
        "ok", "count_s", "bytes_per_device", "step_stats",
        "tensor_parallel", "rows_per_device", "model_division",
        "model_ranks"}


def _same(port, ref, where):
    """A port stand-in (``sharding.Sharded``) against the reference's
    ShapeDtypeStruct: shape, dtype and spec."""
    assert tuple(port.tensor.shape) == tuple(ref.shape), where
    assert str(port.tensor.dtype).removeprefix("torch.") == \
        str(ref.dtype), where
    assert port.tensor.device.type == "meta", where
    assert port.spec == tuple(ref.sharding.spec), where


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_equal_the_reference_at_the_production_meshes(arch,
                                                            mesh_name):
    shape_, axes = MESHES[mesh_name]
    jmesh = AbstractMesh(shape_, axes)
    mesh = tmesh.make_production_mesh(multi_pod=mesh_name == "multi")
    assert mesh.shape == dict(zip(axes, shape_))
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in applicable_shapes(cfg):
        where = (arch, shape.name, mesh_name)
        want = jsteps.input_specs(jcfg, shape, jmesh)
        got = steps.input_specs(cfg, shape, mesh)
        assert set(got) == set(want), where
        assert set(got["batch"]) == set(want["batch"]), where
        for k, v in want["batch"].items():
            _same(got["batch"][k], v, where + (k,))
        if shape.kind == "train":
            assert got["n_microbatches"] == want["n_microbatches"] == \
                steps.default_microbatches(cfg, shape, mesh) == \
                jsteps.default_microbatches(jcfg, shape, jmesh), where
        if shape.kind == "decode":
            assert set(got["cache"]) == set(want["cache"]), where
            for k, v in want["cache"].items():
                _same(got["cache"][k], v, where + (k,))
            # cache_specs alone, on the reference's cache shapes
            shapes = jax.eval_shape(lambda: jserving.init_cache(
                jcfg, shape.global_batch, shape.seq_len))
            jspecs = jsharding.cache_specs(shapes, jmesh, jcfg)
            assert sharding.cache_specs(
                {k: tuple(v.shape) for k, v in shapes.items()}, mesh,
                cfg) == {k: tuple(s) for k, s in jspecs.items()}, where
    pshapes = jax.eval_shape(
        lambda: jtransformer.init_params(jax.random.PRNGKey(0), jcfg))
    for inference in (False, True):
        want = jsharding.param_specs(pshapes, jmesh, jcfg, inference)
        got = sharding.param_specs(
            jax.tree_util.tree_map(lambda s: tuple(s.shape), pshapes),
            mesh, cfg, inference)
        flat = jax.tree_util.tree_leaves_with_path(
            want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        for path, spec in flat:
            node = got
            for k in path:
                node = node[k.key]
            assert node == tuple(spec), (arch, mesh_name, path)


def test_the_production_mesh_is_abstract_and_runs_no_step():
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert single.axis_names == ("data", "model") and single.size == 256
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert {d.type for d in multi.devices.reshape(-1)} == {"meta"}
    with pytest.raises(ValueError, match="no device"):
        single.first_device
    # weights sharded over 'model' (FSDP rules), and the extra_dp config
    # whose 'model' axis shards nothing: both refused, naming A11.9
    for arch in ("deepseek-7b", "musicgen-medium"):
        with pytest.raises(NotImplementedError, match="A11.9"):
            steps.make_train_step(get_config(arch), single,
                                  SHAPES["train_4k"])
    with pytest.raises(ValueError, match="unsupported device"):
        tmesh.make_mesh((1,), ("data",), devices=["meta"])


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_run_cell_on_every_family_smoke_config(family, mesh_name,
                                               monkeypatch, tmp_path):
    monkeypatch.setattr(dryrun, "get_config", smoke_config)
    arch = FAMILIES[family]
    memo = {}
    for shape in applicable_shapes(smoke_config(arch)):
        if family in ("ssm", "hybrid") and shape.kind == "prefill":
            continue
        rec = dryrun.run_cell(arch, shape, mesh_name, tmp_path, memo=memo)
        assert rec["ok"], rec.get("traceback")
        assert KEYS <= set(rec), set(rec) ^ KEYS
        assert ("n_microbatches" in rec) == (shape.kind == "train")
        assert rec["chips"] == (512 if mesh_name == "multi" else 256)
        r = rec["roofline"]
        assert r["dominant"] in ("compute", "memory", "collective")
        assert 0 < r["useful_flops_ratio"] <= 1.0
        assert rec["step_stats"]["flops"] > 0
        on_disk = json.loads((tmp_path / f"{arch}__{shape.name}__"
                                          f"{mesh_name}.json").read_text())
        assert on_disk == json.loads(json.dumps(rec))
        if shape.kind != "decode" and family != "ssm":
            assert rec["step_stats"]["kernel_units"]["flash_attention"][
                "calls"] > 0


def test_a_train_cell_is_its_microbatch_times_n_mb_over_tp():
    """A weight-splitting train cell is rank 0 of the tensor-parallel
    step (no longer the whole step over tp): n_mb times rank 0's
    microbatch, whose count lies between the whole step's / tp (the
    replicated work stands whole) and the whole step's; AdamW on rank
    0's slices scaled to the device's share; the dp ring plus n_mb times
    the metered TP collectives. The ssm family's cell is rank 0 of its
    split step too: no cell is divided by tp any more."""
    cfg = smoke_config("deepseek-7b")
    shape = SHAPES["train_4k"]
    mesh = tmesh.make_production_mesh()
    cell = dryrun.count_cell(cfg, shape, mesh)
    n_mb, rows, div, tp = (cell["n_microbatches"], cell["rows_per_device"],
                           cell["model_division"], cell["model_ranks"])
    assert (n_mb, rows, div, tp) == (8, 2, 1, 16)
    assert cell["tensor_parallel"] == dryrun.TENSOR_PARALLEL
    plan = TP.counting_plan(cfg, mesh)
    state = dryrun.meta_state(cfg, plan)
    assert len(state.params["layers"]["wi"]) == 1    # rank 0's slice only
    grad_step = steps.make_grad_step(
        cfg, None, ShapeConfig("t", shape.seq_len, rows, "train"), 1)
    batch = {k: torch.empty((1, rows, shape.seq_len), dtype=torch.int32,
                            device="meta")
             for k in ("tokens", "positions", "labels")}
    with TP.metering() as rec:
        mb, (grads, _, _) = analysis.count_step(grad_step, state, batch)
    whole, _ = analysis.count_step(grad_step, dryrun.meta_state(cfg), batch)
    assert whole.flops / tp < mb.flops < whole.flops
    adam, _ = analysis.count_step(steps.apply_grads, cfg, state, grads,
                                  torch.empty((), device="meta"))
    st = cell["stats"]
    assert st.flops == mb.flops * n_mb
    structs, params = dryrun.state_structs(cfg, mesh)
    share = dryrun.bytes_per_device(params, mesh) / dryrun.tree_bytes(
        state.params)
    assert st.traffic_bytes == pytest.approx(
        mb.traffic_bytes * n_mb + adam.traffic_bytes * share, rel=1e-12)
    # deepseek's smoke heads (4) do not divide 16: attention runs
    # replicated; per microbatch the embedding's and each layer's MLP
    # all-reduce forward, each MLP input's and the head input's backward,
    # and the logits' all-gather, each chunk's forward and recomputation
    act = rows * shape.seq_len * cfg.d_model * 4
    layers = cfg.num_layers
    assert rec["all-reduce"] == pytest.approx(
        (1 + 2 * layers + 1) * act * 2 * 15 / 16, rel=1e-12)
    assert rec["all-gather"] == pytest.approx(
        2 * rows * shape.seq_len * cfg.vocab_size * 4 * 15 / 16, rel=1e-12)
    # the ring over 'data' (16 ranks) of the device's float32 gradient
    # (its parameters less the 'model' splits)
    grad_bytes = sum(x.tensor.numel() * 4 / dryrun.shards(
        tuple(p for p in x.spec if p != "data"), mesh)
        for x in dryrun._leaves(params))
    assert st.collective_bytes == pytest.approx(
        2 * 15 / 16 * grad_bytes + n_mb * (rec["all-reduce"]
                                           + rec["all-gather"]), rel=1e-12)
    # mamba2's smoke SSD widened to 16 heads, which split over 16 ranks
    mamba = smoke_config("mamba2-1.3b")
    mamba = mamba.replace(ssm=dataclasses.replace(mamba.ssm, expand=4))
    ssm = dryrun.count_cell(mamba, shape, mesh)
    assert (ssm["model_division"], ssm["model_ranks"]) == (1, 16)
    assert ssm["tensor_parallel"] == dryrun.TENSOR_PARALLEL
    assert TP.counting_plan(mamba, mesh).split(("layers", "ssm", "z_proj"))
    assert ssm["stats"].collectives["all-reduce"] > 0
    nbytes = cell["bytes_per_device"]
    assert nbytes["params"] == dryrun.bytes_per_device(params, mesh)
    assert nbytes["opt"] == 2 * nbytes["params"] + 4      # m, v, step
    assert nbytes["total"] == sum(v for k, v in nbytes.items()
                                  if k != "total")


def test_state_structs_carry_the_int8_error_rows():
    cfg = smoke_config("deepseek-7b").replace(grad_compression="int8")
    mesh = tmesh.make_production_mesh(multi_pod=True)
    state, params = dryrun.state_structs(cfg, mesh)
    n = sum(x.tensor.numel() for x in dryrun._leaves(params))
    assert tuple(state.err.tensor.shape) == (32, n)
    assert state.err.spec == (("pod", "data"), None)
    assert state.err.tensor.dtype == torch.bfloat16
    cell = dryrun.count_cell(cfg, SHAPES["train_4k"], mesh)
    assert cell["bytes_per_device"]["err"] == n * 2     # one row a device
    assert cell["stats"].collectives["all-reduce"] > 0


def test_the_cli_writes_a_record_a_cell(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(dryrun, "get_config", smoke_config)
    with pytest.raises(SystemExit) as exit_:
        dryrun.main(["--arch", "gemma2-2b", "--shape", "decode_32k",
                     "--mesh", "both", "--out", str(tmp_path)])
    assert exit_.value.code == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "gemma2-2b__decode_32k__multi.json",
        "gemma2-2b__decode_32k__single.json"]
    assert "done: 2 ok, 0 failed" in capsys.readouterr().out


def test_padded_published_configs_are_counted_unpadded(monkeypatch,
                                                      tmp_path):
    """gemma2-2b pads its heads (ROADMAP C): the cell runs with
    pad_heads_to=0 and says so."""
    monkeypatch.setattr(
        dryrun, "get_config",
        lambda a: smoke_config(a).replace(pad_heads_to=8))
    rec = dryrun.run_cell("gemma2-2b", SHAPES["decode_32k"], "single",
                          tmp_path)
    assert rec["ok"] and rec["reduced"] == dryrun.PADDED
