"""The port stands alone: src/repro_torch, chip_smoke.py and the A/B
tools (tools/flash_f32_ab.py, flash_bwd_ab.py, mc_eval_ab.py,
adc_bank_ab.py, lookup_backward_ab.py, dp_cards.py, tp_cards.py) import
neither JAX nor the JAX package, entry points do not drift to the CPU when
no card is present, and chip_smoke.py refuses to report without a card or
outside a checkout (the A/B tools without a card)."""
import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FRONT = REPO / "tests" / "fixtures" / "fronts" / "cardio_mlp"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tools" / "flash_f32_ab.py",
        REPO / "tools" / "flash_bwd_ab.py", REPO / "tools" / "mc_eval_ab.py",
        REPO / "tools" / "adc_bank_ab.py",
        REPO / "tools" / "lookup_backward_ab.py",
        REPO / "tools" / "dp_cards.py", REPO / "tools" / "tp_cards.py"]


def _modules():
    return sorted(".".join(p.relative_to(REPO / "src").with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_repro_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0 and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_importing_every_port_module_loads_no_jax():
    mods = _modules()
    assert "repro_torch.kernels.qmlp" in mods and len(mods) >= 15
    assert {"repro_torch.timeseries", "repro_torch.timeseries.stream",
            "repro_torch.timeseries.feature",
            "repro_torch.timeseries.cosearch"} <= set(mods)
    assert {"repro_torch.launch.loadgen", "repro_torch.launch.serving_engine",
            "repro_torch.distributed", "repro_torch.distributed.fault"
            } <= set(mods)
    assert {"repro_torch.launch.mesh", "repro_torch.distributed.sharding",
            "repro_torch.distributed.elastic",
            "repro_torch.distributed.tensor_parallel"} <= set(mods)
    assert {"repro_torch.perf", "repro_torch.perf.workload",
            "repro_torch.perf.cost_model", "repro_torch.perf.autotune"
            } <= set(mods)
    assert {"repro_torch.data.lm", "repro_torch.optim.schedule",
            "repro_torch.optim.adamw", "repro_torch.models.steps",
            "repro_torch.launch.train"} <= set(mods)
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('isolated', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("isolated")


def test_entry_points_need_a_card_unless_asked_for_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch.core import deploy
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve_classifier
    designs = deploy.load_front(FRONT)
    x = np.zeros((4, designs[0].channels), np.float32)
    calls = [lambda: resolve_device(),
             lambda: resolve_device("cuda"),
             lambda: deploy.make_bank_fn(designs),
             lambda: deploy.serve_bank(designs, x),
             lambda: deploy.served_accuracies(designs, x, np.zeros(4)),
             lambda: designs[0].logits(x),
             lambda: serve_classifier.serve(designs, [(0, x)], 8)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(SystemExit) as exc:
        serve_classifier.main(["--front-dir", str(FRONT), "--dataset",
                               "cardio"])
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ))


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "cuda" in out.stderr.lower()


def test_flash_ab_tool_without_a_card_fails():
    """tools/flash_f32_ab.py measures on a card only: without one it
    exits 3 before building or printing a number."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(REPO / "tools" /
                                              "flash_f32_ab.py")],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ))
    assert out.returncode == 3
    assert "torch.cuda.is_available() is false" in out.stderr
    assert "TFLOP" not in out.stdout and "ms" not in out.stdout


def test_flash_bwd_ab_tool_without_a_card_fails():
    """tools/flash_bwd_ab.py measures on a card only: without one it
    exits 3 before building or printing a number."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(REPO / "tools" /
                                              "flash_bwd_ab.py")],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ))
    assert out.returncode == 3
    assert "torch.cuda.is_available() is false" in out.stderr
    assert "ms" not in out.stdout and "{" not in out.stdout


def test_adc_bank_ab_tool_without_a_card_fails():
    """tools/adc_bank_ab.py measures on a card only: without one it exits
    3 before building or printing a number."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(REPO / "tools" /
                                              "adc_bank_ab.py")],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ))
    assert out.returncode == 3
    assert "torch.cuda.is_available() is false" in out.stderr
    assert "us" not in out.stdout and "{" not in out.stdout


def test_lookup_backward_tool_without_a_card_fails():
    """tools/lookup_backward_ab.py measures on a card only: without one it
    exits 3 before printing a number."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(REPO / "tools" /
                                              "lookup_backward_ab.py")],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ))
    assert out.returncode == 3
    assert "torch.cuda.is_available() is false" in out.stderr
    assert "ms" not in out.stdout and "{" not in out.stdout


def test_dp_cards_tool_without_two_cards_fails():
    """tools/dp_cards.py compares distinct cards: with fewer than two it
    exits 3 before printing a number."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA cards are present")
    out = subprocess.run([sys.executable, str(REPO / "tools" /
                                              "dp_cards.py")],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ))
    assert out.returncode == 3
    assert "needs at least two CUDA cards" in out.stderr
    assert "{" not in out.stdout


def test_tp_cards_tool_without_four_cards_fails():
    """tools/tp_cards.py serves over four distinct cards: with fewer it
    exits 3 before printing a number."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("four CUDA cards are present")
    out = subprocess.run([sys.executable, str(REPO / "tools" /
                                              "tp_cards.py")],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ))
    assert out.returncode == 3
    assert "needs 4 CUDA cards" in out.stderr
    assert "{" not in out.stdout


def _gradient_slice_calls():
    """The gradient slice's entry points and state helpers, each called
    with no device."""
    from repro_torch import api
    from repro_torch.core import grad_gates, search
    from repro_torch.core import surrogate
    from repro_torch.core.spec import AdcSpec
    from repro_torch.data import tabular
    data = tabular.make_dataset("seeds")
    sizes = (7, 3, 3)
    cfg = search.SearchConfig(bits=2, pop_size=2, generations=0,
                              train_steps=1, engine="gradient",
                              grad_train_steps=2, grad_polish_rounds=0)
    leaves = surrogate.leaves(surrogate.init(10, 2, device="cpu"))
    lanes = grad_gates.init_lanes(sizes, cfg, 2, "cpu")
    bundle = {"dp": lanes.dp.numpy(), "logits": lanes.logits.numpy(),
              "params": [tuple(t.numpy() for t in layer)
                         for layer in lanes.params]}
    zeros = {k: (np.zeros_like(v) if k != "params" else
                 [tuple(np.zeros_like(t) for t in layer) for layer in v])
             for k, v in bundle.items()}
    return {
        "surrogate.init": lambda: surrogate.init(10, 2),
        "surrogate.state_from_numpy":
            lambda: surrogate.state_from_numpy(leaves),
        "grad_gates.init_lanes":
            lambda: grad_gates.init_lanes(sizes, cfg, 2),
        "grad_gates.lanes_from_numpy": lambda: grad_gates.lanes_from_numpy(
            bundle, (np.zeros(2, np.int32), zeros, zeros)),
        "grad_gates.train_gate_family":
            lambda: grad_gates.train_gate_family(data, sizes, cfg, lanes=2),
        "search.run_gradient_search":
            lambda: search.run_gradient_search(data, sizes, cfg),
        "search.full_adc_baseline":
            lambda: search.full_adc_baseline(data, sizes, cfg),
        "api.search_gradient": lambda: api.search_gradient(
            AdcSpec(bits=2), data, sizes, pop_size=2, train_steps=1,
            grad_train_steps=2, grad_polish_rounds=0)}


@pytest.mark.parametrize("name", [
    "surrogate.init", "surrogate.state_from_numpy", "grad_gates.init_lanes",
    "grad_gates.lanes_from_numpy", "grad_gates.train_gate_family",
    "search.run_gradient_search", "search.full_adc_baseline",
    "api.search_gradient"])
def test_gradient_slice_defaults_to_the_card(name):
    """The gradient slice's entry points and its state helpers resolve
    ``device=None`` to cuda like the rest of the port: without a card
    each raises 'no CUDA device' and none puts its state on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    call = _gradient_slice_calls()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_search_entry_points_need_a_card_unless_asked_for_cpu(capsys):
    """The search slice's entry points default to cuda as well: without a
    card each raises 'no CUDA device', and each runs when asked for the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch import api
    from repro_torch.core import deploy, search
    from repro_torch.core.spec import AdcSpec
    from repro_torch.data import tabular
    from repro_torch.launch import train
    data = tabular.make_dataset("seeds")
    sizes = (7, 3, 3)
    cfg = search.SearchConfig(bits=2, pop_size=2, generations=0,
                              train_steps=1)
    genomes = np.ones((1, search.genome_len(7, 2)), np.uint8)
    calls = [lambda: search.run_search(data, sizes, cfg),
             lambda: search.evaluate_population(genomes, data, sizes, cfg),
             lambda: search.evaluate_population_reference(genomes, data,
                                                          sizes, cfg),
             lambda: search.train_pareto_front(genomes, data, sizes, cfg),
             lambda: deploy.export_front(genomes, data, sizes, cfg),
             lambda: api.search(AdcSpec(bits=2), data, sizes, pop_size=2,
                                generations=0, train_steps=1),
             lambda: api.quantize(data["x_test"], np.ones((7, 4)),
                                  AdcSpec(bits=2))]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(SystemExit) as exc:
        train.main(["--adc-search", "--dataset", "seeds", "--pop", "2",
                    "--generations", "0", "--train-steps", "1"])
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
    fit = search.evaluate_population(genomes, data, sizes, cfg, device="cpu")
    assert fit.shape == (1, 2)
    designs = deploy.export_front(genomes, data, sizes, cfg, device="cpu")
    assert len(designs) == 1


def test_sharded_slice_defaults_to_the_card(capsys):
    """The sharded slice's default meshes are every visible CUDA card:
    without one, each entry that builds a mesh by default raises 'no
    CUDA device'; asked for the CPU, each gets a one-entry CPU mesh."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from repro_torch import api
    from repro_torch.core import search
    from repro_torch.core.spec import AdcSpec
    from repro_torch.data import tabular
    from repro_torch.distributed import elastic
    from repro_torch.launch import mesh, serve_classifier, train
    data = tabular.make_dataset("seeds")
    sizes = (7, 3, 3)
    cfg = search.SearchConfig(bits=2, pop_size=2, generations=0,
                              train_steps=1, engine="sharded")
    genomes = np.ones((2, search.genome_len(7, 2)), np.uint8)
    calls = [lambda: mesh.make_mesh((1, 1), ("data", "model")),
             lambda: mesh.make_host_mesh(),
             lambda: elastic.make_elastic_mesh(),
             lambda: search.default_search_mesh(),
             lambda: search.evaluate_population_sharded(genomes, data,
                                                        sizes, cfg),
             lambda: search.make_eval_fn(data, sizes, cfg),
             lambda: search.run_search(data, sizes, cfg),
             lambda: api.search(AdcSpec(bits=2), data, sizes, pop_size=2,
                                generations=0, train_steps=1,
                                engine="sharded")]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for argv, main in (
            (["--adc-search", "--dataset", "seeds", "--pop", "2",
              "--generations", "0", "--train-steps", "1", "--engine",
              "sharded"], train.main),
            (["--front-dir", str(FRONT), "--dataset", "cardio",
              "--sharded"], serve_classifier.main)):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code == 2
        assert "no CUDA device" in capsys.readouterr().err
    cpu = search.default_search_mesh("cpu")
    assert list(cpu.devices.reshape(-1)) == [torch.device("cpu")]
    fit = search.evaluate_population_sharded(genomes, data, sizes, cfg, cpu)
    assert fit.shape == (2, 2)
