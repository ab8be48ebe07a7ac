"""The port's one loop over ranks (``distributed/tensor_parallel.py``:
``map_ranks``): the ranks run in rank order on the caller's thread, a
unit's exception reaches the caller as it was raised, and every per-rank
loop of the split layers (attention, the MLPs, moe's experts, the split
SSD, the vocab-split embedding and head, serving's split decode) and of
the int8 dp step's ranks goes through it, with one argument a rank. A
split model under remat gives bitwise the gradients it gives without.
The launch counters' lock (``kernels/_build.count_launch``) loses no
increment across threads: autograd runs a backward split over distinct
cards on a thread of each card."""
import pytest

torch = pytest.importorskip("torch")

import collections  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import lm  # noqa: E402
from repro_torch.distributed import tensor_parallel as TP  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import serving, steps, transformer  # noqa: E402

JOIN_S = 60.0


def test_map_ranks_runs_the_ranks_in_order_on_the_callers_thread():
    me = threading.current_thread()
    done = []

    def fn(r, x, y):
        done.append((r, threading.current_thread()))
        return x * 10 + y
    assert TP.map_ranks(fn, [1, 2, 3], [4, 5, 6]) == [14, 25, 36]
    assert done == [(0, me), (1, me), (2, me)]
    with pytest.raises(ValueError, match="per-rank arguments"):
        TP.map_ranks(fn, [1, 2], [1])


def test_a_units_exception_reaches_the_caller_and_later_ranks_do_not_run():
    done = []
    bad = ValueError("bad rank 1")

    def fn(r, x):
        done.append(r)
        if r == 1:
            raise bad
        return x
    with pytest.raises(ValueError) as info:
        TP.map_ranks(fn, [0, 1, 2])
    assert info.value is bad and done == [0, 1]


def _split_model(arch, **change):
    cfg = smoke_config(arch).replace(**change)
    mesh = tmesh.make_host_mesh(1, 2, device="cpu")
    params = transformer.init_params(cfg, seed=0,
                                     plan=TP.tp_plan(cfg, mesh))
    assert TP.is_split(params)
    return cfg, mesh, params


def _batch(cfg, b=4, s=32):
    data = lm.SyntheticLM(lm.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
        microbatches=1), cfg)
    return {k: v[0] for k, v in data.device_batch(0).items()}


@pytest.fixture
def units(monkeypatch):
    """Each ``map_ranks`` call's unit (its function's qualified name) and
    number of ranks, counted while the test runs."""
    seen = collections.Counter()
    plain = TP.map_ranks

    def recorded(fn, *per_rank):
        seen[fn.__qualname__.split(".")[0], len(per_rank[0])] += 1
        return plain(fn, *per_rank)
    monkeypatch.setattr(TP, "map_ranks", recorded)
    return seen


ATTENTION = {"project_qkv", "attend_qkv", "run_ranks", "_embed_split",
             "head_logits"}
SSD = {"_ssd_split", "_gated_norm_split", "_out_split", "_embed_split",
       "head_logits"}
SITES = {  # arch: (the training forward's units, serving's)
    "deepseek-7b": (ATTENTION, ATTENTION | {"_attend_decode"}),
    "kimi-k2-1t-a32b": (ATTENTION | {"_experts"},
                        ATTENTION | {"_experts", "_attend_decode"}),
    "mamba2-1.3b": (SSD, SSD | {"_decode_split"}),
}


@pytest.mark.parametrize("path", ["train", "serve"])
@pytest.mark.parametrize("arch", sorted(SITES))
def test_every_split_loop_goes_through_map_ranks(arch, path, units):
    cfg, mesh, params = _split_model(arch)
    batch = _batch(cfg)
    if path == "train":
        live, _ = steps._autograd_leaves(params)
        loss, _ = transformer.loss_fn(live, batch, cfg)
        assert torch.isfinite(loss)
    else:
        del batch["labels"]
        with torch.no_grad():
            logits, cache = serving.prefill(params, batch, cfg,
                                            extra_slots=1, mesh=mesh)
            b, s = batch["positions"].shape[:2]
            step = {"tokens": logits.argmax(-1)[:, None].to(torch.int32),
                    "positions": torch.full((b, 1), s, dtype=torch.int32)}
            logits, _ = serving.decode_step(params, step, cache, cfg,
                                            mesh=mesh)
        assert torch.isfinite(logits).all()
    want = SITES[arch][path == "serve"]
    assert {site for site, _ in units} == want
    assert {n for _, n in units} == {2}          # one argument a rank


def test_the_int8_dp_steps_ranks_go_through_map_ranks(units):
    cfg = smoke_config("deepseek-7b").replace(grad_compression="int8")
    mesh = tmesh.make_host_mesh(2, 1, device="cpu")
    data = lm.SyntheticLM(lm.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=8,
        microbatches=2), cfg)
    state = steps.init_state(cfg, seed=1, device="cpu", mesh=mesh)
    grad_step = steps.make_grad_step(cfg, mesh, ShapeConfig("t", 32, 8,
                                                            "train"), 2)
    _, loss, err = grad_step(state, data.device_batch(0))
    assert torch.isfinite(loss) and len(err) == 2
    assert units == {("make_grad_step", 2): 1}


@pytest.mark.parametrize("arch", ["gemma2-2b", "mamba2-1.3b"])
def test_split_gradients_are_bitwise_with_and_without_remat(arch):
    """Under ``torch.utils.checkpoint`` the split layers' ranks run in
    rank order on the caller's thread, in the forward and in the
    recomputation, so remat changes no gradient."""
    was = torch.are_deterministic_algorithms_enabled()
    # the CPU's accumulating index_put_ (the embedding's backward) adds
    # duplicate rows in a varying order otherwise
    torch.use_deterministic_algorithms(True)
    try:
        got = {}
        for remat in ("full", "none"):
            cfg, _, params = _split_model(arch, remat=remat)
            live, leaves = steps._autograd_leaves(params)
            loss, _ = transformer.loss_fn(live, _batch(cfg), cfg)
            got[remat] = [loss] + list(torch.autograd.grad(loss, leaves))
    finally:
        torch.use_deterministic_algorithms(was)
    for a, b in zip(got["full"], got["none"], strict=True):
        assert torch.equal(a, b)


def test_launch_counts_lose_no_increment_across_threads():
    counts = {"k": 0}
    n_threads, n_each = 16, 2000

    def bump():
        for _ in range(n_each):
            _build.count_launch(counts, "k")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump, daemon=True)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counts["k"] == n_threads * n_each
