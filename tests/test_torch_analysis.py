"""Port parity, the roofline analysis (``launch/analysis.py``) against the
JAX package's ``repro/launch/analysis.py``, and the port's step counter.

* ``model_flops``, ``ideal_bytes`` and ``roofline`` (the v5e row) are
  plain Python over the config: equal to the reference's, as floats, for
  every arch x applicable shape, chips 1 / 256 / 512 and 1 / 8
  microbatches.
* ``count_step`` (the counterpart of the reference's HLO parser, which
  the port does not port): exact on a matmul (2 m k n), on a loop of L
  matmuls (L x) and on a one-layer smoke model's train step against a
  hand count written here; the same on cpu and meta for one smoke config
  of every family; smoke deepseek-7b at 3 layers (the reference's
  ``test_end_to_end_vs_6nd`` shape) within the reference's own (0.6,
  2.0) of 6 N D.
* the meta route (``kernels/dispatch``): the kernel path without a
  launch, every wrapper returning empty outputs of its kernel's shapes
  and no launch counted; the moe aux loss's expert counts from
  ``route``'s starts equal ``bincount``'s.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import analysis as janalysis  # noqa: E402
from repro_torch.configs import (ARCH_NAMES, applicable_shapes,  # noqa: E402
                                 get_config, smoke_config)
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.spec import AdcSpec  # noqa: E402
from repro_torch.data import lm  # noqa: E402
from repro_torch.kernels import (adc_quantize, dispatch,  # noqa: E402
                                 flash_attention, mc_eval, ops, qmlp)
from repro_torch.launch import analysis, dryrun  # noqa: E402
from repro_torch.models import moe, steps  # noqa: E402

FAMILIES = {"dense": "deepseek-7b", "audio": "musicgen-medium",
            "moe": "kimi-k2-1t-a32b", "ssm": "mamba2-1.3b",
            "hybrid": "hymba-1.5b", "local_global": "gemma2-2b",
            "vlm": "qwen2-vl-72b"}


# ------------------------------------------------------- reference parity
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_and_ideal_bytes_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in applicable_shapes(cfg):
        assert analysis.model_flops(cfg, shape) == \
            janalysis.model_flops(jcfg, shape)
        for chips in (1, 256, 512):
            for n_mb in (1, 8):
                assert analysis.ideal_bytes(cfg, shape, chips, n_mb) == \
                    janalysis.ideal_bytes(jcfg, shape, chips, n_mb), \
                    (shape.name, chips, n_mb)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_roofline_on_the_v5e_row_equals_the_reference(arch):
    """The same numbers fed to the reference's HloStats and the port's
    StepStats give the same record, every key and value."""
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.LINK_BW) == \
        (janalysis.PEAK_FLOPS, janalysis.HBM_BW, janalysis.LINK_BW)
    cfg, jcfg = get_config(arch), jget_config(arch)
    rng = np.random.default_rng(len(arch))
    for shape in applicable_shapes(cfg):
        for chips in (1, 256, 512):
            for n_mb in (1, 8):
                f, t, c = (float(x) for x in rng.uniform(1e9, 1e15, 3))
                ib = analysis.ideal_bytes(cfg, shape, chips, n_mb)
                mf = analysis.model_flops(cfg, shape)
                want = janalysis.roofline(
                    janalysis.HloStats(flops=f, traffic_bytes=t,
                                       collective_bytes=c),
                    chips=chips, model_flops_global=mf,
                    ideal_bytes_per_dev=ib)
                got = analysis.roofline(
                    analysis.StepStats(flops=f, traffic_bytes=t,
                                       collective_bytes=c),
                    chips=chips, model_flops_global=mf,
                    ideal_bytes_per_dev=ib, machine=analysis.V5E)
                assert got == want
                assert set(janalysis.HloStats().to_dict()) <= \
                    set(analysis.StepStats().to_dict())


def test_machine_rows_are_the_data_sheets():
    assert analysis.H100.peak_flops == 989e12
    assert analysis.H100.hbm_bw == 3.35e12 and analysis.H100.link_bw == 450e9
    assert analysis.V5E.peak_flops == 197e12


# ---------------------------------------------------------------- counter
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_matmul_counts_2mkn(device):
    m, k, n = 8, 16, 4
    a = torch.ones(m, k, device=device)
    b = torch.ones(k, n, device=device)
    st, out = analysis.count_step(torch.matmul, a, b)
    assert st.flops == 2 * m * k * n and st.dot_ops == 1
    assert st.traffic_bytes == 2 * m * n * 4 and out.shape == (m, n)
    assert st.ops == {"aten.mm": [1, 2.0 * m * n * 4]}


def test_a_loop_of_matmuls_counts_each():
    x = torch.ones(4, 32)
    ws = [torch.ones(32, 32) for _ in range(7)]

    def f():
        y = x
        for w in ws:
            y = y @ w
        return y
    st, _ = analysis.count_step(f)
    one, _ = analysis.count_step(lambda: x @ ws[0])
    assert st.flops == 7 * one.flops == 7 * 2 * 4 * 32 * 32
    assert st.dot_ops == 7


def _train(cfg, device, batch=2, seq=16, mb=1):
    """(the train step, state, batch) of ``cfg`` on ``device``: random
    weights on the CPU, meta leaves on meta."""
    shape = ShapeConfig("t", seq, batch, "train")
    step = steps.make_train_step(cfg, None, shape, microbatches=mb)
    data = lm.SyntheticLM(lm.LMDataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=seq, global_batch=batch,
                                          microbatches=mb), cfg)
    b = data.device_batch(0)
    if device == "meta":
        return step, dryrun.meta_state(cfg), {
            k: torch.empty_like(v, device="meta") for k, v in b.items()}
    return step, steps.init_state(cfg, seed=0, device="cpu"), b


def test_one_layer_step_counts_the_hand_count():
    """deepseek-7b's smoke config at one layer, batch 2 x 16: every
    projection three times (forward, the input's and the weight's
    gradients), the loss head four (its chunk recomputed in the
    backward), attention one forward and one backward unit over the
    causal pairs."""
    cfg = smoke_config("deepseek-7b").replace(num_layers=1)
    b, s = 2, 16
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    f, v = cfg.d_ff, cfg.vocab_size
    t = b * s
    proj = 2 * t * d * (h * hd + 2 * kv * hd) + 2 * t * h * hd * d
    mlp = 3 * 2 * t * d * f
    head = 2 * t * d * v
    pairs = s * (s + 1) // 2
    attn = (4 + 10) * b * h * hd * pairs
    want = 3 * (proj + mlp) + 4 * head + attn
    step, state, batch = _train(cfg, "cpu", b, s)
    st, _ = analysis.count_step(step, state, batch, 0)
    assert st.flops == want
    assert analysis.unit_calls(st) == {"flash_attention": 1,
                                       "flash_attention_bwd": 1}
    assert st.kernel_units["flash_attention"]["flops"] == \
        4 * b * h * hd * pairs


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_a_step_counts_the_same_on_cpu_and_meta(family):
    """Each family's smoke config (remat full, as the published configs)
    trained one step of 2 microbatches: FLOPs, traffic, the matmul calls,
    the hand-kernel units and every op's calls and bytes equal on the CPU
    (plain versions inside the units) and on meta (no launch)."""
    cfg = smoke_config(FAMILIES[family]).replace(remat="full")
    counts = {}
    for device in ("cpu", "meta"):
        step, state, batch = _train(cfg, device, batch=4, seq=32, mb=2)
        counts[device], _ = analysis.count_step(step, state, batch, 0)
    cpu, meta = counts["cpu"], counts["meta"]
    assert cpu.flops == meta.flops and cpu.dot_ops == meta.dot_ops
    assert cpu.kernel_units == meta.kernel_units
    assert cpu.ops == meta.ops
    assert cpu.traffic_bytes == meta.traffic_bytes > 0
    assert cpu.transfers == [0, 0.0]
    if family != "ssm":
        assert cpu.kernel_units["flash_attention"]["calls"] > 0


def test_smoke_deepseek_is_within_the_references_bounds_of_6nd():
    cfg = smoke_config("deepseek-7b").replace(num_layers=3)
    step, state, batch = _train(cfg, "meta", batch=4, seq=64, mb=2)
    st, _ = analysis.count_step(step, state, batch, 0)
    model = 6.0 * cfg.param_counts()["total"] * 64 * 4
    assert 0.6 < st.flops / model < 2.0, (st.flops, model)


def test_attention_pairs_and_costs():
    assert analysis.visible_pairs(4, 4, causal=True, window=0) == 10
    assert analysis.visible_pairs(4, 4, causal=True, window=2) == 7
    assert analysis.visible_pairs(4, 4, causal=False, window=0) == 16
    assert analysis.visible_pairs(2, 5, causal=True, window=0) == 4 + 5
    pos = np.arange(300)
    for w in (0, 1, 7, 64, 400):
        ok = (pos[:, None] >= pos[None]) & (
            (pos[:, None] - pos[None] < w) if w else True)
        assert analysis.visible_pairs(300, 300, causal=True,
                                      window=w) == ok.sum()
    assert analysis.attention_fwd_cost(2, 8, 8, 4, 2, 16, 2, 36) == (
        4.0 * 2 * 4 * 16 * 36, (2.0 * 2 * 8 * 4 * 16 + 2.0 * 2 * 8 * 2 * 16)
        * 2 + 4.0 * 16)
    assert analysis.attention_bwd_cost(2, 8, 8, 4, 2, 16, 2, 36)[0] == \
        10.0 * 2 * 4 * 16 * 36


# ------------------------------------------------------------- meta route
def test_attention_on_meta_is_the_kernel_path_without_a_launch():
    q = torch.empty(2, 64, 8, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 64, 2, 64, dtype=torch.bfloat16, device="meta")
    pos = torch.empty(64, dtype=torch.int32, device="meta")
    res = dispatch.resolve_flash(flash_attention.ENTRY, q)
    assert (res.path, res.route) == ("meta", "tensor_core")
    assert dispatch.resolve_flash_bwd(flash_attention.BWD_ENTRY,
                                      q).path == "meta"
    flash_attention.reset_launches()
    out = ops.flash_attention(q, k, k, pos, pos, window=16)
    grads = ops.flash_attention_bwd(q, k, k, q, pos, pos)
    assert out.device.type == "meta" and out.shape == q.shape
    assert [g.shape for g in grads] == [q.shape, k.shape, k.shape]
    assert sum(flash_attention.launches.values()) == 0
    # outside the envelope: refused on meta as on the card
    wide = torch.empty(1, 8, 1, 512, device="meta")
    with pytest.raises(ValueError, match="envelope"):
        ops.flash_attention(wide, wide, wide, pos[:8], pos[:8])


def test_rows_1_to_10_on_meta_return_empty_outputs():
    spec = AdcSpec(bits=3, vmin=0.0, vmax=1.0)
    x = torch.empty(50, 6, device="meta")
    tables = torch.empty(4, 6, 8, device="meta")
    q = adc_quantize.adc_quantize_population(x, tables, spec=spec)
    assert q.shape == (4, 50, 6) and q.device.type == "meta"
    w1, b1 = torch.empty(4, 6, 3, device="meta"), torch.empty(
        4, 3, device="meta")
    w2, b2 = torch.empty(4, 3, 2, device="meta"), torch.empty(
        4, 2, device="meta")
    assert qmlp.bespoke_mlp_bank(x, tables, w1, b1, w2, b2,
                                 spec=spec).shape == (4, 50, 2)
    assert qmlp.bespoke_svm_bank(x, tables, torch.empty(
        4, 6, 2, device="meta"), b2, spec=spec).shape == (4, 50, 2)
    lb = torch.empty(4, 5, 6, 8, device="meta")
    lo = torch.empty(5, 6, device="meta")
    got = mc_eval.mc_adc_eval_population(x, lb, lb, torch.empty(
        6, 8, device="meta"), lo, lo)
    assert got.shape == (4, 5, 50, 6)
    assert sum(adc_quantize.launches.values()) == 0
    assert sum(qmlp.launches.values()) == 0
    assert sum(mc_eval.launches.values()) == 0
    # priced by the cost model as one unit
    st, _ = analysis.count_step(adc_quantize.adc_quantize_population, x,
                                tables, spec=spec)
    assert st.kernel_units["adc_quantize_population"]["bytes"] == \
        4 * (50 * 6 + 4 * 6 * 8 + 2 * 6 + 4 * 50 * 6)
    assert st.ops == {}


def test_moe_aux_counts_come_from_the_route_starts():
    gen = torch.Generator().manual_seed(0)
    for e, k, t in ((8, 2, 64), (16, 1, 5), (4, 4, 33)):
        ids = torch.randint(0, e, (t, k), generator=gen)
        ids[0] = 0                                # a crowded expert
        r = moe.route(ids, e, 3)
        assert torch.equal(r.counts, torch.bincount(ids.reshape(-1),
                                                    minlength=e))
