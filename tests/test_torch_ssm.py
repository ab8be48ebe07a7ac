"""Port parity, the ssm and hybrid families: repro_torch.models.ssm (the
SSD block, its prefill cache and decode step) against
``repro/models/ssm.py`` on shared numpy-seeded inputs, with the JAX
package's own parameters carried over, at the mamba2 smoke config's SSD
(d_model 64, state 16, head 16, chunk 8) and at a variant with
``ngroups = 2`` (the per-group repeat the smoke configs never take); S a
multiple of the chunk, a non-multiple (the padding path) and S < chunk.
Then the init (constants and scales by path), ``params_from_numpy`` of
both families' trees, prefill + decode == forward inside the port, and
the reference's short-prompt fault, which the port refuses.

Tolerances: rtol = atol = 1e-4 on outputs, cache leaves and logits
(float32; products and sums round in each package's order), as
tests/test_torch_lm.py; gradients rtol 1e-4, atol 1e-6 (GRAD_TOL of
tests/test_torch_lm_train.py); ``A_log`` within two float32 ulps of
log 16 (5e-7: jnp.linspace and XLA's log round differently from
torch's)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import math  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import SSMConfig as JSSM  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import serving as jserving  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import SSMConfig  # noqa: E402
from repro_torch.models import serving, ssm, transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
A_LOG_ATOL = 5e-7
ARCHS = ["mamba2-1.3b", "hymba-1.5b"]
D_MODEL = 64
SSD = {"G1": dict(state_dim=16, head_dim=16, expand=2, ngroups=1,
                  conv_width=4, chunk=8),
       "G2": dict(state_dim=16, head_dim=16, expand=2, ngroups=2,
                  conv_width=4, chunk=8)}
SEQS = [16, 13, 5]         # a chunk multiple, the padding path, S < chunk
B = 2


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(1, 1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _flat(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


def _to_numpy(flat):
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in flat.items()}


def _block(kind, seed=0, dt_bias=None):
    """(jax SSMConfig, port SSMConfig, jax params, port params) of one SSD
    block; the conv biases, dt_bias and norm_w drawn too, so no leaf is
    left at its zero init."""
    js, ts = JSSM(**SSD[kind]), SSMConfig(**SSD[kind])
    jp = _np(jssm.init_ssm(jax.random.PRNGKey(seed), D_MODEL, js))
    rng = np.random.default_rng(seed + 100)
    for name in ("conv_b_x", "conv_b_bc", "dt_bias", "norm_w"):
        jp[name] = (0.3 * rng.normal(size=jp[name].shape)).astype(np.float32)
    if dt_bias is not None:
        jp["dt_bias"] = np.full_like(jp["dt_bias"], dt_bias)
    return js, ts, jp, _torch(jp)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy() if isinstance(
        got, torch.Tensor) else got, np.asarray(want), **(tol or TOL))


# ----------------------------------------------------------- the pieces
@pytest.mark.parametrize("channels", [128, 32, 64])
def test_causal_conv_matches_jax(channels):
    """x (B, S, C) through the depthwise causal conv and SiLU, the conv
    widths of the smoke configs' x (d_inner 128) and B/C (32, 64) parts."""
    rng = np.random.default_rng(channels)
    x = rng.normal(size=(B, 13, channels)).astype(np.float32)
    w = (0.3 * rng.normal(size=(4, channels))).astype(np.float32)
    b = (0.1 * rng.normal(size=(channels,))).astype(np.float32)
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b))
    assert got.shape == (B, 13, channels) and got.dtype == torch.float32
    _close(got, want)
    # causal: the output at t does not see x after t
    x2 = x.copy()
    x2[:, 7:] += 5.0
    got2 = ssm._causal_conv(torch.from_numpy(x2), torch.from_numpy(w),
                            torch.from_numpy(b))
    assert torch.equal(got2[:, :7], got[:, :7])
    assert not torch.equal(got2[:, 7], got[:, 7])


def test_gated_norm_matches_jax():
    rng = np.random.default_rng(1)
    y, z = (rng.normal(size=(B, 9, 128)).astype(np.float32) for _ in range(2))
    w = (0.2 * rng.normal(size=(128,))).astype(np.float32)
    want = jssm._gated_norm(jnp.asarray(y), jnp.asarray(z), jnp.asarray(w))
    got = ssm._gated_norm(torch.from_numpy(y), torch.from_numpy(z),
                          torch.from_numpy(w))
    _close(got, want)


@pytest.mark.parametrize("kind", list(SSD))
@pytest.mark.parametrize("s", SEQS)
def test_ssd_forward_matches_jax(kind, s):
    js, ts, jp, tp = _block(kind, seed=s)
    x = _x((B, s, D_MODEL), s)
    want = jssm.ssd_forward(jp, jnp.asarray(x), D_MODEL, js)
    got = ssm.ssd_forward(tp, torch.from_numpy(x), D_MODEL, ts)
    assert got.shape == (B, s, D_MODEL)
    _close(got, want)


@pytest.mark.parametrize("kind", list(SSD))
@pytest.mark.parametrize("s", SEQS)
def test_ssd_prefill_cache_matches_jax(kind, s):
    """The output and every cache leaf: the raw conv tails of the last
    conv_width - 1 tokens and the float32 state after the last token (the
    padded steps of a ragged last chunk leave it as it is)."""
    js, ts, jp, tp = _block(kind, seed=2 * s)
    x = _x((B, s, D_MODEL), 2 * s)
    want, jc = jssm.ssd_prefill(jp, jnp.asarray(x), D_MODEL, js)
    got, cache = ssm.ssd_prefill(tp, torch.from_numpy(x), D_MODEL, ts)
    _close(got, want)
    assert set(cache) == set(jc) == {"conv_x", "conv_bc", "state"}
    dm = ssm.dims(D_MODEL, ts)
    assert cache["conv_x"].shape == (B, 3, dm["d_in"])
    assert cache["state"].shape == (B, dm["nheads"], ts.state_dim,
                                    ts.head_dim)
    assert cache["state"].dtype == torch.float32
    for key in cache:
        _close(cache[key], jc[key], err_msg=key, **TOL)


@pytest.mark.parametrize("kind", list(SSD))
def test_ssd_decode_chain_matches_jax(kind):
    """Prefill 11 tokens, then 5 decode steps, each fed the reference's
    cache and the port's own: outputs and caches agree at every step."""
    js, ts, jp, tp = _block(kind, seed=7)
    x = _x((B, 16, D_MODEL), 7)
    _, jc = jssm.ssd_prefill(jp, jnp.asarray(x[:, :11]), D_MODEL, js)
    _, cache = ssm.ssd_prefill(tp, torch.from_numpy(x[:, :11]), D_MODEL, ts)
    for t in range(11, 16):
        want, jc = jssm.ssd_decode(jp, jnp.asarray(x[:, t:t + 1]), jc,
                                   D_MODEL, js)
        got, cache = ssm.ssd_decode(tp, torch.from_numpy(x[:, t:t + 1]),
                                    cache, D_MODEL, ts)
        assert got.shape == (B, 1, D_MODEL)
        _close(got, want)
        for key in cache:
            _close(cache[key], jc[key], err_msg=f"step {t} {key}", **TOL)


@pytest.mark.parametrize("kind", list(SSD))
@pytest.mark.parametrize("s", [16, 13, 3])
def test_prefill_then_decode_is_the_forward(kind, s):
    """Inside the port, float32: prefill(S) + decode(k) == forward(S + k)
    at the last k positions (S = 3 is the shortest prompt prefill takes:
    conv_width - 1)."""
    _, ts, _, tp = _block(kind, seed=s + 1)
    k = 4
    x = torch.from_numpy(_x((B, s + k, D_MODEL), s + 1))
    full = ssm.ssd_forward(tp, x, D_MODEL, ts)
    y, cache = ssm.ssd_prefill(tp, x[:, :s], D_MODEL, ts)
    _close(y, full[:, :s].numpy())
    for t in range(s, s + k):
        y, cache = ssm.ssd_decode(tp, x[:, t:t + 1], cache, D_MODEL, ts)
        _close(y, full[:, t:t + 1].numpy())


def _grads(kind, dt_bias, dtype=torch.float32):
    """(jax.grad's, the port's) gradients of mean(ssd_forward * w) with
    respect to x and every leaf, S = 13 (two chunks, the second padded);
    the port's in ``dtype``."""
    js, ts, jp, tp = _block(kind, seed=11, dt_bias=dt_bias)
    x = _x((B, 13, D_MODEL), 11)
    wt = _x((B, 13, D_MODEL), 12)

    def jloss(params, xx):
        return jnp.mean(jssm.ssd_forward(params, xx, D_MODEL, js) * wt)
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    leaves = {k: v.to(dtype).requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    loss = (ssm.ssd_forward(leaves, xt, D_MODEL, ts)
            * torch.from_numpy(wt).to(dtype)).mean()
    loss.backward()
    want = {"x": np.asarray(jg_x), **{k: np.asarray(v)
                                      for k, v in jg_p.items()}}
    got = {"x": xt.grad, **{k: t.grad for k, t in leaves.items()}}
    return want, {k: g.double().numpy() for k, g in got.items()}


@pytest.mark.parametrize("kind", list(SSD))
def test_ssd_forward_gradient_matches_jax_grad(kind):
    """d/d(x, every leaf) of a mean (as the LM's cross-entropy is, so the
    gradients sit at the scale GRAD_TOL's atol was set for) against
    jax.grad."""
    want, got = _grads(kind, None)
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], err_msg=key, **GRAD_TOL)


def test_ssd_gradient_is_finite_at_large_dt():
    """dt_bias = 30 (softplus ~ 30, decay exponents down to -480 a step,
    so the dead branch's exponents reach +3360): the exponent masked
    before exp keeps every gradient finite, in both packages. There both
    float32 gradients lie up to 13x GRAD_TOL from the float64 one
    (conv_w_bc: the reference 3.1e-5, the port 2.2e-5 of a 0.67 maximum),
    so GRAD_TOL cannot compare them with each other: each leaf of the
    port's is held to the float64 gradient (the port's own code in
    float64) within twice the reference's distance from it, or GRAD_TOL."""
    want, got = _grads("G1", 30.0)
    _, truth = _grads("G1", 30.0, dtype=torch.float64)
    for key in want:
        assert np.isfinite(want[key]).all() and np.isfinite(got[key]).all()
        ref_err = np.abs(want[key].astype(np.float64) - truth[key]).max()
        lim = GRAD_TOL["atol"] + GRAD_TOL["rtol"] * np.abs(truth[key])
        port_err = np.abs(got[key] - truth[key])
        assert (port_err <= np.maximum(2 * ref_err, lim)).all(), key
    assert np.abs(want["conv_w_bc"] - truth["conv_w_bc"]).max() > 1e-5


# ---------------------------------------------------------- parameters
@pytest.mark.parametrize("arch", ARCHS)
def test_init_constants_and_scales_by_path(arch):
    """The port's init: A_log = log(linspace(1, 16, H)) and D = 1 (within
    A_LOG_ATOL of the reference's own init, D exactly), the projections
    and out_proj at 1/sqrt(d_model) (out_proj is (d_inner, d), not
    1/sqrt(d_inner)), the conv weights at 0.1, zero conv biases, dt_bias
    and norm gains; the reference's init agrees leaf by leaf (std within
    10 %)."""
    jcfg, cfg = jsmoke(arch), smoke_config(arch)
    d = cfg.d_model
    dm = ssm.dims(d, cfg.ssm)
    own = _flat(transformer.init_params(cfg, seed=3))
    ref = _to_numpy(_flat(_np(jtransformer.init_params(
        jax.random.PRNGKey(3), jcfg))))
    assert set(own) == set(ref)
    n = transformer.scan_len(cfg)
    want = np.log(np.linspace(1.0, 16.0, dm["nheads"])).astype(np.float32)
    np.testing.assert_allclose(own["layers/ssm/A_log"].numpy(),
                               np.broadcast_to(want, (n, dm["nheads"])),
                               rtol=0, atol=A_LOG_ATOL)
    np.testing.assert_allclose(own["layers/ssm/A_log"].numpy(),
                               ref["layers/ssm/A_log"], rtol=0,
                               atol=A_LOG_ATOL)
    assert torch.equal(own["layers/ssm/D"], torch.ones(n, dm["nheads"]))
    np.testing.assert_array_equal(ref["layers/ssm/D"], 1.0)
    for name in ("conv_b_x", "conv_b_bc", "dt_bias", "norm_w"):
        assert not own[f"layers/ssm/{name}"].any(), name
        assert not ref[f"layers/ssm/{name}"].any(), name
    scales = {"z_proj": 1 / math.sqrt(d), "x_proj": 1 / math.sqrt(d),
              "bc_proj": 1 / math.sqrt(d), "dt_proj": 1 / math.sqrt(d),
              "out_proj": 1 / math.sqrt(d), "conv_w_x": 0.1,
              "conv_w_bc": 0.1}
    assert 1 / math.sqrt(d) != 1 / math.sqrt(dm["d_in"])
    for name, scale in scales.items():
        key = f"layers/ssm/{name}"
        assert transformer._init_scale(cfg, ("layers", "ssm", name)) == \
            pytest.approx(scale)
        assert abs(float(own[key].std()) / scale - 1) < 0.1, key
        assert abs(float(ref[key].std()) / scale - 1) < 0.1, key
    if cfg.family == "hybrid":
        for name in ("attn_scale", "ssm_scale", "ln2"):
            assert not own[f"layers/{name}"].any(), name
        assert abs(float(own["layers/wo"].std()) * math.sqrt(cfg.d_ff)
                   - 1) < 0.1


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_round_trips_both_families(arch):
    jcfg, cfg = jsmoke(arch), smoke_config(arch)
    tree = _np(jtransformer.init_params(jax.random.PRNGKey(1), jcfg))
    params = transformer.params_from_numpy(tree, cfg)
    want, got = _to_numpy(_flat(tree)), _to_numpy(_flat(params))
    assert set(got) == set(want)
    assert "layers/ssm/A_log" in got
    assert ("layers/q" in got) == (cfg.family == "hybrid")
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)
    shapes = _flat(transformer.param_shapes(cfg))
    assert {k: tuple(v.shape) for k, v in
            _flat(transformer.init_params(cfg, seed=0)).items()} == {
        k: tuple(v) for k, v in shapes.items()}
    bad = dict(tree, layers=dict(tree["layers"], ssm=dict(
        tree["layers"]["ssm"], D=tree["layers"]["ssm"]["D"][:, 1:])))
    with pytest.raises(ValueError, match="params.layers.ssm.D"):
        transformer.params_from_numpy(bad, cfg)


def test_published_configs_are_accepted_uncut():
    """mamba2-1.3b and hymba-1.5b at their published configs: accepted,
    their trees the published parameter counts, give or take what
    ``param_counts`` leaves out or adds: the conv and dt biases, hymba's
    two branch gains and the final norm are in the tree; an ssm layer
    has no ``ln2``."""
    for name, layers, total in (("mamba2-1.3b", 48, 1_343_625_216),
                                ("hymba-1.5b", 32, 1_640_765_696)):
        cfg = get_config(name)
        transformer.check_supported(cfg)
        assert cfg.num_layers == layers
        assert cfg.param_counts()["total"] == total
        dm = ssm.dims(cfg.d_model, cfg.ssm)
        extra = dm["d_in"] + dm["d_bc"] + dm["nheads"] + (
            2 * cfg.d_model if cfg.family == "hybrid" else -cfg.d_model)
        shapes = _flat(transformer.param_shapes(cfg))
        n = sum(math.prod(s) for s in shapes.values())
        assert n == total + layers * extra + cfg.d_model, (name, n)


# ------------------------------------------------------- short prompts
def test_short_prompt_breaks_the_reference_and_the_port_refuses_it(mesh):
    """A prompt shorter than conv_width - 1 (2 < 3): the reference's
    prefill keeps a 1-token conv tail (S_in - w = -1 wraps) and its decode
    then fails; the port's prefill, the SSD's and serving's, raises
    ValueError naming ROADMAP C, and a 3-token prompt runs."""
    jcfg, cfg = jsmoke("mamba2-1.3b"), smoke_config("mamba2-1.3b")
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    tok = np.array([[3, 5, 7], [2, 4, 6]], np.int32)
    pos = np.broadcast_to(np.arange(3, dtype=np.int32), (2, 3)).copy()
    with compat.set_mesh(mesh):
        _, jc = jserving.prefill(jp, {"tokens": jnp.asarray(tok[:, :2]),
                                      "positions": jnp.asarray(pos[:, :2])},
                                 jcfg, mesh)
        assert jc["conv_x"].shape[2] == 1       # one token, not three
        with pytest.raises(ValueError):
            jserving.decode_step(jp, {"tokens": jnp.asarray(tok[:, 2:]),
                                      "positions": jnp.asarray(pos[:, 2:])},
                                 jc, jcfg, mesh)
    params = transformer.params_from_numpy(_np(jp), cfg)
    short = {"tokens": torch.from_numpy(tok[:, :2]),
             "positions": torch.from_numpy(pos[:, :2])}
    with pytest.raises(ValueError, match="conv_width - 1.*ROADMAP C"):
        serving.prefill(params, short, cfg)
    with pytest.raises(ValueError, match="ROADMAP C"):
        ssm.ssd_prefill(transformer.layer(params, 0)["ssm"],
                        torch.zeros(2, 2, cfg.d_model), cfg.d_model, cfg.ssm)
    full = {"tokens": torch.from_numpy(tok), "positions": torch.from_numpy(pos)}
    _, cache = serving.prefill(params, full, cfg)
    assert cache["conv_x"].shape[2] == 3


def test_serve_launcher_refuses_a_short_ssm_prompt(capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "hymba-1.5b", "--smoke", "--device", "cpu",
                    "--prompt-len", "2"])
    assert exc.value.code == 2
    assert "ROADMAP C" in capsys.readouterr().err


# --------------------------------------------------------- the models
@pytest.mark.parametrize("arch", ARCHS)
def test_model_prefill_and_decode_are_the_forward(arch):
    """Inside the port, float32: the logits of prefill(S) and of each of
    3 decode steps == logits_fn over the whole sequence at that position
    (hymba's window, 32, holds the sequence, so its ring evicts
    nothing)."""
    cfg = smoke_config(arch)
    params = transformer.init_params(cfg, seed=5)
    s, k = 16, 3
    rng = np.random.default_rng(4)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, s + k))
                           .astype(np.int32))
    pos = torch.arange(s + k, dtype=torch.int32)[None].expand(B, -1)
    full = transformer.logits_fn(params, {"tokens": tok, "positions": pos},
                                 cfg)
    log, cache = serving.prefill(params, {"tokens": tok[:, :s],
                                          "positions": pos[:, :s]}, cfg,
                                 extra_slots=k)
    assert ("k" in cache) == (cfg.family == "hybrid")
    _close(log, full[:, s - 1].numpy())
    for t in range(s, s + k):
        log, cache = serving.decode_step(
            params, {"tokens": tok[:, t:t + 1], "positions": pos[:, t:t + 1]},
            cache, cfg)
        _close(log, full[:, t].numpy())
    assert int(cache["pos"]) == s + k


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_equal_the_unrematerialised_ones_bitwise(arch):
    cfg = smoke_config(arch)
    params = transformer.init_params(cfg, seed=3)
    rng = np.random.default_rng(6)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 32))
                           .astype(np.int32))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1),
             "positions": torch.arange(32, dtype=torch.int32)[None].expand(
                 B, -1)}
    out = {}
    for remat in ("none", "full"):
        live = adamw.tree_map(lambda t: t.clone().requires_grad_(True),
                              params)
        loss, m = transformer.loss_fn(live, batch,
                                      dataclasses.replace(cfg, remat=remat))
        assert float(m["aux"]) == 0.0
        loss.backward()
        out[remat] = (loss.detach(), {k: v.grad for k, v in
                                      _flat(live).items()})
    assert torch.equal(out["none"][0], out["full"][0])
    for key, g in out["none"][1].items():
        assert g is not None and torch.equal(g, out["full"][1][key]), key
