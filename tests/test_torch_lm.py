"""Port parity, LM serving: repro_torch.models (transformer, serving,
steps) and repro_torch.launch.serve against the JAX package at smoke size
(smoke_config, float32), with the JAX package's own parameters carried
over by ``params_from_numpy``. On the CPU attention runs the flash
kernel's plain version.

Tolerance: rtol=atol=1e-4 on logits and cache leaves (float32; matmuls,
softmax and RMSNorm round in each package's order; measured below 1e-5).
Inside the port, prefill == forward and decode == teacher forcing use the
JAX package's own tolerances (tests/test_steps_lm.py: 2e-2 and 3e-2)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import serving as jserving  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import serving, steps, transformer  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ["musicgen-medium", "deepseek-7b"]
B, S = 2, 16


def _options_cfg(cfg):
    """deepseek's smoke config with every dense option the port runs:
    sliding window shorter than the prompt, post-norms, tied embeddings,
    attention and final softcaps."""
    return cfg.replace(attn_type="sliding", window=8, post_norm=True,
                       tie_embeddings=True, attn_logit_softcap=30.0,
                       final_logit_softcap=20.0,
                       name="deepseek-7b-options-smoke")


def _configs(arch):
    if arch == "dense-options":
        return (_options_cfg(jsmoke("deepseek-7b")),
                _options_cfg(smoke_config("deepseek-7b")))
    return jsmoke(arch), smoke_config(arch)


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(1, 1)


def _jax_params(jcfg, seed=1):
    return jtransformer.init_params(jax.random.PRNGKey(seed), jcfg)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _batches(cfg, s, seed=0):
    """The same numpy inputs for both packages: (jax batch, port batch)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend:
        out["embeddings"] = rng.random((B, s, cfg.frontend_dim), np.float32)
        out["adc_mask"] = (rng.random((cfg.frontend_dim, 2 ** cfg.adc.bits))
                           < 0.6).astype(np.int32)
        out["adc_mask"][:, 0] = 1
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, s)).astype(
            np.int32)
    out["positions"] = np.broadcast_to(np.arange(s, dtype=np.int32),
                                       (B, s)).copy()
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _slice(batch, lo, hi):
    return {k: (v if k == "adc_mask" else v[:, lo:hi])
            for k, v in batch.items()}


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("arch", ARCHS + ["dense-options"])
def test_logits_fn_matches_jax(arch, mesh):
    jcfg, cfg = _configs(arch)
    jp = _jax_params(jcfg)
    jb, tb = _batches(cfg, S)
    with compat.set_mesh(mesh):
        want = jtransformer.logits_fn(jp, jb, jcfg, mesh)
    params = transformer.params_from_numpy(_np_tree(jp), cfg)
    got = transformer.logits_fn(params, tb, cfg)
    assert got.shape == (B, S, cfg.vocab_size) and got.dtype == torch.float32
    _close(got, want)
    # the nn.Module holds the same tree
    model = transformer.Transformer(cfg, params)
    assert torch.equal(model(tb), got)


def _cache_close(cache, jcache):
    assert set(cache) == set(jcache)
    for key in ("k", "v"):
        _close(cache[key], jcache[key])
    for key in ("kpos", "pos"):
        assert cache[key].dtype == torch.int32
        np.testing.assert_array_equal(cache[key].numpy(),
                                      np.asarray(jcache[key]))


@pytest.mark.parametrize("arch", ARCHS + ["dense-options"])
def test_prefill_and_two_decode_steps_match_jax(arch, mesh):
    """Prefill's logits and every cache leaf, then two decode steps (ring
    eviction at extra_slots=0; a sliding window shorter than the prompt
    for dense-options), logits and cache after each."""
    jcfg, cfg = _configs(arch)
    jp = _jax_params(jcfg)
    jb, tb = _batches(cfg, S + 2, seed=3)
    params = transformer.params_from_numpy(_np_tree(jp), cfg)
    with compat.set_mesh(mesh):
        jlog, jcache = jserving.prefill(jp, _slice(jb, 0, S), jcfg, mesh)
    log, cache = serving.prefill(params, _slice(tb, 0, S), cfg)
    _close(log, jlog)
    _cache_close(cache, jcache)
    for t in range(S, S + 2):
        with compat.set_mesh(mesh):
            jlog, jcache = jserving.decode_step(
                jp, _slice(jb, t, t + 1), jcache, jcfg, mesh)
        log, cache = serving.decode_step(params, _slice(tb, t, t + 1),
                                         cache, cfg)
        assert log.shape == (B, cfg.vocab_size)
        _close(log, jlog)
        _cache_close(cache, jcache)


def test_sliding_ring_slot_matches_jax_off_the_window_grid(mesh):
    """Prompt 13 with window 8: the cache holds positions 5..12 in slots
    0..7 and decode writes slot pos % C = 13 % 8 = 5, which holds position
    10, not the oldest. The port keeps the reference's ring exactly
    (ROADMAP C: the overwritten key is still inside the window, so this
    decode differs from teacher forcing in both packages)."""
    jcfg, cfg = _configs("dense-options")
    jp = _jax_params(jcfg)
    params = transformer.params_from_numpy(_np_tree(jp), cfg)
    jb, tb = _batches(cfg, 14, seed=8)
    with compat.set_mesh(mesh):
        _, jcache = jserving.prefill(jp, _slice(jb, 0, 13), jcfg, mesh,
                                     extra_slots=1)
        jlog, jcache = jserving.decode_step(jp, _slice(jb, 13, 14), jcache,
                                            jcfg, mesh)
    _, cache = serving.prefill(params, _slice(tb, 0, 13), cfg, extra_slots=1)
    assert cache["kpos"].tolist() == list(range(5, 13))
    log, cache = serving.decode_step(params, _slice(tb, 13, 14), cache, cfg)
    assert cache["kpos"].tolist() == [5, 6, 7, 8, 9, 13, 11, 12]
    _close(log, jlog)
    _cache_close(cache, jcache)
    # the lost key shows against teacher forcing (the reference's fault)
    with compat.set_mesh(mesh):
        teacher = jtransformer.logits_fn(jp, jb, jcfg, mesh)[:, -1]
    assert float(jnp.abs(jlog - teacher).max()) > 0.1


@pytest.mark.parametrize("arch", ARCHS + ["mamba2-1.3b", "hymba-1.5b"])
def test_launcher_matches_jax_steps(arch, mesh):
    """The port's launcher, fed the JAX package's init, gives the logits
    the JAX package's steps give on the JAX launcher's inputs
    (make_batch / token_to_batch over default_rng(0)), prefill and every
    decode step. For musicgen each decode input is a fresh random
    embedding; for token archs the JAX steps decode the tokens the port
    sampled (the two samplers' streams differ)."""
    jcfg, cfg = _configs(arch)
    jp = _jax_params(jcfg, seed=0)
    gen, info = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                            "--requests", "2", "--prompt-len", "12",
                            "--gen", "3"], params=_np_tree(jp))
    assert gen.shape == (2, 3)
    assert len(info["logits"]) == 4
    assert info["prefill_flash_launches"] == 0       # CPU: plain version
    rng = np.random.default_rng(0)
    with compat.set_mesh(mesh):
        prefill = jax.jit(jsteps.make_prefill_step(jcfg, mesh))
        decode = jax.jit(jsteps.make_decode_step(jcfg, mesh))
        logits, cache = prefill(jp, jserve.make_batch(jcfg, 2, 12, rng=rng))
        _close(info["logits"][0], logits)
        for i in range(3):
            tok = jnp.asarray(gen[:, i], jnp.int32)
            logits, cache = decode(jp, jserve.token_to_batch(
                jcfg, tok, 12 + i, 2, rng), cache)
            _close(info["logits"][i + 1], logits)


@pytest.mark.parametrize("arch", ARCHS + ["dense-options"])
def test_prefill_matches_forward_in_port(arch):
    cfg = _configs(arch)[1]
    params = transformer.init_params(cfg, seed=5)
    _, tb = _batches(cfg, S, seed=4)
    full = transformer.logits_fn(params, tb, cfg)
    pre, _ = serving.prefill(params, tb, cfg)
    _close(pre, full[:, -1], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ARCHS + ["dense-options"])
def test_decode_matches_teacher_forcing_in_port(arch):
    """Decoding token S after prefill(extra_slots=1) == the forward over
    the extended sequence at its last position."""
    cfg = _configs(arch)[1]
    params = transformer.init_params(cfg, seed=6)
    _, tb = _batches(cfg, S + 1, seed=5)
    want = transformer.logits_fn(params, tb, cfg)[:, -1]
    _, cache = serving.prefill(params, _slice(tb, 0, S), cfg, extra_slots=1)
    assert cache["k"].shape[2] == (S + 1 if cfg.attn_type == "global"
                                   else cfg.window)
    got, cache = serving.decode_step(params, _slice(tb, S, S + 1), cache,
                                     cfg)
    _close(got, want, rtol=3e-2, atol=3e-2)
    assert int(cache["pos"]) == S + 1


@pytest.mark.parametrize("arch", ARCHS + ["dense-options"])
def test_decode_matches_teacher_forcing_in_port_bf16(arch):
    """The served precision: in bfloat16 activations decode after
    prefill(extra_slots=1) == the forward over the extended sequence
    within 6.25e-2 (twice the largest reading over four seeds, 3.1e-2, two
    bf16 ulps of logits of magnitude 2-4), and each path lies as close to
    the float32 forward, so the gap is rounding on both sides. A cache
    fault (each layer reading the next layer's cache) is rejected."""
    limit = 6.25e-2
    cfg = _configs(arch)[1]
    c16 = cfg.replace(dtype="bfloat16")
    params = transformer.init_params(cfg, seed=6)
    _, tb = _batches(cfg, S + 1, seed=5)
    truth = transformer.logits_fn(params, tb, cfg)[:, -1]
    want = transformer.logits_fn(params, tb, c16)[:, -1]
    _, cache = serving.prefill(params, _slice(tb, 0, S), c16, extra_slots=1)
    clean = {k: t.clone() for k, t in cache.items()}
    got, _ = serving.decode_step(params, _slice(tb, S, S + 1), cache, c16)
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= limit
    assert float((got - truth).abs().max()) <= limit
    assert float((want - truth).abs().max()) <= limit
    bad = dict(clean, k=torch.roll(clean["k"], 1, 0),
               v=torch.roll(clean["v"], 1, 0))
    wrong, _ = serving.decode_step(params, _slice(tb, S, S + 1), bad, c16)
    assert float((wrong - want).abs().max()) > 10 * limit


def test_steps_bind_the_config():
    cfg = smoke_config("deepseek-7b")
    params = transformer.init_params(cfg, seed=7)
    _, tb = _batches(cfg, S + 1, seed=6)
    want, cache0 = serving.prefill(params, _slice(tb, 0, S), cfg)
    got, cache = steps.make_prefill_step(cfg)(params, _slice(tb, 0, S))
    assert torch.equal(got, want)
    clone = {k: v.clone() for k, v in cache0.items()}
    d1, _ = serving.decode_step(params, _slice(tb, S, S + 1), cache0, cfg)
    d2, _ = steps.make_decode_step(cfg)(params, _slice(tb, S, S + 1), clone)
    assert torch.equal(d1, d2)


@pytest.mark.parametrize("name,change,match", [
    ("llama4-scout-17b-a16e", {}, "pad_heads_to=48.*ROADMAP C"),
    ("kimi-k2-1t-a32b", {"attn_type": "sliding"},
     "moe with attn_type='sliding'.*ROADMAP C"),
    ("hymba-1.5b", {"attn_type": "local_global"},
     "local_global attention outside the dense family.*ROADMAP C"),
    ("hymba-1.5b", {"pad_heads_to": 8}, "pad_heads_to=8.*ROADMAP C"),
    ("qwen2-vl-72b", {"attn_type": "local_global"},
     "local_global attention outside the dense family.*ROADMAP C"),
    ("gemma2-2b", {}, "pad_heads_to=16.*ROADMAP C"),
    ("deepseek-7b", {"pad_heads_to": 8}, "pad_heads_to=8.*ROADMAP C"),
    ("yi-34b", {"attn_type": "global"}, "pad_heads_to=64.*ROADMAP C"),
])
def test_refusals_name_the_roadmap_item(name, change, match):
    full = name in ("yi-34b", "llama4-scout-17b-a16e", "gemma2-2b")
    cfg = get_config(name) if full else smoke_config(name)
    cfg = dataclasses.replace(cfg, **change)
    for call in (lambda: transformer.check_supported(cfg),
                 lambda: transformer.init_params(cfg),
                 lambda: serving.init_cache(cfg, 1, 4),
                 lambda: transformer.forward({}, {}, cfg),
                 lambda: serving.prefill({}, {}, cfg),
                 lambda: serving.decode_step({}, {}, {}, cfg)):
        with pytest.raises(NotImplementedError, match=match):
            call()


@pytest.mark.parametrize("name", ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b"])
def test_moe_smoke_configs_run(name):
    """The moe family's smoke configs, refused before the moe port, run
    through each entry the refusal test calls (JAX parity:
    tests/test_torch_moe.py)."""
    cfg = smoke_config(name)
    transformer.check_supported(cfg)
    params = transformer.init_params(cfg, seed=0)
    _, tb = _batches(cfg, S + 1, seed=2)
    x = transformer.forward(params, _slice(tb, 0, S), cfg)
    assert x.shape == (B, S, cfg.d_model)
    log, cache = serving.prefill(params, _slice(tb, 0, S), cfg)
    empty = serving.init_cache(cfg, B, S)
    assert {k: v.shape for k, v in empty.items()} == {
        k: v.shape for k, v in cache.items()}
    got, cache = serving.decode_step(params, _slice(tb, S, S + 1), cache,
                                     cfg)
    assert got.shape == (B, cfg.vocab_size)
    assert bool(torch.isfinite(log).all() and torch.isfinite(got).all())
    assert int(cache["pos"]) == S + 1


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_ssm_and_hybrid_smoke_configs_match_jax(arch, mesh):
    """The ssm and hybrid families, refused before their port: logits_fn,
    prefill (logits and every cache leaf: the conv tails and SSD state,
    and hymba's k/v ring over its window) and two decode steps against
    the reference's (block-level parity: tests/test_torch_ssm.py)."""
    jcfg, cfg = _configs(arch)
    jp = _jax_params(jcfg)
    params = transformer.params_from_numpy(_np_tree(jp), cfg)
    jb, tb = _batches(cfg, S + 2, seed=3)
    with compat.set_mesh(mesh):
        want = jtransformer.logits_fn(jp, _slice(jb, 0, S), jcfg, mesh)
        jlog, jcache = jserving.prefill(jp, _slice(jb, 0, S), jcfg, mesh)
    _close(transformer.logits_fn(params, _slice(tb, 0, S), cfg), want)
    log, cache = serving.prefill(params, _slice(tb, 0, S), cfg)
    assert set(cache) == set(jcache)
    assert ("k" in cache) == (cfg.family == "hybrid")
    _close(log, jlog)
    for t in range(S, S + 2):
        for key in cache:
            if key in ("kpos", "pos"):
                np.testing.assert_array_equal(cache[key].numpy(),
                                              np.asarray(jcache[key]))
            else:
                _close(cache[key], jcache[key])
        with compat.set_mesh(mesh):
            jlog, jcache = jserving.decode_step(
                jp, _slice(jb, t, t + 1), jcache, jcfg, mesh)
        log, cache = serving.decode_step(params, _slice(tb, t, t + 1),
                                         cache, cfg)
        _close(log, jlog)
    assert int(cache["pos"]) == S + 2


@pytest.mark.parametrize("kv,moved", [(2, True), (4, True), (1, False)])
def test_padded_heads_change_the_reference_model_under_gqa(kv, moved, mesh):
    """Why the port refuses pad_heads_to > num_heads: in the JAX package
    query head i reads kv head i // (H/KV), and padding raises H/KV, so
    zero heads appended at the end move real heads to other kv heads
    unless KV = 1. phi3 smoke at 4 heads, the same real weights padded to
    8: the logits move with KV=2 (GQA, by 4.57) and KV=4 (MHA, by 4.40)
    and stay put with KV=1 (MQA)."""
    cfg = jsmoke("phi3-mini-3.8b").replace(num_heads=4, num_kv_heads=kv)
    params = _jax_params(cfg, seed=0)
    padded = dict(params, layers=dict(params["layers"]))
    padded["layers"]["q"] = jnp.pad(params["layers"]["q"],
                                    ((0, 0), (0, 0), (0, 4), (0, 0)))
    padded["layers"]["o"] = jnp.pad(params["layers"]["o"],
                                    ((0, 0), (0, 4), (0, 0), (0, 0)))
    jb, _ = _batches(cfg, S, seed=0)
    with compat.set_mesh(mesh):
        want = jtransformer.logits_fn(params, jb, cfg, mesh)
        got = jtransformer.logits_fn(padded, jb, cfg.replace(pad_heads_to=8),
                                     mesh)
    diff = float(jnp.abs(got - want).max())
    if moved:
        assert diff > 1.0, diff
    else:
        assert diff < 1e-4, diff


def test_launcher_refuses_unported_archs(capsys):
    """gemma2-2b's published config pads its heads (ROADMAP C); its smoke
    config serves (tests/test_torch_local_global.py)."""
    with pytest.raises(SystemExit) as exc:
        serve.main(["--arch", "gemma2-2b", "--device", "cpu"])
    assert exc.value.code == 2
    assert "pad_heads_to=16" in capsys.readouterr().err


def test_launcher_serves_mamba2_at_its_defaults(capsys):
    """The call refused before the ssm port runs: 4 requests, a 32-token
    prompt, 16 decode steps, finite logits, no attention kernel (mamba2
    is attention-free)."""
    gen, info = serve.main(["--arch", "mamba2-1.3b", "--smoke", "--device",
                            "cpu"])
    assert gen.shape == (4, 16) and len(info["logits"]) == 17
    assert info["prefill_flash_launches"] == 0
    assert "generated token matrix" in capsys.readouterr().out


def test_rope_refuses_mrope():
    """M-RoPE sections that do not split head_dim / 2 are refused
    (tests/test_torch_vlm.py holds M-RoPE itself)."""
    x = torch.zeros(1, 4, 2, 8)
    from repro_torch.models import layers
    with pytest.raises(ValueError, match="do not sum to head_dim / 2 = 4"):
        layers.rope(x, torch.zeros(1, 4, 3, dtype=torch.int32), 1e4,
                    sections=(1, 1, 1))


@pytest.mark.parametrize("arch", ARCHS + ["dense-options"])
def test_params_from_numpy_round_trips_bitwise(arch):
    jcfg, cfg = _configs(arch)
    tree = _np_tree(_jax_params(jcfg))
    params = transformer.params_from_numpy(tree, cfg)
    flat = {**{k: v for k, v in tree.items() if k != "layers"},
            **{f"layers.{k}": v for k, v in tree["layers"].items()}}
    got = {**{k: v for k, v in params.items() if k != "layers"},
           **{f"layers.{k}": v for k, v in params["layers"].items()}}
    assert set(got) == set(flat)
    for key, want in flat.items():
        back = got[key].numpy()
        assert back.dtype == want.dtype and back.shape == want.shape, key
        np.testing.assert_array_equal(back, want, err_msg=key)
    # the port's own init has the same tree, shapes and dtypes
    own = transformer.init_params(cfg, seed=0)
    assert set(own) == set(params)
    for key, t in own["layers"].items():
        assert t.shape == params["layers"][key].shape
        assert t.dtype == params["layers"][key].dtype
    bad = dict(tree, final_norm=tree["final_norm"][:-1])
    with pytest.raises(ValueError, match="final_norm"):
        transformer.params_from_numpy(bad, cfg)
    with pytest.raises(ValueError, match="leaves"):
        transformer.params_from_numpy(dict(tree, extra=tree["final_norm"]),
                                      cfg)


def test_port_init_is_seeded_and_device_stream():
    cfg = smoke_config("musicgen-medium")
    a = transformer.init_params(cfg, seed=3)
    b = transformer.init_params(cfg, seed=3)
    c = transformer.init_params(cfg, seed=4)
    assert torch.equal(a["layers"]["q"], b["layers"]["q"])
    assert not torch.equal(a["layers"]["q"], c["layers"]["q"])
    assert torch.all(a["layers"]["ln1"] == 0)
    std = float(a["layers"]["wi"].std())
    assert abs(std - 1 / np.sqrt(cfg.d_model)) < 0.02
