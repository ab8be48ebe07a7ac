"""Port parity, ``local_global`` attention (gemma2): repro_torch's
transformer, serving, train step and launchers against the JAX package at
smoke size (smoke_config("gemma2-2b"): one (local, global) layer pair,
d_model 64, window 32, float32), with the JAX package's parameters carried
over by ``params_from_numpy``; and the dh-256 envelope of the attention
backward (csrc/flash_attention_bwd.cu's 32-row tiles), which needs no card.

Tolerances: logits and cache leaves rtol=atol=1e-4 (tests/test_torch_lm.py's
TOL); loss rtol 1e-5, gradient leaves rtol 1e-4 atol 1e-6, three train steps
as tests/test_torch_lm_train.py bounds them (loss, lr, grad_norm rtol 1e-4;
AdamW moments rtol 1e-3 with atol 3e-7 / 1e-12; params atol 2e-5)."""
import pytest

torch = pytest.importorskip("torch")

import re  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data import lm as jlm  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import serving as jserving  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import lm  # noqa: E402
from repro_torch.kernels import envelope  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import serving, steps, transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCH = "gemma2-2b"
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
B = 2


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(1, 1)


@pytest.fixture(scope="module")
def models():
    """(jax config, port config, jax params, port params): the smoke
    config's one (local, global) pair, window 32."""
    jcfg, cfg = jsmoke(ARCH), smoke_config(ARCH)
    assert cfg.attn_type == "local_global" and cfg.window == 32
    assert transformer.scan_len(cfg) == 1 == cfg.num_layers // 2
    jp = jtransformer.init_params(jax.random.PRNGKey(1), jcfg)
    return jcfg, cfg, jp, transformer.params_from_numpy(_np(jp), cfg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(cfg, s, seed):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32),
           "positions": np.broadcast_to(np.arange(s, dtype=np.int32),
                                        (B, s)).copy()}
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _slice(batch, lo, hi):
    return {k: v[:, lo:hi] for k, v in batch.items()}


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def test_logits_fn_matches_jax_where_the_window_binds(models, mesh):
    """S = 80, over twice the window: the local layer masks keys 32 back,
    the global layer none."""
    jcfg, cfg, jp, params = models
    jb, tb = _batches(cfg, 80, seed=0)
    with compat.set_mesh(mesh):
        want = jtransformer.logits_fn(jp, jb, jcfg, mesh)
    got = transformer.logits_fn(params, tb, cfg)
    assert got.shape == (B, 80, cfg.vocab_size)
    _close(got, want)
    assert torch.equal(transformer.Transformer(cfg, params)(tb), got)
    # the window binds: a global local layer gives other logits
    wide = transformer.logits_fn(params, tb, cfg.replace(window=4096))
    assert float((wide - got).abs().max()) > 1e-3


def test_prefill_and_two_decode_steps_match_jax_off_the_window_grid(
        models, mesh):
    """A 45-token prompt (45 % 32 = 13: off the local ring's grid), then
    two decode steps: logits and every cache leaf after each, the local
    ring's kpos holding positions 13..44 and decode writing slot pos % 32
    (the reference's rule, ROADMAP C), the global cache 45 + 2 long."""
    jcfg, cfg, jp, params = models
    s = 45
    jb, tb = _batches(cfg, s + 2, seed=3)
    with compat.set_mesh(mesh):
        jlog, jcache = jserving.prefill(jp, _slice(jb, 0, s), jcfg, mesh,
                                        extra_slots=2)
    log, cache = serving.prefill(params, _slice(tb, 0, s), cfg,
                                 extra_slots=2)
    assert set(cache) == set(jcache) == {"pos", "k", "v", "kpos", "k2", "v2",
                                         "kpos2"}
    assert cache["k"].shape[2] == 32 and cache["k2"].shape[2] == s + 2
    assert cache["kpos"].tolist() == list(range(13, 45))
    assert cache["kpos2"].tolist() == list(range(45)) + [-1, -1]

    def same(cache, jcache):
        for key in cache:
            if key in ("kpos", "kpos2", "pos"):
                assert cache[key].dtype == torch.int32
                np.testing.assert_array_equal(cache[key].numpy(),
                                              np.asarray(jcache[key]))
            else:
                _close(cache[key], jcache[key])
    _close(log, jlog)
    same(cache, jcache)
    for t in range(s, s + 2):
        with compat.set_mesh(mesh):
            jlog, jcache = jserving.decode_step(jp, _slice(jb, t, t + 1),
                                                jcache, jcfg, mesh)
        log, cache = serving.decode_step(params, _slice(tb, t, t + 1), cache,
                                         cfg)
        _close(log, jlog)
        same(cache, jcache)
    assert cache["kpos"][45 % 32] == 45 and cache["kpos"][46 % 32] == 46
    assert cache["kpos2"].tolist()[-2:] == [45, 46]


def test_prefill_and_decode_in_the_port_on_the_window_grid(models):
    """A 64-token prompt (on the grid): prefill == the forward's last
    position, and decode after prefill(extra_slots=1) == teacher forcing
    (tests/test_torch_lm.py's 2e-2 and 3e-2); zeroing the local ring or
    the global cache fails the latter."""
    _, cfg, _, params = models
    _, tb = _batches(cfg, 65, seed=5)
    full = transformer.logits_fn(params, tb, cfg)
    pre, _ = serving.prefill(params, _slice(tb, 0, 64), cfg)
    _close(pre, full[:, 63], rtol=2e-2, atol=2e-2)
    _, cache = serving.prefill(params, _slice(tb, 0, 64), cfg, extra_slots=1)
    clean = {k: t.clone() for k, t in cache.items()}
    got, cache = serving.decode_step(params, _slice(tb, 64, 65), cache, cfg)
    _close(got, full[:, 64], rtol=3e-2, atol=3e-2)
    assert int(cache["pos"]) == 65
    for keys in (("k", "v"), ("k2", "v2")):
        bad = {k: (t.clone().zero_() if k in keys else t.clone())
               for k, t in clean.items()}
        wrong, _ = serving.decode_step(params, _slice(tb, 64, 65), bad, cfg)
        assert float((wrong - full[:, 64]).abs().max()) > 3e-2, keys


def test_params_from_numpy_round_trips_layers2_bitwise(models):
    jcfg, cfg, jp, params = models
    tree = _np(jp)
    assert set(params) == set(tree) == {"final_norm", "embed", "layers",
                                        "layers2"}
    for stack in ("layers", "layers2"):
        assert set(params[stack]) == set(tree[stack])
        for key, want in tree[stack].items():
            back = params[stack][key].numpy()
            assert back.dtype == want.dtype and back.shape == want.shape
            np.testing.assert_array_equal(back, want, err_msg=key)
    own = transformer.init_params(cfg, seed=0)
    assert {k: v.shape for k, v in own["layers2"].items()} == {
        k: v.shape for k, v in params["layers2"].items()}
    assert not torch.equal(own["layers"]["q"], own["layers2"]["q"])
    with pytest.raises(ValueError, match="leaves"):
        transformer.params_from_numpy(
            {k: v for k, v in tree.items() if k != "layers2"}, cfg)


def _data(jcfg, cfg, seq, batch, microbatches):
    kw = dict(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
              microbatches=microbatches)
    return (jlm.SyntheticLM(jlm.LMDataConfig(**kw), jcfg),
            lm.SyntheticLM(lm.LMDataConfig(**kw), cfg))


def _flat(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


def _jax_flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_loss_and_every_gradient_leaf_match_jax(models, mesh):
    """64-token rows (the window binds): the loss and the gradient of
    every leaf of both stacks."""
    jcfg, cfg, jp, _ = models
    jdata, data = _data(jcfg, cfg, 64, 2, 1)
    jb = {k: v[0] for k, v in jdata.batch_at(0).items()}
    with compat.set_mesh(mesh):
        (jloss, _), jg = jax.value_and_grad(
            lambda p: jtransformer.loss_fn(p, jb, jcfg, mesh),
            has_aux=True)(jp)
    params = adamw.tree_map(lambda t: t.requires_grad_(True),
                            transformer.params_from_numpy(_np(jp), cfg))
    tb = {k: v[0] for k, v in data.device_batch(0).items()}
    loss, _ = transformer.loss_fn(params, tb, cfg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    loss.backward()
    want = _jax_flat(jg)
    got = {k: v.grad.numpy() for k, v in _flat(params).items()}
    assert set(got) == set(want) and any(k.startswith("layers2/")
                                         for k in got)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **GRAD_TOL)


def test_three_train_steps_match_the_reference(models, mesh):
    """The microbatched AdamW step (batch 4 x 64 in 2 microbatches),
    remat on: every layer of ``layers2`` among the autograd leaves."""
    jcfg, cfg, _, _ = models
    jcfg, cfg = jcfg.replace(remat="full"), cfg.replace(remat="full")
    seq, batch, mb = 64, 4, 2
    jdata, data = _data(jcfg, cfg, seq, batch, mb)
    _, leaves = steps._autograd_leaves(transformer.init_params(cfg))
    assert len(leaves) == len(_flat(transformer.init_params(cfg)))
    with compat.set_mesh(mesh):
        jstate = jsteps.init_state(jax.random.PRNGKey(0), jcfg, mesh)
        params = transformer.params_from_numpy(_np(jstate.params), cfg)
        state = steps.TrainState(params, adamw.init_tree(params))
        jstep = jax.jit(jsteps.make_train_step(
            jcfg, mesh, JShape("t", seq, batch, "train"), microbatches=mb,
            total_steps=30))
        step = steps.make_train_step(cfg, None, ShapeConfig(
            "t", seq, batch, "train"), microbatches=mb, total_steps=30)
        for i in range(3):
            jstate, jm = jstep(jstate, jdata.device_batch(i),
                               jnp.asarray(i, jnp.int32))
            state, m = step(state, data.device_batch(i), i)
            for key in ("loss", "lr", "grad_norm"):
                np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                           rtol=1e-4, err_msg=key)
    for name, got, want, tol in (
            ("m", state.opt.m, jstate.opt.m, dict(rtol=1e-3, atol=3e-7)),
            ("v", state.opt.v, jstate.opt.v, dict(rtol=1e-3, atol=1e-12)),
            ("params", state.params, jstate.params, dict(rtol=0,
                                                         atol=2e-5))):
        want, got = _jax_flat(want), {k: v.numpy()
                                      for k, v in _flat(got).items()}
        assert set(got) == set(want), name
        for key in want:
            np.testing.assert_allclose(got[key], want[key],
                                       err_msg=f"{name}/{key}", **tol)


def test_launcher_serves_the_smoke_config_as_the_reference_steps(mesh):
    """``launch.serve --arch gemma2-2b --smoke`` (a 40-token prompt over
    the window 32, 3 decode steps), from the JAX package's init: the JAX
    steps' logits on the JAX launcher's inputs, decoding the tokens the
    port sampled."""
    jcfg = jsmoke(ARCH)
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    gen, info = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--requests", "2", "--prompt-len", "40",
                            "--gen", "3"], params=_np(jp))
    assert gen.shape == (2, 3) and len(info["logits"]) == 4
    rng = np.random.default_rng(0)
    with compat.set_mesh(mesh):
        prefill = jax.jit(jsteps.make_prefill_step(jcfg, mesh))
        decode = jax.jit(jsteps.make_decode_step(jcfg, mesh))
        logits, cache = prefill(jp, jserve.make_batch(jcfg, 2, 40, rng=rng))
        _close(info["logits"][0], logits)
        for i in range(3):
            logits, cache = decode(jp, jserve.token_to_batch(
                jcfg, jnp.asarray(gen[:, i], jnp.int32), 40 + i, 2, rng),
                cache)
            _close(info["logits"][i + 1], logits)


def test_launcher_trains_the_smoke_config_as_the_reference(tmp_path, capsys,
                                                           monkeypatch):
    """``launch.train --arch gemma2-2b --smoke --steps 4 --batch 2 --seq
    64``, from the reference launcher's init: its losses and verdict, and
    a final checkpoint."""
    argv = ["--arch", ARCH, "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "64", "--log-every", "1"]
    init = _np(jtransformer.init_params(jax.random.PRNGKey(0), jsmoke(ARCH)))
    monkeypatch.setattr(
        transformer, "init_params",
        lambda cfg, *, seed, device: transformer.params_from_numpy(
            init, cfg, device=device))
    outs, raised = [], []
    for run in (lambda: jtrain.main(argv + ["--ckpt-dir",
                                            str(tmp_path / "j")]),
                lambda: ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "t"),
                                            "--device", "cpu"])):
        try:
            run()
            raised.append(False)
        except AssertionError as exc:    # the reference's check, kept
            assert "loss did not improve" in str(exc)
            raised.append(True)
        outs.append(capsys.readouterr().out)

    def losses(text):
        return [float(line.split()[3]) for line in text.splitlines()
                if line.startswith("step ")]
    assert raised[0] == raised[1]
    assert len(losses(outs[1])) == 4
    np.testing.assert_allclose(losses(outs[1]), losses(outs[0]), rtol=1e-4)
    assert CheckpointManager(tmp_path / "t").all_steps() == [4]


@pytest.mark.parametrize("name,change", [
    ("hymba-1.5b", {}), ("mamba2-1.3b", {}), ("musicgen-medium", {}),
    ("kimi-k2-1t-a32b", {}), ("qwen2-vl-72b", {}),
    ("deepseek-7b", {"num_layers": 3, "family": "dense"})])
def test_local_global_is_refused_outside_the_dense_family(name, change):
    """The reference's decode defines local_global only for the dense
    family (ROADMAP C): the port refuses it elsewhere; an odd layer count
    has no pairs."""
    cfg = smoke_config(name).replace(attn_type="local_global", **change)
    if cfg.family == "dense":
        with pytest.raises(ValueError, match="even num_layers"):
            transformer.check_supported(cfg)
        return
    for call in (lambda: transformer.check_supported(cfg),
                 lambda: transformer.init_params(cfg),
                 lambda: serving.init_cache(cfg, 1, 4)):
        with pytest.raises(NotImplementedError,
                           match="local_global.*dense family.*ROADMAP C"):
            call()


def test_published_config_pads_its_heads_and_is_refused(capsys):
    """gemma2-2b's published config pads 8 heads to 16 over 4 kv heads,
    which is not the published model (ROADMAP C): refused by the model
    and both launchers; unpadded it runs."""
    cfg = get_config(ARCH)
    with pytest.raises(NotImplementedError, match="pad_heads_to=16.*ROADMAP C"):
        transformer.check_supported(cfg)
    for main in (serve.main, ttrain.main):
        with pytest.raises(SystemExit) as exc:
            main(["--arch", ARCH, "--device", "cpu"])
        assert exc.value.code == 2
        assert re.search("pad_heads_to=16.*ROADMAP C",
                         capsys.readouterr().err)
    transformer.check_supported(cfg.replace(pad_heads_to=0))


def test_backward_envelope_at_head_dim_256():
    """csrc/flash_attention_bwd.cu at DHP 256: 32-row tiles, each pass's
    shared memory by the formula (T rows of DHP + 4 words, P and dS rows
    of T + 1) under the H100's 232,448 bytes, the CUDA-core route in
    float32 (and in bf16 below 256, where the tensor-core backward has no
    instantiation), and the grid counted in 32-row tiles."""
    t, ld = 32, 256 + 4
    want = [4 * (4 * t * ld + 2 * t),
            4 * (4 * t * ld + 2 * t * (t + 1) + 4 * t),
            4 * (4 * t * ld + t * (t + 1) + 4 * t)]
    got = [envelope.flash_bwd_smem_bytes(p, 256) for p in range(3)]
    assert got == want == [133_376, 142_080, 137_856]
    assert max(got) < envelope.SMEM_MAX_BYTES == 232_448
    # a 64-row tile would not fit: the statistics pass alone
    assert 4 * (4 * 64 * ld + 2 * 64) == 266_752 > envelope.SMEM_MAX_BYTES
    for dh in (129, 200, 256):
        assert envelope.flash_bwd_head_pad(dh) == 256
        assert envelope.flash_bwd_tile(dh) == 32
        # bf16 at 256 takes the tensor-core backward (Cfg<256>)
        assert envelope.flash_bwd_route(True, dh) == (
            "tensor_core" if dh == 256 else "cuda_core")
        assert envelope.flash_bwd_route(False, dh) == "cuda_core"
        assert envelope.outside_flash_bwd_envelope(1, 8192, 8, dh) is None
    assert envelope.flash_bwd_tile(128) == envelope.flash_bwd_tile(64) == 64
    assert envelope.FLASH_BWD_MAX_HEAD_DIM == 256
    assert "head_dim=257" in envelope.outside_flash_bwd_envelope(1, 64, 8,
                                                                 257)
    # the grid: ceil(S / 32) tiles x B x H blocks against gridDim.x
    limit = envelope.MAX_BLOCKS_1D
    h = limit // 64 + 1                 # 64 tiles of 32 rows at S = 2048
    assert "blocks" in envelope.outside_flash_bwd_envelope(1, 2048, h, 256)
    assert envelope.outside_flash_bwd_envelope(1, 2048, h, 128) is None
