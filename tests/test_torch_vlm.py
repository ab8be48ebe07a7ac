"""Port parity, M-RoPE and the vlm family (qwen2-vl): repro_torch's rope,
transformer, serving, train step and launchers against the JAX package at
smoke size (smoke_config("qwen2-vl-72b"): 2 layers, d_model 64, head_dim
16, sections (2, 3, 3), 24 frontend features through the 3-bit ADC,
float32), with the JAX package's parameters carried over by
``params_from_numpy``, on vision prompts: an image of (1, 4, 6) patches at
its M-RoPE grid (``data.lm.mrope_grid_positions``), then text.

Tolerances: logits and cache leaves rtol=atol=1e-4 (tests/test_torch_lm.py's
TOL); loss rtol 1e-5, gradient leaves rtol 1e-4 atol 1e-6, three train steps
as tests/test_torch_lm_train.py bounds them. ``rope`` against the
reference's: each M-RoPE band is bitwise the port's plain rotation of its
section's component; against the reference rtol=atol=1e-6 (torch's float32
pow, cos and sin differ from XLA's by an ulp on some inputs, plain RoPE
included: 2.4e-7 at these positions)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data import lm as jlm  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.mesh import make_host_mesh as jmesh  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import serving as jserving  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import lm  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import layers, serving, steps, transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCH = "qwen2-vl-72b"
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
GRID = (1, 4, 6)
B = 2


@pytest.fixture(scope="module")
def mesh():
    return jmesh(1, 1)


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jsmoke(ARCH), smoke_config(ARCH)
    assert cfg.family == "vlm" and cfg.mrope and cfg.frontend
    jp = jtransformer.init_params(jax.random.PRNGKey(1), jcfg)
    return jcfg, cfg, jp, transformer.params_from_numpy(_np(jp), cfg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _grid(b, text):
    return lm.mrope_grid_positions(b, [GRID], text)


def _batches(cfg, positions, seed):
    """Vision-prompt inputs for both packages: patch embeddings in [0, 1),
    a random ADC level mask (level 0 kept), the given positions."""
    rng = np.random.default_rng(seed)
    b, s = positions.shape[:2]
    out = {"embeddings": rng.random((b, s, cfg.frontend_dim), np.float32),
           "adc_mask": (rng.random((cfg.frontend_dim, 2 ** cfg.adc.bits))
                        < 0.6).astype(np.int32),
           "positions": np.ascontiguousarray(positions)}
    out["adc_mask"][:, 0] = 1
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _slice(batch, lo, hi):
    return {k: (v if k == "adc_mask" else v[:, lo:hi])
            for k, v in batch.items()}


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def test_mrope_grid_positions_follow_the_qwen2_vl_layout():
    """An image of t x h x w patches at (p + t_i, p + h_i, p + w_i), then
    text with equal components from p + max(t, h, w)."""
    pos = lm.mrope_grid_positions(2, [(2, 2, 3), (1, 1, 2)], 3)
    assert pos.shape == (2, 12 + 2 + 3, 3) and pos.dtype == np.int32
    assert pos[0, :3].tolist() == [[0, 0, 0], [0, 0, 1], [0, 0, 2]]
    assert pos[0, 11].tolist() == [1, 1, 2]
    assert pos[0, 12:14].tolist() == [[3, 3, 3], [3, 3, 4]]
    assert pos[0, 14:].tolist() == [[5, 5, 5], [6, 6, 6], [7, 7, 7]]
    assert np.array_equal(pos[0], pos[1])


@pytest.mark.parametrize("dh,sections,theta", [
    (16, (2, 3, 3), 1e4), (128, (16, 24, 24), 1e6)])
def test_mrope_matches_jax_on_a_vision_grid(dh, sections, theta):
    """On distinct (t, h, w) grid positions: each frequency band of the
    port's M-RoPE is bitwise its plain rotation by that band's section's
    component (the band assignment), the whole within 1e-6 of the
    reference's; a wrong assignment (the sections reversed) is not."""
    rng = np.random.default_rng(dh)
    pos = _grid(2, 40)
    x = rng.normal(size=(2, pos.shape[1], 3, dh)).astype(np.float32)
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    got = layers.rope(tx, tpos, theta, sections)
    want = np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta,
                                   sections))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    half = dh // 2
    comp = np.repeat(np.arange(3), sections)
    for c in range(3):
        plain = layers.rope(tx, tpos[..., c], theta)
        band = np.flatnonzero(comp == c)
        for cols in (band, band + half):
            assert torch.equal(got[..., cols], plain[..., cols])
    wrong = layers.rope(tx, tpos, theta, tuple(reversed(sections)))
    assert float((wrong - got).abs().max()) > 1e-2


def test_stacked_equal_components_give_plain_rope_bitwise():
    """With the reference's stacked-equal positions M-RoPE is plain RoPE,
    bitwise; (B, S, 3) positions without sections use component 0."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 30, 4, 16)).astype(np.float32))
    flat = torch.from_numpy(rng.integers(0, 500, (2, 30)).astype(np.int32))
    plain = layers.rope(x, flat, 1e6)
    stacked = flat[..., None].expand(-1, -1, 3).contiguous()
    assert torch.equal(layers.rope(x, stacked, 1e6, (2, 3, 3)), plain)
    grid = torch.from_numpy(_grid(2, 6))
    assert torch.equal(layers.rope(x, grid, 1e6),
                       layers.rope(x, grid[..., 0], 1e6))


def test_logits_fn_matches_jax_on_a_vision_grid(models, mesh):
    jcfg, cfg, jp, params = models
    jb, tb = _batches(cfg, _grid(B, 16), seed=0)
    with compat.set_mesh(mesh):
        want = jtransformer.logits_fn(jp, jb, jcfg, mesh)
    got = transformer.logits_fn(params, tb, cfg)
    assert got.shape == (B, 40, cfg.vocab_size)
    _close(got, want)
    assert torch.equal(transformer.Transformer(cfg, params)(tb), got)
    # the grid's h and w components move the logits
    flat = dict(tb, positions=tb["positions"][..., :1].expand(-1, -1, 3)
                .contiguous())
    assert float((transformer.logits_fn(params, flat, cfg) - got).abs()
                 .max()) > 1e-3


def _same_cache(cache, jcache):
    assert set(cache) == set(jcache) == {"pos", "k", "v", "kpos"}
    for key in cache:
        if key in ("kpos", "pos"):
            np.testing.assert_array_equal(cache[key].numpy(),
                                          np.asarray(jcache[key]))
        else:
            _close(cache[key], jcache[key])


def test_prefill_and_two_decode_steps_match_jax(models, mesh):
    """A text prompt (stacked-equal (B, S, 3) positions, the reference
    launcher's), then two decode steps: logits and every cache leaf."""
    jcfg, cfg, jp, params = models
    pos = np.broadcast_to(np.arange(30, dtype=np.int32)[None, :, None],
                          (B, 30, 3))
    jb, tb = _batches(cfg, pos, seed=3)
    with compat.set_mesh(mesh):
        jlog, jcache = jserving.prefill(jp, _slice(jb, 0, 28), jcfg, mesh)
    log, cache = serving.prefill(params, _slice(tb, 0, 28), cfg)
    _close(log, jlog)
    _same_cache(cache, jcache)
    for t in (28, 29):
        with compat.set_mesh(mesh):
            jlog, jcache = jserving.decode_step(jp, _slice(jb, t, t + 1),
                                                jcache, jcfg, mesh)
        log, cache = serving.decode_step(params, _slice(tb, t, t + 1), cache,
                                         cfg)
        _close(log, jlog)
        _same_cache(cache, jcache)
    assert int(cache["pos"]) == 30


def test_decode_after_a_vision_grid_keeps_the_reference_fault(models, mesh):
    """After a vision prompt the reference's cache takes position for
    token count (ROADMAP C): kpos is the contiguous range ending at the
    last t component (24 image tokens span 6 positions, so the first 18
    slots get negative positions and drop out of decode's attention),
    and decode writes slot pos % C, a prompt token's. The port keeps it:
    its logits and cache match the reference's, and both differ from
    teacher forcing."""
    jcfg, cfg, jp, params = models
    pos = _grid(B, 12)                 # 24 image tokens, then 12 text
    s = pos.shape[1] - 2
    jb, tb = _batches(cfg, pos, seed=4)
    with compat.set_mesh(mesh):
        _, jcache = jserving.prefill(jp, _slice(jb, 0, s), jcfg, mesh,
                                     extra_slots=2)
        jlog, jcache = jserving.decode_step(jp, _slice(jb, s, s + 1), jcache,
                                            jcfg, mesh)
        teacher = jtransformer.logits_fn(jp, _slice(jb, 0, s + 1), jcfg,
                                         mesh)[:, -1]
    _, cache = serving.prefill(params, _slice(tb, 0, s), cfg, extra_slots=2)
    last = int(pos[0, s - 1, 0])
    assert cache["kpos"].tolist()[:s] == list(range(last - s + 1, last + 1))
    assert sum(p < 0 for p in cache["kpos"].tolist()[:s]) == 18
    log, cache = serving.decode_step(params, _slice(tb, s, s + 1), cache, cfg)
    _close(log, jlog)
    _same_cache(cache, jcache)
    assert float(jnp.abs(jlog - teacher).max()) > 0.1
    assert float((log - torch.from_numpy(np.array(teacher))).abs()
                 .max()) > 0.1


def test_params_from_numpy_round_trips_bitwise(models):
    jcfg, cfg, jp, params = models
    tree = _np(jp)
    assert set(params) == set(tree) == {"final_norm", "front_proj", "head",
                                        "layers"}
    for key in ("final_norm", "front_proj", "head"):
        np.testing.assert_array_equal(params[key].numpy(), tree[key])
    for key, want in tree["layers"].items():
        np.testing.assert_array_equal(params["layers"][key].numpy(), want)
    own = transformer.init_params(cfg, seed=0)
    assert {k: v.shape for k, v in own["layers"].items()} == {
        k: v.shape for k, v in params["layers"].items()}


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


def _data(jcfg, cfg, seq, batch, microbatches):
    kw = dict(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
              microbatches=microbatches)
    return (jlm.SyntheticLM(jlm.LMDataConfig(**kw), jcfg),
            lm.SyntheticLM(lm.LMDataConfig(**kw), cfg))


def _on_grid(batch, grid):
    """A corpus batch with its positions replaced by a vision grid,
    through the microbatch axis."""
    return {k: (grid.reshape(v.shape) if k == "positions" else v)
            for k, v in batch.items()}


def test_loss_and_every_gradient_leaf_match_jax_on_a_vision_grid(models,
                                                                 mesh):
    jcfg, cfg, jp, _ = models
    jdata, data = _data(jcfg, cfg, 40, 2, 1)
    grid = _grid(2, 16)
    jb = {k: (v if k == "adc_mask" else v[0])
          for k, v in _on_grid(jdata.batch_at(0), grid).items()}
    with compat.set_mesh(mesh):
        (jloss, _), jg = jax.value_and_grad(
            lambda p: jtransformer.loss_fn(p, jb, jcfg, mesh),
            has_aux=True)(jp)
    params = adamw.tree_map(lambda t: t.requires_grad_(True),
                            transformer.params_from_numpy(_np(jp), cfg))
    tb = {k: (v if k == "adc_mask" else v[0]) for k, v in _on_grid(
        data.device_batch(0), torch.from_numpy(grid)).items()}
    assert tb["positions"].shape == (2, 40, 3)
    loss, _ = transformer.loss_fn(params, tb, cfg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    loss.backward()
    want = _jax_flat(jg)
    got = {k: v.grad.numpy() for k, v in _flat(params).items()}
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **GRAD_TOL)


def test_three_train_steps_match_the_reference_on_a_vision_grid(models,
                                                                mesh):
    """The microbatched AdamW step (batch 4 x 40 in 2 microbatches, remat
    on), the grid's (n_mb, b, S, 3) positions carried through the
    microbatch axis."""
    jcfg, cfg, _, _ = models
    jcfg, cfg = jcfg.replace(remat="full"), cfg.replace(remat="full")
    seq, batch, mb = 40, 4, 2
    jdata, data = _data(jcfg, cfg, seq, batch, mb)
    grid = _grid(batch, 16)
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
            tbatch = _on_grid(data.device_batch(i), torch.from_numpy(grid))
            assert tbatch["positions"].shape == (mb, batch // mb, seq, 3)
            jstate, jm = jstep(jstate, _on_grid(jdata.device_batch(i), grid),
                               jnp.asarray(i, jnp.int32))
            state, m = step(state, tbatch, i)
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
    """``launch.serve --arch qwen2-vl-72b --smoke`` from the JAX package's
    init: the JAX steps' logits on the JAX launcher's inputs (fresh
    random patch embeddings every decode step, stacked positions)."""
    jcfg = jsmoke(ARCH)
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    gen, info = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                            "--requests", "2", "--prompt-len", "12",
                            "--gen", "3"], params=_np(jp))
    assert gen.shape == (2, 3) and len(info["logits"]) == 4
    rng = np.random.default_rng(0)
    with compat.set_mesh(mesh):
        prefill = jax.jit(jsteps.make_prefill_step(jcfg, mesh))
        decode = jax.jit(jsteps.make_decode_step(jcfg, mesh))
        logits, cache = prefill(jp, jserve.make_batch(jcfg, 2, 12, rng=rng))
        _close(info["logits"][0], logits)
        for i in range(3):
            logits, cache = decode(jp, jserve.token_to_batch(
                jcfg, jnp.asarray(gen[:, i], jnp.int32), 12 + i, 2, rng),
                cache)
            _close(info["logits"][i + 1], logits)


def test_launcher_trains_the_smoke_config_as_the_reference(tmp_path, capsys,
                                                           monkeypatch):
    argv = ["--arch", ARCH, "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "32", "--log-every", "1"]
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


@pytest.mark.parametrize("what", ["weight-sharding model axis",
                                  "make_production_mesh"])
def test_what_stays_refused_names_the_roadmap_item(what):
    """The train step refuses what later slices of ROADMAP A11 port: the
    production mesh the dry run counts against (abstract since A11.7: a
    step over it is A11.9's) and a 'model' axis that would split the ssm
    family's weights (A11.9). A 'model' axis splitting the vlm's weights
    (tensor parallelism) runs since A11.9's TP slice: its step on a
    (1, 2) mesh, uncompressed and int8, holds its weights split and
    gives the unsplit step's loss within float32 sum order."""
    cfg = smoke_config(ARCH)
    shape = ShapeConfig("t", 32, 4, "train")
    if what == "make_production_mesh":
        with pytest.raises(NotImplementedError, match="ROADMAP A11.9"):
            steps.make_train_step(cfg, tmesh.make_production_mesh(), shape,
                                  microbatches=2)
        return
    tp = tmesh.make_mesh((1, 2), ("data", "model"), devices=["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="ssm family.*A11.9"):
        steps.make_train_step(smoke_config("mamba2-1.3b"), tp, shape,
                              microbatches=2)
    data = lm.SyntheticLM(lm.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=32, global_batch=4,
        microbatches=2), cfg)
    for c in (cfg, cfg.replace(grad_compression="int8")):
        losses = []
        for mesh in (tp, tmesh.make_host_mesh(1, 1, device="cpu")):
            state = steps.init_state(c, seed=0, device="cpu", mesh=mesh)
            assert isinstance(state.params["layers"]["q"], list) == (
                mesh is tp)
            step = steps.make_train_step(c, mesh, shape, microbatches=2)
            losses.append(float(step(state, data.device_batch(0), 0)[1][
                "loss"]))
        np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)
    # the same mesh's 'data' axis alone is data parallelism, which runs
    two = tmesh.make_mesh((2, 1), ("data", "model"), devices=["cpu", "cpu"])
    assert callable(steps.make_train_step(cfg, two, shape, microbatches=2))
