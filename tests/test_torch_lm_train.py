"""Port parity, LM training: repro_torch's schedule, synthetic corpus,
loss, gradients, microbatched AdamW train step, checkpoints and launcher
against the JAX package at smoke size (smoke_config: 2 layers, d_model 64,
float32), with the JAX package's parameters carried over by
``params_from_numpy`` and batches made by each package's ``SyntheticLM``
from one seed. On the CPU attention and its gradient run the plain
versions (the reference's attention is its jnp ``layers.attention``).

Tolerances (float32; sums round in each package's order): the schedule
bitwise in the warmup and within one ulp of the peak rate on the cosine;
batches bitwise; loss rtol 1e-5; gradient leaves rtol 1e-4,
atol 1e-6 (measured: below 0.4 of that limit); three train steps: loss,
lr and grad_norm rtol 1e-4, AdamW moments rtol 1e-3 (with the gradient
check's atol carried through: m sums 0.1 * 0.9^k of three gradients, so
atol 0.271e-6 -> 3e-7; v of squares, 1e-12), params atol 2e-5.
The params bound is loose on purpose: an AdamW update moves an element by
about lr (1e-5 at these steps of the warmup) whatever the gradient's size,
so a params check cannot see a gradient error; the moments, which carry
the gradients themselves, are the strong check."""
import pytest

torch = pytest.importorskip("torch")

import pathlib  # noqa: E402
import re  # noqa: E402
import types  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JCkpt  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data import lm as jlm  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import lm  # noqa: E402
from repro_torch.distributed import fault as tfault  # noqa: E402
from repro_torch.kernels import flash_attention, ops  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import steps, transformer  # noqa: E402
from repro_torch.optim import adamw, schedule  # noqa: E402

ARCHS = ["deepseek-7b", "phi3-mini-3.8b", "musicgen-medium"]
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
SEQ, BATCH, MB = 32, 4, 2


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(1, 1)


def _options(cfg):
    """deepseek's smoke config with every dense option the port trains: a
    sliding window shorter than the sequence, post-norms, tied
    embeddings, attention and final softcaps."""
    return cfg.replace(attn_type="sliding", window=8, post_norm=True,
                       tie_embeddings=True, attn_logit_softcap=30.0,
                       final_logit_softcap=20.0,
                       name="deepseek-7b-options-smoke")


def _configs(arch):
    if arch == "dense-options":
        return _options(jsmoke("deepseek-7b")), _options(
            smoke_config("deepseek-7b"))
    return jsmoke(arch), smoke_config(arch)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_flat(tree):
    """{"a/b": numpy leaf} of a JAX tree, in its leaf order."""
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(tree, prefix=""):
    out = {}
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.update(_port_flat(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value.detach().numpy()
    return out


def _data(jcfg, cfg, microbatches=MB, seq=SEQ, batch=BATCH):
    kw = dict(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
              microbatches=microbatches)
    return (jlm.SyntheticLM(jlm.LMDataConfig(**kw), jcfg),
            lm.SyntheticLM(lm.LMDataConfig(**kw), cfg))


def _requires_grad(params):
    return {k: ({kk: vv.requires_grad_(True) for kk, vv in v.items()}
                if k == "layers" else v.requires_grad_(True))
            for k, v in params.items()}


# ------------------------------------------------------------- schedule
@pytest.mark.parametrize("total", [250, 10_000])
def test_warmup_cosine_matches_reference(total):
    got = np.array([float(schedule.warmup_cosine(s, peak_lr=3e-4,
                                                 total=total))
                    for s in range(301)], np.float32)
    want = np.array([np.asarray(jschedule.warmup_cosine(
        s, peak_lr=3e-4, total=total)) for s in range(301)], np.float32)
    # the warmup is the same float32 arithmetic: bitwise; the cosine is
    # XLA's cos against glibc's (an ulp apart at places), which the
    # cancellation in 1 + cos amplifies to 3 ulps of the value near the
    # floor (step 225 of 250): within one ulp of the peak rate there
    np.testing.assert_array_equal(got[:99], want[:99])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=np.spacing(np.float32(3e-4)))
    assert got[0] > 0 and got.dtype == np.float32
    lr = schedule.warmup_cosine(torch.tensor(7), peak_lr=1.0)
    assert lr.dtype == torch.float32 and lr.ndim == 0


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["deepseek-7b", "musicgen-medium"])
def test_synthetic_batches_are_bitwise_the_reference(arch):
    jcfg, cfg = _configs(arch)
    jdata, data = _data(jcfg, cfg, microbatches=2, seq=24, batch=6)
    for step in (0, 1, 17):
        want, got = jdata.batch_at(step), data.batch_at(step)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key])
        if cfg.frontend:
            assert got["embeddings"].shape == (2, 3, 24, cfg.frontend_dim)
            assert got["adc_mask"].shape == (cfg.frontend_dim,
                                             2 ** cfg.adc.bits)
        else:
            assert got["tokens"].shape == (2, 3, 24)
        dev = data.device_batch(step, "cpu")
        for key in want:
            assert isinstance(dev[key], torch.Tensor)
            np.testing.assert_array_equal(dev[key].numpy(), want[key])


# --------------------------------------------------- attention gradient
# (b, s, h, kv, dh, window, softcap, reference q_block): causal; a window
# on the reference's banded path (window + q_block < S); a softcap; GQA
# with a window and a softcap
ATTN_CASES = [(2, 48, 4, 4, 16, None, 0.0, 512),
              (1, 64, 4, 2, 16, 12, 0.0, 16),
              (2, 40, 4, 2, 8, None, 20.0, 512),
              (1, 64, 8, 2, 16, 20, 30.0, 16)]


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_attention_gradient_matches_jax_grad(case):
    b, s, h, kv, dh, window, cap, q_block = case
    rng = np.random.default_rng(sum(case[:5]))
    q = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, dh)).astype(np.float32)
    do = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)

    def f(q_, k_, v_):
        out = jlayers.attention(q_, k_, v_, q_positions=jnp.asarray(pos),
                                k_positions=jnp.asarray(pos), causal=True,
                                window=window, attn_softcap=cap,
                                q_block=q_block)
        return jnp.sum(out * do)
    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    out = ops.attention(tq, tk, tv, tpos, tpos, window=window or 0,
                        attn_softcap=cap)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    # the backward entry is the same gradient, and counts no launch here
    flash_attention.reset_launches()
    direct = ops.flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(),
                                     torch.from_numpy(do), tpos, tpos,
                                     window=window or 0, attn_softcap=cap)
    for g, d in zip(got, direct):
        assert torch.equal(g, d)
    assert flash_attention.launches["flash_attention_bwd"] == 0


def test_backward_wrapper_checks_without_a_card():
    """The backward wrapper's checks, without building the kernel: shapes
    on every device, and (on the operands a CUDA call would pass) device,
    dtype and contiguity; the envelope (head widths up to 128)."""
    from repro_torch.kernels import dispatch, envelope
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    pos = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="flash_attention_bwd: dout"):
        flash_attention.flash_attention_bwd(q, k, k, q[:, :4], pos, pos)
    with pytest.raises(ValueError, match="flash_attention"):
        flash_attention.flash_attention_bwd(q, k, k[:, :4], q, pos, pos)
    chk = flash_attention._check_cuda_operands
    ok = [("q", q), ("k", k), ("v", k), ("dout", q), ("qp", pos),
          ("kp", pos)]
    chk("flash_attention_bwd", ok)
    bad = [(2, ("v", k.double()), TypeError, "must share"),
           (4, ("qp", pos.long()), TypeError, "int32"),
           (3, ("dout", q.transpose(1, 2)), ValueError, "not contiguous"),
           (1, ("k", k.to("meta")), ValueError, "is on meta")]
    for i, item, exc, match in bad:
        named = list(ok)
        named[i] = item
        with pytest.raises(exc, match=match):
            chk("flash_attention_bwd", named)
    with pytest.raises(ValueError, match="unsupported device"):
        dispatch.resolve_flash_bwd("flash_attention_bwd", q.to("meta"))
    assert dispatch.resolve_flash_bwd("flash_attention_bwd", q).path == \
        "plain"
    assert envelope.outside_flash_bwd_envelope(4, 2048, 24, 64) is None
    assert envelope.outside_flash_bwd_envelope(1, 300, 8, 128) is None
    assert "head_dim=256" in envelope.outside_flash_bwd_envelope(
        1, 64, 8, 256)
    # csrc/flash_attention_bwd.cu's smem_stats/dkdv/dq at DHP 64 and 128
    assert [envelope.flash_bwd_smem_bytes(p, 64) for p in range(3)] == [
        70_144, 103_936, 87_296]
    assert [envelope.flash_bwd_smem_bytes(p, 96) for p in range(3)] == [
        135_680, 169_472, 152_832]
    src = (pathlib.Path(flash_attention.__file__).parent / "csrc"
           / "flash_attention_bwd.cu").read_text()
    assert "atomic" not in src.replace("no atomics", "")


def _fake_cuda(shape, dtype):
    """Stand-in for a CUDA tensor: resolve_flash_bwd reads device, shape
    and dtype."""
    return types.SimpleNamespace(device=torch.device("cuda", 0), shape=shape,
                                 dtype=dtype)


@pytest.mark.parametrize("dtype,dh,route", [
    ("bfloat16", 64, "tensor_core"), ("bfloat16", 96, "tensor_core"),
    ("bfloat16", 112, "tensor_core"), ("bfloat16", 128, "tensor_core"),
    ("bfloat16", 80, "cuda_core"), ("bfloat16", 16, "cuda_core"),
    ("float32", 64, "cuda_core"), ("float32", 128, "cuda_core")])
def test_backward_route_table(dtype, dh, route):
    """The backward's two routes: bf16 at 64/96/112/128 on the tensor
    cores, bf16 at other widths and float32 on the CUDA cores; a CPU
    tensor on the plain autograd."""
    from repro_torch.kernels import dispatch, envelope
    dt = getattr(torch, dtype)
    res = dispatch.resolve_flash_bwd("flash_attention_bwd",
                                     _fake_cuda((4, 2048, 24, dh), dt))
    assert (res.path, res.route) == ("kernel", route)
    assert envelope.flash_bwd_route(dt == torch.bfloat16, dh) == route
    res = dispatch.resolve_flash_bwd("flash_attention_bwd",
                                     torch.zeros(1, 4, 2, dh, dtype=dt))
    assert (res.path, res.route) == ("plain", "plain")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_backward_refuses_head_dim_256(dtype):
    """dh 256 is outside both routes' envelopes; the tensor-core route's
    grid is (tiles, B*H), so B*H above gridDim.y is refused too."""
    from repro_torch.kernels import dispatch, envelope
    with pytest.raises(ValueError, match="head_dim=256"):
        dispatch.resolve_flash_bwd(
            "flash_attention_bwd",
            _fake_cuda((1, 64, 8, 256), getattr(torch, dtype)))
    assert "no tensor-core" in envelope.outside_flash_bwd_tc_envelope(
        1, 8, 256)
    with pytest.raises(ValueError, match="grid"):
        dispatch.resolve_flash_bwd(
            "flash_attention_bwd",
            _fake_cuda((envelope.MAX_DESIGNS + 1, 16, 1, 64), torch.bfloat16))


def test_backward_tc_shared_memory():
    """csrc/flash_attention_bwd_tc.cu's Cfg<DH>::kRowBytes / kColBytes
    (passes 0 and 2 / pass 1), mirrored by the envelope, under the
    H100's per-block limit."""
    from repro_torch.kernels import envelope
    assert [envelope.flash_bwd_tc_smem_bytes(p, 64) for p in range(3)] == [
        100_456, 68_200, 100_456]
    for dh in (96, 112, 128):
        assert [envelope.flash_bwd_tc_smem_bytes(p, dh)
                for p in range(3)] == [165_712, 133_736, 165_712]
    assert [envelope.flash_bwd_tc_stages(p, 64) for p in range(3)] == [
        4, 4, 4]
    assert [envelope.flash_bwd_tc_stages(p, 128) for p in range(3)] == [
        3, 4, 3]
    assert envelope.FLASH_BWD_TC_Q_ROWS == 32
    assert all(envelope.outside_flash_bwd_tc_envelope(4, 24, dh) is None
               for dh in envelope.FLASH_BWD_TC_HEAD_DIMS)


@pytest.mark.parametrize("name", ["flash_attention_bwd",
                                  "flash_attention_bwd_tc"])
def test_backward_sources_have_no_atomics(name):
    """Both backward sources are built from the repo, write each output
    element from one block (no atomics in the code), and call no library
    kernel; the tensor-core one runs its products on wgmma and brings its
    tiles by TMA."""
    from repro_torch.kernels import _build
    path = _build.SOURCES[name]
    assert path.name == f"{name}.cu" and path.is_file()
    assert _build.library_path(name).name.startswith(f"lib{name}-")
    src = path.read_text()
    code = re.sub(r"//[^\n]*", "", src)
    assert "atomic" not in code
    for word in ("cublas", "cudnn", "cutlass", "torch"):
        assert word not in code.lower(), word
    assert "cudaGetLastError" in code
    if name.endswith("_tc"):
        for word in ("wgmma.mma_async", "cp.async.bulk.tensor.4d",
                     "setmaxnreg", "__grid_constant__"):
            assert word in code, word


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_matches_plain_on_card(dtype):
    """On the card: the backward kernel against the plain autograd in
    float32 at the same inputs (GQA, ragged S, a window, a softcap, empty
    key slots), bitwise across two runs, counted once per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(31)
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    q = rng.normal(size=(2, 261, 8, 96)) * 1.5
    k = rng.normal(size=(2, 261, 2, 96)) * 1.5
    v = rng.normal(size=(2, 261, 2, 96)) + 1.0
    do = rng.normal(size=(2, 261, 8, 96))
    q, k, v, do = (torch.from_numpy(a).to(dev, dt) for a in (q, k, v, do))
    pos = torch.arange(261, dtype=torch.int32, device=dev)
    kpos = pos.clone()
    kpos[::11] = -1
    kw = dict(window=120, attn_softcap=30.0)
    # dh 96: float32 on the CUDA cores, bf16 on the tensor cores
    key = ("flash_attention_bwd_tc" if dtype == "bfloat16"
           else "flash_attention_bwd")
    before = flash_attention.launches[key]
    got = ops.flash_attention_bwd(q, k, v, do, pos, kpos, **kw)
    again = ops.flash_attention_bwd(q, k, v, do, pos, kpos, **kw)
    want = flash_attention.ref.flash_attention_bwd_ref(
        q.float(), k.float(), v.float(), do.float(), pos, kpos, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches[key] == before + 2
    rtol, atol = (2 ** -7, 2 ** -12) if dtype == "bfloat16" else (1e-5, 1e-5)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        w = w.to(dt).float()
        assert bool(((g.float() - w).abs()
                     <= rtol * w.abs() + atol * w.abs().max()).all())


# ------------------------------------------------------- loss, gradients
@pytest.mark.parametrize("arch", ARCHS + ["dense-options"])
def test_loss_and_every_gradient_leaf_match_jax(arch, mesh):
    jcfg, cfg = _configs(arch)
    jp = jtransformer.init_params(jax.random.PRNGKey(1), jcfg)
    jdata, data = _data(jcfg, cfg, microbatches=1)
    jb = {k: (v if k == "adc_mask" else v[0])
          for k, v in jdata.batch_at(0).items()}
    with compat.set_mesh(mesh):
        (jloss, jm), jg = jax.value_and_grad(
            lambda p: jtransformer.loss_fn(p, jb, jcfg, mesh),
            has_aux=True)(jp)
    params = _requires_grad(transformer.params_from_numpy(_np(jp), cfg))
    tb = {k: (v if k == "adc_mask" else v[0])
          for k, v in data.device_batch(0).items()}
    loss, metrics = transformer.loss_fn(params, tb, cfg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    assert float(metrics["aux"]) == 0.0 == float(jm["aux"])
    assert torch.equal(metrics["ce"], loss)
    loss.backward()
    want = _jax_flat(jg)
    got = {k: v.grad.numpy() for k, v in _leaves_by_name(params).items()}
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **GRAD_TOL)


def _leaves_by_name(params, prefix=""):
    out = {}
    for key in sorted(params):
        value = params[key]
        if isinstance(value, dict):
            out.update(_leaves_by_name(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


@pytest.mark.parametrize("arch", ["musicgen-medium", "dense-options"])
def test_remat_gradients_equal_the_unrematerialised_ones_bitwise(arch):
    """remat="full" recomputes each layer under torch.utils.checkpoint in
    the backward: the same operations on the same inputs, so the loss
    and every gradient are bitwise those without it."""
    _, cfg = _configs(arch)
    params = transformer.init_params(cfg, seed=3)
    _, data = _data(cfg, cfg, microbatches=1)
    tb = {k: (v if k == "adc_mask" else v[0])
          for k, v in data.device_batch(2).items()}
    out = {}
    for remat in ("none", "full"):
        live = _requires_grad({k: (v.clone() if k != "layers" else
                                   {kk: vv.clone() for kk, vv in v.items()})
                               for k, v in params.items()})
        loss, _ = transformer.loss_fn(live, tb, cfg.replace(remat=remat))
        loss.backward()
        out[remat] = (loss.detach(), {k: v.grad for k, v in
                                      _leaves_by_name(live).items()})
    assert torch.equal(out["none"][0], out["full"][0])
    for key, g in out["none"][1].items():
        assert torch.equal(g, out["full"][1][key]), key


def test_chunked_loss_is_the_full_cross_entropy():
    """512-position chunks summed in order == one log-softmax over the
    whole sequence (S = 1536, three chunks), and S % chunk != 0 raises."""
    _, cfg = _configs("dense-options")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, 1536, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, cfg.vocab_size)).astype(
        np.float32) * 0.1)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1536)))
    got = transformer.chunked_ce_loss(x, w, labels.to(torch.int32), cfg)
    logits = transformer.L.softcap(x @ w, cfg.final_logit_softcap)
    want = torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg.vocab_size), labels.reshape(-1))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    with pytest.raises(ValueError, match="multiple of the loss chunk"):
        transformer.chunked_ce_loss(x[:, :600], w, labels[:, :600], cfg)


# ----------------------------------------------------------- optimizer
def test_adamw_tree_state_and_clip_match_the_reference():
    rng = np.random.default_rng(9)
    tree = {"b": rng.normal(size=(3, 4)).astype(np.float32),
            "a": {"y": rng.normal(size=(5,)).astype(np.float32),
                  "x": rng.normal(size=(2, 2)).astype(np.float32)}}
    grads = jax.tree.map(lambda a: (a * 7.0).astype(np.float32), tree)
    jstate = jadamw.init(tree)
    jp, jstate = jadamw.update(grads, jstate, tree, lr=1e-2,
                               weight_decay=0.1, grad_clip=1.0)
    params = jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)
    tgrads = jax.tree.map(lambda a: torch.from_numpy(a.copy()), grads)
    state = adamw.init_tree(params)
    assert state.step.dtype == torch.int32
    norm = adamw.global_norm(tgrads)
    np.testing.assert_allclose(float(norm),
                               float(jadamw.global_norm(grads)), rtol=1e-6)
    adamw.update_(adamw.tree_leaves(params), adamw.tree_leaves(tgrads),
                  state, lr=torch.tensor(1e-2), weight_decay=0.1,
                  grad_clip=1.0)
    assert int(state.step) == int(jstate.step) == 1
    for got, want in ((params, jp), (state.m, jstate.m), (state.v, jstate.v)):
        for g, w in zip(adamw.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    bf = adamw.init_tree(params, "bfloat16")
    assert all(t.dtype == torch.bfloat16 for t in adamw.tree_leaves(bf.m))


# ---------------------------------------------------------- train steps
def _port_state(jstate, cfg):
    params = transformer.params_from_numpy(_np(jstate.params), cfg)
    return steps.TrainState(params, adamw.init_tree(params,
                                                     cfg.opt_state_dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_the_reference(arch, mesh):
    jcfg, cfg = _configs(arch)
    shape = JShape("t", SEQ, BATCH, "train")
    jdata, data = _data(jcfg, cfg)
    with compat.set_mesh(mesh):
        jstate = jsteps.init_state(jax.random.PRNGKey(0), jcfg, mesh)
        state = _port_state(jstate, cfg)
        jstep = jax.jit(jsteps.make_train_step(jcfg, mesh, shape,
                                               microbatches=MB,
                                               total_steps=30))
        step = steps.make_train_step(cfg, None, ShapeConfig("t", SEQ, BATCH,
                                                            "train"),
                                     microbatches=MB, total_steps=30)
        for i in range(3):
            jstate, jm = jstep(jstate, jdata.device_batch(i),
                               jnp.asarray(i, jnp.int32))
            state, m = step(state, data.device_batch(i), i)
            for key in ("loss", "lr", "grad_norm"):
                np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                           rtol=1e-4, err_msg=key)
    assert int(state.opt.step) == int(jstate.opt.step) == 3
    for name, got, want, tol in (
            ("m", state.opt.m, jstate.opt.m, dict(rtol=1e-3, atol=3e-7)),
            ("v", state.opt.v, jstate.opt.v, dict(rtol=1e-3, atol=1e-12)),
            ("params", state.params, jstate.params, dict(rtol=0,
                                                         atol=2e-5))):
        want = _jax_flat(want)
        got = _port_flat(got)
        assert set(got) == set(want), name
        for key in want:
            np.testing.assert_allclose(got[key], want[key],
                                       err_msg=f"{name}/{key}", **tol)


def test_default_microbatches_follow_the_reference():
    jcfg, cfg = _configs("musicgen-medium")
    jmesh = make_host_mesh(1, 1)
    from repro_torch.launch import mesh as tmesh
    tm = tmesh.make_host_mesh(1, 1, device="cpu")
    for batch in (1, 2, 6, 8, 12, 16, 64):
        want = jsteps.default_microbatches(jcfg, JShape("t", 64, batch,
                                                        "train"), jmesh)
        shape = ShapeConfig("t", 64, batch, "train")
        assert steps.default_microbatches(cfg, shape, tm) == want
        assert steps.default_microbatches(cfg, shape, None) == want
    two = tmesh.make_host_mesh(2, 1, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        steps.make_train_step(cfg, two, ShapeConfig("t", 64, 8, "train"))
    with pytest.raises(NotImplementedError, match="compression.py"):
        steps.make_train_step(cfg.replace(grad_compression="int8"), tm,
                              ShapeConfig("t", 64, 8, "train"))
    with pytest.raises(NotImplementedError, match="compression.py"):
        steps.init_state(cfg.replace(grad_compression="int8"),
                         device="cpu")


def test_train_loss_decreases():
    """The reference's test_train_loss_decreases, in the port: deepseek
    smoke, 30 steps at batch 8, seq 64, 2 microbatches."""
    _, train_step, data, state = _built("deepseek-7b", seq=64, batch=8,
                                        steps_total=30)
    losses = []
    for i in range(30):
        state, m = train_step(state, data.device_batch(i), i)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])
    assert np.isfinite(losses).all()


def _built(arch, seq=SEQ, batch=BATCH, steps_total=10):
    cfg, mesh_, train_step, data = ttrain.build(
        arch, smoke=True, seq=seq, batch=batch, microbatches=MB,
        steps_total=steps_total, device="cpu")
    return cfg, train_step, data, steps.init_state(cfg, seed=0, mesh=mesh_)


# ----------------------------------------------- recovery, checkpoints
def _flat_state(state):
    return {**{f"params/{k}": v for k, v in
               _port_flat(state.params).items()},
            **{f"m/{k}": v for k, v in _port_flat(state.opt.m).items()},
            "step": state.opt.step.numpy()}


def test_recovery_with_the_real_manager_replays_bitwise(tmp_path):
    """run_with_recovery with the real CheckpointManager (saves every 2
    steps) and a failure injected at step 5: it restores step 4 and
    replays to the uninterrupted run's state, bitwise."""
    def run(directory, fail_at):
        _, train_step, data, state = _built("musicgen-medium")
        failed = []

        def inject(step):
            if step == fail_at and not failed:
                failed.append(step)
                return True
            return False
        ckpt = CheckpointManager(directory, keep=2)
        state, info = tfault.run_with_recovery(
            train_step, state, lambda i: data.device_batch(i, "cpu"),
            num_steps=7, ckpt=ckpt, ckpt_every=2, inject_failure=inject)
        return state, info, ckpt

    clean, info0, _ = run(tmp_path / "clean", fail_at=None)
    state, info, ckpt = run(tmp_path / "failed", fail_at=5)
    assert info0["failures"] == 0 and info["failures"] == 1
    assert info["final_step"] == 7 and ckpt.all_steps() == [6, 7]
    want, got = _flat_state(clean), _flat_state(state)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    restored = ckpt.restore(7, state)
    assert isinstance(restored, steps.TrainState)
    assert restored.err is None and restored.opt.step.dtype == torch.int32
    for key, value in _flat_state(restored).items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)
    ckpt.wait()


def test_train_state_checkpoints_cross_between_the_packages(tmp_path,
                                                             mesh):
    jcfg, cfg = _configs("musicgen-medium")
    with compat.set_mesh(mesh):
        jstate = jsteps.init_state(jax.random.PRNGKey(4), jcfg, mesh)
    jstate = jstate._replace(opt=jstate.opt._replace(
        step=jnp.asarray(3, jnp.int32),
        m=jax.tree.map(lambda p: p * 0.5, jstate.params)))
    JCkpt(str(tmp_path / "j"), keep=2).save(3, jstate, blocking=True)
    like = _port_state(jstate, cfg)
    got = CheckpointManager(tmp_path / "j").restore(3, like)
    assert int(got.opt.step) == 3 and got.opt.step.dtype == torch.int32
    for key, want in _jax_flat(jstate.opt.m).items():
        np.testing.assert_array_equal(_port_flat(got.opt.m)[key], want)
    for key, want in _jax_flat(jstate.params).items():
        np.testing.assert_array_equal(_port_flat(got.params)[key], want)
    # and back: the port's save restores in the reference
    CheckpointManager(tmp_path / "t").save(3, got)
    names = set(CheckpointManager(tmp_path / "t").restore_flat(3))
    assert names == set(CheckpointManager(tmp_path / "j").restore_flat(3))
    assert {"opt/step", "opt/m/front_proj", "opt/v/layers/wi",
            "params/layers/q"} <= names
    back = JCkpt(str(tmp_path / "t")).restore(3, jstate, host=True)
    for path in ("params", "opt"):
        for key, want in _jax_flat(getattr(jstate, path)).items():
            np.testing.assert_array_equal(
                _jax_flat(getattr(back, path))[key], want)


# -------------------------------------------------------------- launcher
@pytest.mark.parametrize("arch", ["deepseek-7b", "musicgen-medium"])
def test_launcher_matches_the_reference_losses(arch, tmp_path, capsys,
                                               monkeypatch):
    """``python -m repro_torch.launch.train --arch ... --smoke --steps 12
    --batch 2 --seq 32 --device cpu``, started from the reference
    launcher's init (PRNGKey(0), carried over in place of the port's own
    init), gives the reference launcher's losses and its log lines."""
    argv = ["--arch", arch, "--smoke", "--steps", "12", "--batch", "2",
            "--seq", "32", "--log-every", "1"]
    jcfg, _ = _configs(arch)
    init = _np(jtransformer.init_params(jax.random.PRNGKey(0), jcfg))
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
        rows = [line.split() for line in text.splitlines()
                if line.startswith("step ")]
        assert [int(r[1]) for r in rows] == list(range(1, 13))
        return [float(r[3]) for r in rows]
    # deepseek's smoke run does not improve in 12 steps: both launchers
    # say so; musicgen's does
    assert raised == [arch == "deepseek-7b"] * 2
    np.testing.assert_allclose(losses(outs[1]), losses(outs[0]), rtol=1e-4)
    assert "done: 12 steps" in outs[1]
    assert CheckpointManager(tmp_path / "t").all_steps() == [12]


@pytest.mark.parametrize("arch, item", [
    ("gemma2-2b", "local_global.*A11"), ("mamba2-1.3b", "ssm family.*A11"),
    ("hymba-1.5b", "hybrid family.*A11"),
    ("llama4-scout-17b-a16e", "moe family.*A11"),
    ("kimi-k2-1t-a32b", "moe family.*A11"),
    ("qwen2-vl-72b", "M-RoPE.*A11"), ("no-such-arch", "unknown arch")])
def test_launcher_refuses_each_unported_family(arch, item, capsys):
    with pytest.raises(SystemExit) as exc:
        ttrain.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert exc.value.code == 2
    assert re.search(item, capsys.readouterr().err)


def test_launcher_trains_a_ported_arch_and_resumes(tmp_path, capsys):
    """musicgen-medium (smoke) trains through the CLI; rerun on the same
    directory with more steps, it resumes from the last checkpoint."""
    argv = ["--arch", "musicgen-medium", "--smoke", "--batch", "2",
            "--seq", "32", "--device", "cpu", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "4"]
    first = ttrain.main(argv + ["--steps", "8"])
    assert len(first) == 8 and first[-1] < first[0]
    assert "train[repro_torch] arch=musicgen-medium-smoke" in \
        capsys.readouterr().out
    second = ttrain.main(argv + ["--steps", "12"])
    assert len(second) == 4          # steps 9..12 after resuming at 8


def test_lm_training_entry_points_need_a_card_unless_asked_for_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = smoke_config("musicgen-medium")
    for call in (lambda: steps.init_state(cfg),
                 lambda: ttrain.build("musicgen-medium", smoke=True, seq=32,
                                      batch=2, microbatches=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(SystemExit) as exc:
        ttrain.main(["--arch", "musicgen-medium", "--smoke"])
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
