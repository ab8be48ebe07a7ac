"""Port parity, the moe family: repro_torch.models.moe and the moe
branches of transformer / serving / steps / launch against the JAX package
at smoke size (kimi-k2's and llama4-scout's smoke configs, float32), on
shared numpy-seeded inputs, the JAX package's parameters carried over by
``params_from_numpy``. On the CPU attention runs the flash kernel's plain
version.

Tolerances: moe_ffn / moe_ffn_decode / shared_ffn outputs and aux rtol =
atol = 1e-5 (float32; products and sums round in each package's order);
routing (ids, order, slot, keep) bitwise against the reference's own
lines; logits rtol = atol = 1e-4 and gradients rtol 1e-4, atol 1e-6, as
tests/test_torch_lm.py and tests/test_torch_lm_train.py; three train
steps with test_torch_lm_train.py's bounds."""
import pytest

torch = pytest.importorskip("torch")

import math  # noqa: E402
import pathlib  # noqa: E402
import re  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax import lax  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.data import lm as jlm  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import serving as jserving  # noqa: E402
from repro.models import steps as jsteps  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import MoEConfig, ShapeConfig  # noqa: E402
from repro_torch.data import lm  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import moe, serving, steps, transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ARCHS = ["kimi-k2-1t-a32b", "llama4-scout-17b-a16e"]
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
B, S = 2, 16
SEQ, BATCH, MB = 32, 4, 2


@pytest.fixture(scope="module")
def mesh():
    return make_host_mesh(1, 1)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{"a/b": leaf} of nested dicts (torch tensors or arrays), keys
    sorted: the reference's leaf order."""
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


def _moe_params(arch, seed=1):
    """The reference's init_moe at the smoke config (d_model 64): (JAX
    tree, the same leaves as torch tensors, port MoEConfig, JAX
    MoEConfig)."""
    jm, m = jsmoke(arch).moe, smoke_config(arch).moe
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), 64, jm)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp, m, jm


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ------------------------------------------------------- the moe FFN
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_decode_and_shared_match_jax(arch, mesh):
    jp, tp, m, jm = _moe_params(arch)
    x = _x((B, S, 64), 0)
    xd = _x((4, 1, 64), 1)
    with compat.set_mesh(mesh):
        want, want_aux = jmoe.moe_ffn(jnp.asarray(x), jp, jm, mesh)
        want_dec = jmoe.moe_ffn_decode(jnp.asarray(xd), jp, jm, mesh)
        want_sh = jmoe.shared_ffn(jnp.asarray(x), jp)
    got, aux = moe.moe_ffn(torch.from_numpy(x), tp, m)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **MOE_TOL)
    dec = moe.moe_ffn_decode(torch.from_numpy(xd), tp, m)
    np.testing.assert_allclose(dec.numpy(), np.asarray(want_dec), **MOE_TOL)
    sh = moe.shared_ffn(torch.from_numpy(x), tp)
    np.testing.assert_allclose(sh.numpy(), np.asarray(want_sh), **MOE_TOL)


def _jax_routing(x, router_w, jm, cap):
    """The reference's routing lines (``_local_moe``, tp = 1,
    repro/models/moe.py:76-102), verbatim in JAX: ids, order, slot,
    keep."""
    t = x.shape[0]
    e, k = jm.num_experts, jm.top_k
    logits = x.astype(jnp.float32) @ router_w
    probs = jax.nn.softmax(logits, axis=-1)
    _, ids = lax.top_k(probs, k)
    flat_ids = ids.reshape(-1)
    local_eid = jnp.where((flat_ids >= 0) & (flat_ids < e), flat_ids, e)
    order = jnp.argsort(local_eid)
    sorted_eid = local_eid[order]
    starts = jnp.searchsorted(sorted_eid, jnp.arange(e + 1), side="left")
    pos = jnp.arange(t * k) - starts[jnp.clip(sorted_eid, 0, e)]
    keep = (sorted_eid < e) & (pos < cap)
    slot = jnp.where(keep, sorted_eid * cap + pos, e * cap)
    return ids, order, slot, keep


# case: (arch, tokens, decode capacity, how the router is edited)
ROUTING_CASES = [
    ("kimi-k2-1t-a32b", 32, False, None),
    ("llama4-scout-17b-a16e", 32, False, None),
    ("kimi-k2-1t-a32b", 8, True, None),
    ("kimi-k2-1t-a32b", 32, False, "ties"),
    ("llama4-scout-17b-a16e", 32, False, "ties"),
    ("kimi-k2-1t-a32b", 64, False, "crowd"),
    ("llama4-scout-17b-a16e", 48, False, "crowd"),
]


@pytest.mark.parametrize("case", ROUTING_CASES, ids=str)
def test_routing_is_bitwise_the_reference(case, mesh):
    """ids, order, slot and keep equal the reference's lines bitwise.
    'ties': router columns 2 and 5 equal, so every token's probabilities
    tie there (lax.top_k takes the lower index; torch.topk need not).
    'crowd': a router biased toward expert 3, so its pairs overflow the
    capacity and some are dropped. The moe output then matches the
    reference's too."""
    arch, t, decode, edit = case
    jp, tp, m, jm = _moe_params(arch, seed=2)
    router = np.array(jp["router"])
    x = _x((t, 64), 3)
    if edit == "ties":
        router[:, 5] = router[:, 2]
    if edit == "crowd":
        x[:, 0] = np.abs(x[:, 0]) + 2.0
        router[0, :] = 0.0
        router[0, 3] = 3.0
    cap = (moe.decode_capacity(t, m) if decode
           else moe.prefill_capacity(t, m))
    want = _jax_routing(jnp.asarray(x), jnp.asarray(router), jm, cap)
    tx, tr = torch.from_numpy(x), torch.from_numpy(router)
    probs = torch.softmax(tx.float() @ tr, dim=-1)
    _, ids = moe.top_k(probs, m.top_k)
    r = moe.route(ids, m.num_experts, cap)
    got = (ids, r.order, r.slot, r.keep)
    for name, g, w in zip(("ids", "order", "slot", "keep"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if edit == "ties":
        assert bool((probs[:, 2] == probs[:, 5]).all())
        has2, has5 = (ids == 2).any(1), (ids == 5).any(1)
        # the tie decides some token's last pick: 2 in, 5 out; never 5
        # without 2
        assert bool((has2 & ~has5).any()) and not bool((has5 & ~has2).any())
    if edit == "crowd":
        assert int((~r.keep).sum()) >= 1
    # the whole FFN with this router, against the reference's
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=tr)
    xb = x.reshape(1, t, 64) if not decode else x.reshape(t, 1, 64)
    with compat.set_mesh(mesh):
        if decode:
            wy = jmoe.moe_ffn_decode(jnp.asarray(xb), jp, jm, mesh)
        else:
            wy, _ = jmoe.moe_ffn(jnp.asarray(xb), jp, jm, mesh)
    gy = (moe.moe_ffn_decode(torch.from_numpy(xb), tp, m) if decode
          else moe.moe_ffn(torch.from_numpy(xb), tp, m)[0])
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **MOE_TOL)


def test_top_k_follows_lax_top_k_on_ties():
    """A tie witness: [0.25, 0.25, 0.1, 0.25, 0.15] -> [0, 1], the
    lower index first, as lax.top_k; torch.topk gives another order."""
    p = np.array([[0.25, 0.25, 0.1, 0.25, 0.15]], np.float32)
    _, want = lax.top_k(jnp.asarray(p), 2)
    _, got = moe.top_k(torch.from_numpy(p), 2)
    assert got.tolist() == np.asarray(want).tolist() == [[0, 1]]


@pytest.mark.parametrize("t,k,e,cf,prefill,decode", [
    (32, 2, 8, 1.25, 10, 40), (8192, 8, 384, 1.25, 213, 853),
    (4, 8, 384, 1.25, 1, 1), (8192, 1, 16, 1.25, 640, 2560),
    (4, 1, 16, 1.25, 1, 1), (20, 1, 8, 1.0, 2, 10), (12, 1, 8, 1.0, 2, 6),
    (3, 1, 2, 1.0, 2, 3)])
def test_capacities_use_pythons_round(t, k, e, cf, prefill, decode):
    """The capacity rule in Python float arithmetic with Python's
    (banker's) round: 2.5 -> 2, 1.5 -> 2; the decode rule capped at T k;
    kimi-k2's decode at B = 4 gives 1, its 4 x 2048 prefill 213."""
    m = MoEConfig(num_experts=e, top_k=k, capacity_factor=cf, d_expert=1)
    assert moe.prefill_capacity(t, m) == prefill
    assert moe.decode_capacity(t, m) == decode


def test_gather_rows_backward_is_the_adjoint():
    """gather_rows' hand backward equals autograd's gradient of the same
    gather (double precision, gradcheck), with empty and dropped rows."""
    idx = torch.tensor([2, -1, 0, 2, 3, -1])
    # source row r read by output rows inv[r, :]; -1 pads
    inv = torch.tensor([[2, -1], [-1, -1], [0, 3], [4, -1]])
    src = torch.randn(4, 3, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda s: moe.gather_rows(s, idx, inv), (src,))
    out = moe.gather_rows(src, idx, inv)
    assert torch.equal(out[1], torch.zeros(3, dtype=torch.float64))


def test_moe_sources_have_no_atomics():
    """No float accumulation by index in the moe code: no index_add_,
    scatter_add_, accumulating index_put_ or atomicAdd, and no
    torch.topk (its tie order is not lax.top_k's)."""
    src = pathlib.Path(moe.__file__).read_text()
    for bad in ("index_add", "scatter_add", "accumulate=True", "atomicAdd",
                "torch.topk", ".topk("):
        assert bad not in src, bad


# ------------------------------------------------------------ the LM
def _jax_params(jcfg, seed=1):
    return jtransformer.init_params(jax.random.PRNGKey(seed), jcfg)


def _batches(cfg, s, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(
        np.int32),
           "positions": np.broadcast_to(np.arange(s, dtype=np.int32),
                                        (B, s)).copy()}
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _slice(batch, lo, hi):
    return {k: v[:, lo:hi] for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_jax(arch, mesh):
    """logits_fn, prefill (logits and every cache leaf, k_pre/v_pre
    included) and two decode steps against the reference's."""
    jcfg, cfg = jsmoke(arch), smoke_config(arch)
    jp = _jax_params(jcfg)
    params = transformer.params_from_numpy(_np(jp), cfg)
    jb, tb = _batches(cfg, S + 2, seed=3)
    with compat.set_mesh(mesh):
        want = jtransformer.logits_fn(jp, _slice(jb, 0, S), jcfg, mesh)
        jlog, jcache = jserving.prefill(jp, _slice(jb, 0, S), jcfg, mesh)
    got = transformer.logits_fn(params, _slice(tb, 0, S), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    log, cache = serving.prefill(params, _slice(tb, 0, S), cfg)
    assert set(cache) == set(jcache)
    assert ("k_pre" in cache) == bool(cfg.moe.first_k_dense)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
    for t in range(S, S + 2):
        with compat.set_mesh(mesh):
            jlog, jcache = jserving.decode_step(
                jp, _slice(jb, t, t + 1), jcache, jcfg, mesh)
        log, cache = serving.decode_step(params, _slice(tb, t, t + 1),
                                         cache, cfg)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), **TOL)
        for key in cache:
            if key in ("kpos", "pos"):
                np.testing.assert_array_equal(cache[key].numpy(),
                                              np.asarray(jcache[key]))
            else:
                np.testing.assert_allclose(cache[key].numpy(),
                                           np.asarray(jcache[key]),
                                           err_msg=key, **TOL)
    # the nn.Module holds the nested tree
    model = transformer.Transformer(cfg, params)
    assert torch.equal(model(_slice(tb, 0, S)), got)
    assert set(_flat(model.params)) == set(_flat(params))


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_as_the_jax_steps(arch, mesh):
    """repro_torch.launch.serve, fed the JAX package's init, gives the JAX
    steps' logits on the same inputs, prefill and every decode step (the
    JAX steps decode the tokens the port sampled)."""
    from repro.launch import serve as jserve
    jcfg = jsmoke(arch)
    jp = _jax_params(jcfg, seed=0)
    cfg = smoke_config(arch)
    gen, info = tserve.serve(cfg, transformer.params_from_numpy(_np(jp),
                                                                cfg),
                             requests=2, prompt_len=12, gen=3, device="cpu")
    assert gen.shape == (2, 3) and info["prefill_flash_launches"] == 0
    rng = np.random.default_rng(0)
    with compat.set_mesh(mesh):
        prefill = jax.jit(jsteps.make_prefill_step(jcfg, mesh))
        decode = jax.jit(jsteps.make_decode_step(jcfg, mesh))
        logits, cache = prefill(jp, jserve.make_batch(jcfg, 2, 12, rng=rng))
        np.testing.assert_allclose(info["logits"][0], logits, **TOL)
        for i in range(3):
            tok = jnp.asarray(gen[:, i], jnp.int32)
            logits, cache = decode(jp, jserve.token_to_batch(
                jcfg, tok, 12 + i, 2, rng), cache)
            np.testing.assert_allclose(info["logits"][i + 1], logits, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_round_trips_the_nested_tree(arch):
    jcfg, cfg = jsmoke(arch), smoke_config(arch)
    tree = _np(_jax_params(jcfg))
    params = transformer.params_from_numpy(tree, cfg)
    want, got = _flat(tree), _to_numpy(_flat(params))
    assert set(got) == set(want)
    assert "layers/moe/shared/wo" in got
    assert ("prelayers/wo" in got) == bool(cfg.moe.first_k_dense)
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        np.testing.assert_array_equal(got[key], w, err_msg=key)
    own = _flat(transformer.init_params(cfg, seed=0))
    assert set(own) == set(want)
    for key, t in own.items():
        assert tuple(t.shape) == want[key].shape, key
    bad = dict(tree, layers=dict(tree["layers"], moe=dict(
        tree["layers"]["moe"], router=tree["layers"]["moe"]["router"][:, 1:])))
    with pytest.raises(ValueError, match="params.layers.moe.router"):
        transformer.params_from_numpy(bad, cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_scale_of_every_moe_leaf_by_path(arch):
    """The port's init draws each leaf at the reference's scale, keyed by
    path: expert wo 1/sqrt(d_expert), shared wo 1/sqrt(d) (not the dense
    wo's 1/sqrt(d_ff)), router 0.02; the reference's own init agrees
    leaf by leaf within 10 % of the standard deviation."""
    jcfg, cfg = jsmoke(arch), smoke_config(arch)
    d, m = cfg.d_model, cfg.moe
    want = {"layers/moe/router": 0.02,
            "layers/moe/wi": 1 / math.sqrt(d),
            "layers/moe/wg": 1 / math.sqrt(d),
            "layers/moe/wo": 1 / math.sqrt(m.d_expert),
            "layers/moe/shared/wi": 1 / math.sqrt(d),
            "layers/moe/shared/wg": 1 / math.sqrt(d),
            "layers/moe/shared/wo": 1 / math.sqrt(d),
            "layers/q": 1 / math.sqrt(d)}
    if m.first_k_dense:
        want["prelayers/wo"] = 1 / math.sqrt(cfg.d_ff)
        want["prelayers/wi"] = 1 / math.sqrt(d)
    assert 1 / math.sqrt(m.d_expert) != 1 / math.sqrt(d) != 1 / math.sqrt(
        cfg.d_ff)
    own = _flat(transformer.init_params(cfg, seed=4))
    ref = _to_numpy(_flat(_jax_params(jcfg, seed=4)))
    for key, scale in want.items():
        path = tuple(key.split("/"))
        assert transformer._init_scale(cfg, path) == pytest.approx(scale)
        got_std = float(own[key].float().std())
        assert abs(got_std / scale - 1) < 0.1, (key, got_std, scale)
        assert abs(float(ref[key].std()) / scale - 1) < 0.1, key
    assert float(own["layers/moe/shared/wo"].std()) > 1.2 * float(
        own["prelayers/wo"].std() if m.first_k_dense
        else 1 / math.sqrt(cfg.d_ff))


def test_router_stays_float32_under_bf16_params():
    cfg = smoke_config("kimi-k2-1t-a32b").replace(param_dtype="bfloat16")
    own = _flat(transformer.init_params(cfg, seed=0))
    assert own["layers/moe/router"].dtype == torch.float32
    assert all(t.dtype == torch.bfloat16 for k, t in own.items()
               if k != "layers/moe/router")
    jcfg = jsmoke("kimi-k2-1t-a32b").replace(param_dtype="bfloat16")
    ref = _flat(jax.eval_shape(lambda: _jax_params(jcfg)))
    assert {k: str(v.dtype) for k, v in ref.items()} == {
        k: str(t.dtype).replace("torch.", "") for k, t in own.items()}
    # bf16 masters sum bf16 gradients, the router float32 ones
    gsum = adamw.tree_map(lambda p: torch.zeros_like(
        p, dtype=torch.promote_types(p.dtype, torch.bfloat16)),
        transformer.init_params(cfg, seed=0))
    assert gsum["layers"]["moe"]["router"].dtype == torch.float32
    assert gsum["layers"]["moe"]["wi"].dtype == torch.bfloat16


# --------------------------------------------------------- training
def _data(jcfg, cfg, microbatches=MB, seq=SEQ, batch=BATCH):
    kw = dict(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
              microbatches=microbatches)
    return (jlm.SyntheticLM(jlm.LMDataConfig(**kw), jcfg),
            lm.SyntheticLM(lm.LMDataConfig(**kw), cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_every_gradient_leaf_match_jax(arch, mesh):
    jcfg, cfg = jsmoke(arch), smoke_config(arch)
    jp = _jax_params(jcfg)
    jdata, data = _data(jcfg, cfg, microbatches=1)
    jb = {k: v[0] for k, v in jdata.batch_at(0).items()}
    with compat.set_mesh(mesh):
        (jloss, jm), jg = jax.value_and_grad(
            lambda p: jtransformer.loss_fn(p, jb, jcfg, mesh),
            has_aux=True)(jp)
    params = adamw.tree_map(lambda t: t.requires_grad_(True),
                            transformer.params_from_numpy(_np(jp), cfg))
    tb = {k: v[0] for k, v in data.device_batch(0).items()}
    loss, metrics = transformer.loss_fn(params, tb, cfg)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    aux, ce = float(metrics["aux"].detach()), float(metrics["ce"].detach())
    np.testing.assert_allclose(aux, float(jm["aux"]), **MOE_TOL)
    np.testing.assert_allclose(ce, float(jm["ce"]), rtol=1e-5)
    assert aux > 0.5 * transformer.scan_len(cfg)
    loss.backward()
    want = _to_numpy(_flat(jg))
    got = {k: v.grad.numpy() for k, v in _flat(params).items()}
    assert set(got) == set(want)
    assert {"layers/moe/router", "layers/moe/shared/wo"} <= set(got)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **GRAD_TOL)


def _port_state(jstate, cfg):
    params = transformer.params_from_numpy(_np(jstate.params), cfg)
    return steps.TrainState(params, adamw.init_tree(params,
                                                     cfg.opt_state_dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_the_reference(arch, mesh):
    """test_torch_lm_train.py's check at its bounds, through the nested
    moe / shared / prelayers autograd leaves and gradient sums."""
    jcfg, cfg = jsmoke(arch), smoke_config(arch)
    jdata, data = _data(jcfg, cfg)
    with compat.set_mesh(mesh):
        jstate = jsteps.init_state(jax.random.PRNGKey(0), jcfg, mesh)
        state = _port_state(jstate, cfg)
        jstep = jax.jit(jsteps.make_train_step(
            jcfg, mesh, JShape("t", SEQ, BATCH, "train"), microbatches=MB,
            total_steps=30))
        step = steps.make_train_step(cfg, None, ShapeConfig(
            "t", SEQ, BATCH, "train"), microbatches=MB, total_steps=30)
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
        want, got = _to_numpy(_flat(want)), _to_numpy(_flat(got))
        assert set(got) == set(want), name
        for key in want:
            np.testing.assert_allclose(got[key], want[key],
                                       err_msg=f"{name}/{key}", **tol)


def test_replayed_train_step_is_bitwise_the_first():
    """kimi's smoke config is top-2, so tokens are dispatched twice: one
    train step replayed from a cloned state gives the same parameters,
    moments and metrics bitwise."""
    cfg = smoke_config("kimi-k2-1t-a32b")
    _, data = _data(cfg, cfg)
    step = steps.make_train_step(cfg, None, ShapeConfig("t", SEQ, BATCH,
                                                        "train"),
                                 microbatches=MB, total_steps=10)
    state = steps.init_state(cfg, seed=2, device="cpu")
    runs = []
    for _ in range(2):
        clone = steps.TrainState(
            adamw.tree_map(torch.clone, state.params),
            adamw.OptState(state.opt.step.clone(),
                           adamw.tree_map(torch.clone, state.opt.m),
                           adamw.tree_map(torch.clone, state.opt.v)))
        new, m = step(clone, data.device_batch(0), 0)
        runs.append((new, m))
    (a, ma), (b, mb) = runs
    for key in ma:
        assert torch.equal(ma[key], mb[key]), key
    for x, y in zip(adamw.tree_leaves(a.params) + adamw.tree_leaves(a.opt.m),
                    adamw.tree_leaves(b.params) + adamw.tree_leaves(b.opt.m)):
        assert torch.equal(x, y)
    assert not torch.equal(a.params["layers"]["moe"]["wi"],
                           state.params["layers"]["moe"]["wi"])


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_as_the_reference(arch, tmp_path, capsys,
                                          monkeypatch):
    """``python -m repro_torch.launch.train --arch ... --smoke --steps 6
    --batch 2 --seq 32 --device cpu`` from the reference launcher's init
    gives the reference launcher's losses, log lines and verdict."""
    argv = ["--arch", arch, "--smoke", "--steps", "6", "--batch", "2",
            "--seq", "32", "--log-every", "1"]
    init = _np(_jax_params(jsmoke(arch), seed=0))
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
        assert [int(r[1]) for r in rows] == list(range(1, 7))
        return [float(r[3]) for r in rows]
    assert raised[0] == raised[1]
    np.testing.assert_allclose(losses(outs[1]), losses(outs[0]), rtol=1e-4)
    assert "done: 6 steps" in outs[1]
    assert re.search(rf"arch={re.escape(arch)}-smoke", outs[1])
    assert CheckpointManager(tmp_path / "t").all_steps() == [6]


def test_full_llama4_and_moe_sliding_are_refused():
    with pytest.raises(NotImplementedError, match="pad_heads_to=48.*ROADMAP C"):
        transformer.check_supported(get_config("llama4-scout-17b-a16e"))
    transformer.check_supported(
        get_config("llama4-scout-17b-a16e").replace(pad_heads_to=0))
    transformer.check_supported(get_config("kimi-k2-1t-a32b"))
    with pytest.raises(NotImplementedError, match="sliding.*ROADMAP C"):
        transformer.check_supported(smoke_config("kimi-k2-1t-a32b").replace(
            attn_type="sliding"))
