"""The JAX package's data-parallel and int8-compression results for the
port's parity tests (tests/test_torch_compression.py,
tests/test_torch_dp_train.py), computed in a process of their own.

    python tests/torch_dp_reference.py OUT.npz PART [PART ...]

The reference's collectives need real devices, and JAX fixes its device
count when it starts, so this runs apart from the tests with 8 forced
host devices and writes every named part's results into one ``.npz``
(bfloat16 arrays as their uint16 bit patterns). Parts:

* ``ring``: ``ring_allreduce_int8`` at n = 2, 3, 8 and ``compressed_mean``
  at pod 2 x data 2 on the reference test's inputs (seed 0, 8 x 1000),
  every rank's output kept; 8 syncs of ``sync_grads`` over 4 ranks on a
  tree whose keys are out of sorted order, float32 and bf16 leaves.
* ``int8_dp2``, ``moe_int8_dp2``: the int8 train step over 2 dp ranks,
  composed of the reference's pieces as its ``shard_map`` body states
  them (``models/steps.py:108-113``): each rank's ``value_and_grad`` of
  ``loss_fn`` on a one-device mesh over its rows, the microbatch sum and
  its scale, ``sync_grads`` under ``shard_map``, the mean loss,
  ``adamw.update``. The reference's own step raises at dp > 1 (part
  ``pinned``), so its pieces are the reference there.
* ``int8_dp1``, ``none_dp2``, ``musicgen_extra_dp``,
  ``hymba_extra_dp``: the reference's own jitted ``make_train_step`` on
  a (1, 1), (2, 1), (2, 2) and (2, 2) host mesh.
* ``moe_none_dp2``: the same on a (2, 1) mesh for kimi-k2's smoke config
  uncompressed (2 steps), whose moe layers route each dp shard apart;
  plus ``transformer.loss_fn``'s ce and aux on the first microbatch of
  batch 0 at the initial parameters, on the (2, 1) and the (1, 1) mesh.
* ``pinned``: the ValueError the reference's int8 step raises on a
  (2, 1) mesh.

The train parts run 3 steps (moe 2) of smoke configs at batch 8 x 32 in
2 microbatches, from ``init_state(PRNGKey(0))``, on ``SyntheticLM``'s
batches, total_steps 30.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import compat  # noqa: E402
from repro.compat import AxisType, make_mesh, shard_map  # noqa: E402
from repro.configs import smoke_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.data import lm  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import steps, transformer  # noqa: E402
from repro.optim import adamw, compression, schedule  # noqa: E402

SEQ, BATCH, MB, STEPS, TOTAL = 32, 8, 2, 3, 30
EF_RANKS, EF_STEPS = 4, 8


def _np(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _keyed(out, prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(path)] = _np(leaf)


def _mesh(shape, axes):
    return make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes),
                     devices=jax.devices()[:int(np.prod(shape))])


def ring(out):
    xs = np.random.default_rng(0).normal(size=(8, 1000)).astype(np.float32)
    for n in (2, 3, 8):
        fn = jax.jit(shard_map(
            lambda x: compression.ring_allreduce_int8(x[0], "data", n)[None],
            mesh=_mesh((n,), ("data",)), in_specs=P("data", None),
            out_specs=P("data", None), check_vma=False))
        out[f"ring{n}"] = np.asarray(fn(jnp.asarray(xs[:n])))
    fn = jax.jit(shard_map(
        lambda x: compression.compressed_mean(
            x[0, 0], ("pod", "data"), (2, 2))[None, None],
        mesh=_mesh((2, 2), ("pod", "data")), in_specs=P("pod", "data", None),
        out_specs=P("pod", "data", None), check_vma=False))
    out["pod2data2"] = np.asarray(fn(jnp.asarray(xs[:4].reshape(2, 2, -1))))

    r = EF_RANKS
    rng = np.random.default_rng(1)
    grads = {"w": rng.normal(size=(r, 30, 10)).astype(np.float32),
             "b": (rng.normal(size=(r, 7, 11)) * 3).astype(jnp.bfloat16),
             "a": {"z": (rng.normal(size=(r, 50)) * 1e-3).astype(np.float32),
                   "c": rng.normal(size=(r, 64)).astype(jnp.bfloat16)}}
    _keyed(out, "in/", grads)
    n_el = sum(leaf[0].size for leaf in jax.tree_util.tree_leaves(grads))

    def body(g, e):
        g1 = jax.tree_util.tree_map(lambda leaf: leaf[0], g)
        o, ne = compression.sync_grads(g1, e[0], ("data",), (r,))
        return jax.tree_util.tree_map(lambda leaf: leaf[None], o), ne[None]
    fn = jax.jit(shard_map(body, mesh=_mesh((r,), ("data",)),
                           in_specs=(P("data"), P("data")),
                           out_specs=(P("data"), P("data")), check_vma=False))
    err = jnp.zeros((r, n_el), jnp.bfloat16)
    g = jax.tree_util.tree_map(jnp.asarray, grads)
    for step in range(EF_STEPS):
        o, err = fn(g, err)
        out[f"err{step}"] = _np(err)
        _keyed(out, f"out{step}/", o)


def _data(cfg):
    return lm.SyntheticLM(lm.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
        microbatches=MB), cfg)


def composed(out, name, cfg, dp, n_steps=STEPS):
    one = make_host_mesh(1, 1)
    with compat.set_mesh(one):
        st = steps.init_state(jax.random.PRNGKey(0), cfg, None)
    params, opt = st.params, st.opt
    _keyed(out, f"{name}/init/", params)
    n_el = sum(leaf.size for leaf in jax.tree_util.tree_leaves(params))
    err = jnp.zeros((dp, n_el), jnp.bfloat16)

    @jax.jit
    def accum(params, mbs, const):
        gsum = jax.tree_util.tree_map(lambda p: jnp.zeros(
            p.shape, jnp.promote_types(p.dtype, jnp.bfloat16)), params)
        lsum = jnp.zeros((), jnp.float32)
        for mb in mbs:
            (loss, _), g = jax.value_and_grad(
                lambda p: transformer.loss_fn(p, {**mb, **const}, cfg, one),
                has_aux=True)(params)
            gsum = jax.tree_util.tree_map(jnp.add, gsum, g)
            lsum = lsum + loss
        scale = 1.0 / len(mbs)
        return jax.tree_util.tree_map(lambda g: g * scale, gsum), lsum * scale

    update = jax.jit(lambda g, o, p, lr: adamw.update(
        g, o, p, lr=lr, weight_decay=cfg.weight_decay,
        grad_clip=cfg.grad_clip))

    def body(g, e):
        g1 = jax.tree_util.tree_map(lambda leaf: leaf[0], g)
        o, ne = compression.sync_grads(g1, e[0], ("data",), (dp,))
        return jax.tree_util.tree_map(lambda leaf: leaf[None], o), ne[None]
    sync = jax.jit(shard_map(body, mesh=_mesh((dp,), ("data",)),
                             in_specs=(P("data"), P("data")),
                             out_specs=(P("data"), P("data")),
                             check_vma=False))
    data = _data(cfg)
    rows = BATCH // MB // dp
    for i in range(n_steps):
        batch = data.batch_at(i)
        const = {k: jnp.asarray(batch.pop(k)) for k in ("adc_mask",)
                 if k in batch}
        gs, losses = [], []
        with compat.set_mesh(one):
            for r in range(dp):
                mbs = [{k: jnp.asarray(v[j, r * rows:(r + 1) * rows])
                        for k, v in batch.items()} for j in range(MB)]
                g, loss = accum(params, mbs, const)
                gs.append(g)
                losses.append(loss)
        stacked = jax.tree_util.tree_map(
            lambda *a: np.stack([np.asarray(x) for x in a]), *gs)
        o, err = sync(stacked, err)
        for leaf in jax.tree_util.tree_leaves(o):
            a = np.asarray(leaf)
            assert all(np.array_equal(a[r], a[0]) for r in range(dp))
        grads = jax.tree_util.tree_map(
            lambda leaf: jnp.asarray(np.asarray(leaf)[0]), o)
        loss = sum(losses[1:], losses[0]) / dp          # lax.pmean
        lr = schedule.warmup_cosine(i, peak_lr=cfg.learning_rate,
                                    total=TOTAL)
        params, opt = update(grads, opt, params, lr)
        out[f"{name}/loss{i}"] = np.asarray(loss)
        out[f"{name}/grad_norm{i}"] = np.asarray(adamw.global_norm(grads))
        _keyed(out, f"{name}/grads{i}/", grads)
    _keyed(out, f"{name}/params/", params)
    _keyed(out, f"{name}/m/", opt.m)
    _keyed(out, f"{name}/v/", opt.v)
    out[f"{name}/err"] = _np(err)


def stepped(out, name, cfg, mesh_shape, n_steps=STEPS, loss_fn=False):
    mesh = make_host_mesh(*mesh_shape)
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    with compat.set_mesh(mesh):
        st = steps.init_state(jax.random.PRNGKey(0), cfg, mesh)
        _keyed(out, f"{name}/init/", st.params)
        if loss_fn:
            host = jax.tree_util.tree_map(np.asarray, st.params)
            mb = {k: v[0] for k, v in _data(cfg).batch_at(0).items()}
            for m_shape in ((1, 1), mesh_shape):
                m = make_host_mesh(*m_shape)
                with compat.set_mesh(m):
                    _, metrics = jax.jit(lambda p, b: transformer.loss_fn(
                        p, b, cfg, m))(
                        jax.tree_util.tree_map(jnp.asarray, host),
                        {k: jnp.asarray(v) for k, v in mb.items()})
                tag = f"{name}/loss_fn{m_shape[0]}x{m_shape[1]}"
                out[f"{tag}/ce"] = np.asarray(metrics["ce"])
                out[f"{tag}/aux"] = np.asarray(metrics["aux"])
        step = jax.jit(steps.make_train_step(cfg, mesh, shape,
                                             microbatches=MB,
                                             total_steps=TOTAL))
        data = _data(cfg)
        for i in range(n_steps):
            st, m = step(st, data.device_batch(i), jnp.asarray(i, jnp.int32))
            out[f"{name}/loss{i}"] = np.asarray(m["loss"])
            out[f"{name}/grad_norm{i}"] = np.asarray(m["grad_norm"])
    _keyed(out, f"{name}/params/", st.params)
    _keyed(out, f"{name}/m/", st.opt.m)
    _keyed(out, f"{name}/v/", st.opt.v)
    if st.err is not None:
        out[f"{name}/err"] = _np(st.err)


def main(path, parts):
    out = {"shape": np.array([SEQ, BATCH, MB, STEPS, TOTAL])}
    int8 = smoke_config("deepseek-7b").replace(grad_compression="int8")
    runs = {
        "ring": lambda: ring(out),
        "int8_dp2": lambda: composed(out, "int8_dp2", int8, 2),
        "moe_int8_dp2": lambda: composed(
            out, "moe_int8_dp2",
            smoke_config("kimi-k2-1t-a32b").replace(grad_compression="int8"),
            2, n_steps=2),
        "int8_dp1": lambda: stepped(out, "int8_dp1", int8, (1, 1)),
        "none_dp2": lambda: stepped(out, "none_dp2",
                                    smoke_config("deepseek-7b"), (2, 1)),
        "musicgen_extra_dp": lambda: stepped(
            out, "musicgen_extra_dp", smoke_config("musicgen-medium"),
            (2, 2)),
        "hymba_extra_dp": lambda: stepped(
            out, "hymba_extra_dp", smoke_config("hymba-1.5b"), (2, 2)),
        "moe_none_dp2": lambda: stepped(
            out, "moe_none_dp2", smoke_config("kimi-k2-1t-a32b"), (2, 1),
            n_steps=2, loss_fn=True),
    }
    for part in parts:
        if part == "pinned":
            try:
                stepped({}, "pinned", int8, (2, 1))
                out["pinned_error"] = np.array("")
            except ValueError as exc:
                out["pinned_error"] = np.array(str(exc))
        else:
            runs[part]()
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
