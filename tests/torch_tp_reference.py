"""The JAX package's tensor-parallel results for the port's parity tests
(tests/test_torch_tensor_parallel.py, tests/test_torch_tp_train.py),
computed in a process of their own.

    python tests/torch_tp_reference.py OUT.npz PART [PART ...]

The reference splits its weights over 'model' with GSPMD, which needs
real devices, and JAX fixes its device count when it starts, so this runs
apart from the tests with 4 forced host devices and writes every named
part's results into one ``.npz``. Parameters come from
``transformer.init_params(PRNGKey(0), smoke_config(arch))`` and are
placed with ``jax.device_put`` under ``sharding.param_shardings`` (the
inference specs for serving, the training specs for the train step), so
GSPMD really splits them. Parts:

* ``serve:ARCH``: ``serving.prefill`` (2 extra cache slots) of a 4 x 32
  prompt and 2 ``serving.decode_step``s, jitted, on a (1, 2) and a
  (2, 2) host mesh: the prefill's last-position logits and each decode
  step's logits. Tokens (or, for a frontend arch, embeddings: qwen2-vl's
  text prompt, its three M-RoPE components equal) come from
  ``np.random.default_rng(0)``.
* ``train:ARCH:DxM`` and ``train_int8:ARCH:DxM``: the reference's own
  jitted ``make_train_step`` on a (D, M) host mesh, 2 steps at batch
  8 x 32 in 2 microbatches on ``SyntheticLM``'s batches (total_steps
  30): loss and grad norm per step, the final parameters and AdamW
  moments (and the int8 error row).
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import smoke_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.data import lm  # noqa: E402
from repro.distributed import sharding  # noqa: E402
from repro.launch.mesh import make_host_mesh  # noqa: E402
from repro.models import serving, steps, transformer  # noqa: E402

B, S, GEN, EXTRA = 4, 32, 2, 2
SEQ, BATCH, MB, STEPS, TOTAL = 32, 8, 2, 2, 30


def _np(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _keyed(out, prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(path)] = _np(leaf)


def _inputs(cfg, rng, b, s, start):
    pos = np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                          (b, s)).copy()
    if cfg.mrope:
        pos = np.stack([pos] * 3, -1)
    if cfg.frontend:
        out = {"embeddings": rng.random((b, s, cfg.frontend_dim),
                                        np.float32)}
    else:
        out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)}
    out["positions"] = pos
    return out


def serve(out, arch):
    cfg = smoke_config(arch)
    params = transformer.init_params(jax.random.PRNGKey(0), cfg)
    _keyed(out, f"serve:{arch}/init/", params)
    rng = np.random.default_rng(0)
    prompt = _inputs(cfg, rng, B, S, 0)
    steps_in = [_inputs(cfg, rng, B, 1, S + i) for i in range(GEN)]
    for name, arr in prompt.items():
        out[f"serve:{arch}/prompt/{name}"] = arr
    for i, st in enumerate(steps_in):
        for name, arr in st.items():
            out[f"serve:{arch}/step{i}/{name}"] = arr
    for shape in ((1, 2), (2, 2)):
        mesh = make_host_mesh(*shape)
        tag = f"serve:{arch}/{shape[0]}x{shape[1]}"
        with compat.set_mesh(mesh):
            placed = jax.device_put(params, sharding.param_shardings(
                params, mesh, cfg, inference=True))
            prefill = jax.jit(lambda p, b: serving.prefill(
                p, b, cfg, mesh, extra_slots=EXTRA))
            decode = jax.jit(lambda p, b, c: serving.decode_step(
                p, b, c, cfg, mesh))
            logits, cache = prefill(placed, {k: jnp.asarray(v)
                                             for k, v in prompt.items()})
            out[f"{tag}/prefill"] = np.asarray(logits)
            for i, st in enumerate(steps_in):
                logits, cache = decode(placed, {k: jnp.asarray(v)
                                                for k, v in st.items()},
                                       cache)
                out[f"{tag}/decode{i}"] = np.asarray(logits)


def train(out, name, arch, compression, shape):
    cfg = smoke_config(arch).replace(grad_compression=compression)
    mesh = make_host_mesh(*(int(n) for n in shape.split("x")))
    shape = ShapeConfig("t", SEQ, BATCH, "train")
    data = lm.SyntheticLM(lm.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
        microbatches=MB), cfg)
    with compat.set_mesh(mesh):
        st = steps.init_state(jax.random.PRNGKey(0), cfg, mesh)
        _keyed(out, f"{name}/init/", st.params)
        specs = sharding.param_shardings(st.params, mesh, cfg)
        st = st._replace(params=jax.device_put(st.params, specs),
                         opt=st.opt._replace(
                             m=jax.device_put(st.opt.m, specs),
                             v=jax.device_put(st.opt.v, specs)))
        step = jax.jit(steps.make_train_step(cfg, mesh, shape,
                                             microbatches=MB,
                                             total_steps=TOTAL))
        for i in range(STEPS):
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
    for part in parts:
        kind, arch, *shape = part.split(":")
        if kind == "serve":
            serve(out, arch)
        else:
            train(out, part, arch, "int8" if kind == "train_int8" else "none",
                  shape[0])
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
