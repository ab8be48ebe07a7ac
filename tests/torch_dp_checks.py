"""Shared helpers of the port's data-parallel parity tests
(tests/test_torch_dp_train.py, tests/test_torch_compression.py): the
reference's results from tests/torch_dp_reference.py, run in a
subprocess, and the port's train step on the same parameters and batches.

Tolerances. Uncompressed steps are held as tests/test_torch_lm_train.py
holds three train steps: loss and grad_norm rtol 1e-4, params atol 2e-5,
AdamW moments m rtol 1e-3 atol 3e-7 and v rtol 1e-3 atol 1e-12.

Int8 steps add the quantizer's decisions. The two packages' local
gradients agree to float32 summation order (rtol 1e-4), and an element
whose ``x / scale`` lies that close to a rounding boundary rounds the
other way in one of them: its synced gradient then moves by one int8
step, its error residual by one step of its leaf's scale, and AdamW's
moments carry that on. So an int8 step keeps the float bounds above on
at least 98 % of the synced-gradient and moment elements (measured: all
but 0.0 % to 0.8 %), the error rows are bitwise on at least 90 % of their
elements (measured 95.9 % to 96.7 %), and every element that moved stays
within what one flipped decision a step can do: a synced gradient within
2 int8 steps of the largest gradient (a flip in the fake quantization and
one in the ring, 2 max|g| / 127; measured 1.95 steps of the leaf's own
scale), an error element within 2.5 times the row's largest residual (a
flip moves it by a step, about twice the largest residual), m within 1 /
64 and v within 1 / 32 of the leaf's largest value (three steps of a
one-step flip, 0.1 and 0.05 of it, against moments of 0.27 and 0.14 of the
gradient's scale). Loss, grad_norm and params keep the float bounds: a
flip moves the norm by far less than 1e-4, and AdamW moves an element by
about lr whatever its gradient."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.data import lm
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import steps, transformer
from repro_torch.optim import adamw, compression

REPO = Path(__file__).resolve().parents[1]
FLOAT_TOL = {"params": dict(rtol=0, atol=2e-5),
             "m": dict(rtol=1e-3, atol=3e-7),
             "v": dict(rtol=1e-3, atol=1e-12)}
FLIP_SHARE = 0.02
ERR_EQUAL_SHARE = 0.90


def reference(tmp_dir, *parts, script="torch_dp_reference.py") -> dict:
    """tests/torch_dp_reference.py's ``parts`` (or another reference
    script's, tests/torch_tp_reference.py) in one subprocess."""
    path = Path(tmp_dir) / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(REPO / "tests" / script),
                        str(path), *parts],
                       env=env, capture_output=True, text=True, timeout=400)
    assert r.returncode == 0, r.stdout + r.stderr
    return dict(np.load(path))


def bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(
        torch.bfloat16)


def tree(ref: dict, prefix: str) -> dict:
    """The nested numpy tree saved under ``prefix`` (keys like
    ``['layers']['q']``; bf16 patterns as V2, which
    ``params_from_numpy`` reads)."""
    out: dict = {}
    for key, value in ref.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].strip("[]").split("][")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p.strip("'"), {})
        # a copy: params_from_numpy shares memory, and steps update in place
        node[parts[-1].strip("'")] = (value.view("V2")
                                      if value.dtype == np.uint16
                                      else value).copy()
    return out


def flat(t, prefix="") -> dict:
    """{"['a']['b']": float32 numpy leaf} of a port tree (a split leaf
    gathered whole)."""
    out = {}
    for k in sorted(t):
        v = t[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}['{k}']"))
        elif isinstance(v, TP.Shards):
            out[f"{prefix}['{k}']"] = TP.gather_params(
                v).detach().float().numpy()
        else:
            out[f"{prefix}['{k}']"] = v.detach().float().numpy()
    return out


def port_state(ref, name, cfg, mesh):
    """The reference's initial parameters of part ``name`` as a port
    state, placed as ``tp_plan(cfg, mesh)`` places them, AdamW zero,
    error rows zero (one per dp rank) under int8."""
    params = transformer.params_from_numpy(tree(ref, f"{name}/init/"), cfg,
                                           plan=TP.tp_plan(cfg, mesh))
    state = steps.TrainState(params, adamw.init_tree(params,
                                                     cfg.opt_state_dtype))
    if cfg.grad_compression == "int8":
        devs = ["cpu"] if mesh is None else steps.dp_devices(mesh)
        state = state._replace(err=compression.init_error_buffer(
            params, len(devs), devs))
    return state


def run_port(ref, name, cfg, mesh, n_steps=None):
    """The port's train step of part ``name`` from its initial state:
    (state, [metrics], [synced grads before each step]); the grads are
    taken under int8 only, whose rounding checks read them."""
    seq, batch, mb, n_ref, total = (int(x) for x in ref["shape"])
    shape = ShapeConfig("t", seq, batch, "train")
    state = port_state(ref, name, cfg, mesh)
    grad_step = steps.make_grad_step(cfg, mesh, shape, microbatches=mb)
    step = steps.make_train_step(cfg, mesh, shape, microbatches=mb,
                                 total_steps=total)
    data = lm.SyntheticLM(lm.LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        microbatches=mb), cfg)
    metrics, grads = [], []
    for i in range(n_steps or n_ref):
        b = data.device_batch(i)
        if cfg.grad_compression == "int8":
            grads.append(flat(grad_step(state, b)[0]))
        state, m = step(state, b, i)
        metrics.append(m)
    return state, metrics, grads


def _close(got, want, rtol, atol):
    return np.abs(got - want) <= atol + rtol * np.abs(want)


def assert_metrics(ref, name, metrics):
    for i, m in enumerate(metrics):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]),
                                       float(ref[f"{name}/{key}{i}"]),
                                       rtol=1e-4, err_msg=f"{key} {i}")


def assert_float_state(ref, name, state):
    """Params and moments within the float bounds (module docstring)."""
    for what, t in (("params", state.params), ("m", state.opt.m),
                    ("v", state.opt.v)):
        got = flat(t)
        want = {k[len(f"{name}/{what}/"):]: v for k, v in ref.items()
                if k.startswith(f"{name}/{what}/")}
        assert set(got) == set(want), what
        for key in want:
            np.testing.assert_allclose(got[key], want[key],
                                       err_msg=f"{what}{key}",
                                       **FLOAT_TOL[what])


def _assert_flips(got, want, tol, bound, msg):
    ok = _close(got, want, **tol)
    assert 1 - ok.mean() <= FLIP_SHARE, (msg, 1 - ok.mean())
    worst = np.abs(got - want)[~ok]
    assert worst.size == 0 or worst.max() <= bound, (msg, worst.max(),
                                                     bound)


def assert_int8_state(ref, name, state, grads=None):
    """An int8 step's state (and synced grads) against the reference's
    (module docstring)."""
    got = flat(state.params)
    for key, w in tree_flat(ref, f"{name}/params/").items():
        np.testing.assert_allclose(got[key], w, err_msg=f"params{key}",
                                   **FLOAT_TOL["params"])
    for what, t, share in (("m", state.opt.m, 64), ("v", state.opt.v, 32)):
        got = flat(t)
        for key, w in tree_flat(ref, f"{name}/{what}/").items():
            _assert_flips(got[key], w, FLOAT_TOL[what],
                          np.abs(w).max() / share, f"{what}{key}")
    want = bf16(ref[f"{name}/err"]).float().numpy()
    err = torch.stack([e.float() for e in state.err]).numpy()
    assert err.shape == want.shape
    assert (err == want).mean() >= ERR_EQUAL_SHARE, (err == want).mean()
    bound = 2.5 * np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(err - want) <= bound).all()
    for i, g in enumerate(grads or ()):
        want_g = tree_flat(ref, f"{name}/grads{i}/")
        step = 2 * max(np.abs(w).max() for w in want_g.values()) / 127
        for key, w in want_g.items():
            _assert_flips(g[key], w, dict(rtol=1e-4, atol=1e-6), step,
                          f"grads{i}{key}")


def tree_flat(ref, prefix) -> dict:
    return {k[len(prefix):]: (bf16(v).float().numpy()
                              if v.dtype == np.uint16 else v)
            for k, v in ref.items() if k.startswith(prefix)}
