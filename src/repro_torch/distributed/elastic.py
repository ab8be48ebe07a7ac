"""Elastic meshes: rebuild the mesh from the devices that are alive.
Counterpart of ``repro/distributed/elastic.py``.

**What the classifier serving engine uses** (launch/serving_engine.py):
``bank_pool_mesh``. A sharded ``DevicePool`` re-meshes the design bank
over the survivors after a device loss, down to unsharded serving on one
device, and the bit-for-bit served == exported parity is re-asserted
before serving resumes.

``plan_mesh`` / ``make_elastic_mesh`` are the TP-pinned (pod, data,
model) degradation policy of large pod jobs, copied; the classifier bank
has no TP axis, so serving does not use them, and no LM launcher does
either: they cannot repeat a device and they shrink 'model' below the
asked size when fewer devices are visible, where the launchers'
``make_host_mesh`` keeps it (raising, or repeating one named device).
``reshard_state`` restores an
LM train state from a checkpoint onto a new mesh (the data-, FSDP- and
tensor-parallel train step of ``models/steps.py``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.launch import mesh as mesh_lib


def bank_pool_mesh(devices: Sequence) -> mesh_lib.Mesh:
    """A (n, 1) ('data', 'model') mesh over an explicit list of surviving
    devices: the serving engine's re-shard target. The design-bank rules
    (distributed/sharding.design_bank_axes) split the bank's D axis over
    'data' when it divides, else the bank serves unsharded."""
    devices = list(devices)
    if not devices:
        raise ValueError("bank_pool_mesh needs at least one device")
    return mesh_lib.make_mesh((len(devices), 1), ("data", "model"),
                              devices=devices)


def plan_mesh(n_devices: int, *, model: int = 16, chips_per_pod: int = 256):
    """Largest (pod, data, model) grid using <= n_devices devices. The pod
    count follows physical pods (256 chips each); capacity loss inside a
    pod shrinks 'data'; TP degrades last (to a power of two) only when
    fewer than ``model`` devices survive."""
    if n_devices < model:
        m = 1
        while m * 2 <= n_devices:
            m *= 2
        return (1, max(n_devices // m, 1), m)
    rest = n_devices // model
    pods = max(n_devices // chips_per_pod, 1)
    while pods > 1 and rest % pods:
        pods -= 1
    return (pods, rest // pods, model)


def make_elastic_mesh(devices: Optional[Sequence] = None, *,
                      model: int = 16) -> mesh_lib.Mesh:
    """Mesh over surviving devices (default: every visible CUDA card,
    raising without one). Drops remainder devices that do not fill the
    grid (they rejoin at the next restart boundary)."""
    devices = list(devices if devices is not None
                   else mesh_lib.visible_devices())
    pods, data, tp = plan_mesh(len(devices), model=model)
    n = pods * data * tp
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    shape = (pods, data, tp) if pods > 1 else (data, tp)
    axes = ("pod", "data", "model") if pods > 1 else ("data", "model")
    return mesh_lib.Mesh(arr.reshape(shape), axes)


def reshard_state(ckpt, step: int, state_like, new_mesh, cfg):
    """The ``TrainState`` saved at ``step`` restored onto ``new_mesh``: the
    parameters and the AdamW state placed as ``fsdp.param_plan`` places
    them on ``new_mesh``, as the reference's ``reshard_state`` places
    them with ``param_shardings``: uncompressed over dp > 1, each dp
    slice's pieces on its devices (split over 'model' too where the
    'model' plan splits the leaf); else the 'model' plan's slices on the
    first dp slice's ranks and the rest whole on the first device. A
    checkpoint holds whole leaves, so any dp and 'model' size restores,
    a leaf at a time. Under ``grad_compression="int8"`` one error row
    per dp rank of ``new_mesh`` on the rank's first device.
    ``state_like`` gives the tree (its tensors' devices and splits are
    not read).

    The reference restores the saved (dp, n) buffer as it is and leaves
    its step to shard it; it cannot load a bfloat16 leaf at all (ROADMAP
    C). Each error row is one rank's unsent residual, so a checkpoint
    whose row count is not the new mesh's dp size is refused (ROADMAP
    C), as is a compressed state without rows."""
    from repro_torch.distributed import fsdp
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.models import steps

    dev = new_mesh.first_device
    plan = fsdp.param_plan(cfg, new_mesh)

    def placed(t, path=()):
        while isinstance(t, list):          # a split leaf's first part
            t = t[0]
        if isinstance(plan, fsdp.Plan):
            return plan.stand_in(path, t.dtype)
        if plan is None or not plan.split(path):
            return torch.empty(0, dtype=t.dtype, device=dev)
        return TP.Shards([torch.empty(0, dtype=t.dtype, device=d)
                          for d in plan.devices], plan.dims[path],
                         plan.ranks, plan.tp)

    def tree(node, path=()):
        if isinstance(node, dict):
            return {k: tree(v, path + (k,)) for k, v in node.items()}
        return placed(node, path)

    opt = state_like.opt
    like = steps.TrainState(
        tree(state_like.params),
        type(opt)(step=placed(opt.step), m=tree(opt.m), v=tree(opt.v)))
    if cfg.grad_compression == "int8":
        devs = steps.dp_devices(new_mesh)
        saved = ckpt.leaves(step).get("err")
        if saved is None or saved["shape"][0] != len(devs):
            raise NotImplementedError(
                f"step {step} holds "
                f"{'no error rows' if saved is None else saved['shape'][0]}"
                f" error rows and {new_mesh} has {len(devs)} dp ranks: "
                f"moving the int8 ring's residuals to a new dp size is not "
                f"defined (ROADMAP C)")
        like = like._replace(err=[torch.empty(0, dtype=torch.bfloat16,
                                              device=d) for d in devs])
    return ckpt.restore(step, like)
