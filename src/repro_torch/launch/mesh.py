"""Device meshes. Counterpart of ``repro/launch/mesh.py`` and of
``repro/compat.py``'s ``make_mesh``.

The port's mesh is single-process, as the reference's is: one Python
process sees every device of the mesh, places each shard's operands on
its device, launches the shards in mesh order and gathers the results
(``kernels/ops.*_sharded``, ``core/search.evaluate_population_sharded``).
A ``Mesh`` is only the device grid and its axis names; no process group
stands behind it. Devices may repeat: ``[cuda:0, cuda:0]`` is a two-shard
mesh on one card, and ``[cpu, cpu]`` the tests' two-shard mesh, so the
split, the per-shard launches and the gather all run on one device.

The LM train step (``models/steps.py``) runs data parallel over such a
mesh, and tensor parallel over its 'model' axis
(``distributed/tensor_parallel.py``), as LM serving does
(``models/serving.py``, (1, tp) meshes). ``make_production_mesh`` is
the production LM job's topology, the reference's (16, 16) ('data', 'model') pod or (2, 16, 16) with 'pod', as
an ``AbstractMesh``: axis names and sizes over ``meta`` entries, no
device behind them. The dry run (``launch/dryrun.py``) reads its specs
and counts rank 0 of one device's step on meta tensors; no step runs
over it (``models/steps.py`` refuses it, ROADMAP A11.9), and it has no
first device.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _normalize(device: DeviceLike) -> torch.device:
    """``device`` resolved (raising for ``cuda`` without a card), a CUDA
    device with its index, so equal devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices(device: DeviceLike = None) -> list:
    """Every visible device of ``device``'s type: all CUDA cards for
    ``cuda`` (the default; raises without a card), one entry for
    ``cpu``."""
    dev = _normalize(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """A named grid of devices: ``devices`` (a numpy object array of
    ``torch.device``, shaped like the mesh), ``axis_names`` and
    ``shape`` (axis name -> size), as ``jax.sharding.Mesh`` has them."""

    def __init__(self, devices, axis_names: Sequence[str]) -> None:
        arr = np.asarray(devices, dtype=object)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"devices of shape {arr.shape} do not fit the "
                             f"axes {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"repeated mesh axis names {names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        flat = np.empty(arr.size, dtype=object)
        flat[:] = [_normalize(d) for d in arr.reshape(-1)]
        self.devices = flat.reshape(arr.shape)
        self.axis_names: Tuple[str, ...] = names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first_device(self) -> torch.device:
        """Where unsharded work runs and sharded outputs gather."""
        return self.devices.reshape(-1)[0]

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, "
                f"devices={[str(d) for d in self.devices.reshape(-1)]})")


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (default: every visible CUDA
    card, raising without one), filled in row-major order. The device
    count must equal the product of ``shape``, as ``jax.make_mesh``
    requires."""
    shape = tuple(int(s) for s in shape)
    devs = visible_devices() if devices is None else list(devices)
    if len(shape) != len(tuple(axes)):
        raise ValueError(f"mesh shape {shape} does not fit the axes "
                         f"{tuple(axes)}")
    if math.prod(shape) != len(devs):
        raise ValueError(f"a mesh of shape {shape} needs "
                         f"{math.prod(shape)} devices, got {len(devs)}")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axes)


def work_device(device: DeviceLike = None, mesh: Optional[Mesh] = None
                ) -> torch.device:
    """Where a call's unsharded work runs and its sharded outputs gather:
    ``mesh``'s first device when a mesh is given, else ``device``
    resolved (default ``cuda``). A ``device`` given beside a mesh must be
    that first device; a conflict raises instead of picking one."""
    if mesh is None:
        return resolve_device(device)
    first = mesh.first_device
    if device is not None and _normalize(device) != first:
        raise ValueError(f"device {device} conflicts with the mesh, whose "
                         f"work runs on its first device {first}")
    return first


def make_host_mesh(data: int = 1, model: int = 1, *,
                   device: DeviceLike = None) -> Mesh:
    """A small ('data', 'model') mesh over the first ``data * model``
    visible devices of ``device``'s type (default ``cuda``), raising
    where fewer cards are visible. Two cases repeat one device in every
    entry instead: the CPU, which is one device, and a card named by its
    index (``cuda:0``: a (1, 2) mesh is ``[cuda:0, cuda:0]``, one card
    standing in for two ranks)."""
    n = data * model
    asked = torch.device("cuda" if device is None else device)
    if asked.type == "cpu" or asked.index is not None:
        return make_mesh((data, model), ("data", "model"),
                         devices=[_normalize(asked)] * n)
    devs = visible_devices(asked)
    if len(devs) < n:
        raise ValueError(f"a ({data}, {model}) mesh needs {n} cards, "
                         f"{len(devs)} are visible (name one card, e.g. "
                         f"cuda:0, to run every rank on it)")
    return make_mesh((data, model), ("data", "model"), devices=devs[:n])


class AbstractMesh(Mesh):
    """A mesh of axis names and sizes only: every entry is
    ``torch.device("meta")``. The sharding rules read it as any mesh;
    nothing runs on it."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]) -> None:
        names = tuple(axes)
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh shape {shape} does not fit the axes "
                             f"{names}")
        arr = np.empty(math.prod(shape), dtype=object)
        arr[:] = [torch.device("meta")] * arr.size
        self.devices = arr.reshape(shape)
        self.axis_names = names

    @property
    def first_device(self) -> torch.device:
        raise ValueError("an abstract mesh has no device to run on: the "
                         "dry run counts one device's step on meta tensors "
                         "(launch/dryrun.py)")


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production LM job's topology, the reference's: 16 x 16 = 256
    devices ('data', 'model'), or 2 pods of them (512, 'pod' first)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def describe(mesh: Mesh) -> str:
    return f"mesh(shape={dict(mesh.shape)}, devices={mesh.devices.size})"
