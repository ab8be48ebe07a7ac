"""Numpy-only artifact store in the reference's checkpoint format
(counterpart of ``repro/checkpoint/manager.py``), so a front saved by
either package loads in the other:

* ``<dir>/step_<N>/`` holds one ``.npy`` per leaf of a nested dict, named
  by its path with ``/`` replaced by ``__`` (``design_000/w1`` ->
  ``design_000__w1.npy``), plus ``metadata.json`` whose ``leaves`` map
  lists every leaf with its shape and dtype;
* a save writes ``step_<N>.tmp`` and renames it into place, so a crash
  mid-save never leaves a half-written step;
* keep-N retention: after each save only the ``keep`` newest steps stay,
  and ``latest_step`` names the one a restart resumes from.

Trees are nested dicts (keys sorted, as the reference's tree flattening
orders them), NamedTuples and dataclasses (fields in declaration order);
anything else is a leaf, a numpy array or a tensor (copied to the host
on save), and None is no leaf. A ``TrainState(params, opt, err)`` with an
``OptState(step, m, v)`` therefore saves as ``params/...``,
``opt/step``, ``opt/m/...``, ``opt/v/...`` and, under int8 compression,
``err``, the reference's names, and a checkpoint written by either
package restores in the other. ``err``'s rows (one per dp rank, each on
its device) save as the reference's one (dp, n) leaf. numpy has no
bfloat16, so a bfloat16 leaf is saved as its raw 2-byte patterns (dtype
``V2``, the bytes the reference's ``ml_dtypes`` array writes) and
restored as bfloat16 where ``like``'s leaf is. A leaf split over 'model'
(``tensor_parallel.Shards``) or over the dp slices (``fsdp.Pieces``,
each piece perhaps split over 'model' too) saves whole, its slices and
pieces concatenated in rank and slice order: the reference's global
array. It restores into ``like``'s placement, each slice and piece on
its device (``fsdp.place_like``), so a checkpoint restores onto any
mesh.

Saves are synchronous: the leaves are copied to the host and written
before ``save`` returns, so ``wait`` (the reference's join of its
background writer) has nothing to wait for. A train step that updates
its tensors in place after a save cannot reach the saved copy.

Non-array state rides as a uint8 leaf of packed JSON (``pack_json``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.arrays import tensor_from_numpy
from repro_torch.distributed import fsdp
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.tensor_parallel import Shards


def pack_json(obj: Any) -> np.ndarray:
    """JSON-serializable object -> uint8 array leaf."""
    return np.frombuffer(json.dumps(obj).encode("utf-8"), np.uint8).copy()


def unpack_json(arr) -> Any:
    return json.loads(bytes(np.asarray(arr, np.uint8)))


def _children(node):
    """(key, child) pairs of an inner node, in the reference's order; None
    for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """Tree -> {"a/b": leaf}, in the reference's leaf order."""
    flat = {}
    for key, value in _children(tree):
        path = f"{prefix}{key}"
        if value is None:
            continue
        if _children(value) is not None:
            flat.update(_flatten(value, path + "/"))
        else:
            flat[path] = value
    return flat


def _rows(leaf) -> bool:
    """A list of tensors: the rows of one leaf (``TrainState.err``)."""
    return (isinstance(leaf, list)
            and not isinstance(leaf, (Shards, fsdp.Pieces)) and bool(leaf)
            and all(isinstance(r, torch.Tensor) for r in leaf))


def _host(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a tensor is copied off its device;
    rows are stacked; split leaves gathered whole; bfloat16 as its raw
    bytes, dtype V2)."""
    if _rows(leaf):
        leaf = torch.stack([r.detach().cpu() for r in leaf])
    if isinstance(leaf, (Shards, fsdp.Pieces)):
        leaf = TP.gather_params(leaf, "cpu")
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    return np.asarray(leaf)


def _rebuild(like, flat: Dict[str, Any], prefix: str = ""):
    """``like``'s structure with each leaf replaced by ``flat[path]``."""
    kids = _children(like)
    if kids is None:
        return flat[prefix.rstrip("/")]
    values = {key: (None if child is None
                    else _rebuild(child, flat, f"{prefix}{key}/"))
              for key, child in kids}
    if isinstance(like, dict):
        return {k: values[str(k)] for k in like}
    if isinstance(like, tuple):
        return type(like)(**values)
    return dataclasses.replace(like, **values)


def _leaf_file(directory: Path, key: str) -> Path:
    return directory / (key.replace("/", "__") + ".npy")


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def save(self, step: int, tree) -> None:
        """Write ``tree`` as step ``step``, atomically, replacing an
        earlier save of the same step."""
        host = {k: _host(v) for k, v in _flatten(tree).items()}
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        meta = {"step": step, "time": time.time(),
                "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                           for k, v in host.items()}}
        for k, v in host.items():
            np.save(_leaf_file(tmp, k), v)
        (tmp / "metadata.json").write_text(json.dumps(meta, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        """Delete all but the ``keep`` newest steps."""
        steps = self.all_steps()
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def all_steps(self) -> List[int]:
        """Committed steps in ascending order (``.tmp`` leftovers of an
        interrupted save are not steps)."""
        out = []
        for p in self.dir.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp"):
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def leaves(self, step: int) -> Dict[str, Dict[str, Any]]:
        """``metadata.json``'s ``{path: {"shape", "dtype"}}`` of ``step``,
        nothing loaded."""
        d = self.dir / f"step_{step}"
        return json.loads((d / "metadata.json").read_text())["leaves"]

    def restore_flat(self, step: int) -> Dict[str, np.ndarray]:
        """Every leaf saved at ``step`` as a numpy array, keyed by its
        path; ``metadata.json`` enumerates the leaves, so no structure
        needs to be known beforehand."""
        d = self.dir / f"step_{step}"
        meta = json.loads((d / "metadata.json").read_text())
        return {k: np.load(_leaf_file(d, k)) for k in meta["leaves"]}

    def restore(self, step: int, like, device=None):
        """The tree saved at ``step`` in the structure of ``like``: each
        leaf of ``like`` (a tensor, rows, split ``Shards``, ``fsdp.Pieces``
        or a numpy array) is replaced by the saved leaf of its path, a
        tensor on ``device`` (default: that leaf's own device, each row's
        for rows, each slice's and piece's for a split leaf, placed as
        ``like``'s; numpy leaves
        stay numpy), in the saved dtype.
        ``fault.run_with_recovery`` passes its ``shardings`` here, None on
        the port's one-device step. Raises FileNotFoundError for a leaf
        the step does not hold."""
        d = self.dir / f"step_{step}"
        flat = {}
        for key, leaf in _flatten(like).items():
            arr = np.load(_leaf_file(d, key))
            if _rows(leaf):
                if arr.shape[0] != len(leaf):
                    raise ValueError(
                        f"{key}: step {step} holds {arr.shape[0]} rows, the "
                        f"state {len(leaf)} (a new dp size: "
                        f"distributed/elastic.reshard_state)")
                flat[key] = [tensor_from_numpy(a).to(
                    r.device if device is None else device)
                    for a, r in zip(arr, leaf)]
            elif isinstance(leaf, (Shards, fsdp.Pieces)):
                flat[key] = fsdp.place_like(tensor_from_numpy(arr), leaf,
                                            device)
            elif isinstance(leaf, torch.Tensor):
                flat[key] = tensor_from_numpy(arr).to(
                    leaf.device if device is None else device)
            else:
                flat[key] = arr
        return _rebuild(like, flat)

    def wait(self) -> None:
        """Saves are synchronous (see the module docstring): nothing is
        in flight."""
