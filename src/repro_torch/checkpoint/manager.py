"""Numpy-only artifact store in the reference's checkpoint format
(counterpart of ``repro/checkpoint/manager.py``), so a front saved by
either package loads in the other:

* ``<dir>/step_<N>/`` holds one ``.npy`` per leaf of a nested dict, named
  by its path with ``/`` replaced by ``__`` (``design_000/w1`` ->
  ``design_000__w1.npy``), plus ``metadata.json`` whose ``leaves`` map
  lists every leaf with its shape and dtype;
* a save writes ``step_<N>.tmp`` and renames it into place, so a crash
  mid-save never leaves a half-written step.

Non-array state rides as a uint8 leaf of packed JSON (``pack_json``).
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np


def pack_json(obj: Any) -> np.ndarray:
    """JSON-serializable object -> uint8 array leaf."""
    return np.frombuffer(json.dumps(obj).encode("utf-8"), np.uint8).copy()


def unpack_json(arr) -> Any:
    return json.loads(bytes(np.asarray(arr, np.uint8)))


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, Any]:
    """Nested dict -> {"a/b": leaf}, keys in sorted order at every level
    (the order the reference's tree flattening gives dicts)."""
    flat = {}
    for key in sorted(tree):
        value = tree[key]
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            flat.update(_flatten(value, path + "/"))
        elif value is not None:
            flat[path] = value
    return flat


def _leaf_file(directory: Path, key: str) -> Path:
    return directory / (key.replace("/", "__") + ".npy")


class CheckpointManager:
    def __init__(self, directory):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def save(self, step: int, tree: Dict) -> None:
        """Write ``tree`` (a nested dict of arrays) as step ``step``,
        atomically, replacing an earlier save of the same step."""
        host = {k: np.asarray(v) for k, v in _flatten(tree).items()}
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

    def restore_flat(self, step: int) -> Dict[str, np.ndarray]:
        """Every leaf saved at ``step`` as a numpy array, keyed by its
        path; ``metadata.json`` enumerates the leaves, so no structure
        needs to be known beforehand."""
        d = self.dir / f"step_{step}"
        meta = json.loads((d / "metadata.json").read_text())
        return {k: np.load(_leaf_file(d, k)) for k in meta["leaves"]}
