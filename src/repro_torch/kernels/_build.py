"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each source is a plain-C-interface shared library, compiled for sm_90a at
its first CUDA use into ``<repo>/build/repro_torch/`` (listed in
.gitignore). The file name carries a hash of the source and the flags, so
an edited source rebuilds and an unchanged one loads as is. Several
sources build in parallel, one nvcc each (``build_all``). A failed build
raises; nothing falls back. No fast-math: the kernels' ``floorf`` code math
must round exactly as the plain versions do, and the attention kernels'
``expf``/``tanhf`` stay the accurate ones. ``-Xptxas -v`` writes each
kernel's register and shared-memory use into a ``.log`` beside the library.

The wrappers may launch from several threads at once: autograd runs a
backward's nodes on a thread of each CUDA device, so a backward split
over distinct cards (``distributed/tensor_parallel.py``) calls the
attention kernels' backward wrappers from two threads. ``load`` builds
and opens a library under one lock, and ``count_launch`` adds to a
launch counter under another.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"qmlp_bank": CSRC / "qmlp_bank.cu",
           "adc_quantize": CSRC / "adc_quantize.cu",
           "mc_eval": CSRC / "mc_eval.cu",
           "flash_attention": CSRC / "flash_attention.cu",
           "flash_attention_tc": CSRC / "flash_attention_tc.cu",
           "flash_attention_bwd": CSRC / "flash_attention_bwd.cu",
           "flash_attention_bwd_tc": CSRC / "flash_attention_bwd_tc.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = SOURCES[name].read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every named source that is not built yet, all nvcc processes
    started together. Returns {name: seconds} for the ones built (0.0 for
    those already present). Raises RuntimeError with nvcc's output if any
    build fails."""
    names = list(SOURCES if names is None else names)
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    seconds = {n: 0.0 for n in names}
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.is_file():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output (with ``-Xptxas -v``) from the build of ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it first if needed (one
    thread at a time: two builds of one source would write one
    temporary file)."""
    with _LOAD_LOCK:
        return _load(name)


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    build_all([name])
    return ctypes.CDLL(str(library_path(name)))


def count_launch(counts: Dict[str, int], key: str) -> None:
    """``counts[key] += 1`` under a lock: a read then a write, which two
    threads launching at once could otherwise interleave and lose."""
    with _COUNT_LOCK:
        counts[key] += 1
