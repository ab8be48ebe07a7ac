"""Performance layer: workload vocabulary, the cost model priced from the
hand kernels, and the tile autotuner. Counterpart of ``repro/perf``.

  workload   - ``Workload``, ``shape_class``, ``workload_of``.
  cost_model - the H100 machine row, each entry's bytes and operations as
               the CUDA bodies move and do them, the roofline record.
  autotune   - per entry and shape class, every candidate tile timed on
               the card with CUDA events; the winners as a JSON table
               (``kernels/tuned_tables.json``) that kernels/dispatch.py
               consults.

Import-light on purpose: kernels/dispatch.py imports the workload
vocabulary at module import, so only ``workload`` loads eagerly;
``cost_model`` and ``autotune`` resolve lazily on first attribute access.
"""
from repro_torch.perf.workload import (Workload, shape_class,  # noqa: F401
                                       workload_of)

_LAZY = ("cost_model", "autotune")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return importlib.import_module(f"repro_torch.perf.{name}")
    raise AttributeError(
        f"module 'repro_torch.perf' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
