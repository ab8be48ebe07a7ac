"""Serving steps of the LM. Counterpart of ``make_prefill_step`` and
``make_decode_step`` in ``repro/models/steps.py``; the train steps come
with the LM training slice (ROADMAP A11). PyTorch runs eagerly, so a step
is the plain function with the config bound (no jit, no mesh)."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import serving


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch):
        return serving.prefill(params, batch, cfg)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    def decode_step(params, batch, cache):
        return serving.decode_step(params, batch, cache, cfg)
    return decode_step
