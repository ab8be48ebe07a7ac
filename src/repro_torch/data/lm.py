"""Deterministic LM data. Counterpart of ``repro/data/lm.py``, copied: the
same seeded synthetic corpus (Zipfian unigrams overwritten with repeated
n-gram motifs, so losses fall well below log V), drawn from the same
numpy streams, so ``batch_at(step)`` is bitwise the reference's.

* ``batch_at(step)`` is a pure function of (seed, step): a replay after a
  restore sees the same batches, and skipping to step N needs no scan;
* the microbatch reshape happens here, so the train step sees
  (n_mb, b, ...) leaves; ``adc_mask``, a constant, keeps its own shape;
* frontend archs get frame embeddings from a fixed random codebook
  (seed + 1) and, with the pruned ADC, an all-ones level mask.

``device_batch(step, device)`` returns the batch as torch tensors on
``device``. Under M-RoPE its positions are the reference's, three equal
components; ``mrope_grid_positions`` builds a vision prompt's (B, S, 3)
positions, which tell M-RoPE from plain RoPE.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


@dataclass
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    microbatches: int = 1
    seed: int = 0
    motif_len: int = 16
    n_motifs: int = 64


def mrope_grid_positions(batch: int, grids, text: int) -> np.ndarray:
    """(batch, S, 3) int32 M-RoPE positions (t, h, w) of a prompt of images
    then ``text`` text tokens, the layout of Qwen2-VL's rope index: image
    g of ``grids`` (t, h, w patches) holds t * h * w tokens at (p + ti,
    p + hi, p + wi), ti, hi and wi walking its patch grid in (t, h, w)
    order, where p is the next free position (0 for the first image);
    each component of the text tokens after it equals p + max(t, h, w)
    + j. S = sum(t h w) + text."""
    rows, p = [], 0
    for t, h, w in grids:
        ti, hi, wi = np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                                 indexing="ij")
        rows.append(p + np.stack([ti.ravel(), hi.ravel(), wi.ravel()], -1))
        p += max(t, h, w)
    rows.append(np.repeat(p + np.arange(text)[:, None], 3, axis=1))
    pos = np.concatenate(rows).astype(np.int32)
    return np.ascontiguousarray(np.broadcast_to(pos, (batch,) + pos.shape))


class SyntheticLM:
    def __init__(self, cfg: LMDataConfig, arch: Optional[ArchConfig] = None):
        self.cfg = cfg
        self.arch = arch
        rng = np.random.default_rng(cfg.seed)
        # fixed motif bank: repeated structure the model can learn
        self.motifs = rng.integers(
            0, cfg.vocab_size, (cfg.n_motifs, cfg.motif_len)).astype(np.int32)
        # Zipf-ish unigram distribution
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self.unigram = p / p.sum()

    def _tokens(self, rng, shape) -> np.ndarray:
        flat = rng.choice(self.cfg.vocab_size, size=int(np.prod(shape)),
                          p=self.unigram).astype(np.int32)
        toks = flat.reshape(shape)
        # overwrite random windows with motifs (predictable continuations)
        b, s = shape
        for i in range(b):
            for _ in range(max(s // (4 * self.cfg.motif_len), 1)):
                m = self.motifs[rng.integers(0, self.cfg.n_motifs)]
                start = rng.integers(0, max(s - self.cfg.motif_len, 1))
                toks[i, start:start + self.cfg.motif_len] = \
                    m[: max(min(self.cfg.motif_len, s - start), 0)]
        return toks

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for ``step`` (tokens or embeddings, labels,
        positions, adc_mask), every leaf but adc_mask (n_mb, b, ...)."""
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        seq = self._tokens(rng, (c.global_batch, c.seq_len + 1))
        tokens, labels = seq[:, :-1], seq[:, 1:]
        pos = np.broadcast_to(np.arange(c.seq_len, dtype=np.int32),
                              tokens.shape).copy()
        out: Dict[str, np.ndarray] = {"positions": pos, "labels": labels}
        if self.arch is not None and self.arch.frontend:
            # stub modality frontend: embed tokens into analog frames
            emb_rng = np.random.default_rng(c.seed + 1)
            codebook = emb_rng.random((c.vocab_size, self.arch.frontend_dim)
                                      ).astype(np.float32)
            out["embeddings"] = codebook[tokens]
            if self.arch.adc.enable:
                out["adc_mask"] = np.ones(
                    (self.arch.frontend_dim, 2 ** self.arch.adc.bits), np.int32)
        else:
            out["tokens"] = tokens
        if self.arch is not None and self.arch.mrope:
            out["positions"] = np.stack([pos] * 3, axis=-1)
        # the train step always walks a leading microbatch axis (n_mb >= 1)
        nm = c.microbatches
        out = {k: (v if k == "adc_mask" else
                   v.reshape(nm, v.shape[0] // nm, *v.shape[1:]))
               for k, v in out.items()}
        return out

    def device_batch(self, step: int, device=None) -> Dict[str, torch.Tensor]:
        """``batch_at(step)`` as torch tensors on ``device`` (the CPU when
        None)."""
        dev = torch.device("cpu" if device is None else device)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in self.batch_at(step).items()}
