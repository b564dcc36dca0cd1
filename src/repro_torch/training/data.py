"""Synthetic-but-deterministic data pipeline with resumable state, the
port's copy of ``repro.training.data``.

Structured pseudo-text (Zipf-distributed token ids with short-range
repetition patterns a model can learn), drawn with numpy from a (seed,
step) pair exactly as the JAX package draws it, so the two packages' batches
are the same tokens bit for bit.  The state is trivially checkpointable.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class DataState:
    seed: int
    step: int


def make_batch(state: DataState, batch: int, seq: int, vocab: int,
               device: str | torch.device = "cuda"
               ) -> tuple[torch.Tensor, DataState]:
    """int32 tokens [batch, seq] on ``device`` and the next state."""
    rng = np.random.default_rng(state.seed * 1_000_003 + state.step)
    # Zipf body + learnable bigram structure: x[t+1] = (a*x[t]+c) % K patterns
    base = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
    base = np.minimum(base, vocab - 1)
    a = rng.integers(3, 17, size=(batch, 1))
    mask = rng.random((batch, seq)) < 0.7
    lin = (a * np.arange(seq)[None, :] + 7) % max(vocab // 4, 2)
    toks = np.where(mask, lin, base).astype(np.int32)
    return (torch.from_numpy(toks).to(resolve_device(device)),
            DataState(state.seed, state.step + 1))
