"""Flat (non-grouped) synthetic LM stream for plain data-parallel training
(``repro/data/synthetic.py``). The same numpy ``SeedSequence`` keys and
draws as the reference, so the tokens are the reference's, bit for bit;
only the tensors' device is explicit."""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from .. import compat


def synthetic_lm_batch(step: int, batch: int, seq: int, vocab: int,
                       seed: int = 0, device="cuda") -> dict:
    """tokens and labels (the next tokens), (batch, seq) int32 on
    ``device``, deterministic in (seed, step)."""
    dev = compat.resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    toks = rng.integers(0, vocab, size=(batch, seq + 1), dtype=np.int64)
    toks = torch.from_numpy(toks.astype(np.int32)).to(dev)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass
class SyntheticLMStream:
    batch: int
    seq: int
    vocab: int
    seed: int = 0
    step: int = 0
    device: str = "cuda"

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = synthetic_lm_batch(self.step, self.batch, self.seq, self.vocab,
                               self.seed, device=self.device)
        self.step += 1
        return b

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
        self.seed = int(state["seed"])
