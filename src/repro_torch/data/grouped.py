"""Group-partitioned synthetic corpus (``repro/data/grouped.py``).

A keyed collection ``group_id -> stream of examples``; a round samples a
cohort of groups (the DrJAX partition) and each group yields
``num_local_steps`` batches of ``(batch, seq)`` tokens, deterministic in
(group_id, round). The streams are the reference's, bit for bit: the same
numpy ``SeedSequence`` keys and the same draws. Only ``round_batch`` differs,
returning tensors on an explicit device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import compat


@dataclasses.dataclass(frozen=True)
class GroupedCorpus:
    """Deterministic group-keyed synthetic corpus."""

    vocab_size: int
    num_groups: int = 1 << 20
    seed: int = 0

    def _rng(self, group_id: int, round_idx: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, group_id, round_idx])
        )

    def group_batches(self, group_id: int, round_idx: int,
                      num_local_steps: int, batch: int, seq: int) -> np.ndarray:
        """(num_local_steps, batch, seq+1) int32 tokens for one group/round."""
        rng = self._rng(group_id, round_idx)
        bias = (group_id * 2654435761) % max(self.vocab_size // 4, 1)
        toks = rng.integers(
            0, self.vocab_size, size=(num_local_steps, batch, seq + 1)
        )
        skew = rng.random((num_local_steps, batch, seq + 1)) < 0.15
        toks = np.where(skew, (toks + bias) % self.vocab_size, toks)
        return toks.astype(np.int32)


@dataclasses.dataclass
class CohortSampler:
    """Samples a cohort of group ids per round (with over-provisioning)."""

    corpus: GroupedCorpus
    cohort_size: int
    oversample: int = 0
    seed: int = 17

    def cohort(self, round_idx: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, round_idx])
        )
        n = self.cohort_size + self.oversample
        return rng.choice(self.corpus.num_groups, size=n, replace=False)

    def round_batch(self, round_idx: int, num_local_steps: int, batch: int,
                    seq: int, device="cuda") -> dict:
        """Stacked cohort data on ``device``: tokens (n, steps, batch, seq)
        and labels (the next tokens), int32."""
        dev = compat.resolve_device(device)
        ids = self.cohort(round_idx)
        toks = torch.from_numpy(np.stack([
            self.corpus.group_batches(int(g), round_idx, num_local_steps,
                                      batch, seq)
            for g in ids
        ])).to(dev)  # (n, steps, batch, seq+1)
        return {
            "group_ids": ids,
            "tokens": toks[..., :-1],
            "labels": toks[..., 1:],
        }
