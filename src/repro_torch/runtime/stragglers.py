"""Straggler mitigation: over-provisioned cohorts + deadline-masked reduce
(``repro/runtime/stragglers.py``).

MapReduce semantics make this clean (vs. a synchronous allreduce, where one
slow worker stalls the step): sample ``n + s`` groups, set a deadline, and
reduce over whichever groups finish. The mask enters the reduction as
weights (``drjax.masked_reduce_mean``), so the result is an unbiased mean
over the finished groups, it stays differentiable (the mask is data, not
control flow), and the round's shapes do not change with the set of
finishers.

The durations come from numpy with the reference's seeding, so the port
and the reference draw bit-identical durations and masks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class StragglerSimulator:
    """Log-normal per-group round durations (heavy tail, like real fleets)."""

    median_s: float = 10.0
    sigma: float = 0.4
    seed: int = 23

    def durations(self, round_idx: int, n: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, round_idx]))
        return self.median_s * np.exp(self.sigma * rng.standard_normal(n))


def _clamped_min_finishers(min_finishers: Optional[int], n: int) -> Optional[int]:
    """``min_finishers`` capped at the cohort size (asking for more finishers
    than groups exist can only mean "wait for everyone"), floored at 0."""
    if min_finishers is None:
        return None
    return max(0, min(int(min_finishers), n))


def _finished(durations: np.ndarray, deadline_s: float,
              min_finishers: Optional[int]):
    """(bool mask of the finishers, the k-th finish time if the deadline was
    extended to it, else None)."""
    mask = durations <= deadline_s
    k = _clamped_min_finishers(min_finishers, durations.size)
    if k and mask.sum() < k:
        kth = np.partition(durations, k - 1)[k - 1]
        return durations <= kth, float(kth)
    return mask, None


def straggler_mask(durations: np.ndarray, deadline_s: float,
                   min_finishers: Optional[int] = None,
                   device="cpu") -> torch.Tensor:
    """f32 on ``device``: 1.0 for groups finishing before the deadline
    (always >= min_finishers, extending the deadline to the k-th finisher if
    needed).

    ``min_finishers`` is clamped to the cohort size; ``min_finishers == n``
    therefore keeps every group (the synchronous limit). Without
    ``min_finishers`` an all-miss round yields the all-zero mask, for which
    ``drjax.masked_reduce_mean`` returns zeros.
    """
    mask, _ = _finished(np.asarray(durations), deadline_s, min_finishers)
    return torch.as_tensor(mask, dtype=torch.float32, device=device)


def effective_round_time(durations: np.ndarray, deadline_s: float,
                         min_finishers: Optional[int] = None) -> float:
    """Wall time of the round under deadline dropping.

    Without ``min_finishers`` the round ends at the deadline even when every
    group misses it (you waited the deadline out, then reduced over nobody);
    with it, the round extends to the k-th finisher.
    """
    durations = np.asarray(durations)
    _, kth = _finished(durations, deadline_s, min_finishers)
    if kth is not None:
        return kth
    return float(min(deadline_s, durations.max(initial=0.0)))
