"""Failure injection and checkpoint-restart recovery
(``repro/runtime/failure.py``).

The recovery contract is the standard one: on a step failure, restore the
latest complete checkpoint and replay from there. The data of a step is a
function of the step index alone, so a replay is exact. ``launch/train.py``
runs every round through :func:`run_with_recovery`; ``FailureInjector``
simulates device loss.

Recovery policy:

 * only exceptions in the ``recoverable`` allowlist trigger a
   restore-and-replay; programming errors (``TypeError``, ``ValueError``,
   ...) propagate at once instead of burning ``max_restarts`` on an error
   that every replay hits again. A CUDA error (a lost or faulted device)
   and ``torch.OutOfMemoryError`` are ``RuntimeError`` subclasses in
   PyTorch, as ``XlaRuntimeError`` is in JAX, so the default allowlist
   covers them;
 * restarts back off exponentially (``backoff_base_s * 2**(restart-1)``,
   capped at ``backoff_cap_s``);
 * ``stats["completed_steps"]`` counts forward progress (the high-water
   mark of the step counter), never replayed work; a restart from scratch
   replays steps without counting them again; ``stats["replayed_steps"]``
   counts the replays.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Optional, Tuple, Type

logger = logging.getLogger(__name__)


class SimulatedDeviceFailure(RuntimeError):
    pass


#: Default restart allowlist: injected and real device failures surface as
#: RuntimeError subclasses (CUDA errors and torch.OutOfMemoryError
#: included); anything else is a programming bug and fails fast.
DEFAULT_RECOVERABLE: Tuple[Type[BaseException], ...] = (
    SimulatedDeviceFailure,
    RuntimeError,
)


class FailureInjector:
    """Raises SimulatedDeviceFailure at the given step indices (once each)."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)
        self.failures = 0

    def check(self, step: int) -> None:
        if step in self.fail_at:
            self.fail_at.discard(step)
            self.failures += 1
            raise SimulatedDeviceFailure(f"injected failure at step {step}")


def run_with_recovery(
    step_fn: Callable[[int, Any], Any],
    init_state: Any,
    num_steps: int,
    checkpoint_mgr,
    *,
    checkpoint_every: int = 10,
    max_restarts: int = 5,
    recoverable: Tuple[Type[BaseException], ...] = DEFAULT_RECOVERABLE,
    backoff_base_s: float = 0.0,
    backoff_cap_s: float = 30.0,
    state_metadata: Optional[Callable[[Any], dict]] = None,
    on_restore: Optional[Callable[[Any, dict], Any]] = None,
    on_recovery: Optional[Callable[[int, Optional[int]], None]] = None,
) -> Tuple[Any, dict]:
    """Run ``state = step_fn(step, state)`` for num_steps with restart-on-fail.

    Returns (final_state, stats). Steps are 0-indexed; a checkpoint is
    taken after the step completes, when ``(step + 1) % checkpoint_every
    == 0`` or on the last step, and records ``step + 1`` as the resume
    point (also injected into the checkpoint metadata under ``"step"``,
    so ``on_restore`` callbacks see where they landed). The save is
    asynchronous: the host copy is taken before it returns, the write runs
    on the manager's thread, and ``checkpoint_mgr.wait()`` runs before
    this function returns.

    Only exceptions matching ``recoverable`` trigger a restore; everything
    else propagates. ``backoff_base_s > 0`` sleeps
    ``min(backoff_cap_s, backoff_base_s * 2**(restart-1))`` before each
    restore.

    stats keys: ``restarts``, ``scratch_restarts`` (restarts with no
    checkpoint to restore), ``completed_steps`` (unique forward progress,
    replays excluded), ``replayed_steps``, ``backoff_s``.

    ``on_recovery(restart_index, restored_step_or_None)`` fires after every
    recovery restore (1-indexed restart counter; ``None`` means a restart
    from scratch).
    """
    stats = {
        "restarts": 0,
        "scratch_restarts": 0,
        "completed_steps": 0,
        "replayed_steps": 0,
        "backoff_s": 0.0,
    }
    state = init_state
    step = 0
    restored = checkpoint_mgr.restore_latest(state)
    if restored is not None:
        step, state, meta = restored
        if on_restore is not None:
            state = on_restore(state, meta)
        logger.info("resumed from checkpoint at step %d", step)

    start_step = step
    high_water = step  # completed_steps counts progress past this, once
    restarts = 0
    while step < num_steps:
        try:
            state = step_fn(step, state)
            step += 1
            if step > high_water:
                high_water = step
                stats["completed_steps"] = high_water - start_step
            else:
                stats["replayed_steps"] += 1
            if step % checkpoint_every == 0 or step == num_steps:
                meta = state_metadata(state) if state_metadata else {}
                meta = dict(meta, step=step)
                checkpoint_mgr.save(step, state, metadata=meta, blocking=False)
        except recoverable as e:
            restarts += 1
            stats["restarts"] = restarts
            if restarts > max_restarts:
                raise RuntimeError(
                    f"exceeded max_restarts={max_restarts}"
                ) from e
            if backoff_base_s > 0.0:
                delay = min(backoff_cap_s, backoff_base_s * 2 ** (restarts - 1))
                stats["backoff_s"] += delay
                time.sleep(delay)
            logger.warning("step %d failed (%s); restoring", step, e)
            restored = checkpoint_mgr.restore_latest(state)
            if restored is None:
                # no checkpoint yet: restart from the initial state. The
                # step counter resets but completed_steps does not: the
                # replayed prefix is not new progress.
                state, step = init_state, 0
                stats["scratch_restarts"] += 1
                if on_recovery is not None:
                    on_recovery(restarts, None)
            else:
                step, state, meta = restored
                if on_restore is not None:
                    state = on_restore(state, meta)
                if on_recovery is not None:
                    on_recovery(restarts, step)
    checkpoint_mgr.wait()
    return state, stats
