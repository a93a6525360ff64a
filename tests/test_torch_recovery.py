"""Recovery in the port: ``runtime.run_with_recovery`` and
``FailureInjector`` as ``tests/test_runtime.py::TestRecovery*`` hold the
reference's, ``launch.train``'s ``--fail-at`` replay bitwise equal to the
uninterrupted run, and the synthetic LM stream against the reference's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import tree_flatten  # noqa: E402
from repro_torch.data import SyntheticLMStream, synthetic_lm_batch  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    FailureInjector,
    SimulatedDeviceFailure,
    run_with_recovery,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so this file's tests do not crowd
    out the suite's other workers; the worker's count comes back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)



def _x(v=0.0):
    return {"x": torch.tensor(v, dtype=torch.float32)}


class TestRecovery:
    def test_recovers_from_injected_failures(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        injector = FailureInjector(fail_at=[7, 13])

        def step_fn(step, state):
            injector.check(step)
            return {"x": state["x"] + 1.0}

        final, stats = run_with_recovery(step_fn, _x(), num_steps=20,
                                         checkpoint_mgr=mgr, checkpoint_every=5)
        assert stats["restarts"] == 2
        assert float(final["x"]) == 20.0  # exact replay: no lost/double steps
        assert stats["completed_steps"] == 20 and stats["replayed_steps"] == 5

    def test_exceeding_max_restarts_raises(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))

        def always_fail(step, state):
            raise SimulatedDeviceFailure("boom")

        with pytest.raises(RuntimeError, match="max_restarts"):
            run_with_recovery(always_fail, _x(), 5, mgr, max_restarts=2)

    def test_resume_from_existing_checkpoint(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(10, _x(10.0))

        def step_fn(step, state):
            return {"x": state["x"] + 1.0}

        final, stats = run_with_recovery(step_fn, _x(), 15, mgr)
        assert float(final["x"]) == 15.0
        assert stats["completed_steps"] == 5  # only 10..15 re-run

    def test_metadata_hooks(self, tmp_path):
        """The resume step is injected into the metadata; ``on_restore``
        sees it and ``on_recovery`` names the step each failure fell back
        to."""
        mgr = CheckpointManager(str(tmp_path))
        injector = FailureInjector(fail_at=[1, 5])
        seen, recoveries = [], []

        def step_fn(step, state):
            injector.check(step)
            return {"x": state["x"] + 1.0}

        def on_restore(state, meta):
            seen.append(meta)
            return state

        final, stats = run_with_recovery(
            step_fn, _x(), 6, mgr, checkpoint_every=2,
            state_metadata=lambda s: {"x": float(s["x"])},
            on_restore=on_restore,
            on_recovery=lambda i, step: recoveries.append((i, step)))
        assert float(final["x"]) == 6.0
        assert recoveries == [(1, None), (2, 4)]
        assert seen == [{"x": 4.0, "step": 4}]
        assert stats["scratch_restarts"] == 1


class TestRecoveryHardening:
    def test_non_recoverable_error_fails_fast(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        calls = []

        def step_fn(step, state):
            calls.append(step)
            raise TypeError("programming bug")

        with pytest.raises(TypeError, match="programming bug"):
            run_with_recovery(step_fn, _x(), 5, mgr, max_restarts=5)
        assert calls == [0]

    def test_device_errors_are_recoverable(self, tmp_path):
        """CUDA errors and ``torch.OutOfMemoryError`` are RuntimeErrors, so
        the default allowlist restores and replays on them."""
        assert issubclass(torch.OutOfMemoryError, RuntimeError)
        mgr = CheckpointManager(str(tmp_path))
        fired = []

        def step_fn(step, state):
            if step == 2 and not fired:
                fired.append(step)
                raise torch.OutOfMemoryError("CUDA out of memory")
            return {"x": state["x"] + 1.0}

        final, stats = run_with_recovery(step_fn, _x(), 4, mgr,
                                         checkpoint_every=1)
        assert float(final["x"]) == 4.0 and stats["restarts"] == 1

    def test_custom_recoverable_allowlist(self, tmp_path):
        class FlakyStore(Exception):
            pass

        mgr = CheckpointManager(str(tmp_path))
        fired = []

        def step_fn(step, state):
            if step == 2 and not fired:
                fired.append(step)
                raise FlakyStore("transient")
            return {"x": state["x"] + 1.0}

        final, stats = run_with_recovery(step_fn, _x(), 5, mgr,
                                         recoverable=(FlakyStore,))
        assert float(final["x"]) == 5.0
        assert stats["restarts"] == 1

    def test_scratch_restart_does_not_overcount_progress(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        injector = FailureInjector(fail_at=[3])

        def step_fn(step, state):
            injector.check(step)
            return {"x": state["x"] + 1.0}

        final, stats = run_with_recovery(step_fn, _x(), 5, mgr,
                                         checkpoint_every=10)
        assert float(final["x"]) == 5.0
        assert stats["scratch_restarts"] == 1
        assert stats["completed_steps"] == 5  # not 5 + the replayed prefix
        assert stats["replayed_steps"] == 3  # steps 0..2 re-run once

    @pytest.mark.parametrize("cap,fail_at,want", [
        (30.0, [1, 2], 0.03),           # 0.01 * 2**0 + 0.01 * 2**1
        (0.015, [1, 2, 3], 0.04),       # 0.01, then 0.02 and 0.04 capped
    ], ids=["exponential", "capped"])
    def test_backoff(self, tmp_path, cap, fail_at, want):
        mgr = CheckpointManager(str(tmp_path))
        injector = FailureInjector(fail_at=fail_at)

        def step_fn(step, state):
            injector.check(step)
            return {"x": state["x"] + 1.0}

        _, stats = run_with_recovery(step_fn, _x(), 5, mgr,
                                     backoff_base_s=0.01, backoff_cap_s=cap)
        assert stats["restarts"] == len(fail_at)
        assert stats["backoff_s"] == pytest.approx(want)


# ---------------------------------------------------------------------------
# launch.train: --fail-at replays bitwise
# ---------------------------------------------------------------------------


def _run(tmp_path, name, compression, *extra):
    args = train.parse_args([
        "--reduced", "--rounds", "4", "--cohort", "4", "--local-steps", "2",
        "--algorithm", "fedavg", "--compression", compression,
        "--ckpt-dir", str(tmp_path / name), "--ckpt-every", "2",
        "--device", "cpu", *extra])
    return train.train(args)


def _assert_state_equal(a, b):
    for part in ("params", "server_state"):
        x, y = (tree_flatten(getattr(r, part)) for r in (a, b))
        assert x[1] == y[1]  # the same structure
        for u, v in zip(x[0], y[0]):
            assert u.dtype == v.dtype and torch.equal(u, v), part


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_fail_at_replay_is_bitwise(tmp_path, compression):
    """``--rounds 4 --ckpt-every 2 --fail-at 3``: round 3 fails, the run
    restores step 2 and replays round 2; params and server state (with
    its f32 momentum) end bitwise equal to the uninterrupted run."""
    clean = _run(tmp_path, "clean", compression)
    failed = _run(tmp_path, "failed", compression, "--fail-at", "3")
    assert clean.recovery["restarts"] == 0
    assert failed.recovery == {"restarts": 1, "scratch_restarts": 0,
                               "completed_steps": 4, "replayed_steps": 1,
                               "backoff_s": 0.0, "restored_from": [2]}
    assert failed.summary["restarts"] == 1
    assert len(failed.losses) == len(failed.seconds) == 5  # round 2 twice
    assert failed.losses[2] == failed.losses[3] == clean.losses[2]
    assert failed.losses[4] == clean.losses[3]
    assert int(failed.server_state["step"]) == 4
    _assert_state_equal(clean, failed)


def test_resume_continues_bitwise(tmp_path):
    """A second run on the same directory resumes at the last checkpoint:
    4 rounds then 2 more equal 6 rounds in one go."""
    six = _run(tmp_path, "six", "none", "--rounds", "6")
    _run(tmp_path, "resumed", "none")
    resumed = _run(tmp_path, "resumed", "none", "--rounds", "6")
    assert len(resumed.losses) == 2 and resumed.losses == six.losses[4:]
    assert resumed.recovery["completed_steps"] == 2
    _assert_state_equal(six, resumed)


def test_no_checkpoint_dir_runs_straight_and_refuses_fail_at():
    args = train.parse_args(["--reduced", "--rounds", "1", "--cohort", "2",
                             "--local-steps", "1", "--device", "cpu"])
    args.ckpt_dir = None
    result = train.train(args)
    assert result.recovery["restarts"] == 0 and len(result.losses) == 1
    args.fail_at = [0]
    with pytest.raises(ValueError, match="fail-at"):
        train.train(args)


# ---------------------------------------------------------------------------
# the synthetic LM stream
# ---------------------------------------------------------------------------


def test_synthetic_stream_matches_reference():
    for step, seed in ((0, 0), (3, 7)):
        got = synthetic_lm_batch(step, 2, 16, 256, seed, device="cpu")
        want = jsynthetic.synthetic_lm_batch(step, 2, 16, 256, seed)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    stream = SyntheticLMStream(batch=2, seq=8, vocab=64, seed=5, device="cpu")
    first = [next(stream) for _ in range(3)]
    state = stream.state()
    fourth = next(stream)
    restored = SyntheticLMStream(batch=2, seq=8, vocab=64, device="cpu")
    restored.restore(state)
    assert state == {"step": 3, "seed": 5}
    assert torch.equal(next(restored)["tokens"], fourth["tokens"])
    assert not torch.equal(first[0]["tokens"], fourth["tokens"])
