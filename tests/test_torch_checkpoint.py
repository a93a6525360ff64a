"""The port's checkpoint manager (``repro_torch.checkpoint``): each class of
``tests/test_checkpoint.py`` on trees of tensors (round trip, bf16 included,
async, ``restore_latest``, fault modes, write-error surfacing, chaos hooks,
the kill-offset sweep, ``_gc`` keeping the last good step), and checkpoints
that cross packages: a state written by either package's manager restores
in the other bitwise, with the same sha256 of every leaf in both
manifests."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint import manager as manager_mod  # noqa: E402
from repro_torch.models import registry  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so this file's tests do not crowd
    out the suite's other workers; the worker's count comes back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)



def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn((8, 4), generator=g),
        "nested": {"b": torch.arange(5, dtype=torch.float32),
                   "step": torch.tensor(7, dtype=torch.int32)},
    }


def _leaves(tree):
    return manager_mod.tree_flatten(tree)[0]


def _assert_tree_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


class TestRoundTrip:
    def test_save_restore(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        tree = _tree()
        mgr.save(3, tree, metadata={"lr": 0.1})
        restored, meta = mgr.restore(3, tree)
        assert meta == {"lr": 0.1}
        _assert_tree_equal(restored, tree)
        assert list(restored) == list(tree)  # the example's key order

    def test_bf16_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        w = (torch.randn(4, 4) * 3).to(torch.bfloat16)
        tree = {"w": w}
        mgr.save(1, tree)
        restored, _ = mgr.restore(1, tree)
        assert restored["w"].dtype == torch.bfloat16
        assert torch.equal(restored["w"].view(torch.int16), w.view(torch.int16))
        with open(tmp_path / "step_000000001" / "manifest.json") as f:
            spec = json.load(f)["leaves"][0]
        assert spec["dtype"] == "bfloat16"
        stored = np.load(tmp_path / "step_000000001" / "arrays.npz")["leaf_00000"]
        assert stored.dtype == np.uint16  # as the reference stores bf16

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        tree = _tree()
        mgr.save(1, tree, blocking=False)
        mgr.wait()
        assert mgr.latest_step() == 1
        assert mgr.last_save["leaves"] == 3 and mgr.last_save["bytes"] == 152
        assert {"host_copy_s", "write_s", "hash_s"} <= set(mgr.last_save)

    def test_async_save_copies_before_returning(self, tmp_path):
        """The host copy is taken in save(): changing the tensors after it
        returns does not change what is written."""
        mgr = CheckpointManager(str(tmp_path))
        tree = _tree()
        want = {"w": tree["w"].clone(), "nested": dict(tree["nested"])}
        mgr.save(1, tree, blocking=False)
        tree["w"].add_(1.0)
        restored, _ = mgr.restore_latest(tree)[1:]
        _assert_tree_equal(restored, want)

    def test_restore_latest(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        t1, t2 = _tree(1), _tree(2)
        mgr.save(1, t1)
        mgr.save(5, t2)
        step, restored, _ = mgr.restore_latest(t1)
        assert step == 5
        _assert_tree_equal(restored, t2)

    def test_leaf_order_is_jax_order(self):
        """Dict keys sorted, as ``jax.tree_util`` flattens them (not
        ``torch.utils._pytree``'s insertion order); the structure string is
        JAX's."""
        tree = {"b": [torch.tensor(1), (torch.tensor(2), torch.tensor(3))],
                "a": {"y": torch.tensor(4), "x": torch.tensor(5)}, "c": ()}
        leaves, treedef = manager_mod.tree_flatten(tree)
        jleaves, jtreedef = jax.tree_util.tree_flatten(
            jax.tree_util.tree_map(lambda t: int(t), tree))
        assert [int(t) for t in leaves] == jleaves == [5, 4, 1, 2, 3]
        assert treedef == str(jtreedef)

    def test_restore_casts_to_example_dtype_and_device(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"w": torch.ones(3, dtype=torch.float32)})
        restored, _ = mgr.restore(1, {"w": np.zeros(3, np.float64)})
        assert torch.is_tensor(restored["w"])
        assert restored["w"].dtype == torch.float64
        restored, _ = mgr.restore(1, {"w": torch.zeros(3, dtype=torch.bfloat16)})
        assert restored["w"].dtype == torch.bfloat16
        assert restored["w"].device.type == "cpu"

    @pytest.mark.parametrize("example", [
        {"v": torch.zeros(3)},                      # another key
        {"w": torch.zeros(4)},                      # another shape
    ], ids=["tree", "shape"])
    def test_restore_refuses_another_state(self, tmp_path, example):
        """A checkpoint of another state (another model left in the same
        directory) is refused, not loaded into the example's slots."""
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"w": torch.ones(3)})
        with pytest.raises(ValueError, match="step 1"):
            mgr.restore(1, example)
        with pytest.raises(ValueError, match="step 1"):
            mgr.restore_latest(example)


class TestFaultModes:
    def test_integrity_check_detects_corruption(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        tree = _tree()
        mgr.save(2, tree)
        path = os.path.join(str(tmp_path), "step_000000002", "arrays.npz")
        data = dict(np.load(path))
        data["leaf_00000"] = data["leaf_00000"] + 1.0
        np.savez(path, **data)
        with pytest.raises(IOError, match="corruption"):
            mgr.restore(2, tree)

    def test_restore_latest_skips_torn_checkpoint(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        tree = _tree()
        mgr.save(1, tree)
        mgr.save(2, tree)
        os.remove(os.path.join(str(tmp_path), "step_000000002", "arrays.npz"))
        step, _, _ = mgr.restore_latest(tree)
        assert step == 1

    def test_retention_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
        tree = _tree()
        for s in (1, 2, 3, 4):
            mgr.save(s, tree)
        assert sorted(mgr._complete_steps()) == [3, 4]

    def test_no_checkpoint_returns_none(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        assert mgr.restore_latest(_tree()) is None


class TestWriteErrorSurfacing:
    def test_async_write_error_carries_originating_step(
        self, tmp_path, monkeypatch
    ):
        mgr = CheckpointManager(str(tmp_path))

        def boom(*a, **k):
            raise OSError("disk full")

        monkeypatch.setattr(manager_mod.np, "savez", boom)
        mgr.save(7, _tree(), blocking=False)
        with pytest.raises(RuntimeError, match="step 7") as ei:
            mgr.wait()
        assert isinstance(ei.value.__cause__, OSError)

    def test_error_surfaces_on_next_save_too(self, tmp_path, monkeypatch):
        mgr = CheckpointManager(str(tmp_path))
        real_savez = manager_mod.np.savez
        calls = {"n": 0}

        def flaky(*a, **k):
            calls["n"] += 1
            if calls["n"] == 1:
                raise OSError("disk full")
            return real_savez(*a, **k)

        monkeypatch.setattr(manager_mod.np, "savez", flaky)
        mgr.save(3, _tree(), blocking=False)
        with pytest.raises(RuntimeError, match="step 3"):
            mgr.save(4, _tree(), blocking=False)


class TestChaosFaultInjection:
    def test_corrupt_fault_skipped_in_favor_of_previous_step(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        t1, t2 = _tree(1), _tree(2)
        mgr.save(1, t1)
        mgr.save(2, t2)
        mgr.inject_fault(2, "corrupt")
        assert sorted(mgr._complete_steps()) == [1, 2]  # 2 still "complete"
        step, restored, _ = mgr.restore_latest(t1)
        assert step == 1
        _assert_tree_equal(restored, t1)

    def test_torn_fault_hook_mid_training(self, tmp_path):
        mgr = CheckpointManager(
            str(tmp_path),
            fault_hook=lambda step: "torn" if step == 2 else None,
        )
        tree = _tree()
        mgr.save(1, tree)
        mgr.save(2, tree)
        with open(os.path.join(str(tmp_path), "LATEST")) as f:
            assert f.read() == "step_000000001"  # the torn write never advanced it
        step, _, _ = mgr.restore_latest(tree)
        assert step == 1

    def test_corrupt_fault_hook_async(self, tmp_path):
        mgr = CheckpointManager(
            str(tmp_path),
            fault_hook=lambda step: "corrupt" if step == 5 else None,
        )
        t1, t2 = _tree(1), _tree(2)
        mgr.save(1, t1)
        mgr.save(5, t2, blocking=False)
        step, _, _ = mgr.restore_latest(t1)
        assert step == 1

    def test_clean_resave_clears_fault(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        tree = _tree()
        mgr.save(2, tree)
        mgr.inject_fault(2, "torn")
        assert mgr.restore_latest(tree) is None
        mgr.save(2, tree)
        step, _, _ = mgr.restore_latest(tree)
        assert step == 2

    def test_unknown_fault_kind_raises(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, _tree())
        with pytest.raises(ValueError, match="unknown checkpoint fault"):
            mgr.inject_fault(1, "gamma-ray")


def _npz_bytes(directory, step):
    return os.path.getsize(
        os.path.join(directory, f"step_{step:09d}", "arrays.npz"))


class TestMidWriteKills:
    """A writer killed at any byte offset leaves the previous committed step
    restorable (temp dir + fsync + atomic rename + LATEST last)."""

    def test_kill_offset_sweep_deterministic(self, tmp_path):
        t1, t2 = _tree(1), _tree(2)
        probe = CheckpointManager(str(tmp_path / "probe"))
        probe.save(1, t1)
        npz = _npz_bytes(str(tmp_path / "probe"), 1)
        offsets = [0, 1, npz // 2, npz, npz + 10, npz + 10_000_000,
                   "pre-rename", "pre-latest"]
        for i, off in enumerate(offsets):
            mgr = CheckpointManager(str(tmp_path / f"kill_{i}"))
            mgr.save(1, t1)
            mgr.kill_writer_at_byte(off)
            mgr.save(2, t2)  # the writer "dies": no error may surface
            assert mgr.killed_writes.get(2), f"offset {off!r}: kill not recorded"
            assert mgr.latest_step() == 1, f"offset {off!r}"
            step, restored, _ = mgr.restore_latest(t1)
            assert step == 1, f"offset {off!r}: restored step {step}"
            _assert_tree_equal(restored, t1)
            mgr.save(2, t2)  # the replay's clean re-save commits
            step, restored, _ = mgr.restore_latest(t1)
            assert step == 2
            _assert_tree_equal(restored, t2)

    def test_async_kill_is_silent(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        t = _tree()
        mgr.save(1, t)
        mgr.kill_writer_at_byte(64)
        mgr.save(2, t, blocking=False)
        mgr.wait()  # must not raise
        assert 2 in mgr.killed_writes
        assert mgr._write_error is None
        step, _, _ = mgr.restore_latest(t)
        assert step == 1

    def test_pre_latest_kill_leaves_uncommitted_dir_invisible(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        t1, t2 = _tree(1), _tree(2)
        mgr.save(1, t1)
        mgr.kill_writer_at_byte("pre-latest")
        mgr.save(2, t2)
        assert sorted(mgr._complete_steps()) == [1, 2]  # the dir exists...
        assert mgr.latest_step() == 1  # ...but is uncommitted
        step, _, _ = mgr.restore_latest(t1)
        assert step == 1

    def test_kill_via_fault_hook_spec(self, tmp_path):
        mgr = CheckpointManager(
            str(tmp_path),
            fault_hook=lambda step: "kill@128" if step == 2 else None,
        )
        t = _tree()
        mgr.save(1, t)
        mgr.save(2, t)
        assert 2 in mgr.killed_writes
        step, _, _ = mgr.restore_latest(t)
        assert step == 1

    def test_kill_before_any_commit_restores_none(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.kill_writer_at_byte(0)
        mgr.save(1, _tree())
        assert mgr.restore_latest(_tree()) is None

    def test_malformed_kill_spec_raises(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        with pytest.raises(ValueError, match="unknown checkpoint fault"):
            mgr.kill_writer_at_byte("kill@sometime")
        with pytest.raises(ValueError, match=">= 0"):
            mgr.kill_writer_at_byte(-1)

    def test_kill_offset_sweep_every_stride(self, tmp_path):
        """Offsets every 97 bytes across the whole stream (arrays.npz, then
        the manifest) and past its end: each kill leaves step 1."""
        t1, t2 = _tree(1), _tree(2)
        probe = CheckpointManager(str(tmp_path / "probe"))
        probe.save(1, t1)
        hi = _npz_bytes(str(tmp_path / "probe"), 1) + 1200
        for off in range(0, hi, 97):
            mgr = CheckpointManager(str(tmp_path / f"k{off}"))
            mgr.save(1, t1)
            mgr.kill_writer_at_byte(off)
            mgr.save(2, t2)
            assert 2 in mgr.killed_writes, off
            step, restored, _ = mgr.restore_latest(t1)
            assert step == 1, off
            _assert_tree_equal(restored, t1)


class TestGCKeepsLastGood:
    def test_gc_never_deletes_newest_complete_under_faulted_tail(self, tmp_path):
        mgr = CheckpointManager(
            str(tmp_path), keep_last_n=1,
            fault_hook=lambda step: "corrupt" if step > 1 else None,
        )
        t = _tree()
        mgr.save(1, t)
        mgr.save(2, t)  # corrupt: complete but unverifiable
        mgr.save(3, t)
        assert 1 in mgr._complete_steps()
        step, _, _ = mgr.restore_latest(t)
        assert step == 1

    def test_gc_still_prunes_old_clean_steps(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
        t = _tree()
        for s in (1, 2, 3, 4):
            mgr.save(s, t)
        assert sorted(mgr._complete_steps()) == [3, 4]

    def test_gc_keeps_latest_target_after_killed_writes(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last_n=1)
        t = _tree()
        mgr.save(1, t)
        for s in (2, 3):
            mgr.kill_writer_at_byte("pre-latest")
            mgr.save(s, t)  # dirs land but never commit
        step, _, _ = mgr.restore_latest(t)
        assert step == 1


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------


def _state(dtype):
    """The training state in both packages from the same numbers: reduced
    lm_350m params and a server state with f32 moments (FedAdam's m and v)
    after one update, so no leaf is all zeros."""
    jcfg = jreg.get_config("lm_350m").reduced(dtype=dtype)
    tcfg = registry.get_config("lm_350m").reduced(dtype=dtype)
    jparams = jreg.init_params(jax.random.PRNGKey(0), jcfg)
    server = jopt.fedadam(1e-2)
    delta = jax.tree_util.tree_map(lambda p: p * 0.01, jparams)
    _, jserver = server.update(delta, server.init(jparams), jparams)
    jstate = jax.device_get({"params": jparams, "server": jserver})
    return tcfg, jstate, convert.state_from_jax(tcfg, jstate, device="cpu")


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:09d}", "manifest.json")) as f:
        return json.load(f)


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_reference(tmp_path, dtype):
    tcfg, jstate, state = _state(dtype)
    CheckpointManager(str(tmp_path / "port")).save(
        3, convert.state_to_numpy(tcfg, state), metadata={"step": 3})
    JManager(str(tmp_path / "ref")).save(3, jstate, metadata={"step": 3})
    port, ref = _manifest(tmp_path / "port", 3), _manifest(tmp_path / "ref", 3)
    assert port == ref  # leaves, dtypes, shapes, sha256, structure
    assert any(spec["dtype"] == dtype for spec in port["leaves"])
    restored, meta = JManager(str(tmp_path / "port")).restore(3, jstate)
    assert meta == {"step": 3}
    got, want = jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(jstate)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(_jbits(a), _jbits(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_port(tmp_path, dtype):
    tcfg, jstate, state = _state(dtype)
    JManager(str(tmp_path)).save(5, jstate)
    mgr = CheckpointManager(str(tmp_path))
    step, restored, _ = mgr.restore_latest(convert.state_to_numpy(tcfg, state))
    assert step == 5
    back = convert.state_from_jax(tcfg, restored, device="cpu")
    assert back["params"].keys() == state["params"].keys()
    assert back["server"].keys() == state["server"].keys()
    for part in ("params", "server"):
        for a, b in zip(_leaves(back[part]), _leaves(state[part])):
            assert a.dtype == b.dtype and torch.equal(a, b)
    # and the port writing it back gives the reference's manifest
    mgr.save(6, convert.state_to_numpy(tcfg, back))
    JManager(str(tmp_path / "again")).save(6, jstate)
    assert _manifest(tmp_path, 6) == _manifest(tmp_path / "again", 6)
