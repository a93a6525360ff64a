"""Checkpoint manager: atomic, hashed, async, crash-consistent, restart-safe
(``repro/checkpoint/manager.py``).

Layout per step, the reference's byte for byte::

    <dir>/step_000123/
        manifest.json     # tree structure, shapes, dtypes, per-array sha256,
                          # user metadata (data-iterator state, step)
        arrays.npz        # flattened leaves keyed by leaf index
    <dir>/LATEST          # atomic commit pointer (rename barrier)

Leaves are flattened in JAX's order: nested dicts by sorted key, lists and
tuples in order (``torch.utils._pytree`` keeps a dict's insertion order,
so ``leaf_00012`` would name another leaf in each package). Manifest
dtypes are NumPy's names (``"float32"``, ``"int32"``, ``"bfloat16"``), and
a bf16 leaf is stored as the reference stores it, as the ``uint16`` view
of its bits. So a tree in the reference's layout (``convert.state_to_numpy``)
written here restores through the reference's manager bitwise, with the
same sha256 per leaf, and the other way round.

Crash-consistency model (the write-ordering contract the mid-write kill
tests sweep):

 1. every file is written into ``step_NNN.tmp`` and fsync'd (file + dir);
 2. the temp dir atomically renames to ``step_NNN`` (``os.replace``);
 3. only then does LATEST advance (tmp file + fsync + ``os.replace``).

LATEST is the commit point: ``restore_latest`` considers only complete
steps at or below the step LATEST names, so a writer killed at any byte
offset (mid-``arrays.npz``, mid-manifest, after the data but before the
rename, or after the rename but before LATEST) never surfaces a partial
or uncommitted step. Below the pointer the fallback is newest first,
skipping torn and corrupt dirs.

Guarantees:
 * atomicity: a checkpoint becomes visible only after its directory is
   complete and LATEST has advanced past it;
 * integrity: every array carries a sha256; restore verifies it;
 * async: ``save(..., blocking=False)`` copies every leaf to the host
   before it returns (a device-to-host copy that has completed, so the
   caller may go on changing its tensors) and hands the file writes and
   hashing to a writer thread; one outstanding write, with back-pressure
   on the next save; a write error surfaces on the next ``save``/``wait``;
 * retention: ``keep_last_n`` garbage-collects old steps, but never the
   newest cleanly written one or LATEST's target;
 * auto-resume: ``restore_latest()`` picks the newest committed complete
   checkpoint, skipping torn or corrupt ones. ``restore`` returns tensors
   of the example tree's dtypes on the example leaves' devices.

Chaos hooks: ``fault_hook(step)`` is consulted once per ``save``:
``"torn"`` simulates a crash between the array write and the manifest
write (directory present, no manifest, stale LATEST), ``"corrupt"`` a
bit-flip on disk (valid npz, sha256 mismatch), and ``"kill@<bytes>"`` /
``"kill@pre-rename"`` / ``"kill@pre-latest"`` terminate the writer
mid-write as if the process died (no error surfaces; see
:meth:`CheckpointManager.kill_writer_at_byte`). Every one of these states
is survived by ``restore_latest`` falling back to the previous committed
step. ``inject_fault(step, kind)`` applies the torn/corrupt mutations to
an already-written checkpoint.

``last_save`` records the newest save's leaves and bytes, and the seconds
of its host copy, of its file writes with ``fsync`` and of its hashing.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch


def _leaf_key(i: int) -> str:
    return f"leaf_{i:05d}"


#: Post-write fault kinds ``fault_hook`` / ``inject_fault`` understand.
#: ``fault_hook`` may additionally return mid-write kill specs:
#: ``"kill@<bytes>"``, ``"kill@pre-rename"``, ``"kill@pre-latest"``.
FAULT_KINDS = ("torn", "corrupt")

_KILL_PREFIX = "kill@"
_KILL_PHASES = ("pre-rename", "pre-latest")


# ---------------------------------------------------------------------------
# trees in JAX's leaf order
# ---------------------------------------------------------------------------


def tree_flatten(tree) -> Tuple[list, str]:
    """Leaves of nested dicts, lists and tuples in ``jax.tree_util``'s
    order (dict keys sorted), and the structure as JAX prints it
    (``{'a': *, 'b': [*, *]}``). ``None`` is an empty node, as in JAX;
    anything else is a leaf."""
    leaves: list = []

    def walk(x) -> str:
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {walk(x[k])}"
                                   for k in sorted(x)) + "}"
        if isinstance(x, list):
            return "[" + ", ".join(walk(v) for v in x) + "]"
        if isinstance(x, tuple):
            inner = ", ".join(walk(v) for v in x)
            return "(" + inner + ("," if len(x) == 1 else "") + ")"
        if x is None:
            return "None"
        leaves.append(x)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def tree_unflatten(example, leaves) -> Any:
    """``example``'s structure with its leaves replaced, in
    :func:`tree_flatten`'s order."""
    it = iter(leaves)

    def build(x):
        if isinstance(x, dict):
            out = {k: build(x[k]) for k in sorted(x)}
            return {k: out[k] for k in x}  # the example's key order
        if isinstance(x, (list, tuple)):
            return type(x)(build(v) for v in x)
        if x is None:
            return None
        return next(it)

    return build(example)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(host array as stored, manifest dtype) of one leaf: a copy (of a
    CPU leaf too), complete when this returns, so the caller may change
    the leaf while the copy is written. bf16 (a tensor, or an ml_dtypes
    array from a caller that has one) is stored as the ``uint16`` view of
    its bits."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.array(leaf)
    if a.dtype.name == "bfloat16":
        return np.ascontiguousarray(a).view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    """The tensor a stored array holds (bf16 back through the same views)."""
    if dtype == "bfloat16" and a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _like(t: torch.Tensor, example) -> torch.Tensor:
    """``t`` with the example leaf's dtype, on its device (CPU for a NumPy
    or scalar example)."""
    if torch.is_tensor(example):
        return t.to(device=example.device, dtype=example.dtype)
    if hasattr(example, "dtype"):
        name = np.dtype(example.dtype).name
        return t.to(torch.bfloat16 if name == "bfloat16"
                    else torch.from_numpy(np.zeros(0, name)).dtype)
    return t


def _sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).data).hexdigest()


# ---------------------------------------------------------------------------
# mid-write kills and faults
# ---------------------------------------------------------------------------


class WriterKilled(BaseException):
    """Simulated hard death of the checkpoint writer (SIGKILL mid-write).

    Derives from ``BaseException`` so no ``except Exception`` cleanup path
    can "handle" it: a killed process reports nothing, surfaces no write
    error, and leaves whatever partial bytes were durable at the moment of
    death. The write path catches exactly this class to stop writing.
    """


class _KillSwitchFile:
    """File wrapper that terminates the writer after a byte budget.

    Counts every byte written through it (across all files of one
    checkpoint, in write order: ``arrays.npz`` then ``manifest.json``) and
    raises :class:`WriterKilled` once the budget is spent, after flushing
    the partial prefix, so the on-disk state is exactly "crashed at byte N".
    """

    def __init__(self, raw, budget: List[int]):
        self._raw = raw
        self._budget = budget
        # After the kill the wrapper goes silent: a dead process neither
        # writes nor errors, and zipfile's destructor must not trip on it.
        self._dead = False

    def write(self, data):
        if self._dead:
            return len(bytes(data))
        b = bytes(data)
        if self._budget[0] <= 0:
            self._dead = True
            raise WriterKilled("writer killed: byte budget exhausted")
        if len(b) >= self._budget[0]:
            n = self._budget[0]
            self._budget[0] = 0
            self._raw.write(b[:n])
            self._raw.flush()
            self._dead = True
            raise WriterKilled(f"writer killed mid-write after {n} bytes")
        self._budget[0] -= len(b)
        return self._raw.write(b)

    def seek(self, *args):
        return 0 if self._dead else self._raw.seek(*args)

    def tell(self):
        return 0 if self._dead else self._raw.tell()

    def flush(self):
        return None if self._dead else self._raw.flush()

    def __getattr__(self, name):
        # full file-object duck typing (np.savez probes read/seekable/...)
        return getattr(self._raw, name)


def _parse_kill(spec: Union[int, str]):
    """``"kill@256"`` -> 256; ``"kill@pre-rename"`` -> ``"pre-rename"``.

    Bare ints and bare phase strings pass through (the
    ``kill_writer_at_byte`` argument forms)."""
    if isinstance(spec, int):
        offset = spec
    else:
        arg = spec[len(_KILL_PREFIX):] if spec.startswith(_KILL_PREFIX) else spec
        if arg in _KILL_PHASES:
            return arg
        try:
            offset = int(arg)
        except ValueError:
            raise ValueError(
                f"unknown checkpoint fault kind {spec!r}; expected one of "
                f"{FAULT_KINDS}, 'kill@<bytes>', or 'kill@{{{'|'.join(_KILL_PHASES)}}}'"
            ) from None
    if offset < 0:
        raise ValueError(f"kill offset must be >= 0, got {offset}")
    return offset


def _fsync_dir(path: str) -> None:
    """fsync a directory so renames and creates inside it are durable
    (a no-op where directory fds reject fsync)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - exotic filesystems
        pass
    finally:
        os.close(fd)


def _apply_fault(step_dir: str, kind: str) -> None:
    if kind == "torn":
        _tear_checkpoint(step_dir)
    elif kind == "corrupt":
        _corrupt_checkpoint(step_dir)
    else:
        raise ValueError(f"unknown checkpoint fault kind {kind!r}; "
                         f"expected one of {FAULT_KINDS}")


def _tear_checkpoint(step_dir: str) -> None:
    """Simulate a crash mid-write: arrays on disk, manifest never written."""
    manifest = os.path.join(step_dir, "manifest.json")
    if os.path.exists(manifest):
        os.remove(manifest)


def _corrupt_checkpoint(step_dir: str) -> None:
    """Flip one byte of the first non-empty leaf: the npz stays loadable but
    the manifest's sha256 no longer matches."""
    path = os.path.join(step_dir, "arrays.npz")
    data = dict(np.load(path))
    for key in sorted(data):
        a = data[key]
        if a.size == 0:
            continue
        raw = bytearray(a.tobytes())
        raw[0] ^= 0xFF
        data[key] = np.frombuffer(bytes(raw), dtype=a.dtype).reshape(a.shape)
        break
    np.savez(path, **data)


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------


class CheckpointManager:
    def __init__(self, directory: str, keep_last_n: int = 3,
                 fault_hook: Optional[Callable[[int], Optional[str]]] = None):
        self.directory = directory
        self.keep_last_n = keep_last_n
        self.fault_hook = fault_hook
        os.makedirs(directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        # (originating step, exception): surfaced on the next save()/wait()
        self._write_error: Optional[Tuple[int, BaseException]] = None
        # one-shot kill armed by kill_writer_at_byte for the NEXT save
        self._armed_kill: Optional[Union[int, str]] = None
        # step -> kill label, for every write that "died" mid-flight
        self.killed_writes: Dict[int, str] = {}
        # newest step this manager wrote cleanly (no fault, no kill): the
        # GC floor, see _gc
        self._last_good_step: Optional[int] = None
        # the newest save's sizes and seconds (complete after wait())
        self.last_save: Dict[str, Any] = {}

    # ------------------------------------------------------------------
    # save
    # ------------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}")

    def kill_writer_at_byte(self, offset: Union[int, str]) -> None:
        """Arm a one-shot mid-write kill for the NEXT :meth:`save`.

        ``offset`` is a byte offset into the checkpoint's write stream
        (``arrays.npz`` then ``manifest.json``, in write order) at which the
        writer is terminated as if the process died: no error surfaces, the
        partial bytes stay in the ``.tmp`` dir, the step never renames into
        place and LATEST never advances. An offset at or past the end of
        the stream kills immediately before the rename instead (an armed
        kill always prevents the commit). The phases ``"pre-rename"`` and
        ``"pre-latest"`` kill at the named ordering point; ``"pre-latest"``
        leaves a complete but uncommitted step dir that ``restore_latest``
        must ignore.

        Killed writes are recorded in ``killed_writes`` (step -> label);
        they are not surfaced as write errors: a dead process reports
        nothing.
        """
        self._armed_kill = _parse_kill(offset)

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None,
             blocking: bool = True) -> None:
        self.wait()  # back-pressure: one outstanding async write
        # The fault decision is made here, before the writer thread starts:
        # torn/corrupt mutate the completed write; kill specs arm the
        # mid-write kill switch.
        fault = self.fault_hook(step) if self.fault_hook else None
        kill = self._armed_kill
        self._armed_kill = None
        if fault is not None and str(fault).startswith(_KILL_PREFIX):
            kill, fault = _parse_kill(str(fault)), None
        t0 = time.perf_counter()
        leaves, treedef_repr = tree_flatten(tree)
        host = [_to_host(leaf) for leaf in leaves]  # device->host copy now
        host_leaves = [a for a, _ in host]
        leaf_dtypes = [dt for _, dt in host]
        stats = {"step": step, "leaves": len(host_leaves),
                 "bytes": sum(a.nbytes for a in host_leaves),
                 "host_copy_s": time.perf_counter() - t0}
        self.last_save = stats

        def _write():
            try:
                tmp = self._step_dir(step) + ".tmp"
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                budget = [kill] if isinstance(kill, int) else None

                def _out(raw):
                    return _KillSwitchFile(raw, budget) if budget else raw

                t1 = time.perf_counter()
                arrays = {_leaf_key(i): a for i, a in enumerate(host_leaves)}
                with open(os.path.join(tmp, "arrays.npz"), "wb") as raw:
                    np.savez(_out(raw), **arrays)
                    raw.flush()
                    os.fsync(raw.fileno())
                t2 = time.perf_counter()
                manifest = {
                    "step": step,
                    "treedef": treedef_repr,
                    "num_leaves": len(host_leaves),
                    "leaves": [
                        {"shape": list(a.shape), "dtype": dt,
                         "sha256": _sha256(a)}
                        for a, dt in zip(host_leaves, leaf_dtypes)
                    ],
                    "metadata": metadata or {},
                }
                t3 = time.perf_counter()
                with open(os.path.join(tmp, "manifest.json"), "wb") as raw:
                    _out(raw).write(json.dumps(manifest).encode("utf-8"))
                    raw.flush()
                    os.fsync(raw.fileno())
                _fsync_dir(tmp)
                stats.update(write_s=time.perf_counter() - t3 + t2 - t1,
                             hash_s=t3 - t2)
                if budget is not None and budget[0] > 0:
                    # the byte budget outlived the whole stream: an armed
                    # kill must still prevent the commit
                    raise WriterKilled("writer killed before step-dir rename")
                if kill == "pre-rename":
                    raise WriterKilled("writer killed before step-dir rename")
                final = self._step_dir(step)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                _fsync_dir(self.directory)
                if fault is not None:
                    _apply_fault(final, fault)
                if kill == "pre-latest":
                    raise WriterKilled(
                        "writer killed after rename, before LATEST advanced"
                    )
                if fault != "torn":
                    # atomic LATEST pointer, advanced last: the commit point
                    # (a torn write crashed before it)
                    ptr_tmp = os.path.join(self.directory, ".LATEST.tmp")
                    with open(ptr_tmp, "w") as f:
                        f.write(os.path.basename(final))
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(ptr_tmp, os.path.join(self.directory, "LATEST"))
                    _fsync_dir(self.directory)
                if fault is None:
                    self._last_good_step = step
                self._gc()
            except WriterKilled as e:
                # a dead writer reports nothing: recorded for inspection
                # only, never surfaced as a write error
                self.killed_writes[step] = str(e)
            except BaseException as e:  # surfaced on next save()/wait()
                self._write_error = (step, e)

        if blocking:
            _write()
            self._raise_pending()
        else:
            self._writer = threading.Thread(target=_write, daemon=True)
            self._writer.start()

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        self._raise_pending()

    def _raise_pending(self):
        if self._write_error is not None:
            (step, e), self._write_error = self._write_error, None
            raise RuntimeError(
                f"async checkpoint write failed at step {step}"
            ) from e

    def inject_fault(self, step: int, kind: str) -> None:
        """Mutate an already-written checkpoint in place (chaos testing).

        ``kind="torn"`` removes the manifest (the crash-mid-write state);
        ``kind="corrupt"`` flips a byte in ``arrays.npz`` so the sha256
        verification fails. Either way ``restore_latest`` must skip the
        step and fall back to the previous complete one.
        """
        self.wait()
        _apply_fault(self._step_dir(step), kind)

    def _gc(self) -> None:
        # Keep the newest keep_last_n complete steps, and always the newest
        # cleanly written one and the step LATEST commits to, even when
        # later faulted or killed writes pushed them past the budget (a
        # faulted dir counting toward the budget must not evict the only
        # restorable state).
        steps = sorted(self._complete_steps())
        keep = set(steps[-self.keep_last_n:]) if self.keep_last_n > 0 else set()
        if self._last_good_step is not None:
            keep.add(self._last_good_step)
        target = self._latest_target()
        if target is not None:
            keep.add(target)
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    # restore
    # ------------------------------------------------------------------

    def _complete_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            if os.path.exists(
                os.path.join(self.directory, name, "manifest.json")
            ):
                out.append(int(name.split("_")[1]))
        return out

    def _latest_target(self) -> Optional[int]:
        """The step LATEST commits to, or None when no commit has happened
        (a missing or garbled pointer: the pre-commit crash states)."""
        try:
            with open(os.path.join(self.directory, "LATEST")) as f:
                name = f.read().strip()
            return int(name.split("_")[1])
        except (OSError, IndexError, ValueError):
            return None

    def latest_step(self) -> Optional[int]:
        """Newest complete step at or below the LATEST commit point.

        A step dir that exists but was never committed (writer killed after
        the rename, before LATEST advanced) is invisible here: restoring it
        could resume from state whose write was never acknowledged."""
        target = self._latest_target()
        if target is None:
            return None
        steps = [s for s in self._complete_steps() if s <= target]
        return max(steps) if steps else None

    def restore(self, step: int, example_tree: Any,
                verify: bool = True) -> Tuple[Any, dict]:
        """The tree saved at ``step`` in ``example_tree``'s structure: each
        leaf a tensor of the example leaf's dtype on its device (a CPU
        tensor for a NumPy example leaf), and the user metadata."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            arrays = [data[_leaf_key(i)] for i in range(manifest["num_leaves"])]
        if verify:
            for a, spec in zip(arrays, manifest["leaves"]):
                if _sha256(a) != spec["sha256"]:
                    raise IOError(
                        f"checkpoint corruption at step {step}: hash mismatch"
                    )
        examples, treedef_repr = tree_flatten(example_tree)
        if len(examples) != len(arrays):
            raise ValueError(
                f"checkpoint at step {step} holds {len(arrays)} leaves, the "
                f"example tree {len(examples)}"
            )
        if manifest["treedef"] != treedef_repr:
            raise ValueError(
                f"checkpoint at step {step} holds another tree than the "
                f"example: {manifest['treedef'][:200]} vs {treedef_repr[:200]}"
            )
        for i, (a, ex) in enumerate(zip(arrays, examples)):
            if tuple(a.shape) != tuple(np.shape(ex)):
                raise ValueError(
                    f"checkpoint at step {step}: leaf {i} has shape "
                    f"{tuple(a.shape)}, the example's {tuple(np.shape(ex))}"
                )
        leaves = [_like(_from_host(a, spec["dtype"]), ex)
                  for a, spec, ex in zip(arrays, manifest["leaves"], examples)]
        return tree_unflatten(example_tree, leaves), manifest["metadata"]

    def restore_latest(self, example_tree: Any,
                       verify: bool = True) -> Optional[Tuple[int, Any, dict]]:
        self.wait()
        target = self._latest_target()
        if target is None:
            return None
        steps = sorted(
            (s for s in self._complete_steps() if s <= target), reverse=True
        )
        for s in steps:
            try:
                tree, meta = self.restore(s, example_tree, verify=verify)
                return s, tree, meta
            except (IOError, KeyError, json.JSONDecodeError):
                continue  # torn/corrupt checkpoint: fall back to previous
        return None
