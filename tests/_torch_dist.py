"""Multi-rank worlds for the port's distributed tests, on the CPU over gloo.

:func:`run_world` starts ``world`` ranks, each a fresh Python process
running this file as a script, which joins the world through a
``file://`` rendezvous under the caller's directory (never a fixed port,
so worlds of concurrent test workers cannot collide), runs the named
checks of :mod:`_torch_dist_checks` one after another and writes each
check's result (any picklable value) to ``result_<rank>.pkl``. The
parent joins every rank with one deadline (at most 180 s): on expiry it
kills them all and fails, so a hang never eats the suite's time limit.
A spawn costs about 7 s here, so a test module runs all its checks in one
world, from a module-scoped fixture.

The ranks import torch and the port only, never JAX: the parent holds
their results to the reference.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
import traceback
from typing import Dict, List, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
TIMEOUT_S = 180.0


class WorldFailed(AssertionError):
    pass


def run_world(world: int, checks: Sequence[str], workdir: str, *,
              timeout: float = TIMEOUT_S) -> Dict[str, List]:
    """Run ``checks`` (names of functions in ``_torch_dist_checks``) in one
    world of ``world`` gloo ranks. Returns ``{check: [result of rank 0,
    rank 1, ...]}``; raises :class:`WorldFailed` with every rank's error
    if a rank failed or the deadline passed."""
    return run_worlds({0: (world, checks, workdir)}, timeout=timeout)[0]


def run_worlds(specs: Dict, *, timeout: float = TIMEOUT_S) -> Dict:
    """Several worlds at once, ``{key: (world, checks, workdir)}`` ->
    ``{key: results}``, under one deadline."""
    timeout = min(float(timeout), TIMEOUT_S)
    started = {k: _start(*spec) for k, spec in specs.items()}
    procs = [p for ranks in started.values() for p, _ in ranks]
    deadline = time.monotonic() + timeout
    timed_out = False
    # A rank that failed exits non-zero; its peers may wait on it in a
    # collective, so every world is stopped at once.
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs):
            break
        if time.monotonic() > deadline:
            timed_out = True
            break
        time.sleep(0.05)
    for ranks in started.values():
        for proc, log in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    out, errors = {}, []
    if timed_out:
        errors.append(f"worlds passed their {timeout:.0f} s deadline and "
                      "were killed")
    for key, (world, checks, workdir) in specs.items():
        results = []
        for rank in range(world):
            path = os.path.join(workdir, f"result_{rank}.pkl")
            if not os.path.exists(path):
                with open(os.path.join(workdir, f"rank_{rank}.log")) as fh:
                    errors.append(f"world {key} rank {rank} wrote no "
                                  f"result:\n{fh.read()[-4000:]}")
                continue
            with open(path, "rb") as fh:
                res = pickle.load(fh)
            if "__error__" in res:
                errors.append(f"world {key} rank {rank}:\n{res['__error__']}")
            results.append(res)
        if len(results) == world:
            out[key] = {c: [r.get(c) for r in results] for c in checks}
    if errors:
        raise WorldFailed("\n".join(errors))
    return out


def _start(world: int, checks: Sequence[str], workdir: str):
    os.makedirs(workdir, exist_ok=True)
    rdzv = os.path.join(workdir, "rendezvous")
    if os.path.exists(rdzv):
        os.remove(rdzv)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC, HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    ranks = []
    for rank in range(world):
        log = open(os.path.join(workdir, f"rank_{rank}.log"), "w")
        ranks.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), str(world),
             rdzv, workdir, ",".join(checks)],
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return ranks


def _rank_main(rank: int, world: int, rdzv: str, workdir: str,
               checks: List[str]) -> None:
    import torch

    torch.set_num_threads(1)
    out: Dict[str, object] = {}
    try:
        from repro_torch import compat

        compat.init_process_group(rank, world, init_method=f"file://{rdzv}",
                                  device="cpu")
        import _torch_dist_checks as lib

        for name in checks:
            out[name] = getattr(lib, name)(rank, world, workdir)
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the test
        out["__error__"] = traceback.format_exc()
    with open(os.path.join(workdir, f"result_{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    sys.exit(1 if "__error__" in out else 0)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
               [c for c in sys.argv[5].split(",") if c])
