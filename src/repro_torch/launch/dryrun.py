"""Multi-pod dry run: one rank's step of every (arch × shape × mesh) cell,
counted in a fake world (``repro/launch/dryrun.py:56-390``).

The reference lowers and compiles each cell on 512 fake host devices and
reads its HLO. The port is SPMD, so a rank's program is what one rank
runs: this module makes the process rank 0 of a fake world of 256 or 512
ranks (``compat.fake_world``: torch's ``"fake"`` backend, collectives
that move nothing) on the production meshes (``launch/mesh.py``'s
``production_mesh_spec``)::

    single-pod:  (16, 16)      -> ("data", "model")       256 ranks
    multi-pod:   (2, 16, 16)   -> ("pod", "data", "model") 512 ranks

builds the cell's step and its input specs with ``launch/steps.py``, and
runs it once under ``FakeTensorMode`` on the rank's local shards, with
fake tensors on ``--device`` (default ``cuda``, so the step takes the
card's branches: ``common.matmul_f32``, the K2 routes; a CPU-only torch
cannot index a fake CUDA tensor or take its gradient, so the CPU tests
pass ``cpu``). Nothing is allocated. One call gives:

* FLOPs a rank: ``FlopCounterMode`` with the kernel ops' formulas
  (``hlo_cost.count_flops``): every op the rank dispatches, every layer,
  every group of its share and every recompute counted (the reference's
  XLA counts a loop body once);
* collectives a rank by kind, counts and operand bytes
  (``hlo_cost.CollectiveCounter``, the reference's schema);
* a rank's bytes: parameters, optimizer state and inputs exactly, from
  the local shards it holds, and its peak from
  ``torch.distributed._tools.mem_tracker.MemTracker`` over the call;
* ``roofline_terms`` of those counts, and the analytic model
  (``launch/analytic.py``) beside them, as the reference records it.

Results go to ``--out`` (default ``build/dryrun/``), one JSON file a cell.
The reference's keys are kept where they have a counterpart; those that
name HLO or XLA take a ``trace_`` name:

    lower_s                          -> build_s (step and inputs built)
    compile_s                        -> trace_s (the one counted call)
    memory.argument_bytes            -> memory.argument_bytes (params +
                                        optimizer + inputs, local shards)
    memory.peak_hbm_bytes            -> memory.peak_hbm_bytes (MemTracker)
    memory.{output,temp,alias,code}_bytes -> (none: no compiled buffers)
    hlo_cost                         -> trace_cost (``bytes_per_device``
                                        None: a trace has no byte model)
    collectives                      -> collectives
    collective_bytes_per_device_hlo  -> collective_bytes_per_device_trace
    roofline, collective_breakdown   -> roofline, collective_breakdown

and the port adds ``memory.{param,optimizer,input}_bytes``,
``memory.peak_breakdown``, ``trace_cost.flops_by_op`` and
``flops_over_analytic``. A cell ends ``skipped`` where
``registry.cell_applicable`` says so, and ``error`` with the message and
the tail of the traceback where the step raises: on a mesh the slot pool's
sharded slots and MoE routing groups that span ranks' rows are not ported
(ROADMAP queue 1 item 5).

Usage (``PYTHONPATH=src``)::

    python -m repro_torch.launch.dryrun --arch lm_350m --cell train_4k --mesh single
    python -m repro_torch.launch.dryrun --all            # every missing cell
    python -m repro_torch.launch.dryrun --paper          # DrJAX local-SGD rounds
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from .. import compat
from ..models import registry
from . import analytic, hlo_cost
from . import mesh as mesh_lib
from . import steps as steps_lib

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

# the paper's own §4 workload: local-SGD rounds of the 350M/1B/8B models
PAPER_ARCHS = ("lm_350m", "lm_1b", "lm_8b")


def mesh_model(shape: Sequence[int]) -> analytic.MeshModel:
    """The analytic model's mesh: every rank a chip, the last dim
    "model", the others data parallelism ((16, 16) is ``single()``,
    (2, 16, 16) ``multi()``)."""
    return analytic.MeshModel(chips=math.prod(shape),
                              data=math.prod(shape[:-1]), model=shape[-1])


# ---------------------------------------------------------------------------
# a cell's step and its inputs
# ---------------------------------------------------------------------------


def build_step(cfg, kind: str, mesh, *, batch: int, seq: int,
               algorithm: str = "sgd", n_groups: int = 1):
    """``(step, specs, placements)`` of one cell on ``mesh``
    (``repro/launch/dryrun.py:74-128``): ``specs`` are ``meta`` tensors of
    the step's arguments at their global shapes, ``placements`` a tree
    beside them (None where a rank holds the whole value)."""
    if kind == "train":
        if algorithm == "local_sgd":
            local_batch = max(batch // n_groups, 1)
            step, _, _, data_sh = steps_lib.make_drjax_round_step(
                cfg, mesh, partition_size=n_groups, num_local_steps=1)
            specs = steps_lib.drjax_round_specs(
                cfg, partition_size=n_groups, num_local_steps=1,
                local_batch=local_batch, seq=seq)
            # the round's parameters and server state are server values
            # every rank holds whole; each rank holds its groups' data
            data_pl = {k: data_sh(v) for k, v in specs[2].items()}
            return step, specs, (None, None, data_pl)
        step, shardings_for = steps_lib.make_sgd_train_step(cfg, mesh)
        specs = steps_lib.train_input_specs(cfg, batch, seq)
        return step, specs, shardings_for(specs)[0]
    if kind == "prefill":
        step = steps_lib.make_prefill_step(cfg, mesh)
        specs = steps_lib.prefill_input_specs(cfg, batch, seq)
        return step, specs, step.shardings_for(specs)
    step = steps_lib.make_decode_step(cfg, mesh)
    specs = steps_lib.decode_input_specs(cfg, batch, seq)
    placements = step.shardings_for(specs)
    if specs[3] is None:  # a decoder-only model takes no memory K/V
        specs, placements = specs[:3], placements[:3]
    return step, specs, placements


def _local_shape(shape, mesh, placements) -> Tuple[int, ...]:
    """This rank's block of a value of global ``shape``: every dim
    sharded by ``placements`` split evenly (the port's layouts need it)."""
    from torch.distributed.tensor import Shard

    local = list(shape)
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            k = mesh.size(m)
            if local[p.dim] % k:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split over {k} ranks")
            local[p.dim] //= k
    return tuple(local)


def materialize(specs, placements, mesh, make):
    """The step's arguments: each ``meta`` leaf of ``specs`` as
    ``make(shape, dtype)`` at the rank's local shape, wrapped as a DTensor
    at its placements (no communication), or whole where its placements
    are None."""
    from torch.distributed.tensor import DTensor

    from ..core import sharding

    if isinstance(specs, torch.Tensor):
        shape = tuple(int(s) for s in specs.shape)
        if placements is None:
            return make(shape, specs.dtype)
        local = make(_local_shape(shape, mesh, placements), specs.dtype)
        return DTensor.from_local(
            local, mesh, placements, run_check=False,
            shape=torch.Size(shape),
            stride=sharding.contiguous_stride(shape))
    if isinstance(specs, dict):
        return {k: materialize(v, None if placements is None
                               else placements[k], mesh, make)
                for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(
            materialize(v, None if placements is None else placements[i],
                        mesh, make) for i, v in enumerate(specs))
    return specs


def _local_leaves(tree) -> list:
    """The tensors a rank holds of a tree: each DTensor's local shard,
    each plain tensor whole."""
    from torch.utils import _pytree as pytree

    from ..core import sharding

    return [x.to_local() if sharding.is_dtensor(x) else x
            for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def local_bytes(tree) -> int:
    """Bytes a rank holds of a tree."""
    return sum(x.numel() * x.element_size() for x in _local_leaves(tree))


def count_step(step, args, *, track_memory: bool = True) -> dict:
    """One call of ``step(*args)`` counted: FLOPs (total and by op),
    collectives by kind, and (``track_memory``) the peak bytes of each
    device by ``MemTracker``, with the arguments' local tensors tracked
    from the start."""
    counter = hlo_cost.CollectiveCounter()
    tracker = contextlib.nullcontext()
    if track_memory:
        from torch.distributed._tools.mem_tracker import MemTracker

        tracker = MemTracker()
        tracker.track_external(*_local_leaves(args))
    t0 = time.time()
    with tracker, counter:
        _, flops, by_op = hlo_cost.count_flops(step, *args)
    out = {"flops": flops, "flops_by_op": by_op,
           "collectives": counter.stats(), "seconds": time.time() - t0}
    if track_memory:
        peak = tracker.get_tracker_snapshot("peak")
        out["peak"] = {str(dev): {str(getattr(k, "value", k)): int(v)
                                  for k, v in snap.items()}
                       for dev, snap in peak.items()}
    return out


def run_in_world(cfg, kind: str, *, batch: int, seq: int,
                 mesh_shape: Sequence[int], mesh_axes: Sequence[str],
                 algorithm: str = "sgd", device="cuda") -> dict:
    """One cell's step counted as rank 0 of a fake world of
    ``prod(mesh_shape)`` ranks, on fake tensors on ``device``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import DeviceMesh

    dev = compat.resolve_device(device)
    world = math.prod(mesh_shape)
    n_groups = math.prod(mesh_shape[:-1])  # the partition's data ways
    with compat.fake_world(world):
        t0 = time.time()
        mesh = DeviceMesh(dev.type, torch.arange(world).reshape(
            tuple(mesh_shape)), mesh_dim_names=tuple(mesh_axes))
        step, specs, placements = build_step(
            cfg, kind, mesh, batch=batch, seq=seq, algorithm=algorithm,
            n_groups=n_groups)
        with FakeTensorMode(allow_non_fake_inputs=False):
            args = materialize(
                specs, placements, mesh,
                lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                                 device=dev))
            build_s = time.time() - t0
            counted = count_step(step, args)
        counted["build_s"] = build_s
        # the peak of the step's device (a snapshot may list the host too)
        counted["peak"] = max(
            (v for k, v in counted["peak"].items()
             if torch.device(k).type == dev.type),
            key=lambda v: v["Total"], default={})
        # train: (params, optimizer or server state, batch or round data);
        # prefill: (params, batch); decode: (params, token, caches[, memory])
        train = kind == "train"
        counted["bytes"] = {
            "params": local_bytes(args[0]),
            "optimizer": local_bytes(args[1]) if train else 0,
            "inputs": local_bytes(args[2:] if train else args[1:])}
    return counted


# ---------------------------------------------------------------------------
# a cell's record
# ---------------------------------------------------------------------------


def run_cell(arch: str, cell: str, mesh_kind: str = "single",
             algorithm: str = "sgd", *, device="cuda", cfg=None,
             mesh_spec: Optional[Tuple] = None, shape: Optional[dict] = None
             ) -> dict:
    """The record of one cell (``repro/launch/dryrun.py:131-219``).
    ``cfg``, ``mesh_spec`` ((shape, axes)) and ``shape`` (a
    ``registry.SHAPE_CELLS`` entry) override the production ones, as the
    tests' reduced cells do."""
    multi_pod = mesh_kind == "multi"
    m_shape, m_axes = mesh_spec or mesh_lib.production_mesh_spec(
        multi_pod=multi_pod)
    chips = math.prod(m_shape)
    cfg = cfg if cfg is not None else registry.get_config(arch)
    ok, why = registry.cell_applicable(cfg, cell)
    result = {
        "arch": arch, "cell": cell, "mesh": mesh_kind,
        "algorithm": algorithm, "chips": chips, "device": str(device),
        "timestamp": time.time(),
    }
    if not ok:
        result.update(status="skipped", reason=why)
        return result
    shape = shape or registry.SHAPE_CELLS[cell]
    kind, seq, gb = shape["kind"], shape["seq_len"], shape["global_batch"]
    try:
        counted = run_in_world(cfg, kind, batch=gb, seq=seq,
                               mesh_shape=m_shape, mesh_axes=m_axes,
                               algorithm=algorithm, device=device)
        coll = counted["collectives"]
        coll_bytes = hlo_cost.collective_bytes(coll)
        flops = float(counted["flops"])
        terms = hlo_cost.roofline_terms(flops, 0.0, coll_bytes)
        ana = analytic.analytic_roofline(cfg, kind, gb, seq,
                                         mesh_model(m_shape))
        by, peak = counted["bytes"], counted["peak"]
        result.update(
            status="ok",
            build_s=round(counted["build_s"], 2),
            trace_s=round(counted["seconds"], 2),
            memory=dict(
                argument_bytes=sum(by.values()),
                param_bytes=by["params"],
                optimizer_bytes=by["optimizer"],
                input_bytes=by["inputs"],
                peak_hbm_bytes=peak.get("Total", 0),
                peak_breakdown=peak,
            ),
            trace_cost=dict(
                flops_per_device=flops,
                bytes_per_device=None,  # a trace has no byte model
                bytes_available=False,
                flops_by_op=counted["flops_by_op"],
                note="every op of one rank's call counted once per "
                     "dispatch",
                **{f"term_{k}": round(v, 6) for k, v in terms.items()},
            ),
            collectives=coll,
            collective_bytes_per_device_trace=coll_bytes,
            flops_over_analytic=flops / ana["flops_per_device"],
            roofline={
                k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in ana.items()
                if k != "collective_breakdown"
            },
            collective_breakdown={
                k: round(v, 1) for k, v in ana["collective_breakdown"].items()
            },
        )
    except Exception as e:  # noqa: BLE001  (a cell's failure is its record)
        result.update(
            status="error",
            error=f"{type(e).__name__}: {e}",
            traceback=traceback.format_exc()[-4000:],
        )
    return result


def result_path(out_dir, arch: str, cell: str, mesh_kind: str,
                algorithm: str) -> Path:
    tag = f"{arch}__{cell}__{mesh_kind}"
    if algorithm != "sgd":
        tag += f"__{algorithm}"
    return Path(out_dir) / (tag + ".json")


def summary_line(res: dict) -> str:
    line = (f"{res['arch']} {res['cell']} {res['mesh']} {res['algorithm']}: "
            f"{res['status']}")
    if res["status"] == "ok":
        line += (
            f" trace={res['trace_s']}s"
            f" peakHBM={res['memory']['peak_hbm_bytes'] / 2**30:.2f}GiB"
            f" flops/analytic={res['flops_over_analytic']:.4f}"
            f" coll={res['collective_bytes_per_device_trace']:.0f}B"
            f" dominant={res['roofline']['dominant']}"
            f" bound={res['roofline']['step_time_lower_bound_s']:.4f}s"
        )
    elif res["status"] == "error":
        line += " " + res["error"][:200]
    return line


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=registry.ARCH_IDS)
    ap.add_argument("--cell", choices=list(registry.SHAPE_CELLS))
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--algorithm", choices=("sgd", "local_sgd"), default="sgd")
    ap.add_argument("--all", action="store_true",
                    help="run every missing assigned-arch cell")
    ap.add_argument("--paper", action="store_true",
                    help="dry-run the paper's local-SGD rounds (lm_350m/1b/8b)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(RESULTS_DIR),
                    help="directory of the per-cell JSON files")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (cuda: the card's "
                         "branches; needs a CUDA build of torch)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    def run_and_save(arch, cell, mesh_kind, algorithm):
        path = result_path(out_dir, arch, cell, mesh_kind, algorithm)
        if path.exists() and not args.force:
            prev = json.loads(path.read_text())
            if prev.get("status") in ("ok", "skipped"):
                print(f"[cached] {path.name}: {prev['status']}")
                return prev
        res = run_cell(arch, cell, mesh_kind, algorithm, device=args.device)
        out_dir.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(res, indent=1))
        print(summary_line(res), flush=True)
        return res

    if args.all:
        assigned = [a for a in registry.ARCH_IDS if not a.startswith("lm_")]
        for arch in assigned:
            for cell in registry.SHAPE_CELLS:
                for mesh_kind in ("single", "multi"):
                    run_and_save(arch, cell, mesh_kind, "sgd")
        return 0
    if args.paper:
        # the DrJAX round (broadcast -> the clients' local steps -> reduce)
        # on the production meshes, partitioned over ("pod",) "data"
        for arch in PAPER_ARCHS:
            for mesh_kind in ("single", "multi"):
                run_and_save(arch, "train_4k", mesh_kind, "local_sgd")
        return 0
    if args.arch and args.cell:
        run_and_save(args.arch, args.cell, args.mesh, args.algorithm)
        return 0
    ap.error("pass --arch/--cell, --all, or --paper")


if __name__ == "__main__":
    raise SystemExit(main())
