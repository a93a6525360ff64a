"""Chaos soak: composed fault injection with production invariants
(``repro/runtime/chaos.py``), in its logical mode.

The runtime pieces of this package are each tested alone, but production
failures compose: a pod drops WHILE a straggler deadline is active WHILE
the latest checkpoint turns out torn WHILE serve traffic shares the card.
This module drives a real hierarchical training round
(:func:`repro_torch.runtime.elastic.make_elastic_hierarchical_round`,
masked) through :func:`repro_torch.runtime.failure.run_with_recovery`
while a deterministic, seeded :class:`ChaosSchedule` injects overlapping
adversity, and asserts the system's production invariants as hard checks:

* **determinism under recovery**: after device failures, checkpoint
  restores (skipping torn, corrupt and killed checkpoints) and restarts
  from scratch, the final model and server state is BITWISE that of an
  uninterrupted oracle run of the same schedule on the same executor;
* **no retraces under elasticity**: the per-client leg is traced once for
  the whole soak (``ElasticHierarchicalRound.client_trace_count``); a pod
  dropout or regrowth builds only a cross-pod leg, one per distinct pod
  count (``cross_compile_count``), and the oracle replay builds nothing;
* **bounded tail latency under stragglers**: deadline-masked rounds have a
  strictly smaller p99 and p99/p50 ratio than the synchronous
  wait-for-all baseline on the same duration draws;
* **unbiasedness of the masked mean**: on audit rounds the hierarchical
  finisher-weighted composition is held to the flat masked round
  (``make_local_sgd_round`` with ``straggler_mask``) over the same cohort;
* **serve isolation**: bursts through
  :class:`~repro_torch.launch.serve.ContinuousBatchingScheduler` complete
  every request (surviving an injected scheduler fault through
  ``reset_slots`` and a resubmit) with the schedulers' build counts
  (``prefill_traces``, ``decode_traces``) flat after the warm-up. A burst
  is issued right after the round's dispatch, before the host waits for
  the round's loss: on the card the round's kernels are still queued, so
  the burst's latencies (``serve_p99_contended``) are contended ones;
* **crash-consistent checkpointing**: the fault cycle includes mid-write
  writer kills (``kill@<bytes>`` at a seeded offset); every kill must be
  survived by a fallback restore strictly below the killed step
  (``mid_write_kills_survived == mid_write_kills_injected``).

**Physical mode** (``physical_mesh=True``, the reference's): the soak
runs in a world of at least ``num_pods * clients_per_pod`` ranks
(``compat.init_process_group``; every rank calls ``run_chaos_soak`` with
the same config), one rank standing for each device of the reference's
pod pool (:func:`~repro_torch.runtime.elastic.pod_device_pool`). Each
round runs on the ``(pod, data)`` mesh of that round's surviving pods
(:func:`~repro_torch.runtime.elastic.mesh_for_surviving_pods`), built
once per alive set on every rank (construction is collective) and passed
to ``ElasticHierarchicalRound.step(mesh=)``:

* the schedule is drawn identically on every rank, and every rank runs
  the loop; a dropped pod's ranks sit out its rounds;
* each rank checkpoints into its own ``<ckpt_dir>/rank_<r>``, so the
  torn, corrupt and ``kill@`` faults need no cross-rank file protocol;
  after a restore to step s the ranks of round s - 1's mesh hold the
  current state, and the next step broadcasts it to any other rank;
* serve bursts, where the config asks for them, run on rank 0 alone;
* the oracle replays on the same meshes; ``reshards``,
  ``mesh_migrate_ms`` and ``meshes_seen`` are the executor's (taken
  before the replay), and the physical invariants hold
  (``reshards >= elastic events``, ``cross_compiles == meshes_seen``).
  The counters that differ between ranks are agreed by ``all_reduce``:
  the losses and audits of the rounds each rank ran, the cross legs
  built (one per mesh across the world), the slowest migration; the
  bitwise verdict is that of the ranks in the last round's mesh.

In logical mode those report columns are zero, as the reference's are.

``ChaosConfig(minutes=N)`` replaces the fixed round count with a
wall-clock budget: a probe round is timed (:func:`_calibrate_round_s`) and
the schedule rescaled (:func:`scale_config_to_minutes`) so the soak fills
about N minutes, with fault counts scaled in proportion.

Seeding rule: every chaos stream derives from
``np.random.SeedSequence([seed, stream_id, ...])``, so streams are
independent, stable under config changes to OTHER streams, and replayable,
and every draw is bitwise the reference's. ``step_fn`` is deterministic in
the round index, which is what makes restore-and-replay exact and the
oracle comparison bitwise. The initial weights are the one draw that is
not the reference's: a torch ``Generator`` seeded by ``cfg.seed``.

Entry points: ``run_chaos_soak(ChaosConfig(...))`` returns a
:class:`ChaosReport` (and asserts the invariants unless ``check=False``);
``launch/train.py --chaos`` and ``examples/torch_chaos_soak.py`` wrap it.
Like every entry point of the port it runs on the card unless
``ChaosConfig.device`` is ``"cpu"``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from .. import compat
from ..checkpoint.manager import CheckpointManager
from .failure import (
    DEFAULT_RECOVERABLE,
    FailureInjector,
    SimulatedDeviceFailure,
    run_with_recovery,
)
from .stragglers import StragglerSimulator, effective_round_time, straggler_mask

# Stream ids for SeedSequence([seed, stream_id, ...]): never renumber
# (renumbering silently changes every recorded soak).
STREAM_FAILURES = 1
STREAM_ELASTIC = 2
STREAM_DATA = 3
STREAM_SERVE = 4
STREAM_CKPT = 5


def _rng(*ids: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(list(ids)))


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Knobs for one soak (``repro/runtime/chaos.py:96``). Defaults are the
    full soak's shape: 48 rounds with 2 device failures, 4 elastic events,
    straggler deadlines every round, 2 checkpoint faults and concurrent
    serve bursts. ``device`` is where the rounds, the checkpoints'
    restores and the serve fleet run: the card unless ``"cpu"``."""

    rounds: int = 48
    seed: int = 0

    # training problem (tiny linear regression; the *runtime* is under test)
    num_pods: int = 4
    clients_per_pod: int = 2
    local_steps: int = 2
    batch: int = 8
    dim: int = 3  # != clients_per_pod, as the reference requires
    client_lr: float = 0.05
    server_momentum: float = 0.9

    # fault injection
    num_device_failures: int = 2
    num_elastic_events: int = 4
    num_ckpt_faults: int = 2

    # stragglers
    straggler_median_s: float = 10.0
    straggler_sigma: float = 0.6
    deadline_pct: float = 90.0
    min_finisher_frac: float = 0.5

    # recovery
    checkpoint_every: int = 8
    keep_last_n: int = 3
    max_restarts: int = 8
    backoff_base_s: float = 0.0
    ckpt_dir: Optional[str] = None  # None -> a temporary directory

    # serve traffic
    serve_traffic: bool = True
    serve_every: int = 16
    serve_requests: int = 3
    serve_slots: int = 2
    serve_max_new: int = 4
    serve_fault: bool = True
    serve_chunk: int = 8
    serve_arch: str = "stablelm_3b"

    # audits
    audit_every: int = 12

    # physical elasticity: the rounds on a real (pod, data) mesh of the
    # surviving pods' ranks, in a world of num_pods * clients_per_pod ranks
    physical_mesh: bool = False

    # time budget: scale the schedule to ~N minutes of wall clock instead
    # of a fixed round count (calibrated from a probe round at soak start)
    minutes: Optional[float] = None

    device: str = "cuda"

    def validate(self) -> None:
        if self.rounds < 8:
            raise ValueError(f"need rounds >= 8 for a soak, got {self.rounds}")
        if self.max_restarts <= self.num_device_failures:
            raise ValueError(
                "max_restarts must exceed num_device_failures "
                f"({self.max_restarts} <= {self.num_device_failures})"
            )
        if self.dim == self.clients_per_pod:
            raise ValueError(
                "dim must differ from clients_per_pod (the reference's "
                "partitioned-invar heuristic matches leading dims)"
            )
        compat.resolve_device(self.device)


class ChaosSchedule:
    """Deterministic, seeded schedule of composed adversity
    (``repro/runtime/chaos.py:170``).

    Built once from a :class:`ChaosConfig`; every accessor is a pure
    function of ``(seed, round)``, so a replay after a restore sees exactly
    the data, mask and pod count the first execution saw.
    """

    def __init__(self, cfg: ChaosConfig, pod_counts: Tuple[int, ...],
                 elastic_events: Tuple[Tuple[int, int, int], ...],
                 failure_rounds: Tuple[int, ...],
                 ckpt_faults: Dict[int, str],
                 serve_rounds: Tuple[int, ...],
                 serve_fault_round: Optional[int],
                 audit_rounds: frozenset,
                 alive_pods: Optional[Tuple[Tuple[int, ...], ...]] = None):
        self.cfg = cfg
        self.device = compat.resolve_device(cfg.device)
        self.pod_counts = pod_counts
        self.elastic_events = elastic_events  # (round, old_pods, new_pods)
        self.failure_rounds = failure_rounds
        self.ckpt_faults = dict(ckpt_faults)  # checkpoint step -> kind
        self.serve_rounds = serve_rounds
        self.serve_fault_round = serve_fault_round
        self.audit_rounds = audit_rounds
        # which pod ids are alive each round (what a physical reshard
        # needs); by default the leading pods
        self.alive_pods = alive_pods or tuple(
            tuple(range(p)) for p in pod_counts
        )
        self._sim = StragglerSimulator(
            median_s=cfg.straggler_median_s,
            sigma=cfg.straggler_sigma,
            seed=cfg.seed,
        )
        # fixed ground-truth weights for the regression data
        self._w_true = _rng(cfg.seed, STREAM_DATA).standard_normal(
            cfg.dim
        ).astype(np.float32)

    @classmethod
    def from_config(cls, cfg: ChaosConfig) -> "ChaosSchedule":
        cfg.validate()
        # --- elastic: alternating drop/regrow at sampled rounds ---
        rng = _rng(cfg.seed, STREAM_ELASTIC)
        lo, hi = 2, cfg.rounds - 1
        k = min(cfg.num_elastic_events, max(0, hi - lo))
        event_at = set(
            int(r)
            for r in rng.choice(np.arange(lo, hi), size=k, replace=False)
        ) if k else set()
        pods: List[int] = []
        events: List[Tuple[int, int, int]] = []
        alive_per_round: List[Tuple[int, ...]] = []
        alive = list(range(cfg.num_pods))
        cur, drop_next = cfg.num_pods, True
        for r in range(cfg.rounds):
            if r in event_at:
                old = cur
                if drop_next and cur > 1:
                    cur -= 1
                elif cur < cfg.num_pods:
                    cur += 1
                else:
                    cur = max(1, cur - 1)
                drop_next = not drop_next
                if cur != old:
                    events.append((r, old, cur))
                    # pod-identity draws come after the event_at choice on
                    # the same stream
                    if cur < old:  # dropout: pick the victim
                        victim = alive[int(rng.integers(len(alive)))]
                        alive.remove(victim)
                    else:  # regrowth: revive a dead pod
                        dead = sorted(set(range(cfg.num_pods)) - set(alive))
                        alive.append(dead[int(rng.integers(len(dead)))])
                        alive.sort()
            pods.append(cur)
            alive_per_round.append(tuple(alive))

        # --- device failures: distinct rounds in [1, rounds) ---
        rng = _rng(cfg.seed, STREAM_FAILURES)
        nf = min(cfg.num_device_failures, cfg.rounds - 1)
        failure_rounds = tuple(
            sorted(
                int(r)
                for r in rng.choice(
                    np.arange(1, cfg.rounds), size=nf, replace=False
                )
            )
        )

        # --- checkpoint faults: break the checkpoint a failure will want.
        # For each failure round r the restore target is the last
        # checkpoint step <= r; faulting exactly that step makes the
        # skip-and-fall-back path run under real recovery pressure. Kinds
        # cycle mid-write kill / corrupt / torn; the kill offset comes from
        # its own stream.
        ckpt_rng = _rng(cfg.seed, STREAM_CKPT)
        faults: Dict[int, str] = {}
        for r in failure_rounds:
            if len(faults) >= cfg.num_ckpt_faults:
                break
            s = (r // cfg.checkpoint_every) * cfg.checkpoint_every
            if s >= cfg.checkpoint_every and s not in faults:
                i = len(faults)
                if i % 3 == 0:
                    faults[s] = f"kill@{int(ckpt_rng.integers(64, 2048))}"
                else:
                    faults[s] = ("corrupt", "torn")[i % 3 - 1]

        # --- serve bursts + one scheduler-level fault ---
        serve_rounds: Tuple[int, ...] = ()
        serve_fault_round = None
        if cfg.serve_traffic:
            serve_rounds = tuple(
                r for r in range(1, cfg.rounds) if r % cfg.serve_every == 0
            )
            if cfg.serve_fault and serve_rounds:
                serve_fault_round = serve_rounds[min(1, len(serve_rounds) - 1)]

        # --- unbiasedness audits: periodic + at every elastic transition ---
        audits = {0} | {
            r for r in range(cfg.rounds) if r % cfg.audit_every == 0
        } | {r for (r, _, _) in events}

        return cls(cfg, tuple(pods), tuple(events), failure_rounds, faults,
                   serve_rounds, serve_fault_round, frozenset(audits),
                   alive_pods=tuple(alive_per_round))

    # ------------------------------------------------------------------
    # per-round accessors (pure in (seed, round))
    # ------------------------------------------------------------------

    def data_for_round(self, r: int, p: int):
        """Cohort batches ``(x, y)`` on the config's device: leaves (p,
        clients_per_pod, local_steps, B, ...)."""
        cfg = self.cfg
        rng = _rng(cfg.seed, STREAM_DATA, r)
        shape = (p, cfg.clients_per_pod, cfg.local_steps, cfg.batch)
        x = rng.standard_normal(shape + (cfg.dim,)).astype(np.float32)
        noise = rng.standard_normal(shape).astype(np.float32)
        y = np.einsum("pcsbd,d->pcsb", x, self._w_true) + 0.05 * noise
        return (torch.from_numpy(x).to(self.device),
                torch.from_numpy(y).to(self.device))

    def round_mask_and_times(self, r: int, p: int):
        """(mask (p, C) f32 on the config's device, masked_round_time_s,
        synchronous_round_time_s)."""
        cfg = self.cfg
        n = p * cfg.clients_per_pod
        d = self._sim.durations(r, n)
        deadline = float(np.percentile(d, cfg.deadline_pct))
        k = max(1, int(np.ceil(cfg.min_finisher_frac * n)))
        mask = straggler_mask(d, deadline, min_finishers=k,
                              device=self.device)
        masked_t = effective_round_time(d, deadline, min_finishers=k)
        return (mask.reshape(p, cfg.clients_per_pod), masked_t,
                float(d.max()))

    def serve_requests_for(self, r: int, vocab: int):
        """One burst of serve requests; prompt lengths stay inside the chunk
        buckets the warm-up covered (<= 2*chunk - 1), so builds stay
        flat."""
        from ..launch.serve import Request

        cfg = self.cfg
        rng = _rng(cfg.seed, STREAM_SERVE, r)
        lens = rng.integers(1, 2 * cfg.serve_chunk, size=cfg.serve_requests)
        return [
            Request(
                rid=i,
                prompt=rng.integers(0, vocab, (int(n),)).astype(np.int32),
                max_new=cfg.serve_max_new,
            )
            for i, n in enumerate(lens)
        ]


@dataclasses.dataclass
class ChaosReport:
    """Everything the soak measured (``repro/runtime/chaos.py:350``), with
    the reference's field and JSON key names; ``assert_invariants`` is the
    verdict."""

    rounds: int
    seed: int
    # recovery
    restarts: int
    scratch_restarts: int
    completed_steps: int
    replayed_steps: int
    backoff_s: float
    device_failures: int
    failure_rounds: Tuple[int, ...]
    restores: Tuple[Optional[int], ...]  # restored step per recovery (None=scratch)
    fallback_restores: int
    ckpt_faults_injected: Dict[int, str]
    # elasticity
    elastic_events: Tuple[Tuple[int, int, int], ...]
    pods_seen: Tuple[int, ...]
    client_leg_traces: int
    client_retraces: int
    cross_compiles: int
    oracle_extra_traces: int
    # physical resharding (all zero/False in logical mode)
    physical_mesh: bool
    reshards: int
    mesh_migrate_ms: float
    meshes_seen: int
    # mid-write checkpoint kills
    mid_write_kills_injected: int
    mid_write_kills_survived: int
    # stragglers
    straggler: Dict[str, float]
    # unbiasedness
    audit: Dict[str, Any]
    # training signal
    loss_first: float
    loss_final: float
    # the verdict input
    oracle_bitwise_equal: bool
    serve: Optional[Dict[str, Any]]
    # serve p99 while a training round is in flight on the same card
    # (None when serve traffic is off)
    serve_p99_contended: Optional[float]
    minutes_budget: Optional[float]
    wall_s: float

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["ckpt_faults_injected"] = {
            str(k): v for k, v in self.ckpt_faults_injected.items()
        }
        return json.loads(json.dumps(d))  # normalize tuples -> lists

    def assert_invariants(self) -> None:
        errs = []
        if not self.oracle_bitwise_equal:
            errs.append(
                "post-recovery state is not bitwise identical to the "
                "uninterrupted oracle run"
            )
        if self.client_retraces != 0:
            errs.append(
                f"per-client leg retraced {self.client_retraces}x across "
                "elastic/recovery events (must be 0)"
            )
        if self.oracle_extra_traces != 0:
            errs.append(
                f"oracle replay added {self.oracle_extra_traces} traces "
                "(executables must be reused)"
            )
        if self.restarts < self.device_failures:
            errs.append(
                f"only {self.restarts} restarts for {self.device_failures} "
                "injected device failures"
            )
        st = self.straggler
        if st["p99_masked_s"] >= st["p99_sync_s"]:
            errs.append(
                "masked p99 round time not below synchronous baseline: "
                f"{st['p99_masked_s']:.3f} >= {st['p99_sync_s']:.3f}"
            )
        if st["tail_ratio_masked"] >= st["tail_ratio_sync"]:
            errs.append(
                "masked p99/p50 not below synchronous p99/p50: "
                f"{st['tail_ratio_masked']:.4f} >= {st['tail_ratio_sync']:.4f}"
            )
        if self.audit["max_rel_err"] > 1e-3:
            errs.append(
                "hierarchical masked mean diverged from flat "
                f"masked_reduce_mean reference: rel err "
                f"{self.audit['max_rel_err']:.2e}"
            )
        if self.ckpt_faults_injected and self.fallback_restores < 1:
            errs.append(
                "checkpoint faults were injected but no restore fell back "
                "past a broken checkpoint"
            )
        if self.mid_write_kills_survived < self.mid_write_kills_injected:
            errs.append(
                f"only {self.mid_write_kills_survived}/"
                f"{self.mid_write_kills_injected} mid-write checkpoint kills "
                "were survived via fallback restore"
            )
        if self.physical_mesh:
            if self.reshards < len(self.elastic_events):
                errs.append(
                    f"only {self.reshards} physical reshards for "
                    f"{len(self.elastic_events)} elastic events (every pod "
                    "change must re-map the mesh)"
                )
            if self.cross_compiles != self.meshes_seen:
                errs.append(
                    "cross-pod executable count != distinct meshes "
                    f"({self.cross_compiles} != {self.meshes_seen}): the "
                    "cache must hold exactly one executable per mesh"
                )
        if self.serve is not None:
            if not self.serve["flat_traces"]:
                errs.append("serve traces grew after the warmup burst")
            if self.serve["completed"] != self.serve["requests"]:
                errs.append(
                    f"serve completed {self.serve['completed']}/"
                    f"{self.serve['requests']} requests"
                )
            if self.serve["faults_injected"] and not self.serve["recoveries"]:
                errs.append("serve fault injected but never recovered")
        if errs:
            raise AssertionError(
                "chaos invariants violated:\n  - " + "\n  - ".join(errs)
            )


def _loss_fn(params, batch):
    x, y = batch
    pred = x @ params["w"] + params["b"]
    return torch.mean((pred - y) ** 2)


def _init_state(cfg: ChaosConfig, server_opt):
    """The soak's initial state on the config's device: ``w`` drawn from a
    torch ``Generator`` seeded by ``cfg.seed`` (the reference draws it
    with ``jax.random``), ``b`` zero; 0-d leaves are f32 tensors, as the
    checkpoint restores them, so a restore never changes a leg's key."""
    device = compat.resolve_device(cfg.device)
    gen = torch.Generator().manual_seed(cfg.seed)
    params = {
        "w": torch.randn((cfg.dim,), generator=gen,
                         dtype=torch.float32).to(device),
        "b": torch.zeros((), dtype=torch.float32, device=device),
    }
    return {"params": params, "server": server_opt.init(params)}


def _percentiles(values: List[float]) -> Tuple[float, float]:
    a = np.asarray(values, np.float64)
    return float(np.percentile(a, 50)), float(np.percentile(a, 99))


def _calibrate_round_s(run_round) -> float:
    """Seconds per training round: one warm-up (the trace and the
    capture), two timed runs. Module-level so tests can monkeypatch it."""
    run_round()
    t0 = time.perf_counter()
    run_round()
    run_round()
    return max((time.perf_counter() - t0) / 2.0, 1e-4)


def scale_config_to_minutes(cfg: ChaosConfig, round_s: float) -> ChaosConfig:
    """Rescale a soak config to a ~``cfg.minutes`` wall-clock budget.

    Pure in ``(cfg, round_s)``: rounds become ``minutes * 60 / round_s``
    (floor 8, the minimum ``validate`` accepts), fault counts scale in
    proportion (floor 1 for any fault class the template enabled), and
    ``max_restarts`` grows to keep headroom over the scaled failure count.
    ``minutes`` is cleared on the result so the scaling never re-triggers.
    """
    if cfg.minutes is None:
        return cfg
    target = max(8, int(round(cfg.minutes * 60.0 / round_s)))
    factor = target / max(cfg.rounds, 1)

    def scaled(n: int) -> int:
        return max(1, int(round(n * factor))) if n > 0 else 0

    nf = scaled(cfg.num_device_failures)
    return dataclasses.replace(
        cfg,
        rounds=target,
        num_device_failures=nf,
        num_elastic_events=scaled(cfg.num_elastic_events),
        num_ckpt_faults=scaled(cfg.num_ckpt_faults),
        max_restarts=max(cfg.max_restarts, nf + 2),
        minutes=None,
    )


class _ServeTraffic:
    """Lazy serve fleet (``repro/runtime/chaos.py:547``): a
    ContinuousBatchingScheduler of the reduced ``cfg.serve_arch``, warmed
    on a burst that covers every chunk bucket, with a one-shot fault armed
    on the schedule's designated burst. Recovery is ``reset_slots`` and a
    resubmit; on the card the steps are CUDA graphs, which recovery
    replays without a new capture."""

    def __init__(self, cfg: ChaosConfig):
        from ..launch.serve import ContinuousBatchingScheduler, Request
        from ..models import registry

        self.cfg = cfg
        self.scfg = registry.get_config(cfg.serve_arch).reduced()
        params = registry.init_params(self.scfg, seed=cfg.seed,
                                      device=cfg.device)
        max_len = (2 * cfg.serve_chunk - 1) + cfg.serve_max_new
        self.fault = {"at": None, "injected": 0}

        def hook(idx: int) -> None:
            if self.fault["at"] is not None and idx >= self.fault["at"]:
                self.fault["at"] = None
                self.fault["injected"] += 1
                raise SimulatedDeviceFailure(
                    f"injected serve fault at scheduler step {idx}"
                )

        self.sched = ContinuousBatchingScheduler(
            self.scfg, params, cfg.serve_slots, max_len,
            chunk=cfg.serve_chunk, fault_hook=hook,
        )
        self._request_cls = Request
        # warm-up: one burst whose prompt (2*chunk - 1 tokens) touches every
        # power-of-two chunk bucket, plus the decode-only step
        rng = _rng(cfg.seed, STREAM_SERVE)
        warm = [
            Request(
                rid=i,
                prompt=rng.integers(
                    0, self.scfg.vocab_size, (2 * cfg.serve_chunk - 1,)
                ).astype(np.int32),
                max_new=2,
            )
            for i in range(2)
        ]
        self.sched.run(warm)
        self.warm_traces = (self.sched.prefill_traces,
                            self.sched.decode_traces)
        self.fault_armed_once = False
        self.stats = {"bursts": 0, "recoveries": 0}
        self._done_rids: Dict[int, set] = {}
        # per-round completion latencies (scheduler clock, arrival 0)
        self._latencies: Dict[int, List[float]] = {}

    def burst(self, r: int, schedule: ChaosSchedule) -> None:
        reqs = schedule.serve_requests_for(r, self.scfg.vocab_size)
        if r == schedule.serve_fault_round and not self.fault_armed_once:
            self.fault_armed_once = True
            self.fault["at"] = self.sched.step_index + 3
        self.stats["bursts"] += 1
        pending = list(reqs)
        all_objs = list(reqs)
        for _ in range(4):
            if not pending:
                break
            try:
                self.sched.run(pending)
                break
            except SimulatedDeviceFailure:
                self.stats["recoveries"] += 1
                self.sched.reset_slots()
                pending = [
                    self._request_cls(
                        rid=q.rid, prompt=q.prompt, max_new=q.max_new
                    )
                    for q in pending
                    if not q.done
                ]
                all_objs.extend(pending)
        else:
            raise RuntimeError("serve burst failed to recover after retries")
        # a replayed burst overwrites its round's completion record
        self._done_rids[r] = {q.rid for q in all_objs if q.done}
        self._latencies[r] = [
            float(q.t_done) for q in all_objs
            if q.done and q.t_done is not None
        ]

    def report(self, num_rounds_requests: int) -> Dict[str, Any]:
        now = (self.sched.prefill_traces, self.sched.decode_traces)
        completed = sum(len(s) for s in self._done_rids.values())
        lats = [t for r in sorted(self._latencies)
                for t in self._latencies[r]]
        p50, p99 = _percentiles(lats) if lats else (0.0, 0.0)
        return {
            "bursts": self.stats["bursts"],
            "requests": num_rounds_requests,
            "completed": completed,
            "faults_injected": self.fault["injected"],
            "recoveries": self.stats["recoveries"],
            "prefill_traces": now[0],
            "decode_traces": now[1],
            "flat_traces": now == self.warm_traces,
            "p50_contended_s": round(p50, 4),
            "p99_contended_s": round(p99, 4),
        }


def _agree_max(values: List[float], device) -> List[float]:
    """The elementwise max of ``values`` over every rank of the world."""
    import torch.distributed as dist

    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def _host(tree) -> List[np.ndarray]:
    return [t.detach().cpu().numpy() for t in pytree.tree_leaves(tree)]


def run_chaos_soak(cfg: Optional[ChaosConfig] = None, *,
                   check: bool = True) -> ChaosReport:
    """Run the soak (``repro/runtime/chaos.py:658``); returns a
    :class:`ChaosReport`, asserting the production invariants first
    unless ``check=False``."""
    from .. import optim
    from ..algorithms.rounds import LocalSGDConfig, make_local_sgd_round
    from .elastic import make_elastic_hierarchical_round

    from .elastic import mesh_for_surviving_pods, pod_device_pool

    t_start = time.time()
    cfg = cfg or ChaosConfig()
    device = compat.resolve_device(cfg.device)
    C = cfg.clients_per_pod

    # --- physical elasticity: a real (pod, data) mesh per alive set -----
    pool, rank = None, 0
    if cfg.physical_mesh:
        import torch.distributed as dist

        need = cfg.num_pods * C
        if not dist.is_initialized() or dist.get_world_size() < need:
            raise RuntimeError(
                f"physical_mesh soak needs a world of {need} ranks "
                f"({cfg.num_pods} pods x {C} clients): join one with "
                "compat.init_process_group on every rank first")
        pool, rank = pod_device_pool(cfg.num_pods, C), dist.get_rank()
    mesh_cache: Dict[Tuple[int, ...], Any] = {}

    def mesh_for(alive: Tuple[int, ...]):
        # one mesh per alive set for the whole soak (oracle included), built
        # by every rank in the same order
        if pool is None:
            return None
        if alive not in mesh_cache:
            mesh_cache[alive] = mesh_for_surviving_pods(pool, alive,
                                                        device=device.type)
        return mesh_cache[alive]

    client_opt = optim.sgd(cfg.client_lr)
    server_opt = optim.fedavg_momentum(1.0, momentum=cfg.server_momentum)
    round_cfg = LocalSGDConfig(
        partition_size=C,
        num_local_steps=cfg.local_steps,
        straggler_mask=True,
    )
    elastic = make_elastic_hierarchical_round(
        _loss_fn, client_opt, server_opt, round_cfg, straggler_mask=True,
        device=device.type,
    )
    init_state = _init_state(cfg, server_opt)

    # --- time budget: calibrate a probe round, rescale the schedule -----
    minutes_budget = cfg.minutes
    if cfg.minutes is not None:
        rng_p = _rng(cfg.seed, STREAM_DATA, 0)
        shape = (cfg.num_pods, C, cfg.local_steps, cfg.batch)
        probe_batch = {
            "data": (
                torch.from_numpy(rng_p.standard_normal(
                    shape + (cfg.dim,)).astype(np.float32)).to(device),
                torch.from_numpy(rng_p.standard_normal(shape).astype(
                    np.float32)).to(device),
            ),
            # an all-finishers mask of the soak's dtype and shape, so the
            # calibration's warm-up IS the per-client leg's one trace
            "mask": torch.ones((cfg.num_pods, C), dtype=torch.float32,
                               device=device),
        }

        probe_mesh = mesh_for(tuple(range(cfg.num_pods)))

        def probe_round():
            _, _, m = elastic.step(init_state["params"], init_state["server"],
                                   probe_batch, mesh=probe_mesh)
            float(m["loss"])

        cfg = scale_config_to_minutes(cfg, _calibrate_round_s(probe_round))

    schedule = ChaosSchedule.from_config(cfg)

    # flat masked reference rounds for the unbiasedness audits, one per
    # distinct cohort size
    flat_cache: Dict[int, Any] = {}

    def flat_round(n: int):
        if n not in flat_cache:
            fcfg = LocalSGDConfig(
                partition_size=n,
                num_local_steps=cfg.local_steps,
                straggler_mask=True,
            )
            flat_cache[n] = make_local_sgd_round(_loss_fn, client_opt,
                                                 server_opt, fcfg)
        return flat_cache[n]

    # --- chaos plumbing -------------------------------------------------
    # no directory given: a temporary one, removed when the soak ends
    tmp = (tempfile.TemporaryDirectory(prefix="chaos_ckpt_")
           if cfg.ckpt_dir is None else None)
    ckpt_dir = cfg.ckpt_dir or tmp.name
    if pool is not None:
        ckpt_dir = os.path.join(ckpt_dir, f"rank_{rank}")
    remaining_faults = dict(schedule.ckpt_faults)
    injected_faults: Dict[int, str] = {}

    def ckpt_fault_hook(step: int) -> Optional[str]:
        kind = remaining_faults.pop(step, None)  # once: replays re-save clean
        if kind is not None:
            injected_faults[step] = kind
        return kind

    mgr = CheckpointManager(
        ckpt_dir, keep_last_n=cfg.keep_last_n, fault_hook=ckpt_fault_hook
    )
    # every recovery's restored step (None for a from-scratch restart)
    recovery_log: List[Optional[int]] = []

    injector = FailureInjector(schedule.failure_rounds)
    fired_failures: List[int] = []

    serve = (_ServeTraffic(cfg) if schedule.serve_rounds and rank == 0
             else None)

    # per-round records keyed by round index: a replay overwrites with the
    # identical value (step_fn is deterministic in the round), so replays
    # never double-count
    losses: Dict[int, float] = {}
    masked_t: Dict[int, float] = {}
    sync_t: Dict[int, float] = {}
    audit_errs: Dict[int, float] = {}

    def on_recovery(_i: int, s: Optional[int]) -> None:
        recovery_log.append(s)
        if pool is not None:  # the ranks that ran round s - 1 are current
            elastic.set_state_holders(
                None if not s else pool[list(schedule.alive_pods[s - 1])]
                .reshape(-1))

    def step_fn(r: int, state):
        try:
            injector.check(r)
        except SimulatedDeviceFailure:
            fired_failures.append(r)
            raise
        p = schedule.pod_counts[r]
        x, y = schedule.data_for_round(r, p)
        mask, mt, st_ = schedule.round_mask_and_times(r, p)
        masked_t[r], sync_t[r] = mt, st_
        batch = {"data": (x, y), "mask": mask}
        # a rank whose inputs are stale (it receives the state in this
        # step's migration) does not audit the round
        current = elastic.holds_state(rank)
        out = elastic.step(state["params"], state["server"], batch,
                           mesh=mesh_for(schedule.alive_pods[r]))
        if serve is not None and r in schedule.serve_rounds:
            # the burst goes out BEFORE the host waits for the loss: on the
            # card the round is still queued, so these latencies are
            # contended
            serve.burst(r, schedule)
        if out is None:  # this rank's pod is down: it sits the round out
            return state
        params, server, metrics = out
        losses[r] = float(metrics["loss"])
        if r in schedule.audit_rounds and current:
            n = p * C
            ref_p, _, _ = flat_round(n)(
                state["params"], state["server"],
                (x.reshape((n,) + x.shape[2:]), y.reshape((n,) + y.shape[2:])),
                mask.reshape((n,)),
            )
            audit_errs[r] = max(
                float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))
                for a, b in zip(_host(params), _host(ref_p)))
        return {"params": params, "server": server}

    final_state, stats = run_with_recovery(
        step_fn,
        init_state,
        cfg.rounds,
        mgr,
        checkpoint_every=cfg.checkpoint_every,
        max_restarts=cfg.max_restarts,
        recoverable=DEFAULT_RECOVERABLE,
        backoff_base_s=cfg.backoff_base_s,
        on_recovery=on_recovery,
    )

    # --- fallback accounting: a recovery fell back iff it restored below
    # (or from scratch instead of) the newest checkpoint its failure round
    # implies must exist ---
    fallbacks = 0
    for r, s in zip(fired_failures, recovery_log):
        expected = (r // cfg.checkpoint_every) * cfg.checkpoint_every
        if expected > 0 and (s is None or s < expected):
            fallbacks += 1

    # --- mid-write kill accounting: every injected kill must have been
    # survived: its step never committed, the manager recorded the death,
    # and the failure that wanted that checkpoint restored strictly below
    # it (or from scratch) ---
    kill_steps = sorted(
        s for s, k in injected_faults.items() if k.startswith("kill@")
    )
    kills_survived = 0
    for s in kill_steps:
        died = s in mgr.killed_writes
        fell_back = any(
            (r // cfg.checkpoint_every) * cfg.checkpoint_every == s
            and (rest is None or rest < s)
            for r, rest in zip(fired_failures, recovery_log)
        )
        if died and fell_back:
            kills_survived += 1
    if tmp is not None:
        tmp.cleanup()

    # physical counters: taken BEFORE the oracle, whose replay re-adopts
    # every mesh
    reshards = elastic.reshard_count
    mesh_migrate_ms = elastic.mesh_migrate_ms
    meshes_seen = elastic.meshes_seen

    # --- oracle: the same schedule, uninterrupted, on the SAME executor;
    # it must build nothing and reproduce the final state bitwise ---
    traces_before = elastic.client_trace_count
    cross_before = elastic.cross_compile_count
    elastic.set_state_holders(None)  # every rank starts from init_state
    o_state = init_state
    for r in range(cfg.rounds):
        p = schedule.pod_counts[r]
        x, y = schedule.data_for_round(r, p)
        mask, _, _ = schedule.round_mask_and_times(r, p)
        out = elastic.step(o_state["params"], o_state["server"],
                           {"data": (x, y), "mask": mask},
                           mesh=mesh_for(schedule.alive_pods[r]))
        if out is not None:
            o_state = {"params": out[0], "server": out[1]}
    oracle_extra = (elastic.client_trace_count - traces_before) + (
        elastic.cross_compile_count - cross_before
    )
    final_mesh = mesh_for(schedule.alive_pods[cfg.rounds - 1])
    bitwise = (final_mesh is not None and final_mesh.get_coordinate() is None
               ) or all(np.array_equal(a, b) for a, b in
                        zip(_host(final_state), _host(o_state)))
    cross_compiles = elastic.cross_compile_count
    client_traces = elastic.client_trace_count
    if pool is not None:
        from . import executor

        # one cross leg per mesh across the world; the rest as above
        built = set(elastic.cross_meshes())
        agreed = _agree_max(
            [float(executor._mesh_key(m) in built) for m in
             mesh_cache.values()]
            + [float(client_traces), float(oracle_extra), mesh_migrate_ms,
               float(not bitwise)]
            + [losses.get(r, -np.inf) for r in range(cfg.rounds)]
            + [audit_errs.get(r, -np.inf)
               for r in sorted(schedule.audit_rounds)],
            device)
        k, n = len(mesh_cache), cfg.rounds
        built_v, counts, loss_v, audit_v = (
            agreed[:k], agreed[k:k + 4], agreed[k + 4:k + 4 + n],
            agreed[k + 4 + n:])
        cross_compiles = int(sum(built_v))
        client_traces, oracle_extra = int(counts[0]), int(counts[1])
        mesh_migrate_ms, bitwise = counts[2], counts[3] == 0.0
        losses = {r: v for r, v in enumerate(loss_v) if v != -np.inf}
        audit_errs = {r: v for r, v in zip(sorted(schedule.audit_rounds),
                                           audit_v) if v != -np.inf}

    mp50, mp99 = _percentiles([masked_t[r] for r in sorted(masked_t)])
    sp50, sp99 = _percentiles([sync_t[r] for r in sorted(sync_t)])
    serve_report = (
        serve.report(len(schedule.serve_rounds) * cfg.serve_requests)
        if serve is not None
        else None
    )
    report = ChaosReport(
        rounds=cfg.rounds,
        seed=cfg.seed,
        restarts=stats["restarts"],
        scratch_restarts=stats["scratch_restarts"],
        completed_steps=stats["completed_steps"],
        replayed_steps=stats["replayed_steps"],
        backoff_s=stats["backoff_s"],
        device_failures=injector.failures,
        failure_rounds=tuple(fired_failures),
        restores=tuple(recovery_log),
        fallback_restores=fallbacks,
        ckpt_faults_injected=dict(injected_faults),
        elastic_events=schedule.elastic_events,
        pods_seen=tuple(sorted(set(schedule.pod_counts))),
        client_leg_traces=client_traces,
        client_retraces=max(0, client_traces - 1),
        cross_compiles=cross_compiles,
        oracle_extra_traces=oracle_extra,
        physical_mesh=cfg.physical_mesh,
        reshards=reshards,
        mesh_migrate_ms=round(mesh_migrate_ms, 3),
        meshes_seen=meshes_seen,
        mid_write_kills_injected=len(kill_steps),
        mid_write_kills_survived=kills_survived,
        straggler={
            "p50_masked_s": round(mp50, 4),
            "p99_masked_s": round(mp99, 4),
            "p50_sync_s": round(sp50, 4),
            "p99_sync_s": round(sp99, 4),
            "tail_ratio_masked": round(mp99 / mp50, 4),
            "tail_ratio_sync": round(sp99 / sp50, 4),
            "speedup": round(
                sum(sync_t.values()) / max(sum(masked_t.values()), 1e-9), 4
            ),
        },
        audit={
            "rounds": sorted(audit_errs),
            "max_rel_err": max(audit_errs.values()) if audit_errs else 0.0,
        },
        loss_first=losses.get(0, float("nan")),
        loss_final=losses.get(cfg.rounds - 1, float("nan")),
        oracle_bitwise_equal=bool(bitwise),
        serve=serve_report,
        serve_p99_contended=(
            serve_report["p99_contended_s"] if serve_report else None
        ),
        minutes_budget=minutes_budget,
        wall_s=round(time.time() - t_start, 2),
    )
    if check:
        report.assert_invariants()
    return report
