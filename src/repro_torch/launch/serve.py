"""Continuous-batching serve runtime over a slot pool
(``repro/launch/serve.py:84-431``).

On the CPU, a reduced config:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm_3b \
        --reduced --requests 8 --max-new 16 --device cpu

and on the card (the default device), at full width:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm_3b \
        --requests 16 --slots 4 --prompt-len 256 --max-new 32 --chunk 64

Two schedulers share the steps of :mod:`repro_torch.launch.steps`:

* :class:`ContinuousBatchingScheduler`: requests are admitted per step
  from an arrival queue; a new request's prompt chunks ride in the same
  step as the in-flight decodes (``make_serve_step``), and a finished slot
  is reassigned on the next step with no reallocation;
* :class:`StaticWaveScheduler`: the baseline. It admits a wave, prefills
  it one request at a time (``make_slot_chunk_step``), decodes it in
  lockstep and drains it before admitting the next.

The reference's admission model: at most one request is mid-prefill; its
slot's cache is gathered before the fused step's decode leg and scattered
back after it. A request is admitted when a slot is free and ``prompt_len
+ max_new <= max_len``; the first chunk zero-resets its slot. Prompts are
cut into power-of-two chunks ``<= chunk`` (:func:`chunk_schedule`, no
padding: padding would advance a recurrent state), so the steps are one
per chunk bucket plus one decode-only step whatever the traffic: on the
card one CUDA graph each, replayed (``runtime.executor.CudaGraphs``), on
the CPU run eagerly. ``prefill_traces`` and ``decode_traces`` count their
builds and stay flat after a bucket warm-up.

On a mesh (``mesh=``, as the reference's schedulers take it), every rank
runs the same scheduler over the same requests, SPMD: the pool is
sharded over the data ranks (``registry.init_slot_pool(mesh=)``: a rank
allocates and decodes its block of the slots), the steps are the mesh
steps of :mod:`repro_torch.launch.steps`, whose next tokens reach every
rank by an exact gather, and the scheduler clock advances by the
slowest rank's step (a max over the mesh), so every rank admits, chunks
and retires the same requests at the same step. Each step ends in a
collective that no CUDA graph holds (gloo's on the card: ROADMAP, Port
conventions), so on a mesh every step runs eagerly; ``captured`` says
which, and ``replayed_launches()`` stays empty.

The reference's async discipline: the host stays one step ahead of the
device. Step t is dispatched before the host does the bookkeeping of step
t - 1, from one batched device-to-host copy of that step's tokens (into
pinned memory, waited on by its event; never a per-request read). The
greedy tokens chain on the device: each step writes the next step's token
feed in place. A slot stops at ``cfg.eos_id`` (kept in ``generated``) or
after ``max_new`` tokens.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from .. import compat
from ..models import registry
from ..runtime.executor import CudaGraphs, TraceCounter
from . import steps as steps_lib

DEFAULT_CHUNK = 16


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    arrival: float = 0.0  # seconds on the scheduler clock
    generated: List[int] = field(default_factory=list)
    done: bool = False
    # timing (scheduler-clock seconds; filled by the schedulers)
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    token_times: List[float] = field(default_factory=list)


def chunk_schedule(n: int, chunk_max: int) -> List[int]:
    """Greedy binary decomposition of a prompt length into power-of-two
    chunks ``<= chunk_max``, largest first (``repro/launch/serve.py:98``):
    exact (no padding) and bounded (every length maps into the same
    ``log2(chunk_max) + 1`` buckets)."""
    if n <= 0 or chunk_max <= 0:
        raise ValueError(f"need n > 0 and chunk_max > 0, got {n}, {chunk_max}")
    out = []
    c = 1 << (chunk_max.bit_length() - 1)
    while n:
        while c > n:
            c >>= 1
        out.append(c)
        n -= c
    return out


@dataclass
class _Slot:
    req: Request
    chunks: List[int]
    pos: int = 0
    first: bool = True
    phase: str = "prefill"  # prefill | decode


class _Fetch:
    """One step's token feed on its way to the host: a pinned copy and the
    event after it on the card, a copy on the CPU."""

    def __init__(self, tokens: torch.Tensor):
        if tokens.is_cuda:
            self.host = torch.empty(tokens.shape, dtype=tokens.dtype,
                                    pin_memory=True)
            self.host.copy_(tokens, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = tokens.clone(), None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class _SchedulerBase:
    """Slot-pool state and host bookkeeping shared by both schedulers
    (``repro/launch/serve.py:121``).

    ``fault_hook(step_index)`` is called once per scheduler step with the
    monotonic 1-based step index and may raise to simulate a serving fault.
    A harness that catches it calls :meth:`reset_slots` and submits the
    unfinished requests again: a reused slot is zero-reset by its first
    chunk, so recovery neither reallocates the pool nor builds a step
    again."""

    def __init__(self, cfg, params, slots: int, max_len: int,
                 chunk: int = DEFAULT_CHUNK, mesh=None, fault_hook=None):
        self.cfg, self.params = cfg, params
        self.slots, self.max_len, self.chunk = slots, max_len, chunk
        self.mesh = mesh
        self.eos_id = cfg.eos_id
        self.fault_hook = fault_hook
        self.step_index = 0  # monotonic across run() calls
        self.device = _local(next(iter(params.values()))).device
        # a collective ends every mesh step: no CUDA graph holds it
        self.captured = mesh is None and self.device.type == "cuda"
        self._pool = registry.init_slot_pool(cfg, slots, max_len,
                                             device=self.device, mesh=mesh)
        self._tokens = torch.zeros((slots, 1), dtype=torch.int32,
                                   device=self.device)
        # the steps' scalar inputs, written before each step (static buffers
        # of the captured graphs)
        self._cslot = torch.zeros((1,), dtype=torch.int64, device=self.device)
        self._cpos = torch.zeros((), dtype=torch.int32, device=self.device)
        self._cfirst = torch.zeros((), dtype=torch.bool, device=self.device)
        self._cemit = torch.zeros((), dtype=torch.bool, device=self.device)
        self._ctokens: Dict[int, torch.Tensor] = {}
        self._slots: List[Optional[_Slot]] = [None] * slots
        self._prefill_counter = TraceCounter()
        self._decode_counter = TraceCounter()
        self._decode = self._graphs(steps_lib.make_slot_decode_step(cfg, mesh),
                                    self._decode_counter)
        self._steps = [self._decode]

    def _graphs(self, step, counter: TraceCounter) -> CudaGraphs:
        return CudaGraphs(step, device=self.device, counter=counter,
                          capture=self.captured)

    def _elapsed(self, t0: float) -> float:
        """The seconds since ``t0``: on a mesh the slowest rank's, so the
        ranks' clocks, and their admissions, agree."""
        dt = time.perf_counter() - t0
        if self.mesh is None:
            return dt
        import torch.distributed as dist

        t = torch.tensor([dt], dtype=torch.float64)
        for d in range(self.mesh.ndim):
            dist.all_reduce(t, op=dist.ReduceOp.MAX,
                            group=self.mesh.get_group(d))
        return float(t[0])

    def _tick(self) -> None:
        self.step_index += 1
        if self.fault_hook is not None:
            self.fault_hook(self.step_index)

    def reset_slots(self) -> None:
        """Drop all in-flight work after a fault: free every slot and zero
        the token feed. The pool is kept (a reused slot is zero-reset by
        its first chunk) and the build counters are untouched."""
        self._slots = [None] * self.slots
        self._tokens.zero_()

    @property
    def prefill_traces(self) -> int:
        """Builds of the chunk (or fused) step: one per chunk bucket."""
        return self._prefill_counter.count

    @property
    def decode_traces(self) -> int:
        """Builds of the decode step: one (fixed slot shapes)."""
        return self._decode_counter.count

    def replayed_launches(self) -> Dict[str, int]:
        """Kernel launches of this scheduler's CUDA graph replays, by
        kernel (the wrappers' counters see only eager calls)."""
        out: Dict[str, int] = {}
        for step in self._steps:
            for name, n in step.replayed.items():
                out[name] = out.get(name, 0) + n
        return out

    def _check(self, req: Request):
        if len(req.prompt) + req.max_new > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + max_new "
                f"{req.max_new} exceeds max_len {self.max_len}")

    def _set_chunk(self, slot: int, prompt: np.ndarray, pos: int, c: int,
                   first: bool, emit: bool = False) -> torch.Tensor:
        """Write one chunk's inputs into the static buffers (stream-ordered
        device writes, no host sync) and return its token buffer."""
        buf = self._ctokens.get(c)
        if buf is None:
            buf = self._ctokens[c] = torch.zeros((c,), dtype=torch.int32,
                                                 device=self.device)
        host = torch.from_numpy(np.ascontiguousarray(prompt[pos:pos + c],
                                                     dtype=np.int32))
        if self.device.type == "cuda":
            host = host.pin_memory()
        buf.copy_(host, non_blocking=True)
        self._cslot.fill_(slot)
        self._cpos.fill_(pos)
        self._cfirst.fill_(first)
        self._cemit.fill_(emit)
        return buf

    def _decode_all(self):
        self._pool = self._decode("decode", self.params, self._tokens,
                                  self._pool)[1]

    def _collect(self, tokens_np: np.ndarray, meta, clock: float) -> int:
        """Apply one fetched step's tokens to the requests that produced
        them (``meta``, the (slot, request) list at dispatch: a request
        that finished in the meantime takes no more tokens). Returns the
        number of requests finished."""
        ndone = 0
        for slot, req in meta:
            if req.done:
                continue
            tok = int(tokens_np[slot, 0])
            req.generated.append(tok)
            req.token_times.append(clock)
            if req.t_first is None:
                req.t_first = clock
            hit_eos = self.eos_id is not None and tok == self.eos_id
            if hit_eos or len(req.generated) >= req.max_new:
                req.done = True
                req.t_done = clock
                self._slots[slot] = None  # freed: reassigned, not reallocated
                ndone += 1
        return ndone


class ContinuousBatchingScheduler(_SchedulerBase):
    """Per-step admission, prompt chunks fused into the decode step
    (``repro/launch/serve.py:219``)."""

    def __init__(self, cfg, params, slots: int, max_len: int,
                 chunk: int = DEFAULT_CHUNK, mesh=None, fault_hook=None):
        super().__init__(cfg, params, slots, max_len, chunk, mesh, fault_hook)
        # one build per chunk bucket (the chunk length keys the step)
        self._serve = self._graphs(steps_lib.make_serve_step(cfg, mesh),
                                   self._prefill_counter)
        self._steps.append(self._serve)
        self._mid_prefill: Optional[int] = None

    def reset_slots(self) -> None:
        super().reset_slots()
        self._mid_prefill = None

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Drive ``requests`` to completion, honouring ``arrival`` on the
        scheduler clock (which advances by each step's measured wall
        time)."""
        reqs = sorted(requests, key=lambda r: r.arrival)
        for r in reqs:
            self._check(r)
        clock = 0.0
        arrive_i = 0
        waiting: Deque[Request] = deque()
        pending: Deque = deque()
        remaining = len(reqs)

        while remaining:
            t0 = time.perf_counter()
            self._tick()
            while arrive_i < len(reqs) and reqs[arrive_i].arrival <= clock:
                waiting.append(reqs[arrive_i])
                arrive_i += 1

            # admission: one request a step, at most one mid-prefill
            if self._mid_prefill is None and waiting:
                free = next((i for i, s in enumerate(self._slots) if s is None),
                            None)
                if free is not None:
                    req = waiting.popleft()
                    self._slots[free] = _Slot(
                        req=req, chunks=chunk_schedule(len(req.prompt),
                                                       self.chunk))
                    self._mid_prefill = free

            meta = [(i, s.req) for i, s in enumerate(self._slots)
                    if s is not None and s.phase == "decode"]
            dispatched = True
            if self._mid_prefill is not None:
                i = self._mid_prefill
                st = self._slots[i]
                c = st.chunks.pop(0)
                emit = not st.chunks
                ctokens = self._set_chunk(i, st.req.prompt, st.pos, c,
                                          st.first, emit)
                self._pool = self._serve(
                    c, self.params, self._tokens, self._pool, self._cslot,
                    ctokens, self._cpos, self._cfirst, self._cemit)[1]
                st.pos += c
                st.first = False
                if emit:  # the chunk's token is in the feed at slot i
                    st.phase = "decode"
                    self._mid_prefill = None
                    meta.append((i, st.req))
            elif meta:
                self._decode_all()
            else:
                dispatched = False

            if dispatched:
                pending.append((_Fetch(self._tokens), meta))

            # the bookkeeping of earlier steps while this one runs; one step
            # in flight
            while len(pending) > (1 if dispatched else 0):
                fetch, m = pending.popleft()
                remaining -= self._collect(fetch.numpy(), m, clock)

            if not dispatched and not pending:
                # idle: jump the clock to the next arrival
                if arrive_i < len(reqs):
                    clock = max(clock, reqs[arrive_i].arrival)
                continue
            clock += self._elapsed(t0)

        return {r.rid: r.generated for r in reqs}


class StaticWaveScheduler(_SchedulerBase):
    """Wave at a time (``repro/launch/serve.py:322``): admit up to
    ``batch`` requests, prefill them one by one into their slots, decode
    the wave in lockstep and drain it before the next. It shares the decode
    step and the chunk decomposition with the continuous scheduler, so
    only the scheduling differs."""

    def __init__(self, cfg, params, batch: int, max_len: int,
                 chunk: int = DEFAULT_CHUNK, mesh=None, fault_hook=None):
        super().__init__(cfg, params, batch, max_len, chunk, mesh, fault_hook)
        self.batch = batch
        self._chunk = self._graphs(steps_lib.make_slot_chunk_step(cfg, mesh),
                                   self._prefill_counter)
        self._steps.append(self._chunk)

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        reqs = sorted(requests, key=lambda r: r.arrival)
        for r in reqs:
            self._check(r)
        clock = 0.0
        arrive_i = 0
        waiting: Deque[Request] = deque()
        ndone = 0
        while ndone < len(reqs):
            while arrive_i < len(reqs) and reqs[arrive_i].arrival <= clock:
                waiting.append(reqs[arrive_i])
                arrive_i += 1
            if not waiting:
                clock = max(clock, reqs[arrive_i].arrival)
                continue
            wave = [waiting.popleft()
                    for _ in range(min(self.batch, len(waiting)))]
            clock = self._run_wave(wave, clock)
            ndone += len(wave)
        return {r.rid: r.generated for r in reqs}

    def run_wave(self, requests: List[Request]) -> Dict[int, List[int]]:
        """One wave (the reference's older entry point)."""
        assert len(requests) <= self.batch
        self._run_wave(list(requests), 0.0)
        return {r.rid: r.generated for r in requests}

    def _run_wave(self, wave: List[Request], clock: float) -> float:
        # prefill, one request at a time into its slot
        first = np.zeros((self.slots, 1), np.int32)
        for slot, req in enumerate(wave):
            t0 = time.perf_counter()
            self._tick()
            pos, cfirst, ctok = 0, True, None
            for c in chunk_schedule(len(req.prompt), self.chunk):
                ctokens = self._set_chunk(slot, req.prompt, pos, c, cfirst)
                ctok, self._pool = self._chunk(
                    c, self.params, self._pool, self._cslot, ctokens,
                    self._cpos, self._cfirst)
                pos += c
                cfirst = False
            self._slots[slot] = _Slot(req=req, chunks=[], phase="decode")
            # the baseline waits once per request here
            tok = int(ctok)
            clock += self._elapsed(t0)
            first[slot, 0] = tok
            req.generated.append(tok)
            req.token_times.append(clock)
            req.t_first = clock
            if (self.eos_id is not None and tok == self.eos_id) \
                    or req.max_new <= 1:
                req.done = True
                req.t_done = clock
                self._slots[slot] = None

        # lockstep decode, fetching each step's tokens one step late
        self._tokens.copy_(torch.from_numpy(first))
        prev = None
        while True:
            t0 = time.perf_counter()
            self._tick()
            meta = [(i, s.req) for i, s in enumerate(self._slots)
                    if s is not None]
            dispatched = bool(meta)
            if dispatched:
                self._decode_all()
            if prev is not None:
                fetch, m = prev
                self._collect(fetch.numpy(), m, clock)
                prev = None
            if not dispatched:
                break
            prev = (_Fetch(self._tokens), meta)
            clock += self._elapsed(t0)
        for slot in range(self.slots):
            self._slots[slot] = None
        return clock


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor, or ``t``."""
    return t.to_local() if hasattr(t, "to_local") else t


# the reference's older name: the static scheduler succeeds BatchScheduler
BatchScheduler = StaticWaveScheduler


def poisson_trace(rng, n: int, rate: float) -> List[float]:
    """Arrival times of ``n`` requests at ``rate`` per second."""
    gaps = rng.exponential(1.0 / rate, size=n)
    return list(np.cumsum(gaps))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm_3b", choices=registry.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--scheduler", default="continuous",
                    choices=("continuous", "static"))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=DEFAULT_CHUNK)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate (req/s); 0 = all at t=0")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = registry.get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder_decoder or cfg.family == "vlm":
        raise SystemExit("serve runtime targets token-only decoder archs")
    device = compat.resolve_device(args.device)

    params = registry.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    arrivals = (poisson_trace(rng, args.requests, args.rate)
                if args.rate > 0 else [0.0] * args.requests)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=(args.prompt_len,))
                    .astype(np.int32),
                    max_new=args.max_new, arrival=arrivals[i])
            for i in range(args.requests)]
    cls = (ContinuousBatchingScheduler if args.scheduler == "continuous"
           else StaticWaveScheduler)
    max_len = args.prompt_len + args.max_new
    sched = cls(cfg, params, args.slots, max_len=max_len, chunk=args.chunk)
    t0 = time.time()
    results = sched.run(reqs)
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in results.values())
    ttfts = [r.t_first - r.arrival for r in reqs]
    print(json.dumps({
        "arch": cfg.name,
        "scheduler": args.scheduler,
        "requests": len(reqs),
        "generated_tokens": total_tokens,
        "wall_s": round(dt, 2),
        "tokens_per_s": round(total_tokens / dt, 1),
        "ttft_p50_s": round(float(np.percentile(ttfts, 50)), 4),
        "prefill_traces": sched.prefill_traces,
        "decode_traces": sched.decode_traces,
        "pool_mb": round(registry.slot_pool_bytes(cfg, args.slots, max_len)
                         / 2**20, 2),
    }))


if __name__ == "__main__":
    main()
