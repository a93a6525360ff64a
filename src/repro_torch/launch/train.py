"""End-to-end training driver (``repro/launch/train.py``).

Trains any decoder of ``registry.ARCH_IDS`` (``--arch``) with DrJAX
local-SGD / FedAvg / DiLoCo rounds, optionally with int8 delta
compression, on one CUDA card (``--device cuda``, the default; it raises
without a card) or, for small runs, the CPU (``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch lm_350m --reduced --algorithm diloco --rounds 20 \
        --cohort 4 --local-steps 2 --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch recurrentgemma_2b --cohort 2 --local-steps 2 --batch 1 \
        --seq 4096 --compression none

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch rwkv6_3b --cohort 2 --local-steps 2 --batch 1 \
        --seq 4096 --compression none

``--stragglers`` draws each round's client durations
(``runtime.StragglerSimulator``), sets the deadline at the
``--straggler-deadline-pct`` percentile (default 90), keeps at least half
the cohort, and passes the mask to the round, which averages over the
clients that finished:

    PYTHONPATH=src python -m repro_torch.launch.train \
        --reduced --rounds 2 --cohort 4 --local-steps 2 --compression int8 \
        --stragglers --device cpu

Every round runs through ``runtime.run_with_recovery`` with a
``CheckpointManager`` in ``--ckpt-dir`` (default ``/tmp/repro_ckpt``; at
start it resumes from whatever that directory holds, as the reference
does), a checkpoint every ``--ckpt-every`` rounds (20) and after the last,
and ``--fail-at`` rounds at which a simulated device failure restores the
newest checkpoint and replays from there. A round's data and straggler mask
depend on its index alone, so the replay is exact:

    PYTHONPATH=src python -m repro_torch.launch.train \
        --reduced --rounds 4 --cohort 4 --local-steps 2 --compression int8 \
        --ckpt-dir /tmp/ckpt_demo --ckpt-every 2 --fail-at 3 --device cpu

``--compression topk`` sparsifies each client's delta to its top 1% by
magnitude (``LocalSGDConfig.topk_fraction``).

``--chaos`` runs the chaos soak instead of training
(``runtime.chaos.run_chaos_soak``, logical mode): 48 rounds unless
``--rounds`` is given, a checkpoint every ``min(--ckpt-every, 8)`` rounds
into a temporary directory (never ``--ckpt-dir``), ``--seed`` and
``--device`` passed through; it prints the report's JSON and raises if an
invariant fails:

    PYTHONPATH=src python -m repro_torch.launch.train --chaos --device cpu

Same flags, defaults and final JSON line as the reference. An
encoder-decoder (seamless_m4t_medium) is refused with a ``ValueError``:
this module's batches are tokens and labels, as the reference's
``launch/train.py`` builds them, which cannot train one either; its rounds run through
``algorithms.rounds.make_local_sgd_round`` on ``registry.make_batch``. One
difference from the reference: the programmatic :func:`train` takes
``args.ckpt_dir = None`` to run the rounds without a checkpoint manager
(no flag sets it); ``--fail-at`` then raises, since nothing could be
restored.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import logging
import time
from typing import List, Optional

import numpy as np
import torch

from .. import compat, optim
from ..algorithms.rounds import LocalSGDConfig, make_local_sgd_round
from ..checkpoint import CheckpointManager
from ..data.grouped import CohortSampler, GroupedCorpus
from ..models import registry
from ..runtime.failure import FailureInjector, run_with_recovery
from ..runtime.stragglers import StragglerSimulator, straggler_mask

logger = logging.getLogger(__name__)


def optimizers(args):
    """(client_opt, server_opt) for ``args.algorithm``."""
    client_opt = (
        optim.adamw(args.client_lr) if args.algorithm == "diloco"
        else optim.sgd(args.client_lr)
    )
    server_opt = {
        "local_sgd": optim.fedavg_momentum(1.0),
        "fedavg": optim.fedavg_momentum(1.0, momentum=0.9),
        "diloco": optim.diloco_optimizer(0.7, 0.9),
    }[args.algorithm]
    return client_opt, server_opt


def build_round_fn(cfg, args):
    """The flat round for ``args``, and its server optimizer."""
    client_opt, server_opt = optimizers(args)
    round_cfg = LocalSGDConfig(
        partition_size=args.cohort, num_local_steps=args.local_steps,
        grad_clip=1.0,
        compression=None if args.compression in (None, "none") else args.compression,
        straggler_mask=args.stragglers,
    )
    loss_fn = functools.partial(registry.loss_fn, cfg)
    return make_local_sgd_round(loss_fn, client_opt, server_opt, round_cfg), server_opt


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm_350m", choices=registry.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config (CPU)")
    ap.add_argument("--algorithm", default="local_sgd",
                    choices=("local_sgd", "fedavg", "diloco"))
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--cohort", type=int, default=8)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--client-lr", type=float, default=0.05)
    ap.add_argument("--compression", default="none",
                    choices=("none", "int8", "topk"))
    ap.add_argument("--stragglers", action="store_true")
    ap.add_argument("--straggler-deadline-pct", type=float, default=90.0)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject simulated failures at these rounds")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--chaos", action="store_true",
                    help="run the chaos soak instead of training: composed "
                         "fault injection (device failures, pod dropout and "
                         "regrowth, straggler deadlines, checkpoint faults, "
                         "serve traffic) with the production invariants "
                         "asserted (see repro_torch.runtime.chaos)")
    return ap.parse_args(argv)


def chaos(args):
    """The soak of ``--chaos`` (``repro/launch/train.py:96-111``): its
    :class:`~repro_torch.runtime.chaos.ChaosReport`."""
    from ..runtime.chaos import ChaosConfig, run_chaos_soak

    report = run_chaos_soak(ChaosConfig(
        rounds=args.rounds if args.rounds != 100 else 48,
        seed=args.seed,
        checkpoint_every=min(args.ckpt_every, 8),
        ckpt_dir=None,  # soak state is throwaway; never reuse --ckpt-dir
        device=args.device,
    ))
    logger.info(
        "chaos soak survived: %d failures, %d elastic events, "
        "%d fallback restores, bitwise=%s",
        report.device_failures, len(report.elastic_events),
        report.fallback_restores, report.oracle_bitwise_equal,
    )
    return report


def round_mask(strag: StragglerSimulator, round_idx: int, args, device):
    """The straggler mask of one round, as the reference's ``launch.train``
    draws it: the cohort's durations, a deadline at
    ``--straggler-deadline-pct``, and at least half the cohort kept."""
    durations = strag.durations(round_idx, args.cohort)
    deadline = float(np.percentile(durations, args.straggler_deadline_pct))
    return straggler_mask(durations, deadline,
                          min_finishers=max(args.cohort // 2, 1),
                          device=device)


@dataclasses.dataclass
class TrainResult:
    """What :func:`train` returns. ``losses``, ``seconds`` and ``masks``
    hold one entry for every round that ran, in the order they ran, a
    replayed round again each time; ``masks`` is None without
    ``--stragglers``. ``recovery`` holds ``run_with_recovery``'s stats
    (``replayed_steps`` counts the replays) and ``restored_from``, the step
    each failure restored (None for a restart from scratch)."""

    summary: dict
    params: dict
    server_state: dict
    losses: List[float]
    seconds: List[float]
    masks: Optional[List[torch.Tensor]]
    recovery: dict


def train(args) -> TrainResult:
    """Run ``args.rounds`` flat rounds, through ``run_with_recovery`` and a
    ``CheckpointManager(args.ckpt_dir)``, or with ``args.ckpt_dir`` None
    straight, without checkpoints. A round's seconds end when its loss
    reaches the host, which waits for the device."""
    if args.ckpt_dir is None and args.fail_at:
        raise ValueError("--fail-at needs a checkpoint directory to recover "
                         "from; args.ckpt_dir is None")
    device = compat.resolve_device(args.device)
    cfg = registry.get_config(args.arch)
    if cfg.is_encoder_decoder:
        # the reference's launch/train.py feeds tokens and labels only
        # (repro/launch/train.py:139): it cannot train one either
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: launch.train's batches hold "
            f"tokens and labels, not frames; run its rounds through "
            f"algorithms.rounds.make_local_sgd_round(registry.loss_fn) on a "
            f"registry.make_batch batch")
    if args.reduced:
        cfg = cfg.reduced()
        args.seq = min(args.seq, 64)
        args.batch = min(args.batch, 4)
    params = registry.init_params(cfg, seed=args.seed, device=device)
    round_fn, server_opt = build_round_fn(cfg, args)
    server_state = server_opt.init(params)
    sampler = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                            cohort_size=args.cohort)
    strag = StragglerSimulator() if args.stragglers else None
    injector = FailureInjector(args.fail_at)
    n_params = sum(p.numel() for p in params.values())
    logger.info("arch=%s params=%.2fM cohort=%d local_steps=%d device=%s",
                cfg.name, n_params / 1e6, args.cohort, args.local_steps, device)
    history, seconds, masks = [], [], []

    def round_step(round_idx, state):
        injector.check(round_idx)
        data = sampler.round_batch(round_idx, args.local_steps, args.batch,
                                   args.seq, device=device)
        batch = {"tokens": data["tokens"], "labels": data["labels"]}
        t0 = time.perf_counter()
        mask = None
        if strag is not None:
            mask = round_mask(strag, round_idx, args, device)
            masks.append(mask)
        new_params, new_server, metrics = round_fn(
            state["params"], state["server"], batch, mask)
        loss = float(metrics["loss"])
        seconds.append(time.perf_counter() - t0)
        history.append(loss)
        if round_idx % args.log_every == 0:
            logger.info("round %d loss %.4f (%.2fs)", round_idx, loss,
                        seconds[-1])
        return {"params": new_params, "server": new_server}

    state = {"params": params, "server": server_state}
    del params, server_state
    if args.ckpt_dir is None:
        for round_idx in range(args.rounds):
            state = round_step(round_idx, state)
        stats = {"restarts": 0, "scratch_restarts": 0,
                 "completed_steps": args.rounds, "replayed_steps": 0,
                 "backoff_s": 0.0, "restored_from": []}
    else:
        mgr = CheckpointManager(args.ckpt_dir, keep_last_n=3)
        restored = []
        state, stats = run_with_recovery(
            round_step, state, args.rounds, mgr,
            checkpoint_every=args.ckpt_every,
            on_recovery=lambda restart, step: restored.append(step))
        stats["restored_from"] = restored
    logger.info("done: %d rounds, %d restarts, final loss %.4f", args.rounds,
                stats["restarts"], history[-1] if history else float("nan"))
    summary = {
        "arch": cfg.name,
        "algorithm": args.algorithm,
        "rounds": args.rounds,
        "restarts": stats["restarts"],
        "first_loss": history[0] if history else None,
        "final_loss": history[-1] if history else None,
    }
    return TrainResult(summary, state["params"], state["server"], history,
                       seconds, masks if strag is not None else None, stats)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.chaos:
        print(json.dumps(chaos(args).to_json(), indent=2))
        return
    print(json.dumps(train(args).summary))


if __name__ == "__main__":
    main()
