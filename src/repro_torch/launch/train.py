"""End-to-end training driver (``repro/launch/train.py``).

Trains lm_350m, recurrentgemma_2b or rwkv6_3b (``--arch``) with DrJAX
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

Same flags and the same final JSON line as the reference. Not ported yet,
and rejected: ``--ckpt-dir``/``--ckpt-every``, ``--fail-at``, ``--chaos``
and ``--compression topk`` (checkpointing and recovery come in a later
slice).
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import time

import numpy as np
import torch

from .. import compat, optim
from ..algorithms.rounds import LocalSGDConfig, make_local_sgd_round
from ..data.grouped import CohortSampler, GroupedCorpus
from ..models import registry
from ..runtime.stragglers import StragglerSimulator, straggler_mask

logger = logging.getLogger(__name__)

NOT_PORTED = ("--ckpt-dir", "--ckpt-every", "--fail-at", "--chaos")


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
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    for flag in NOT_PORTED:
        ap.add_argument(flag, nargs="*", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    given = [f for f in NOT_PORTED
             if getattr(args, f[2:].replace("-", "_")) is not None]
    if given or args.compression == "topk":
        ap.error(
            f"not ported to repro_torch yet: "
            f"{', '.join(given + (['--compression topk'] if args.compression == 'topk' else []))} "
            "(checkpoint, recovery, chaos and top-k come in a later slice)"
        )
    return args


def round_mask(strag: StragglerSimulator, round_idx: int, args, device):
    """The straggler mask of one round, as the reference's ``launch.train``
    draws it: the cohort's durations, a deadline at
    ``--straggler-deadline-pct``, and at least half the cohort kept."""
    durations = strag.durations(round_idx, args.cohort)
    deadline = float(np.percentile(durations, args.straggler_deadline_pct))
    return straggler_mask(durations, deadline,
                          min_finishers=max(args.cohort // 2, 1),
                          device=device)


def train(args):
    """Run ``args.rounds`` flat rounds. Returns (summary, params,
    server_state, per-round losses, per-round wall seconds, per-round
    straggler masks or None). A round's seconds end when its loss reaches
    the host, which waits for the device."""
    device = compat.resolve_device(args.device)
    cfg = registry.get_config(args.arch)
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
    n_params = sum(p.numel() for p in params.values())
    logger.info("arch=%s params=%.2fM cohort=%d local_steps=%d device=%s",
                cfg.name, n_params / 1e6, args.cohort, args.local_steps, device)
    history, seconds, masks = [], [], []
    for round_idx in range(args.rounds):
        data = sampler.round_batch(round_idx, args.local_steps, args.batch,
                                   args.seq, device=device)
        batch = {"tokens": data["tokens"], "labels": data["labels"]}
        t0 = time.perf_counter()
        mask = None
        if strag is not None:
            mask = round_mask(strag, round_idx, args, device)
            masks.append(mask)
        params, server_state, metrics = round_fn(params, server_state, batch,
                                                 mask)
        loss = float(metrics["loss"])
        seconds.append(time.perf_counter() - t0)
        history.append(loss)
        if round_idx % args.log_every == 0:
            logger.info("round %d loss %.4f (%.2fs)", round_idx, loss,
                        seconds[-1])
    summary = {
        "arch": cfg.name,
        "algorithm": args.algorithm,
        "rounds": args.rounds,
        "restarts": 0,
        "first_loss": history[0] if history else None,
        "final_loss": history[-1] if history else None,
    }
    return (summary, params, server_state, history, seconds,
            masks if strag is not None else None)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary, *_ = train(args)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
