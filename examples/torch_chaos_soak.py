"""Chaos soak quickstart on the PyTorch port: composed fault injection with
hard invariants (the counterpart of ``examples/chaos_soak.py``).

Trains a masked hierarchical round while a deterministic, seeded schedule
injects overlapping adversity (device failures, pod dropout and regrowth,
log-normal stragglers with deadline masking, killed, corrupt and torn
checkpoints, and serve traffic with a scheduler fault), then asserts the
production invariants: a final state bitwise that of an uninterrupted
oracle, no per-client retraces, a masked tail latency strictly below the
synchronous baseline, and an unbiased masked mean.

Run on the card (the default; it raises without one), or on the CPU:

    PYTHONPATH=src python examples/torch_chaos_soak.py [--rounds 48]
    PYTHONPATH=src python examples/torch_chaos_soak.py --device cpu
    PYTHONPATH=src python examples/torch_chaos_soak.py --minutes 5

``--minutes`` replaces the fixed round count with a wall-clock budget: the
soak times one calibration round, scales rounds (and fault counts, in
proportion) to fill the budget, and then runs the scaled schedule.
"""

import argparse
import json

from repro_torch.runtime.chaos import ChaosConfig, ChaosSchedule, run_chaos_soak


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--minutes", type=float, default=None,
                    help="wall-clock budget: calibrate one round, then "
                         "scale rounds and fault counts to fill this many "
                         "minutes (overrides --rounds)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()

    cfg = ChaosConfig(rounds=args.rounds, seed=args.seed,
                      minutes=args.minutes, device=args.device)
    if args.minutes is None:
        schedule = ChaosSchedule.from_config(cfg)
        print(f"schedule: failures at {schedule.failure_rounds}, "
              f"elastic events {schedule.elastic_events}, "
              f"checkpoint faults {schedule.ckpt_faults}, "
              f"serve bursts at {schedule.serve_rounds}")
    else:
        # the schedule depends on the round count, which is unknown until
        # the calibration round inside run_chaos_soak has been timed
        print(f"time-budgeted soak: calibrating to fill "
              f"{args.minutes:g} min")

    # run_chaos_soak raises AssertionError if any invariant is violated
    report = run_chaos_soak(cfg)

    print(json.dumps(report.to_json(), indent=2))
    print(f"\nsurvived {report.device_failures} device failures, "
          f"{len(report.elastic_events)} elastic events, "
          f"{len(report.ckpt_faults_injected)} checkpoint faults "
          f"({report.fallback_restores} fallback restores); "
          f"bitwise-identical to oracle: {report.oracle_bitwise_equal}; "
          f"client-leg retraces: {report.client_retraces}; "
          f"straggler speedup: {report.straggler['speedup']}x")


if __name__ == "__main__":
    main()
