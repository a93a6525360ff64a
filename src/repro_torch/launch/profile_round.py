"""Where a training round's time goes on the card.

Runs DrJAX local-SGD rounds of a full-size model (default: lm_350m in the
``chip_smoke.py`` flat and hierarchical settings: cohort 4, 2 local steps,
int8; the smoke's long rounds are ``--seq 4096 --batch 2``; its hybrid
rounds are ``--arch recurrentgemma_2b --seq 4096 --batch 1 --cohort 2
--compression none``, its ssm rounds the same with ``--arch rwkv6_3b``,
its [encdec] rounds ``--arch seamless_m4t_medium --seq 4096 --batch 2
--cohort 2 --compression none``, with ``--seq`` frames and
``registry.make_batch``'s text),
warms up one round, then traces one round with
``torch.profiler`` and prints the round's wall time, the device's busy time
(the sum of kernel times; one stream, so kernels do not overlap) and idle
share, and the device time by kernel family and by kernel:

    PYTHONPATH=src python -m repro_torch.launch.profile_round [--pods 2] \
        [--seq 4096 --batch 2] [--arch A --cohort N --compression none]

The same numbers go to ``--out`` as JSON. Needs a card.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import time
from pathlib import Path

import torch

from ..algorithms import rounds
from ..data.grouped import CohortSampler, GroupedCorpus
from ..models import registry
from . import train

FAMILIES = (
    ("flash attention K2 (repro)", ("repro::flash::",)),
    ("RG-LRU scan K4 (repro)", ("repro::lru::",)),
    ("WKV6 K5 (repro)", ("repro::wkv::",)),
    ("int8 kernels (repro)", ("quantize_kernel", "dequantize_kernel",
                              "reduce_compress_roundtrip_kernel")),
    ("matmul", ("gemm", "cutlass", "xmma", "cublas", "sm90_", "nvjet")),
    ("softmax/reduce", ("softmax", "reduce", "logsumexp", "norm")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "copy",
                     "fill", "index", "gather", "scatter", "cat")),
)


def _family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    raise RuntimeError("profiler events carry no device time")


def profile(pods: int, seq: int = 512, batch: int = 4, rounds_warm: int = 1,
            arch: str = "lm_350m", cohort: int = 4,
            compression: str = "int8"):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = train.parse_args([
        "--arch", arch, "--cohort", str(cohort), "--local-steps", "2",
        "--batch", str(batch), "--seq", str(seq), "--compression",
        compression, "--device", "cuda"])
    cfg = registry.get_config(args.arch)
    params = registry.init_params(cfg, seed=0, device="cuda")
    if pods:
        client_opt, server_opt = train.optimizers(args)
        round_fn = rounds.make_hierarchical_local_sgd_round(
            functools.partial(registry.loss_fn, cfg), client_opt, server_opt,
            rounds.LocalSGDConfig(
                partition_size=args.cohort // pods,
                num_local_steps=args.local_steps, grad_clip=1.0,
                compression=None if compression == "none" else compression,
                num_pods=pods))
    else:
        round_fn, server_opt = train.build_round_fn(cfg, args)
    state = server_opt.init(params)
    sampler = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                            cohort_size=args.cohort)

    def data(r):
        lead = (pods, args.cohort // pods) if pods else (args.cohort,)
        if cfg.is_encoder_decoder:  # frames, tokens and labels
            return registry.make_batch(cfg, args.batch, args.seq, seed=r,
                                       lead=lead + (args.local_steps,))
        d = sampler.round_batch(r, args.local_steps, args.batch, args.seq,
                                device="cuda")
        return {k: d[k].reshape(lead + tuple(d[k].shape[1:]))
                for k in ("tokens", "labels")}

    for r in range(rounds_warm):
        params, state, m = round_fn(params, state, data(r))
        float(m["loss"])
    batch = data(rounds_warm)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        params, state, m = round_fn(params, state, batch)
        float(m["loss"])
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if _device_us(e) > 0 and e.device_type.name == "CUDA"]
    busy_us = sum(_device_us(e) for e in kernels)
    if busy_us <= 0:
        raise RuntimeError("the trace shows no device time")
    fam = collections.Counter()
    for e in kernels:
        fam[_family(e.key)] += _device_us(e)
    top = sorted(kernels, key=_device_us, reverse=True)[:12]
    return {
        "arch": cfg.name,
        "form": f"hierarchical {pods}x{args.cohort // pods}" if pods else "flat",
        "cohort": args.cohort, "compression": args.compression,
        "seq": args.seq, "batch": args.batch,
        "card": torch.cuda.get_device_name(0),
        "round_wall_ms": wall_s * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e3 / (wall_s * 1e3)),
        "families_ms": {k: v / 1e3 for k, v in fam.most_common()},
        "top_kernels": [
            {"name": e.key[:90], "ms": _device_us(e) / 1e3, "calls": e.count}
            for e in top
        ],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pods", type=int, default=0)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--arch", default="lm_350m", choices=registry.ARCH_IDS)
    ap.add_argument("--cohort", type=int, default=4)
    ap.add_argument("--compression", default="int8", choices=("none", "int8"))
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_round needs a CUDA card")
    res = profile(a.pods, a.seq, a.batch, arch=a.arch, cohort=a.cohort,
                  compression=a.compression)
    print(json.dumps(res, indent=1))
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
