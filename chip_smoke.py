#!/usr/bin/env python3
"""Run the PyTorch port (``src/repro_torch``) on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each reported on its own line (any failure raises, exit != 0):

1. build: the card's name and power limit (nvidia-smi) and the seconds to
   build every CUDA kernel from ``src/repro_torch/kernels/csrc`` with nvcc
   (one process per source, in parallel) into ``build/kernels``; for each
   instantiation of K2's tensor-core kernels, its registers and spills
   (``nvcc -Xptxas -v``) and its dynamic shared memory;
2. kernels: each kernel against its plain PyTorch version on the card at
   the shapes of the main path (the packed lm_350m delta, R rows of 256
   f32; (2, 2, R, 256) for the fused reduce and the wire payload K3a, whose
   (q, s) must also be K3b's; (2, R, 256) payloads for K3c), bitwise, plus
   a small bf16 check and a K3a/K3c sweep (bf16, R = 1 and 1027, P = 1, 3
   and 4); median ms of the kernel, of the plain version and, for
   dequantize, of the one library call that computes it (``torch.mul``)
   (CUDA events, >= 20 timed runs after warmup) beside the bytes bound;
   then K2 (flash attention forward, ``bwd_dq`` and ``bwd_dkdv``) against
   the plain versions at the main path's shapes (B 4 x S 512 and B 2 x S
   4096, 16 heads, hd 64, bf16, causal) and over a sweep of small shapes
   (f32 and bf16, hd 80 and 128, GQA G = 7 and 8, window 256 at a ragged
   S = 1000, non-causal Sq 24 / Skv 56): f32 outputs within the
   reference's 2e-5 and gradients within 1e-4 of their largest magnitude;
   bf16 outputs and gradients within one bf16 step (2^-7 |plain|) plus
   1e-3 of the largest magnitude; with the times of the kernels, the
   plain versions and ``scaled_dot_product_attention`` (forward, and its
   autograd backward) beside the bound: for these bf16 calls the
   function's FLOP at the bf16 tensor-core rate (or its bytes, if larger),
   with the f32 SIMT bound of the f32 route beside it. Every K2 case and
   wrapper is run again under ``torch.profiler`` (one trace per sweep and
   per main shape, ``kernel_names``): a bf16 call at head dim 64 or 128
   must launch the wgmma forward, ``bwd_dq`` and ``bwd_dkdv``
   (``repro::flash::wg::``, ``flash_attention_sm90.cu``), a bf16 call at
   another head dim the mma.sync kernels (``repro::flash::tc::``), a bf16
   forward of at most 16 query rows a kv head (Sq * G) the split-KV
   decode kernels of ``flash_decode.cu`` instead (``FLASH_DECODE_SWEEP``:
   Sq * G of 1, 4, 16 and 17, Skv of 1 to 4097, every head dim), an f32
   call the SIMT kernels, and nothing else (``flash_kernels``); each
   wrapper's kernel names at the main shapes are logged, and the SASS of
   the three K2 libraries holds HGMMA and UTMALDG in each wgmma kernel
   and in no other (``flash_sass``). Every phase that trains or serves a
   bf16 model ([flat], [long], [hier], [encdec], [serve], [mesh], ...)
   checks that each K2 launch went through that route's entry point
   (``flash_attention.ROUTE_LAUNCHES``, ``require_flash_entries``), and
   [encdec]'s decode steps that every K2 launch took the decode entry. Then K2's second order (P3) at B 2 x S 512 x 16 heads x
   64, f32 and bf16, causal: the double backward through
   ``ops.flash_attention`` against autograd's double backward through the
   plain forward on the card (f32 within 1e-4 of the largest magnitude,
   bf16 within two bf16 steps plus 1e-2 of the largest), its first order
   bitwise the kernels called directly, one launch of each kernel and one
   plain second-order call, whose ms, bound and held memory are logged;
   then K2 at the full-width attention of the new configs (``FLASH_WIDE``:
   hd 128, bf16, causal; B 4 x S 512 at 16:16 heads, and B 1 x S 4096 at
   64:8, 32:8, 64:4 and 56:8), forward and both backward kernels against the plain
   versions at the same tolerances and route checks, timed beside their
   bounds and SDPA;
3. flat: 3 DrJAX local-SGD rounds of full lm_350m (bf16, 24 layers; cohort
   4, 2 local steps, batch 4, seq 512) with int8 delta compression, through
   ``repro_torch.launch.train``; losses finite, quantize/dequantize launched
   at least rounds x cohort times, the K2 forward at least rounds x cohort
   x steps x layers x 2 (the checkpoint recompute) and each K2 backward
   kernel rounds x cohort x steps x layers times;
4. hier: 2 pod-hierarchical rounds of lm_350m at full width and 8 of
   its 24 layers (``HIER_LAYERS``; 2 pods x 2 clients, fused int8
   reduce+compress), then one more round from the same state unfused; the
   fused and unfused rounds agree within one quantization step per element;
   the fused rounds launch K2 as often as the flat ones. Then the wire
   step: the last round's client deltas rebuilt and flat-packed, K3a's
   payload (bitwise to K3b's, its bytes those of ``cross_pod_bytes``) and
   K3c's cross-pod mean (within the R6 bound of the round's
   ``reduce_mean@pods``);
4a. plan: the MapReduce plan IR (paper §5) on [hier]'s round: the same
   12-layer model's 2 x 2 fused-int8 round traced (``core.interpreter.trace``),
   planned (``build_plan``; its communication skeleton must be
   ``PLAN_SKELETON``, which ``tests/test_torch_plan.py`` pins to the
   reference's) with no constant the size of an activation; one round of
   ``run_plan`` bitwise the direct round from the same inputs, with the
   same launches (K3b once, K2 forward / ``bwd_dq`` / ``bwd_dkdv`` 192 /
   96 / 96); the compiled plan (``runtime.executor``: one CUDA graph,
   params and server state donated) three rounds bitwise three
   ``run_plan`` rounds, built once, its replays outside the launch
   counters and running the ``repro`` kernels by name in one
   ``torch.profiler`` trace of a replay; the plan built again from a new
   trace a cache hit; ``to_beam`` of the round compiling with every name
   defined (Beam itself is not installed: the pipeline is not run); the
   seconds of trace, ``build_plan``, graph build and capture, the median
   round seconds of the direct round, ``run_plan`` and a replay, node
   counts and peak memory; the static analyses (``plan.analyze`` with the
   carry donated, its comm model cross-validated by one ``run_plan``
   round on the card that measures what each comm stage carried): no
   error, the ``reduce_mean@pods`` stage over the packed delta priced at
   exactly the bytes of K3a's payload measured by the wire step, the
   compiled plan's donation report clean, the findings by code, the DCN
   and ICI bytes and the analysis seconds logged; then reduced lm_350m's
   flat int8 round (K1 in its group stage) with ``run_plan`` bitwise the
   direct round and the compiled plan bitwise ``run_plan``;
4b. elastic: lm_350m at full width and 6 of its 24 layers
   (``ELASTIC_LAYERS``) at [hier]'s shapes through
   ``make_elastic_hierarchical_round`` (2 clients a pod, bf16 K2 in every
   layer): steps at 3, 2 and 3 pods, each bitwise the direct unfused
   hierarchical round at that pod count, the per-client leg traced once
   (one CUDA graph, replayed per pod) and two cross-pod legs at the end;
   the seconds of each step beside the direct round's, the one-time
   trace (with ``build_plan`` and ``compile_plan``) of the per-client leg
   and the rest of the first step (captures and runs) and the peak GiB;
   then one masked step at full width and 2 layers (3 pods, one client
   and one whole pod masked) within 1e-6 relative of the flat masked
   round over the same finishers;
4c. loop: lm_350m at full width with 2 layers, 2 flat int8 rounds of
   cohort 4 through ``make_multi_round``: one ``LOOP[scan]`` stage of
   trip count 2, ``run_plan`` bitwise the direct trainer, the compiled
   plan (carry donated, the body's CUDA graph replayed once per round)
   bitwise ``run_plan``, built once; seconds per round replayed and
   direct;
4d. stragglers: 3 rounds of full lm_350m through ``launch.train
   --stragglers`` (deadline at the 90th percentile, cohort 4, int8): masks
   that drop clients, finite losses, per-client K1 and no K3b; from the
   trained state, an all-ones mask bitwise the unmasked round, an all-zero
   mask leaving the params bitwise unchanged, and a masked hierarchical
   round (2 x 2, a whole pod dropped) with per-client K1 and no K3b;
5. long: 2 flat int8 rounds of full lm_350m at seq 4096 (the reference's
   train_4k shape; cohort 4, 2 local steps, batch 2: 65,536 tokens a
   round); losses finite, the same K2 launch counts;
6. grads: lm_350m at full width with 2 layers, f32, seq 4096, batch 1:
   loss and every gradient through the K2 kernels against the same through
   PyTorch's autograd of the plain forward on the card (loss within 1e-5
   relative, each leaf within 1e-4 of its largest magnitude);
7. reference: one flat int8 round of the reduced config on the card and on
   the CPU (the plain versions) agree within one quantization step, with
   ``naive`` attention and again with ``blocked`` (K2 on the card), and a
   masked round of cohort 4;
8. kernels / K4: the RG-LRU scan forward and backward bitwise against
   their plain versions, at the main shape (1, 4096, 2560) f32 and over
   ragged shapes (S shorter than a tile and not a multiple of it, W not a
   multiple of 32, 2 and 3 batch rows at a ragged S; the serve chunks of
   full recurrentgemma_2b, S 1, 37 and 64 at W 2560) in f32 and bf16,
   with and without an initial state; each launch on the route it must
   take (TMA where a row of W values is a 16-byte multiple: the main
   shape, (2, 4100, 2560) and the serve chunks; SIMT at W 45, 33 and 1),
   counted by the
   launchers and seen by kernel name in one ``torch.profiler`` trace of
   every case; the TMA kernels' ``UTMALDG``/``UTMASTG`` in the SASS (none
   in the SIMT kernels) and every kernel's registers and ring; median ms
   of the kernels (20 timed runs, the host's launch path included), of
   the plain loops (5 timed runs: each is 4,096 dependent steps of small
   launches) and the bytes bound; each pass's CUDA kernel time from one
   trace (``kernel_split``), and the host microseconds a launch takes;
9. flash / hd 256: K2 at recurrentgemma_2b's attention shape (B 1 x S 4096,
   10 query heads on 1 kv head of 256, window 2048, bf16) and over a sweep
   at hd 256 (f32 and bf16, G = 10 and 1, window 64 at a ragged S,
   non-causal), at the tolerances and route checks of phase 2; times
   beside the bounds of phase 2
   and SDPA with the window as a boolean mask (the log names the kernels
   SDPA ran);
10. hybrid: 2 flat uncompressed rounds of full recurrentgemma_2b (3.55 B
   parameters, 26 layers; cohort 2, 2 local steps, batch 1, seq 4096:
   16,384 tokens a round) through ``repro_torch.launch.train``; losses
   finite, K4 forward launched at least rounds x cohort x steps x 18
   recurrent layers x 2 (the checkpoint recompute) and its backward half
   that, every K4 launch on the TMA route, K2 at least rounds x cohort x
   steps x 8 attention layers (x 2 for the forward); round seconds,
   tokens/s, model utilization and peak GiB;
11. hybrid grads: recurrentgemma_2b at full width with 3 layers
   (recurrent, recurrent, attention), f32, seq 4096, batch 1: loss and
   every gradient through K4 and K2 against PyTorch's autograd of their
   plain forwards on the card (1e-5 relative, 1e-4 of each leaf's largest
   magnitude);
12. reference (hybrid): one flat int8 round of reduced recurrentgemma_2b
   with ``blocked`` attention on the card and on the CPU agree within one
   quantization step;
13. kernels / K5: the WKV6 forward and backward against their plain
   versions (the sequential recurrence and its reverse pass) at the main
   shape (1, 4096, 40, 64) f32, under decays drawn as the model draws them
   (whose cumulative log-decay passes -88 inside a chunk, where the
   reference's chunked form overflows) and under the reference test's mild
   ones, and over a sweep (head dims 16 and 32, ragged S 1000 and 37,
   batch 2): outputs within 1e-4 (rtol = atol, the reference's WKV
   tolerance), gradients within 1e-4 of their largest magnitude, all
   finite; median ms of the kernels (20 timed runs), of the plain loops
   (3 timed runs: each is 4,096 dependent steps) and the bound of the
   tensor-core route (bytes at 3.35 TB/s or 3 x FLOP at TF32's
   495 TFLOP/s, each logged, with the f32 SIMT bound); each K5 CUDA
   kernel's share of its pass from one ``torch.profiler`` trace, which
   must show the expected kernels; the TF32 ``HMMA`` count of each K5
   kernel's SASS (``cuobjdump -sass``: every chunk kernel has some, the
   scans none) and the blocks an SM holds of each chunk kernel (two at
   head dim 64);
14. ssm: 2 flat uncompressed rounds of full rwkv6_3b (3.07 B parameters,
   32 layers; cohort 2, 2 local steps, batch 1, seq 4096: 16,384 tokens a
   round) through ``repro_torch.launch.train``; losses finite, K5 forward
   launched at least rounds x cohort x steps x 32 x 2 (the checkpoint
   recompute) and its backward half that; round seconds, tokens/s, model
   utilization and peak GiB;
15. ssm grads: rwkv6_3b at full width with 2 layers, f32, seq 4096, batch
   1, seeds 0 and 1: loss and every gradient through K5 against PyTorch's
   autograd of its plain forward on the card (loss within 1e-5 relative;
   each leaf within ``SSM_GRAD_TOL`` of its largest magnitude, a limit
   set from measured readings because the model at init magnifies f32
   rounding), and a control, the plain forward with a bf16 WKV output,
   that must read beyond that limit;
16. reference (ssm): one flat int8 round of reduced rwkv6_3b (one head of
   64, seq 64) on the card and on the CPU agree within one quantization
   step;
17. ckpt: checkpointing and recovery of lm_350m at full width and 8 of
   its 24 layers (``CKPT_LAYERS``) through
   ``launch.train`` (flat int8 FedAvg, so the server state holds an f32
   momentum of every parameter; cohort 4, 2 local steps, batch 4, seq
   512), in fresh directories under the temporary directory (its
   filesystem and free space logged; too little space fails): run A, 4
   rounds with ``--ckpt-every 2``; run B, the same with ``--fail-at 3``:
   1 restart, restored from step 2, 4 rounds completed, 1 replayed, and
   params and server state bitwise A's; K1a, K1b and K2 launches of both
   runs (the replay's included). On B's directory: step 4 restored with
   CPU example leaves equals the state's host copy bitwise; a corrupted
   step 4 falls back to step 2 (the sha256 of run A's step 2); a save
   killed before LATEST advances stays invisible. Logs the checkpoint's
   leaves and bytes and the seconds of its host copy, its write with
   fsync, its sha256 and a restore;
18. topk: 2 flat rounds of full lm_350m through ``launch.train
   --compression topk`` (fraction 0.01): finite losses, K2 in every layer,
   no K1 or K3 launch; one client's delta rebuilt, sparsified on the card
   and on its CPU copy, bitwise, with exactly k entries (or every nonzero,
   when fewer) in each of the reference's leaves (a uniform stack's
   layers as one leaf); the sparsify time of the whole delta (CUDA
   events, 20 runs); then one hierarchical 2 x 2 top-k round: no K1 or K3
   launch, and each leaf of the applied update moves at most the k
   entries its (2, ...) pod partial keeps;
19. algorithms: at lm_350m's full width, a FedSGD round with learned
   weights (cohort 4, batch 4, seq 512) whose loss has a finite, nonzero
   gradient in the 4 weights; ``make_multi_round`` of 2 local-SGD int8
   rounds bitwise the same rounds one at a time; 2 asynchronous rounds
   with finite losses; then, on reduced lm_350m with ``blocked``
   attention, a FedSGD round with learned weights and 2 asynchronous
   rounds on the card and on the CPU within 1e-5. Each of the three
   phases logs its seconds, and ``[new phases]`` their sum;
20. pipeline: full lm_350m (bf16, 24 layers) as 4 stages of 6 layers
   (``transformer.apply_layers``), 8 microbatches of 1 x 512 embedded
   outside the pipeline, through ``make_pipelined_round``: outputs bitwise
   the 24 layers one microbatch at a time, 264 K2 forward launches (11
   ticks x 24 layers), a head loss's gradients in every parameter within
   1e-4 of each leaf's largest magnitude of the sequential run's; traced
   and planned: one ``LOOP[scan]`` of 11 ticks with a ``TRANSFER`` in its
   body, ``run_plan`` bitwise the direct round, the compiled plan (buffer
   donated) bitwise ``run_plan`` with one build, ``plan.analyze()``
   without error, the transfer priced on ICI; bubble fraction, seconds
   and peak logged;
21. maml: full lm_350m, 4 tasks, support and query batches of 2 x 512,
   inner lr 0.05, one inner step: the outer gradient with K2 against the
   same with ``naive`` attention (``MAML_REL_L2`` in the L2 norm over all
   leaves, ``MAML_LEAF_REL`` of each leaf's largest magnitude), 96
   second-order calls; two ``maml_train_step`` s (outer lr 0.2) with
   finite meta-losses, the first bitwise the SGD step of the gradient;
22. btm: Branch-Train-Merge of full lm_350m, 4 domains, 2 steps of batch
   4 x 512, ``sgd(0.05)``: the mean merge bitwise the experts trained one
   by one, summed and multiplied by ``reciprocal(4)``; the weighted
   merge's metrics finite with max >= mean. ``[slice 12 phases]`` logs the
   three phases' seconds;
23. after the K5 phase, K5 from an initial state s0 with the final
   state's gradient (ragged S 1, 37, 64, 200 at (2, S, 2, 64), and serve
   chunks of full rwkv6_3b, (1, S, 40, 64) at S 2, 37 and 64) against the
   plain versions (out within
   1e-4, the final state and every gradient, ds0 included, within 1e-4 of
   the largest magnitude), the call without s0 bitwise the call with a
   zero one, and the forward's times with a state; then the second order
   of K4 (S 256 at full width, h0) and K5 ((1, 128, 4, 64), s0 and the
   final state in the loss) through the kernels and the plain recompute
   against autograd through the plain loops, within 1e-4 of the largest
   magnitude, the first order bitwise the kernels, one plain call each,
   its ms;
24. serve (last): full-width stablelm_3b (``SERVE_RUNS``: 16 requests of
   16-512 prompt tokens, 4 slots, 32 new tokens, chunk 64, max_len 576),
   then shorter runs of full recurrentgemma_2b and rwkv6_3b (6 requests
   of 16-300, 2 slots, 16 new), each through
   ``ContinuousBatchingScheduler`` and ``StaticWaveScheduler`` after a
   warm-up request that builds every chunk bucket: the two token for
   token, builds flat (buckets, 1), every request finished; K4 (with h0)
   and K5 (with s0) launched exactly once per recurrent or rwkv layer and
   chunk step that ran (eager calls and CUDA graph replays, counted
   apart); K4 on its TMA route; a replayed decode step bitwise the eager
   step, both timed; a replayed fused step with a full 64-token chunk
   bitwise the same step run eagerly on a copy of the pool, and one replay
   traced by kernel name: K4's ``tma_fwd_kernel`` (recurrentgemma_2b) or
   K5's ``state_kernel``, ``scan_kernel`` and ``out_kernel`` (rwkv6_3b)
   once per recurrent or rwkv layer, no SIMT K4 kernel; tokens/s, TTFT and ITL p50/p99, pool_mb and peak
   memory. For stablelm_3b also ``prefill`` (K2 in every layer) against
   the chunked path's last logits within ``SERVE_LOGITS_TOL`` of their
   largest magnitude, and the share of tokens that agree with the batch-1
   greedy oracle (logged, not gated). ``[slice 13 phases]`` logs their
   seconds;
25. the other decoder architectures: ``dense configs`` (2 flat int8
   rounds of full lm_1b, 1.745 B, at [flat]'s shapes), then ``cost``
   (``phase_cost``, no new round): the analytic bound of one round on one
   card (``repro_torch.launch.analytic``, H100 constants) for [flat],
   [long], [hybrid], [ssm] and [dense configs], each round's seconds over
   it and the analytic model-FLOP utilization; and one full-width lm_350m
   client train step at B 4 x S 512 under ``hlo_cost.count_flops``: its
   FLOPs within [0.65, 1.5] of ``analytic.flops_cell``, K2's three ops
   counted at their launches times the call's FLOP; ``qkv bias``
   (qwen2_72b at full width, its biases drawn nonzero: a flat round at 1
   of 80 layers, cohort 2, batch 1, seq 4096, and loss and gradients at
   2 layers and seq 4096 in f32 through K2 against the plain path);
   ``moe`` (2 flat rounds of phi35_moe at 2 of 32 layers, cohort 2, batch
   1, seq 4096; utilization on active parameters); ``moe grads``
   (qwen3_moe at 1 of 94 layers, seq 4096, f32, its 128-expert top-8
   router); ``qkv bias`` and ``moe grads``, which need most of the card,
   run after phase 2, before any full-size round; ``moe layer`` (one
   full-width MoE layer of each on 4,096 tokens, bf16 against f32: the
   same choices kept and dropped, the output within two bf16 steps plus
   1e-2 of the largest, the aux loss within 1e-3); ``vlm``
   (llava_next_34b at 2 of 60 layers: loss and gradients with 2,880 patch
   embeddings and 1,216 tokens, then prefill with the embeddings and 8
   decode steps against ``transformer.forward``); ``serve moe``
   (phi35_moe at 8 of 32 layers, bf16, 8 requests of power-of-two
   prompts, 2 slots, 16 new, chunk 64, through both schedulers as
   [serve]: token for token, flat builds, replays bitwise; each slot's
   decode logits bitwise the same whatever the other slot's token; the
   f32 prefill against the chunked path at 2 layers within 1e-3).
   ``[slice 14 phases]`` logs their seconds;
26. the encoder-decoder: after ``FLASH_WIDE``, K2 non-causal at
   ``FLASH_ENCDEC``'s shapes (seamless_m4t_medium's encoder, B 2 x 4096
   x 4096, and its cross-attention, B 2 x 512 x 4096 in training and B 4
   x 1 x 4096 in a decode step, 16:16 heads of 64) and a ragged (1, 100,
   1000, 4:2, 64), f32 and bf16, forward and both backward kernels at
   K2's gates, timed in bf16 beside their bounds and SDPA, and the decode
   call beside the plain einsum form; at the end ``encdec``: 2 flat
   local-SGD rounds of full seamless_m4t_medium (978,384,896 parameters,
   12 + 12 layers, bf16; cohort 2, 2 local steps, B 2 x 4096 frames x 512
   text tokens; K2 exactly 144 times of each kernel a round), its loss
   and gradients at 2 + 2 f32 layers through K2 against the plain path,
   ``encdec.prefill`` of 4 prompts (4096 frames, 64 tokens) and 32 greedy
   decode steps with memory K/V against a teacher-forced forward, and
   ``common.matmul_f32`` (the bf16 FFN's f32 up and gate products) at
   lm_350m's FFN and phi35_moe's experts against the f32 product, with
   its ms;
27. after [chaos] and [mesh], ``tp``: the model-parallel half of the
   distributed layer in gloo worlds whose ranks share the card
   (``--mesh-rank tp|tpc``): (a) ``make_sgd_train_step`` of whole lm_1b
   (2 AdamW steps, B 4 x S 512) on a (data 1, model 2) mesh, K2's wgmma
   kernels on each rank's 8 heads, the losses within 2^-10 relative of the
   mesh-free steps' and the update within 2^-2 of theirs (the worst
   leaf's relative L2 gap; the start and the half-batch update must both
   fail that gate); (b) ``make_prefill_step`` of qwen2_72b at 2 of 80
   layers with ``tp_comm="int8"`` against the bf16 wire (cosine > 0.9999,
   every int8 reduction within its bound, payload equal to
   ``tpcomm.int8_wire_bytes``; each wire timed warm, without the spies
   that check the bound); (c) ``make_drjax_round_step`` of lm_350m
   (dp) on a (data 2, model 2) mesh of 4 ranks, with ``all_reduce``s over
   "data" and "model", held to the mesh-free round.

Then one JSON line with every kernel's launches, error and times (the K2
rows with their launches in [pipeline], [maml] and [btm], the split-KV
decode forward on a line of its own with [encdec]'s decode-step launches, the
``FLASH_WIDE`` shapes under ``wide`` with the launches of the slice-14
phase that ran each, the ``FLASH_ENCDEC`` shapes under ``encdec`` with
[encdec]'s launches, and ``bwd_dkdv``'s with the plain second order's
calls, ms and bound; the K2, K4
and K5 forward rows with their [serve] launches, K5's forward with its
times with a state, and the K4 and K5 backward rows with their plain
second order's ms and bound), and last
``{"ok": true, "device": {...}}``. Exits non-zero without a card, and when
the port's sources are not beside this script.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

def peaks():
    """The port's cost model, the one owner of the card's peaks
    (``repro_torch.launch.hlo_cost``: ``HBM_BW`` HBM3 bytes/s,
    ``PEAK_FLOPS`` dense bf16 tensor-core FLOP/s, ``F32_FLOPS`` f32 outside
    the tensor cores), imported once the port is on the path."""
    from repro_torch.launch import hlo_cost

    return hlo_cost


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median device milliseconds of ``fn()`` over ``iters`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes: float, ops: float):
    t_bytes = nbytes / peaks().HBM_BW * 1e3
    t_ops = ops / peaks().F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(outs, refs) -> float:
    return max(float((o.double() - r.double()).abs().max()) for o, r in zip(outs, refs))


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def require_equal(outs, refs, what: str) -> None:
    """Bitwise equality of kernel outputs and plain outputs, or a report of
    where they differ."""
    bad = []
    for i, (o, r) in enumerate(zip(outs, refs)):
        if not (o.shape == r.shape and o.dtype == r.dtype
                and bool(o.eq(r).all())):
            diff = (o.double() - r.double()).abs()
            idx = diff.reshape(-1).nonzero()[:3].reshape(-1).tolist()
            bad.append(f"output {i}: {int((diff > 0).sum())} differ, "
                       f"max {float(diff.max())}, first flat idx {idx}, "
                       f"kernel {o.reshape(-1)[idx].tolist()} "
                       f"plain {r.reshape(-1)[idx].tolist()}")
    require(not bad, f"{what} != plain: " + "; ".join(bad))


def quant_steps(delta: dict) -> dict:
    """Per element, the int8 step (row absmax / 127) of its 256-wide row in
    the packed layout (each leaf padded to the row boundary)."""
    out = {}
    for k, d in delta.items():
        flat = d.reshape(-1).float()
        pad = (-flat.numel()) % 256
        rows = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, 256)
        step = rows.abs().amax(dim=1, keepdim=True) / 127.0
        out[k] = step.expand(-1, 256).reshape(-1)[: flat.numel()].reshape(d.shape)
    return out


def agree_within_step(a: dict, b: dict, steps: dict, rel: float) -> tuple:
    """Max over elements of |a - b| / (step + rel * |a| + 1e-6); <= 1 means
    within tolerance. Also the fraction of elements that are equal."""
    worst, equal, total = 0.0, 0, 0
    for k in a:
        x, y = a[k].float(), b[k].float()
        tol = steps[k] + rel * x.abs() + 1e-6
        worst = max(worst, float(((x - y).abs() / tol).max()))
        equal += int((x == y).sum())
        total += x.numel()
    return worst, equal / total


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_build():
    from repro_torch.kernels import _build

    smi = card_line()
    print(smi, flush=True)
    secs = _build.KERNELS.build_all()
    for name in _build.SOURCES:
        _build.KERNELS.library(name)
    log("build", seconds=f"{secs:.2f}", sources=",".join(_build.SOURCES),
        dir=_build.KERNELS.build_dir,
        source_seconds=json.dumps({k: round(v, 2) for k, v in
                                   _build.KERNELS.source_seconds.items()}))
    for row in flash_resources(_build.KERNELS.logs):
        log("build", **row)
    return smi


# K2's tensor-core kernels by library: the mma.sync kernels (namespace tc;
# their dynamic shared memory from repro_flash_tc_smem) and the wgmma
# kernels (wg; repro_flash_wg_smem), with the number of instantiations.
FLASH_TC_LIBS = (("flash_attention", "tc", "repro_flash_tc_smem", 13),
                 ("flash_attention_sm90", "wg", "repro_flash_wg_smem", 6))
FLASH_WHICH = {"fwd_kernel": 0, "bwd_dq_kernel": 1, "bwd_dkdv_kernel": 2}


def flash_resources(logs: dict) -> list:
    """Registers and spills (nvcc -Xptxas -v) and dynamic shared memory of
    every instantiation of K2's tensor-core kernels, the mma.sync ones of
    flash_attention.cu and the wgmma ones of flash_attention_sm90.cu (which
    must not spill); nothing for a library this process did not build."""
    import re

    from repro_torch.kernels import _build

    rows = []
    for name, ns, smem_fn, want in FLASH_TC_LIBS:
        lines = (logs.get(name) or "").splitlines()
        if not lines:
            continue
        smem_of = getattr(_build.KERNELS.library(name), smem_fn)
        found = []
        for i, line in enumerate(lines):
            m = re.search(rf"Compiling entry function '\S*2{ns}\d+({ns}_\w+?)"
                          r"(?:ILi(\d+)E|E)", line)
            if not m:
                continue
            props = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", props)
            spill = re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", props)
            kernel, hd = m.group(1), m.group(2)
            which = FLASH_WHICH.get(kernel[len(ns) + 1:])
            found.append(dict(kernel=kernel, hd=hd or "-",
                              registers=regs.group(1) if regs else "?",
                              spill_stores=spill.group(1) if spill else "?",
                              spill_loads=spill.group(2) if spill else "?",
                              dynamic_smem_bytes=smem_of(which, int(hd))
                              if hd else 0))
        require(len(found) == want, f"expected {want} {ns} kernels in "
                f"{name}'s ptxas report, got {len(found)}")
        if ns == "wg":
            require(all(r["spill_stores"] == r["spill_loads"] == "0"
                        for r in found), f"a wgmma kernel spills: {found}")
        rows += found
    return rows


DECODE_KERNELS = ("decode_split_kernel", "decode_combine_kernel")


def flash_sass() -> dict:
    """{kernel<hd>: [HGMMA, UTMALDG] count} in the SASS of K2's three
    libraries (``cuobjdump -sass``): every wgmma kernel multiplies on
    HGMMA and loads through the TMA, the mma.sync, SIMT and split-KV
    decode kernels do neither."""
    import re

    from repro_torch import compat
    from repro_torch.kernels import _build

    tool = Path(compat.nvcc_path()).with_name("cuobjdump")
    counts, name = {}, None
    for lib in ("flash_attention", "flash_attention_sm90", "flash_decode"):
        sass = subprocess.run(
            [str(tool), "-sass", str(_build.KERNELS.path(lib))],
            capture_output=True, text=True, check=True).stdout
        for line in sass.splitlines():
            m = re.search(r"Function : _ZN5repro5flash(?:2(?:tc|wg))?\d+"
                          r"(\w+?_kernel)(\S*)", line)
            if m:
                hd = re.search(r"Li(\d+)E", m.group(2))
                name = f"{m.group(1)}<{hd.group(1)}>" if hd else m.group(1)
                counts[name] = [0, 0]
            elif name and re.search(r"\bHGMMA\b", line):
                counts[name][0] += 1
            elif name and re.search(r"\bUTMALDG\b", line):
                counts[name][1] += 1
    wg = {k: v for k, v in counts.items() if k.startswith("wg_")}
    require(sorted(wg) == ["wg_bwd_dkdv_kernel<128>", "wg_bwd_dkdv_kernel<64>",
                           "wg_bwd_dq_kernel<128>", "wg_bwd_dq_kernel<64>",
                           "wg_fwd_kernel<128>", "wg_fwd_kernel<64>"],
            f"K2 SASS holds the wgmma kernels {sorted(wg)}")
    decode = sorted(k for k in counts if k.startswith("decode_"))
    require(decode == sorted(["decode_combine_kernel"] + [
        f"decode_split_kernel<{hd}>" for hd in (128, 16, 256, 32, 64, 80)]),
        f"K2 SASS holds the decode kernels {decode}")
    for kernel, (mma, tma) in counts.items():
        require(mma > 0 and tma > 0 if kernel.startswith("wg_")
                else mma == tma == 0,
                f"{kernel}: {mma} HGMMA and {tma} UTMALDG in its SASS")
    return counts


def phase_kernels(rows: int, gen):
    from repro_torch.kernels import quantize as kq
    from repro_torch.kernels import reduce_compress as krc
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    results = {}
    n = rows * 256

    # K1a quantize: the packed f32 delta, with zero rows (flat-pack padding)
    x = torch.randn((rows, 256), generator=gen, device=dev) * 1e-3
    x[:7] = 0.0
    q, s = kq.quantize(x)
    qr, sr = ref.quantize_ref(x)
    torch.cuda.synchronize()
    require_equal((q, s), (qr, sr), "quantize")
    require(bool((s[:7] == 1e-12).all()) and not bool(q[:7].any()),
            "zero rows: scale must be 1e-12 and q 0")
    b, by = bound(n * 4 + n + rows * 4, 6.0 * n)
    results["quantize"] = dict(
        err=max_abs_err((q, s), (qr, sr)), ms=time_ms(lambda: kq.quantize(x)),
        plain_ms=time_ms(lambda: ref.quantize_ref(x)), bound_ms=b, bound_by=by,
        source="src/repro_torch/kernels/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize.py:31")
    log("kernels", name="quantize", rows=rows, bitwise=True,
        ms=f"{results['quantize']['ms']:.4f}",
        plain_ms=f"{results['quantize']['plain_ms']:.4f}", bound_ms=f"{b:.4f}")

    # K1b dequantize. One library call computes the same f32 function:
    # torch.mul promotes int8 * f32 to f32, each int8 is exact in f32 and
    # the product is one IEEE multiply, so it must be bitwise too.
    out = kq.dequantize(q, s, torch.float32)
    outr = ref.dequantize_ref(qr, sr, torch.float32)
    outl = torch.mul(q, s)
    torch.cuda.synchronize()
    require_equal((out,), (outr,), "dequantize")
    require_equal((out,), (outl,), "dequantize vs torch.mul")
    b, by = bound(n + rows * 4 + n * 4, 1.0 * n)
    results["dequantize"] = dict(
        err=max_abs_err((out,), (outr,)),
        ms=time_ms(lambda: kq.dequantize(q, s, torch.float32)),
        plain_ms=time_ms(lambda: ref.dequantize_ref(q, s, torch.float32)),
        library_ms=time_ms(lambda: torch.mul(q, s)),
        bound_ms=b, bound_by=by,
        source="src/repro_torch/kernels/csrc/quantize.cu",
        replaces="src/repro/kernels/quantize.py:57")
    log("kernels", name="dequantize", rows=rows, bitwise=True,
        ms=f"{results['dequantize']['ms']:.4f}",
        plain_ms=f"{results['dequantize']['plain_ms']:.4f}",
        library_ms=f"{results['dequantize']['library_ms']:.4f}",
        bound_ms=f"{b:.4f}")
    del x, q, s, qr, sr, out, outr, outl
    torch.cuda.empty_cache()

    # K3b reduce_compress_roundtrip on (L=2 pods, G=2 clients, R, 256)
    L, G = 2, 2
    x4 = torch.randn((L, G, rows, 256), generator=gen, device=dev) * 1e-3
    outs = krc.reduce_compress_roundtrip(x4)
    refs = ref.reduce_compress_roundtrip_ref(x4)
    torch.cuda.synchronize()
    require_equal(outs, refs, "reduce_compress_roundtrip")
    m = L * rows * 256  # output values
    b, by = bound(G * m * 4 + m * 4 + m + L * rows * 4, (G + 7.0) * m)
    results["reduce_compress_roundtrip"] = dict(
        err=max_abs_err(outs, refs),
        ms=time_ms(lambda: krc.reduce_compress_roundtrip(x4)),
        plain_ms=time_ms(lambda: ref.reduce_compress_roundtrip_ref(x4)),
        bound_ms=b, bound_by=by,
        source="src/repro_torch/kernels/csrc/reduce_compress.cu",
        replaces="src/repro/kernels/reduce_compress.py:108")
    log("kernels", name="reduce_compress_roundtrip", shape=tuple(x4.shape),
        bitwise=True, ms=f"{results['reduce_compress_roundtrip']['ms']:.4f}",
        plain_ms=f"{results['reduce_compress_roundtrip']['plain_ms']:.4f}",
        bound_ms=f"{b:.4f}")
    del x4, outs, refs
    torch.cuda.empty_cache()

    # K3a reduce_compress, the wire payload, on the same layout with zero
    # rows as K1a's case has them; its (q, s) must also be K3b's. Then K3c
    # dequant_accumulate on the P = 2 payloads.
    x4 = torch.randn((L, G, rows, 256), generator=gen, device=dev) * 1e-3
    x4[:, :, :7] = 0.0
    q, s = krc.reduce_compress(x4)
    qr, sr = ref.reduce_compress_ref(x4)
    _, qb, sb = krc.reduce_compress_roundtrip(x4)
    torch.cuda.synchronize()
    require_equal((q, s), (qr, sr), "reduce_compress")
    require_equal((q, s), (qb, sb), "reduce_compress vs K3b's payload")
    err = max_abs_err((q, s), (qr, sr))
    del qr, sr, qb, sb
    b, by = bound(G * m * 4 + m + L * rows * 4, (G + 6.0) * m)
    results["reduce_compress"] = dict(
        err=err, ms=time_ms(lambda: krc.reduce_compress(x4)),
        plain_ms=time_ms(lambda: ref.reduce_compress_ref(x4)),
        library_ms=None, bound_ms=b, bound_by=by,
        source="src/repro_torch/kernels/csrc/reduce_compress.cu",
        replaces="src/repro/kernels/reduce_compress.py:84")
    log("kernels", name="reduce_compress", shape=tuple(x4.shape),
        bitwise=True, payload_equals_k3b=True,
        ms=f"{results['reduce_compress']['ms']:.4f}",
        plain_ms=f"{results['reduce_compress']['plain_ms']:.4f}",
        library_ms="- (no one call)", bound_ms=f"{b:.4f}")
    del x4
    torch.cuda.empty_cache()
    out = krc.dequant_accumulate(q, s)
    outr = ref.dequant_accumulate_ref(q, s)
    torch.cuda.synchronize()
    require_equal((out,), (outr,), "dequant_accumulate")
    err = max_abs_err((out,), (outr,))
    del outr
    torch.cuda.empty_cache()
    b, by = bound(L * rows * (256 + 4) + rows * 256 * 4, 2.0 * L * rows * 256)
    results["dequant_accumulate"] = dict(
        err=err, ms=time_ms(lambda: krc.dequant_accumulate(q, s)),
        plain_ms=time_ms(lambda: ref.dequant_accumulate_ref(q, s)),
        library_ms=None, bound_ms=b, bound_by=by,
        source="src/repro_torch/kernels/csrc/reduce_compress.cu",
        replaces="src/repro/kernels/reduce_compress.py:139")
    log("kernels", name="dequant_accumulate", shape=tuple(q.shape),
        bitwise=True, ms=f"{results['dequant_accumulate']['ms']:.4f}",
        plain_ms=f"{results['dequant_accumulate']['plain_ms']:.4f}",
        library_ms="- (no one call)", bound_ms=f"{b:.4f}")
    del q, s, out
    torch.cuda.empty_cache()

    # bf16 instances of the same kernels, ragged row count
    xb = (torch.randn((4099, 256), generator=gen, device=dev) * 3).bfloat16()
    qb, sb = kq.quantize(xb)
    require_equal((qb, sb), ref.quantize_ref(xb), "bf16 quantize")
    require_equal((kq.dequantize(qb, sb, torch.bfloat16),),
                  (ref.dequantize_ref(qb, sb, torch.bfloat16),),
                  "bf16 dequantize")
    x4b = (torch.randn((2, 3, 1027, 256), generator=gen, device=dev)).bfloat16()
    require_equal(krc.reduce_compress_roundtrip(x4b),
                  ref.reduce_compress_roundtrip_ref(x4b),
                  "bf16 reduce_compress_roundtrip")
    torch.cuda.synchronize()
    log("kernels", bf16="bitwise", shapes="(4099,256),(2,3,1027,256)")

    # K3a/K3c sweep: bf16 input, R = 1 and 1027, P = 1, 3 and 4
    for shape, dtype in (((2, 3, 1027, 256), torch.bfloat16),
                         ((2, 2, 1, 256), torch.float32),
                         ((1, 4, 1027, 256), torch.float32)):
        xs = (torch.randn(shape, generator=gen, device=dev) * 1e-2).to(dtype)
        xs[:, :, :1] = 0.0
        q, s = krc.reduce_compress(xs)
        require_equal((q, s), ref.reduce_compress_ref(xs),
                      f"reduce_compress {shape} {dtype}")
        require_equal((q, s), krc.reduce_compress_roundtrip(xs)[1:],
                      f"reduce_compress {shape} {dtype} vs K3b's payload")
    for p, r in ((1, 1027), (3, 1027), (4, 1027), (3, 1)):
        xs = torch.randn((p, r, 256), generator=gen, device=dev) * 1e-2
        q, s = krc.reduce_compress(xs[:, None])  # p pods of one client
        require_equal((krc.dequant_accumulate(q, s),),
                      (ref.dequant_accumulate_ref(q, s),),
                      f"dequant_accumulate P={p} R={r}")
    torch.cuda.synchronize()
    log("kernels", name="K3a/K3c sweep", bitwise=True,
        reduce_compress="(2,3,1027,256) bf16, (2,2,1,256), (1,4,1027,256)",
        dequant_accumulate="P 1/3/4 x R 1027, P 3 x R 1")
    return results


# K2: the main path's attention shapes (lm_350m: 16 heads of 64, bf16,
# causal), the seq-512 rounds' first, then the seq-4096 rounds'.
FLASH_MAIN = {"seq512": (4, 512), "seq4096": (2, 4096)}
FLASH_SOURCE = {
    "flash_attention_fwd": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:103"),
    "flash_attention_bwd_dq": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/models/attention.py:437"),
    "flash_attention_bwd_dkdv": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/models/attention.py:437"),
}
# the bf16 forward, bwd_dq and bwd_dkdv at head dims 64 and 128
FLASH_SM90_SOURCE = dict(
    source="src/repro_torch/kernels/csrc/flash_attention_sm90.cu")
# the bf16 forward of at most 16 query rows a kv head
FLASH_DECODE_SOURCE = dict(
    source="src/repro_torch/kernels/csrc/flash_decode.cu")
FLASH_SWEEP = (  # (B, Sq, Skv, Hq, Hkv, hd, causal, window)
    (2, 200, 200, 8, 8, 80, True, 0),
    (1, 300, 300, 4, 2, 128, True, 0),
    (1, 130, 130, 56, 8, 64, True, 0),      # yi_34b's 56:8, G = 7
    (2, 100, 100, 8, 1, 32, True, 0),       # G = 8
    (1, 1000, 1000, 4, 2, 64, True, 256),   # window, ragged S
    (1, 24, 56, 4, 2, 32, False, 0),        # non-causal, Sq != Skv
)
# the wgmma kernels' 128-row tiles: ragged Sq and Skv, G 7, 8 and 16
FLASH_WG_SWEEP = (
    (1, 129, 65, 8, 1, 128, False, 0),
    (2, 63, 127, 7, 1, 64, False, 0),
    (1, 1000, 1000, 16, 1, 128, True, 256),
)
# the split-KV decode forward (bf16, Sq * G <= 16 query rows a kv head):
# Sq * G of 1, 4, 16 and 17 (the route's boundary), Skv of 2, 63, 257 and
# 4097, every head dim, causal, window and non-causal (no call with one
# visible key a row: there dq is 0 up to rounding, which no relative gate
# holds)
FLASH_DECODE_SWEEP = (
    (4, 1, 4097, 16, 16, 64, False, 0),
    (3, 1, 2, 4, 4, 128, False, 0),
    (2, 1, 257, 8, 2, 80, False, 0),
    (1, 4, 63, 16, 4, 256, True, 32),
    (1, 16, 4097, 2, 2, 32, True, 0),
    (2, 2, 257, 16, 2, 128, False, 0),
    (1, 2, 63, 8, 4, 16, False, 0),
    (1, 17, 257, 4, 4, 64, False, 0),
    (1, 1, 4097, 17, 1, 128, False, 0),
)


def check_close(what, got, want, tol) -> float:
    """Elementwise ``|got - want| <= tol + tol * |want|`` (rtol = atol =
    tol); returns the max abs error."""
    diff = (got.double() - want.double()).abs()
    excess = float((diff - tol - tol * want.double().abs()).max())
    require(excess <= 0, f"{what}: beyond rtol = atol = {tol} by {excess} "
            f"(max abs err {float(diff.max())})")
    return float(diff.max())


def check_bf16(what, got, want) -> float:
    """bf16 values that the kernel and the plain version both compute in
    f32 and round once: ``|got - want| <= 2^-7 |want| + 1e-3 max|want|``
    (one bf16 step of each value, plus a floor for values that cancel to
    near 0); returns the max abs error."""
    diff = (got.double() - want.double()).abs()
    lim = 2.0 ** -7 * want.double().abs() + 1e-3 * float(want.double().abs().max())
    excess = float((diff - lim).max())
    require(excess <= 0, f"{what}: beyond one bf16 step + 1e-3 max|plain| by "
            f"{excess} (max abs err {float(diff.max())})")
    return float(diff.max())


def check_grad(what, got, want, dtype) -> float:
    """f32: max abs error <= 1e-4 * max |plain| (sums over up to 4096
    positions and G heads in another order); bf16: one bf16 step."""
    if dtype != torch.float32:
        return check_bf16(what, got, want)
    err = float((got.double() - want.double()).abs().max())
    lim = 1e-4 * float(want.double().abs().max())
    require(err <= lim, f"{what}: max abs err {err} > {lim}")
    return err


def flash_case(gen, b, sq, skv, hq, hkv, hd, causal, window, dtype):
    """K2 forward and backward against the plain versions on one input.
    The backward kernels get the plain residuals (out_f32, L) and D, so each
    kernel is held to its own plain version. Returns the inputs, the
    residuals, the errors and ``kernels``, which runs the three kernels on
    these inputs again (for ``kernel_names``)."""
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    q = torch.randn((b, sq, hq, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, skv, hkv, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, skv, hkv, hd), generator=gen, device=dev).to(dtype)
    do = torch.randn((b, sq, hq, hd), generator=gen, device=dev).to(dtype)
    kw = dict(causal=causal, window=window)
    what = f"K2 {(b, sq, skv, hq, hkv, hd)} {dtype} causal={causal} w={window}"
    r_out, r_out32, r_lse = ref.flash_attention_ref(q, k, v, **kw)
    r_dq, r_delta = ref.flash_attention_bwd_dq_ref(q, k, v, r_out32, r_lse,
                                                   do, **kw)
    r_dk, r_dv = ref.flash_attention_bwd_dkdv_ref(q, k, v, r_lse, r_delta,
                                                  do, **kw)

    def kernels():
        return (ops.flash_attention_fwd(q, k, v, **kw),
                ops.flash_attention_bwd_dq(q, k, v, r_out32, r_lse, do, **kw),
                ops.flash_attention_bwd_dkdv(q, k, v, r_lse, r_delta, do, **kw))

    (out, out32, lse), (dq, delta), (dk, dv) = kernels()
    torch.cuda.synchronize()
    errs = {
        "out": (check_close(f"{what} out", out, r_out, 2e-5)
                if dtype == torch.float32 else check_bf16(f"{what} out", out, r_out)),
        "out32": check_close(f"{what} out32", out32, r_out32, 2e-5),
        "lse": check_close(f"{what} L", lse, r_lse, 2e-5),
        "delta": check_close(f"{what} D", delta, r_delta, 2e-5),
        "dq": check_grad(f"{what} dq", dq, r_dq, dtype),
        "dk": check_grad(f"{what} dk", dk, r_dk, dtype),
        "dv": check_grad(f"{what} dv", dv, r_dv, dtype),
    }
    require(out.dtype == dtype and dq.dtype == dtype and dk.dtype == dtype,
            f"{what}: output dtypes")
    return (q, k, v, do, r_out32, r_lse, r_delta), errs, kernels


def visible_pairs(sq, skv, causal, window) -> int:
    from repro_torch.kernels import ref

    return int(ref.visible_mask(sq, skv, causal, window, "cpu").sum())


def sdpa_times(q, k, v, do, window: int = 0, causal: bool = True):
    """The library yardstick: ``scaled_dot_product_attention`` (GQA;
    causal, or not; with a window, the causal window as a boolean
    ``attn_mask``, and PyTorch picks the backend that takes a mask)
    forward, and its autograd backward (dq, dk, dv), in ms; its forward's
    max abs difference from the plain version as information (it computes
    p in bf16 and is not held to the tolerance); and the forward call
    (whose kernels the caller traces)."""
    from repro_torch.kernels import ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    if window:
        mask = ref.visible_mask(q.shape[1], k.shape[1], True, window, q.device)
        call = lambda: sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=True)  # noqa: E731
    else:
        call = lambda: sdpa(qt, kt, vt, is_causal=causal,  # noqa: E731
                            enable_gqa=True)
    fwd_ms = time_ms(call)
    out = call()
    dot = do.transpose(1, 2)
    bwd_ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                 retain_graph=True))
    err = float((out.detach().transpose(1, 2).double()
                 - ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window)[0].double())
                .abs().max())
    return fwd_ms, bwd_ms, err, call


def flash_work(q, k, pairs: int) -> dict:
    """(bytes, FLOP) of each K2 kernel on these inputs: each input read
    once, each output written once (out_f32 and L are outputs of the
    training forward); FLOP per visible pair: forward q.k and p.v (4 hd),
    ``bwd_dq`` recomputes s and dp and forms dq (6 hd), ``bwd_dkdv``
    recomputes s and dp and forms dv and dk (8 hd)."""
    hd = q.shape[-1]
    nq = q.numel() * q.element_size()
    nk = k.numel() * k.element_size()  # each of k, v (and dk, dv)
    n32 = q.numel() * 4                # out_f32
    rows = q.shape[0] * q.shape[1] * q.shape[2] * 4  # L or D
    return {
        "flash_attention_fwd": (nq + 2 * nk + nq + n32 + rows, 4 * hd * pairs),
        "flash_attention_bwd_dq": (nq + 2 * nk + n32 + nq + rows + nq + rows,
                                   6 * hd * pairs),
        "flash_attention_bwd_dkdv": (nq + 2 * nk + nq + 2 * rows + 2 * nk,
                                     8 * hd * pairs),
    }


TRACE_LEAD_S = 3.0  # idle seconds in a trace before its first call
TRACE_GAP_S = 0.1   # idle seconds after each call
TRACE_LAG_S = 6.0   # more idle seconds before the trace ends


def traced_calls(calls: dict, attempts: int = 3) -> dict:
    """{label: [(device kernel name, device us), ...]} of the kernels
    ``calls[label]()`` ran, from one ``torch.profiler`` trace of all the
    calls in order, each followed by a synchronize and TRACE_GAP_S idle. A
    call's kernels run back to back, so on the device clock they form one
    group, and the groups follow the calls' order.

    On the H100 machines a trace of a second or two can lose all its
    kernel events (most short traces did after a few minutes of work),
    while traces of several seconds kept every one: hence the idle lead
    and lag. A trace whose groups do not match the calls one to one is
    taken again, up to ``attempts`` times, and logged."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    labels = list(calls)
    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            time.sleep(TRACE_LEAD_S)
            for label in labels:
                calls[label]()
                torch.cuda.synchronize()
                time.sleep(TRACE_GAP_S)
            time.sleep(TRACE_LAG_S)
        events = sorted((e.time_range.start, e.time_range.end, e.name)
                        for e in prof.events() if e.device_type.name == "CUDA")
        groups, end = [], None
        for start, stop, name in events:  # microseconds
            if end is None or start - end > TRACE_GAP_S * 1e6 / 2:
                groups.append([])
            groups[-1].append((name, stop - start))
            end = stop if end is None else max(end, stop)
        if len(groups) == len(labels):
            return dict(zip(labels, groups))
        log("trace", attempt=attempt, calls=len(labels), groups=len(groups))
    raise AssertionError(f"traced_calls: {attempts} traces of {len(labels)} "
                         f"calls did not show one kernel group per call")


def kernel_names(calls: dict, attempts: int = 3) -> dict:
    """{label: sorted names of the device kernels ``calls[label]()`` ran}
    (:func:`traced_calls`)."""
    return {label: sorted({name for name, _ in group})
            for label, group in traced_calls(calls, attempts).items()}


def kernel_split(calls: dict, reps: int = 10) -> dict:
    """{label: {device kernel name: mean device ms per call}}: each of
    ``calls`` run ``reps`` times in one trace (:func:`traced_calls`)."""
    runs = {(label, i): fn for label, fn in calls.items() for i in range(reps)}
    split = {label: {} for label in calls}
    for (label, _), group in traced_calls(runs).items():
        for name, us in group:
            split[label][name] = split[label].get(name, 0.0) + us / 1e3 / reps
    return split


# bf16 K2 at these head dims runs the forward, bwd_dq and bwd_dkdv on
# wgmma (flash_attention_sm90.cu, namespace wg); every other call on
# flash_attention.cu: bf16 on mma.sync (tc), f32 on the SIMT kernels. A
# bf16 forward of at most DECODE_ROWS query rows a kv head (Sq * G) runs
# the split-KV kernels of flash_decode.cu instead, at every head dim.
WG_HEAD_DIMS = (64, 128)
DECODE_ROWS = 16
FLASH_NAMES = ("flash_attention_fwd", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkdv")


def takes_decode(dtype, rows) -> bool:
    """A bf16 forward of ``rows`` = Sq * G query rows a kv head takes the
    decode kernels (None: rows unknown, so no)."""
    return dtype == torch.bfloat16 and rows is not None and rows <= DECODE_ROWS


def flash_kernels(dtype, hd: int, g: int, which=FLASH_NAMES,
                  rows=None) -> set:
    """Short names of the device kernels that the K2 calls ``which`` launch
    for ``dtype`` at head dim ``hd`` with G = Hq / Hkv and ``rows`` = Sq *
    G query rows a kv head (the smoke's own oracle of the launchers' route
    table)."""
    out = set()
    for name in which:
        kernel = name[len("flash_attention_"):] + "_kernel"
        if dtype != torch.bfloat16:
            out.add(kernel)
        elif name == "flash_attention_fwd" and takes_decode(dtype, rows):
            out.update(DECODE_KERNELS)
        elif hd in WG_HEAD_DIMS:
            out.add("wg_" + kernel)
        else:
            out.add("tc_" + kernel)
            if name == "flash_attention_bwd_dkdv" and g > 1:
                out.add("tc_sum_heads_kernel")
    return out


def flash_entries(dtype, hd: int, decode: bool = False) -> dict:
    """{K2 call: the extern "C" entry point it takes} for ``dtype`` at
    head dim ``hd``, for a forward of few query rows with ``decode`` (the
    same oracle)."""
    wg = dtype == torch.bfloat16 and hd in WG_HEAD_DIMS
    if decode and dtype == torch.bfloat16:
        fwd = "repro_flash_decode"
    else:
        fwd = "repro_flash_wg_fwd" if wg else "repro_flash_fwd"
    return {"flash_attention_fwd": fwd,
            "flash_attention_bwd_dq": "repro_flash_wg_bwd_dq" if wg
            else "repro_flash_bwd_dq",
            "flash_attention_bwd_dkdv": "repro_flash_wg_bwd_dkdv" if wg
            else "repro_flash_bwd_dkdv"}


def short_kernel(name: str) -> str:
    """``tc_fwd_kernel`` of ``void repro::flash::tc::tc_fwd_kernel<64>(...)``."""
    return name.split("(")[0].split("<")[0].split("::")[-1]


def require_flash_route(names, dtype, hd, g, what, which=FLASH_NAMES,
                        rows=None) -> None:
    """The K2 kernels among ``names`` (a trace of the calls ``which``) are
    exactly :func:`flash_kernels`' for this dtype, head dim, G and query
    rows a kv head."""
    got = {short_kernel(n) for n in names if "repro::flash::" in n}
    want = flash_kernels(dtype, hd, g, which, rows)
    require(got == want, f"{what}: K2 ran {sorted(got)}, want {sorted(want)}")


def require_flash_entries(what: str, wgmma: bool = False,
                          need=("repro_flash_wg_fwd", "repro_flash_wg_bwd_dq",
                                "repro_flash_wg_bwd_dkdv"),
                          decode=None) -> None:
    """Every K2 launch since the last ``ops.reset_launches`` went through
    the entry point :func:`flash_entries` gives its dtype and head dim
    (``flash_attention.ROUTE_LAUNCHES``): a bf16 forward through the
    full-sequence entry or, for few query rows, the decode entry; with
    ``decode`` True only the latter, False only the former. With
    ``wgmma``, each entry of ``need`` launched."""
    from repro_torch.kernels import flash_attention as fa

    def allowed(dtype, hd):
        modes = (False, True) if decode is None else (decode,)
        return {e for m in modes for e in flash_entries(dtype, hd, m).values()}

    wrong = {k: n for k, n in fa.ROUTE_LAUNCHES.items()
             if k[0] not in allowed(k[1], k[2])}
    require(not wrong, f"{what}: K2 launches off their route: {wrong}")
    by_entry = {}
    for (entry, _, _), n in fa.ROUTE_LAUNCHES.items():
        by_entry[entry] = by_entry.get(entry, 0) + n
    require(not wgmma or all(by_entry.get(e, 0) > 0 for e in need),
            f"{what}: the wgmma K2 kernels {need} did not launch: {by_entry}")


def flash_bounds(nbytes: float, flop: float, dtype):
    """(bound ms, bound_by for the JSON line, what the log calls it): bf16
    calls at the bf16 tensor-core rate, f32 calls at the f32 SIMT rate,
    or the bytes where those take longer."""
    if dtype != torch.bfloat16:
        b_ms, by = bound(nbytes, flop)
        return b_ms, by, by
    t_bytes = nbytes / peaks().HBM_BW * 1e3
    t_ops = flop / peaks().PEAK_FLOPS * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", "bytes"
    return t_ops, "operations", "bf16 tensor-core ops"


def flash_measure(gen, b, s, hq, hkv, hd, window, skv=None,
                  causal=True) -> dict:
    """K2 at one main-path shape (bf16; causal, or not, with ``skv`` keys,
    default ``s``): errors against the plain versions, the times of the
    kernels, the plain versions and SDPA, and the calls whose kernels
    :func:`flash_report` checks by name."""
    from repro_torch.kernels import ops, ref

    skv = s if skv is None else skv
    (q, k, v, do, out32, lse, delta), errs, case_kernels = flash_case(
        gen, b, s, skv, hq, hkv, hd, causal, window, torch.bfloat16)
    kw = dict(causal=causal, window=window)
    pairs = b * hq * visible_pairs(s, skv, causal, window)
    calls = {
        "flash_attention_fwd": lambda: ops.flash_attention_fwd(q, k, v, **kw),
        "flash_attention_bwd_dq": lambda: ops.flash_attention_bwd_dq(
            q, k, v, out32, lse, do, **kw),
        "flash_attention_bwd_dkdv": lambda: ops.flash_attention_bwd_dkdv(
            q, k, v, lse, delta, do, **kw),
    }
    plain_calls = {
        "flash_attention_fwd": lambda: ref.flash_attention_ref(q, k, v, **kw),
        "flash_attention_bwd_dq": lambda: ref.flash_attention_bwd_dq_ref(
            q, k, v, out32, lse, do, **kw),
        "flash_attention_bwd_dkdv": lambda: ref.flash_attention_bwd_dkdv_ref(
            q, k, v, lse, delta, do, **kw),
    }
    ms = {name: time_ms(fn) for name, fn in calls.items()}
    plain = {name: time_ms(fn) for name, fn in plain_calls.items()}
    lib_fwd, lib_bwd, lib_err, lib_call = sdpa_times(q, k, v, do, window,
                                                     causal)
    errs_by = {"flash_attention_fwd": max(errs["out"], errs["lse"]),
               "flash_attention_bwd_dq": max(errs["dq"], errs["delta"]),
               "flash_attention_bwd_dkdv": max(errs["dk"], errs["dv"])}
    shape = ((b, s, f"{hq}:{hkv}", hd, window) if skv == s and causal else
             (b, s, skv, f"{hq}:{hkv}", hd, "causal" if causal
              else "non-causal"))
    return dict(shape=shape, dtype=q.dtype, hd=hd, g=hq // hkv,
                rows=s * (hq // hkv),
                work=flash_work(q, k, pairs), errs=errs_by, ms=ms,
                plain=plain, lib=(lib_fwd, lib_bwd, lib_err),
                calls=dict(calls, case=case_kernels, sdpa=lib_call))


def flash_report(m: dict, traced: dict) -> dict:
    """The route checks of :func:`flash_measure`'s calls on their traced
    kernel names (``traced``: label -> names), the log lines, and the
    results by kernel."""
    shape, dtype, hd, g, rows = (m["shape"], m["dtype"], m["hd"], m["g"],
                                 m["rows"])
    lib_fwd, lib_bwd, lib_err = m["lib"]
    require_flash_route(traced["case"], dtype, hd, g, f"K2 {shape}",
                        rows=rows)
    results = {}
    for name, (nbytes, flop) in m["work"].items():
        names = traced[name]
        require_flash_route(names, dtype, hd, g, f"{name} {shape}", (name,),
                            rows)
        b_ms, by, by_log = flash_bounds(nbytes, flop, dtype)
        f32_ms, _ = bound(nbytes, flop)
        ms, plain, err = m["ms"][name], m["plain"][name], m["errs"][name]
        results[name] = dict(
            err=err, ms=ms, plain_ms=plain,
            library_ms=lib_fwd if name == "flash_attention_fwd" else lib_bwd,
            bound_ms=b_ms, bound_by=by, bound_ms_f32_simt=f32_ms, hd=hd,
            kernels=sorted(short_kernel(n) for n in names
                           if "repro::flash::" in n))
        log("kernels", name=name, shape=shape, ms=f"{ms:.4f}",
            plain_ms=f"{plain:.4f}",
            library_ms=f"{results[name]['library_ms']:.4f}",
            bound_ms=f"{b_ms:.4f}", bound_by=f"'{by_log}'", flop=flop,
            bytes=nbytes, bound_ms_f32_simt=f"{f32_ms:.4f}",
            err=f"{err:.3e}", kernels=json.dumps(names))
    log("kernels", name="sdpa (information)", shape=shape,
        fwd_max_abs_diff_vs_plain=f"{lib_err:.3e}",
        fwd_kernels=json.dumps([n[:60] for n in traced["sdpa"]]))
    return results


def flash_main(gen, b, s, hq, hkv, hd, window):
    """K2 at one main-path shape (bf16, causal): errors against the plain
    versions, and the times of the kernels, the plain versions and SDPA
    beside the bounds, its kernels checked by name in one trace."""
    m = flash_measure(gen, b, s, hq, hkv, hd, window)
    return flash_report(m, kernel_names(m["calls"]))


def flash_sweep(gen, cases, phase: str, name: str) -> None:
    """K2 against its plain versions over ``cases`` in f32 and bf16; then
    one trace of every case's kernels, each call on exactly its route's
    kernels (:func:`require_flash_route`)."""
    calls, routes = {}, {}
    for case in cases:
        for dtype in (torch.float32, torch.bfloat16):
            _, errs, kernels = flash_case(gen, *case, dtype)
            dt = str(dtype).split(".")[-1]
            log(phase, name=name, shape=case[:6], causal=case[6],
                window=case[7], dtype=dt,
                errs=json.dumps({k: f"{v:.3e}" for k, v in errs.items()}))
            calls[f"{case} {dt}"] = kernels
            routes[f"{case} {dt}"] = (dtype, case[5], case[3] // case[4],
                                      case[1] * (case[3] // case[4]))
    for label, names in kernel_names(calls).items():
        dtype, hd, g, rows = routes[label]
        require_flash_route(names, dtype, hd, g, f"K2 {label}", rows=rows)
    log(phase, name=f"{name} routes", cases=len(calls),
        bf16="wg:: at hd 64/128, tc:: the rest; the forward of <= 16 "
        "query rows a kv head on the decode kernels", f32="SIMT only")


def phase_flash(gen):
    """K2 against its plain versions, its libraries' SASS, and its times
    at the main shapes."""
    log("kernels", name="K2 SASS", hgmma_utmaldg=json.dumps(flash_sass()))
    flash_sweep(gen, FLASH_SWEEP, "kernels", "K2 sweep")
    flash_sweep(gen, FLASH_WG_SWEEP, "kernels", "K2 wgmma sweep")
    flash_sweep(gen, FLASH_DECODE_SWEEP, "kernels", "K2 decode sweep")
    results = {}
    for key, (b, s) in FLASH_MAIN.items():
        for name, r in flash_main(gen, b, s, 16, 16, 64, 0).items():
            results.setdefault(name, {})[key] = r
        torch.cuda.empty_cache()
    return results


# K2's second order (P3) at the flat rounds' attention shape: B 2 x S 512,
# 16 heads of 64, causal, in f32 and bf16.
FLASH_P3 = (2, 512, 16, 64)


def check_second_order(what, got, want, dtype) -> float:
    """f32: max abs error <= 1e-4 max |plain|; bf16: ``|got - want| <=
    2^-6 |want| + 1e-2 max |want|`` (two bf16 steps plus 1e-2 of the
    largest, the tolerance ``ops._FlashAttentionBackward`` states for a
    given cotangent). Returns the max abs error."""
    diff = (got.double() - want.double()).abs()
    top = float(want.double().abs().max())
    if dtype == torch.float32:
        lim = 1e-4 * top
        require(float(diff.max()) <= lim,
                f"{what}: max abs err {float(diff.max())} > {lim}")
    else:
        excess = float((diff - 2.0 ** -6 * want.double().abs()
                        - 1e-2 * top).max())
        require(excess <= 0, f"{what}: beyond two bf16 steps + 1e-2 "
                f"max|plain| by {excess} (max |plain| {top}, max abs err "
                f"{float(diff.max())})")
    return float(diff.max())


def phase_flash_second_order(gen) -> dict:
    """P3 on the card: the second order through ``ops.flash_attention``
    (the K2 forward and backward kernels, then the plain recompute of
    ``ops._FlashAttentionBackward``) against autograd's double backward
    through the plain forward on the card: in f32 of ``sum |g|^2`` over
    the first-order gradients g, in bf16 of ``sum g . u`` (a
    Hessian-vector product, so both sides differentiate with the same
    cotangent; the bf16 kernels' first order is one bf16 step from the
    plain one, and ``sum |g|^2`` would carry that step into its
    cotangent: 0.0104 beyond the gate for dq in PR 22's first call); the first order
    bitwise the K2 kernels called as the parent's wrapper called them;
    each kernel launched once and the second order counted once; the
    second-order call's ms (CUDA events) and the memory it holds."""
    from repro_torch.kernels import ops, ref

    b, s, h, hd = FLASH_P3
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, w = (torch.randn((b, s, h, hd), generator=gen,
                                  device="cuda").to(dtype) for _ in range(4))
        u = [torch.randn((b, s, h, hd), generator=gen, device="cuda")
             for _ in range(3)]

        def second(attend):
            qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
            g1 = torch.autograd.grad(attend(qq, kk, vv), (qq, kk, vv), w,
                                     create_graph=True)
            if dtype == torch.float32:
                total = sum((g ** 2).sum() for g in g1)
            else:
                # a Hessian-vector product: the cotangent of the first
                # order is u on both sides, so the bf16 kernels' first
                # order (one bf16 step from the plain one) does not enter
                total = sum((g.float() * uu).sum() for g, uu in zip(g1, u))
            return ([g.detach() for g in g1],
                    torch.autograd.grad(total, (qq, kk, vv)))

        dt = str(dtype).split(".")[-1]
        ops.reset_launches()
        g1, g2 = second(lambda *t: ops.flash_attention(*t, causal=True))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        plain_calls = ops.plain_counts()["flash_attention_bwd2_plain"]
        require(counts["flash_attention_fwd"] == 1
                and counts["flash_attention_bwd_dq"] == 1
                and counts["flash_attention_bwd_dkdv"] == 1
                and plain_calls == 1,
                f"P3 {dt}: launches {counts}, second-order calls "
                f"{plain_calls}")
        o, o32, lse = ops.flash_attention_fwd(q, k, v, causal=True)
        dq, delta = ops.flash_attention_bwd_dq(q, k, v, o32, lse, w,
                                               causal=True)
        dk, dv = ops.flash_attention_bwd_dkdv(q, k, v, lse, delta, w,
                                              causal=True)
        require(all(torch.equal(a, c) for a, c in zip(g1, (dq, dk, dv))),
                f"P3 {dt}: first order != the kernels called directly")
        p1, p2 = second(lambda *t: ref.flash_attention_ref(*t,
                                                           causal=True)[0])
        errs = {n: check_second_order(f"P3 {dt} d{n}", g, p, dtype)
                for n, g, p in zip("qkv", g2, p2)}
        first = {n: check_grad(f"P3 {dt} first d{n}", g, p, dtype)
                 for n, g, p in zip("qkv", g1, p1)}
        del p1, p2, g2
        qq, kk, vv, ww = (t.detach().requires_grad_(True) for t in (q, k, v, w))
        outs = ops._FlashAttentionBackward.apply(qq, kk, vv, o32, lse, ww,
                                                 True, 0)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.autograd.grad(outs, (qq, kk, vv, ww), g1, retain_graph=True)
        torch.cuda.synchronize()
        held = torch.cuda.max_memory_allocated() - before
        ms = time_ms(lambda: torch.autograd.grad(outs, (qq, kk, vv, ww), g1,
                                                 retain_graph=True))
        # the call reads q, k, v, dout, out_f32, L and the first order's
        # cotangents and writes four gradients; FLOP: the six products of
        # the forward and the first-order backward (q.k, p.v, dout.v,
        # p^T.dout, ds.k, ds^T.q: 12 hd a visible pair) recomputed, and
        # the two products of each in their transpose (24 hd)
        nbytes = tensor_bytes(q, k, v, w, o32, lse, *g1, q, k, v, w)
        flop = 36.0 * hd * b * h * visible_pairs(s, s, True, 0)
        b_ms, by, by_log = flash_bounds(nbytes, flop, dtype)
        out[dt] = {"ms": ms, "held_mib": held / 2 ** 20, "errs": errs,
                   "bound_ms": b_ms, "bound_by": by}
        log("flash", name="K2 second order (plain recompute)",
            shape=f"B {b} x S {s} x {h} heads x {hd}, causal", dtype=dt,
            ms=f"{ms:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=f"'{by_log}'",
            bytes=nbytes, flop=flop, held_mib=f"{held / 2 ** 20:.1f}",
            second_order_calls=plain_calls, first_order_bitwise=True,
            launches=json.dumps({k_: v_ for k_, v_ in counts.items() if v_}),
            errs=json.dumps({k_: f"{v_:.3e}" for k_, v_ in errs.items()}),
            first_errs=json.dumps({k_: f"{v_:.3e}"
                                   for k_, v_ in first.items()}))
        del q, k, v, w, outs, qq, kk, vv, ww, g1
        torch.cuda.empty_cache()
    return out


# K2 at recurrentgemma_2b's local attention: 10 query heads on one kv head
# of 256, window 2048, at the hybrid rounds' B 1 x S 4096.
FLASH_HD256_MAIN = (1, 4096, 10, 1, 256, 2048)
FLASH_HD256_SWEEP = (  # (B, Sq, Skv, Hq, Hkv, hd, causal, window)
    (1, 300, 300, 10, 1, 256, True, 0),     # MQA, G = 10
    (2, 100, 100, 2, 2, 256, True, 0),      # G = 1
    (1, 333, 333, 10, 1, 256, True, 64),    # window, ragged S
    (1, 24, 56, 4, 1, 256, False, 0),       # non-causal, Sq != Skv
)


def phase_flash_hd256(gen):
    """K2 at head dim 256 against its plain versions, and its times at the
    hybrid model's shape."""
    flash_sweep(gen, FLASH_HD256_SWEEP, "flash", "K2 hd256 sweep")
    results = flash_main(gen, *FLASH_HD256_MAIN)
    torch.cuda.empty_cache()
    return results


# K4: the RG-LRU scan at the hybrid model's shape (batch 1, seq 4096,
# lru_width 2560, f32 as the model calls it), and a ragged sweep: W not a
# multiple of 32 (45, 33, 1; 100, a TMA width in f32 only), S shorter than
# a tile and not a multiple of it, several batch rows; and the serve
# chunks of full recurrentgemma_2b (S 1, a ragged 37 and 64 at width 2560,
# taken with h0 as the chunk steps take it).
LRU_MAIN = (1, 4096, 2560)
LRU_SERVE_SHAPES = ((1, 1, 2560), (1, 37, 2560), (1, 64, 2560))
LRU_SWEEP = ((2, 37, 45), (3, 1000, 100), (1, 5, 33), (2, 129, 2560),
             (3, 16, 1), (2, 4100, 2560)) + LRU_SERVE_SHAPES
# must take the TMA route
LRU_TMA_SHAPES = (LRU_MAIN, (2, 4100, 2560)) + LRU_SERVE_SHAPES
LRU_SIMT_WIDTHS = (45, 33, 1)                  # must take the SIMT route
LRU_PLAIN_RUNS = 5
LRU_SOURCE = "src/repro_torch/kernels/csrc/rglru_scan.cu"
LRU_REPLACES = {"lru_scan_fwd": "src/repro/kernels/rglru_scan.py:41",
                # no TPU backward: the reference differentiates its
                # associative scan
                "lru_scan_bwd": "src/repro/models/rglru.py:103"}


def lru_route(w: int, dtype) -> str:
    """The route K4 must take on fresh (aligned) tensors of width w: TMA
    when a row of W values is a multiple of 16 bytes, else SIMT."""
    size = torch.empty((), dtype=dtype).element_size()
    return "tma" if w * size % 16 == 0 else "simt"


def lru_inputs(gen, b, s, w, dtype, with_h0):
    dev = torch.device("cuda")
    a = torch.sigmoid(torch.randn((b, s, w), generator=gen, device=dev))
    x = torch.randn((b, s, w), generator=gen, device=dev)
    g = torch.randn((b, s, w), generator=gen, device=dev)
    h0 = torch.randn((b, w), generator=gen, device=dev) if with_h0 else None
    return a.to(dtype), x.to(dtype), g.to(dtype), h0


def lru_case(gen, b, s, w, dtype, with_h0):
    """K4 forward and backward bitwise against the plain versions; the
    backward gets the plain forward's output. Each launch must take the
    route :func:`lru_route` names (the launchers' route counts)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rglru_scan as kl

    a, x, g, h0 = lru_inputs(gen, b, s, w, dtype, with_h0)
    what = f"K4 {(b, s, w)} {dtype} h0={with_h0}"
    kl.reset_route_launches()
    h = ops.lru_scan_fwd(a, x, h0)
    hr = ref.lru_scan_ref(a, x, h0)
    torch.cuda.synchronize()
    require_equal((h,), (hr,), f"{what} forward")
    got = ops.lru_scan_bwd(a, hr, g, h0)
    want = ref.lru_scan_bwd_ref(a, hr, g, h0)
    torch.cuda.synchronize()
    require_equal(got, want, f"{what} backward")
    route = lru_route(w, dtype)
    require(kl.ROUTE_LAUNCHES[route] == 2,
            f"{what}: launches by route {kl.ROUTE_LAUNCHES}, expected {route}")
    return a, x, g, hr


def lru_sass() -> dict:
    """{kernel<type>: (UTMALDG, UTMASTG) count} in the SASS of the
    K4 library (``cuobjdump -sass``): every TMA kernel loads and stores
    through the TMA, the SIMT kernels never."""
    import re

    from repro_torch import compat
    from repro_torch.kernels import _build

    tool = Path(compat.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(tool), "-sass", str(_build.KERNELS.path("rglru_scan"))],
        capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*lru\d+(\w+?_kernel)I(f|13__nv_bfloat16)",
                      line)
        if m:
            name = f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'}>"
            counts[name] = [0, 0]
        elif name and re.search(r"\bUTMALDG\b", line):
            counts[name][0] += 1
        elif name and re.search(r"\bUTMASTG\b", line):
            counts[name][1] += 1
    for kernel, (ld, st) in counts.items():
        tma = kernel.startswith("tma_")
        require(ld > 0 and st > 0 if tma else ld == st == 0,
                f"{kernel}: {ld} UTMALDG and {st} UTMASTG in its SASS")
    require(len(counts) == 8, f"K4 SASS holds the kernels {sorted(counts)}")
    return counts


def lru_resources(ptxas_log) -> list:
    """Registers and spills (nvcc -Xptxas -v) of every K4 kernel, with the
    dynamic shared memory of each TMA ring (``repro_lru_ring_smem``);
    nothing when the library was not built by this process."""
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels.quantize import DTYPE_CODES

    lib = _build.KERNELS.library("rglru_scan")
    lines = (ptxas_log or "").splitlines()
    rows = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\S*lru\d+(\w+?_kernel)"
                      r"I(f|13__nv_bfloat16)", line)
        if not m:
            continue
        props = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", props)
        spill = re.search(r"(\d+) bytes spill stores", props)
        kernel = m.group(1)
        dt = torch.float32 if m.group(2) == "f" else torch.bfloat16
        smem = (lib.repro_lru_ring_smem(DTYPE_CODES[dt],
                                        int(kernel.endswith("bwd_kernel")))
                if kernel.startswith("tma_") else 0)
        rows.append(dict(kernel=kernel, dtype=str(dt).split(".")[-1],
                         registers=regs.group(1) if regs else "?",
                         spill_stores=spill.group(1) if spill else "?",
                         dynamic_smem_bytes=smem))
    require(not ptxas_log or len(rows) == 8,
            f"expected 8 K4 kernels in the ptxas report, got {len(rows)}")
    return rows


def lru_routes_traced(gen) -> dict:
    """One ``torch.profiler`` trace of K4's forward and backward at every
    sweep case (f32 and bf16) and the main shape: each must run only the
    kernels of its route (``repro::lru::tma_`` or ``repro::lru::simt_``),
    both passes, and the launchers must have counted that route."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as kl

    cases = [(case, dtype) for case in LRU_SWEEP
             for dtype in (torch.float32, torch.bfloat16)]
    cases.append((LRU_MAIN, torch.float32))
    inputs = {(case, dtype): lru_inputs(gen, *case, dtype, True)
              for case, dtype in cases}

    def run(key):
        a, x, g, h0 = inputs[key]
        return lambda: ops.lru_scan_bwd(a, ops.lru_scan_fwd(a, x, h0), g, h0)

    kl.reset_route_launches()
    names = kernel_names({key: run(key) for key in inputs})
    want = {"tma": 0, "simt": 0}
    routes = {}
    for (case, dtype), ran in names.items():
        route = lru_route(case[2], dtype)
        want[route] += 2
        short = {short_kernel_name(n).split("<")[0] for n in ran
                 if "repro::lru::" in n}
        require(short == {f"{route}_fwd_kernel", f"{route}_bwd_kernel"},
                f"K4 {case} {dtype}: expected the {route} kernels, ran {ran}")
        routes[f"{case} {str(dtype).split('.')[-1]}"] = route
    # a trace taken again (traced_calls) runs every call again
    runs = kl.ROUTE_LAUNCHES["tma"] // max(want["tma"], 1)
    require(runs >= 1 and kl.ROUTE_LAUNCHES == {r: runs * n
                                                for r, n in want.items()},
            f"K4 route counts {kl.ROUTE_LAUNCHES}, the trace shows {want}")
    del inputs
    return routes


def phase_lru(gen):
    """K4 against its plain versions on both routes, the routes by kernel
    name, and the times at recurrentgemma_2b's shape."""
    from repro_torch.kernels import _build, ops, ref

    for shape in LRU_TMA_SHAPES:
        require(lru_route(shape[2], torch.float32) == "tma"
                and lru_route(shape[2], torch.bfloat16) == "tma",
                f"K4 {shape} must take the TMA route")
    for w in LRU_SIMT_WIDTHS:
        require(lru_route(w, torch.float32) == "simt"
                and lru_route(w, torch.bfloat16) == "simt",
                f"K4 at W {w} must take the SIMT route")
    for row in lru_resources(_build.KERNELS.logs.get("rglru_scan")):
        log("build", **row)
    log("kernels", name="K4 SASS", utmaldg_utmastg=json.dumps(lru_sass()))
    for case in LRU_SWEEP:
        for dtype in (torch.float32, torch.bfloat16):
            for with_h0 in (False, True):
                lru_case(gen, *case, dtype, with_h0)
    log("kernels", name="K4 sweep", shapes=LRU_SWEEP, dtypes="f32,bf16",
        h0="with and without", bitwise=True)
    log("kernels", name="K4 routes (torch.profiler)",
        routes=json.dumps(lru_routes_traced(gen)))

    b, s, w = LRU_MAIN
    lru_case(gen, b, s, w, torch.float32, True)
    a, x, g, h = lru_case(gen, b, s, w, torch.float32, False)
    n, nb = a.numel(), a.numel() * 4
    work = {  # (bytes, FLOP): inputs read once, outputs written once
        "lru_scan_fwd": (3 * nb, 2 * n),
        "lru_scan_bwd": (5 * nb + b * w * 4, 3 * n + b * w),
    }
    calls = {"lru_scan_fwd": (lambda: ops.lru_scan_fwd(a, x),
                              lambda: ref.lru_scan_ref(a, x)),
             "lru_scan_bwd": (lambda: ops.lru_scan_bwd(a, h, g),
                              lambda: ref.lru_scan_bwd_ref(a, h, g))}
    results = {}
    for name, (nbytes, flop) in work.items():
        kernel, plain = calls[name]
        b_ms, by = bound(nbytes, flop)
        results[name] = dict(
            err=0.0, ms=time_ms(kernel),
            plain_ms=time_ms(plain, warmup=1, iters=LRU_PLAIN_RUNS),
            library_ms=None, bound_ms=b_ms, bound_by=by,
            source=LRU_SOURCE, replaces=LRU_REPLACES[name],
            route_detail="TMA rings (cp.async.bulk.tensor, mbarriers), "
            "32 chains a block; SIMT for unaligned widths")
        log("kernels", name=name, shape=LRU_MAIN, dtype="float32",
            bitwise=True, route="tma",
            ms=f"{results[name]['ms']:.4f}",
            plain_ms=f"{results[name]['plain_ms']:.4f}",
            plain_runs=LRU_PLAIN_RUNS, bound_ms=f"{b_ms:.4f}", bound_by=by,
            bytes=nbytes)
    # each pass's CUDA kernels from one trace
    traced = {name: kernel for name, (kernel, _) in calls.items()}
    for name, by_kernel in kernel_split(traced).items():
        kernel_ms = sum(by_kernel.values())
        ran = {short_kernel_name(k) for k in by_kernel}
        want = {name.replace("lru_scan_", "tma_") + "_kernel<float>"}
        require(ran == want, f"{name} ran the kernels {sorted(ran)}, "
                f"expected {sorted(want)}")
        results[name]["split_ms"] = {short_kernel_name(k): ms
                                     for k, ms in by_kernel.items()}
        log("kernels", name=f"{name} split", shape=LRU_MAIN,
            kernel_ms=f"{kernel_ms:.4f}",
            tb_per_s=f"{work[name][0] / kernel_ms / 1e9:.3f}",
            bound_share=f"{results[name]['bound_ms'] / kernel_ms:.3f}",
            kernels=json.dumps({
                short_kernel_name(k): f"{ms:.4f} ms ({ms / kernel_ms:.1%})"
                for k, ms in by_kernel.items()}))
    for name, (kernel, _) in calls.items():
        # the host's launch path: back-to-back calls queue on the card
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            kernel()
        host_us = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
        log("kernels", name=f"{name} host", calls=50,
            host_us_per_call=f"{host_us:.1f}")
    del a, x, g, h
    torch.cuda.empty_cache()
    return results


# K5: the WKV6 recurrence at rwkv6_3b's shape (batch 1, seq 4096, 40 heads
# of 64, f32 as the model calls it), and a sweep: head dims 16 and 32,
# ragged S, batch 2. Each under the model's decay law and the reference
# test's mild one.
WKV_MAIN = (1, 4096, 40, 64)
WKV_SWEEP = ((2, 1000, 2, 32), (2, 37, 3, 16), (1, 300, 2, 64),
             (2, 129, 3, 64))
WKV_PLAIN_RUNS = 3
WKV_SOURCE = "src/repro_torch/kernels/csrc/wkv6.cu"
WKV_REPLACES = {"wkv6_fwd": "src/repro/kernels/wkv6.py:73",
                # no TPU backward: the reference differentiates its
                # chunked jnp form with XLA
                "wkv6_bwd": "src/repro/models/rwkv.py:142"}
# the CUDA kernels each wrapper launches (csrc/wkv6.cu): per-chunk terms,
# the elementwise scan over the chunk states, the per-chunk output or
# gradients (and du's fixed-order sum)
WKV_KERNELS = {"wkv6_fwd": {"state_kernel", "scan_kernel", "out_kernel"},
               "wkv6_bwd": {"xterm_kernel", "scan_kernel", "grad_kernel",
                            "du_sum_kernel"}}
TF32_TC_OPS_PER_S = 495e12  # H100 SXM TF32 tensor cores, dense


def wkv_inputs(gen, b, s, h, n, law):
    """r, k, v, the output gradient and u (x 0.5) standard normal; logw as
    the model draws it (``-exp(w0 + lora)``, w0 ~ N(0, 0.5) per channel as
    ``rwkv.py:47``, lora 0.3 N(0, 1)), whose cumulative log-decay passes
    -88 inside a 64-step chunk, or mild (``-exp(0.5 N(0, 1))``, the
    reference's kernel test)."""
    dev = torch.device("cuda")
    r, k, v, do = (torch.randn((b, s, h, n), generator=gen, device=dev)
                   for _ in range(4))
    if law == "model":
        w0 = 0.5 * torch.randn((h, n), generator=gen, device=dev)
        lw = -torch.exp(w0 + 0.3 * torch.randn((b, s, h, n), generator=gen,
                                               device=dev))
    else:
        lw = -torch.exp(0.5 * torch.randn((b, s, h, n), generator=gen,
                                          device=dev))
    u = 0.5 * torch.randn((h, n), generator=gen, device=dev)
    return r, k, v, lw, u, do


def wkv_case(gen, b, s, h, n, law):
    """K5 forward against the sequential plain version (rtol = atol = 1e-4,
    the reference's WKV tolerance; chunk states within 1e-4 of their
    largest magnitude) and the backward, given the plain chunk states,
    against the plain reverse pass (1e-4 of each gradient's largest
    magnitude); every output finite. Returns the inputs, the plain states
    and the errors."""
    from repro_torch.kernels import ops, ref

    r, k, v, lw, u, do = wkv_inputs(gen, b, s, h, n, law)
    what = f"K5 {(b, s, h, n)} {law} decays"
    out, states, final = ops.wkv6_fwd(r, k, v, lw, u)
    r_out, r_states, r_final = ref.wkv6_fwd_ref(r, k, v, lw, u)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(out).all()), f"{what}: non-finite output")
    require(float((final - r_final).abs().max())
            <= 1e-4 * max(float(r_final.abs().max()), 1.0),
            f"{what}: final state off")
    errs = {"out": check_close(f"{what} out", out, r_out, 1e-4)}
    # the largest |out - plain| / (1e-4 + 1e-4 |plain|): 1 is the gate
    errs["out_of_gate"] = float(((out.double() - r_out.double()).abs() / (
        1e-4 + 1e-4 * r_out.double().abs())).max())
    errs["states"] = float((states - r_states).abs().max())
    require(errs["states"] <= 1e-4 * max(float(r_states.abs().max()), 1.0),
            f"{what}: states off by {errs['states']}")
    got = ops.wkv6_bwd(r, k, v, lw, u, r_states, do)
    want = ref.wkv6_bwd_ref(r, k, v, lw, u, do)
    torch.cuda.synchronize()
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, want):
        require(bool(torch.isfinite(g).all()), f"{what}: non-finite {name}")
        errs[name] = check_grad(f"{what} {name}", g, w, torch.float32)
        errs["grads_of_gate"] = max(errs.get("grads_of_gate", 0.0), errs[name] / (
            1e-4 * max(float(w.double().abs().max()), 1e-30)))
    return (r, k, v, lw, u, do, r_states), errs


def short_kernel_name(name: str) -> str:
    """``void ns::kernel<64>(float const*, ...)`` -> ``kernel<64>``."""
    import re

    m = re.search(r"(\w+(?:<[^()]*>)?)\(", name)
    return m.group(1) if m else name


def wkv_work(b, s, h, n):
    """(bytes, FLOP) of each K5 kernel at (B, S, H, N): each input of the
    function read once and each output written once (the forward reads r,
    k, v, logw and u and writes o; the backward reads those and do and
    writes dr, dk, dv, dlogw and du). The chunk states that the forward
    writes and the backward reads are this port's choice for its backward,
    not part of the function, so the bound leaves them out
    (:func:`wkv_state_bytes`). FLOP per (b, h) and chunk of L steps, the
    chunked form's products: forward 2 L^2 N (scores and their product
    with v) + 4 L N^2 (the readout of S and its update); backward
    5 L^2 N + 8 L N^2."""
    nb = b * s * h * n * 4
    nc = -(-s // 64)
    lens = [min(64, s - 64 * c) for c in range(nc)]
    fwd = b * h * sum(2 * L * L * n + 4 * L * n * n for L in lens)
    bwd = b * h * sum(5 * L * L * n + 8 * L * n * n for L in lens)
    return {"wkv6_fwd": (4 * nb + h * n * 4 + nb, fwd),
            "wkv6_bwd": (5 * nb + h * n * 4 + 4 * nb + h * n * 4, bwd)}


def wkv_state_bytes(b, s, h, n):
    """Bytes of the chunk states (B, H, ceil(S / 64), N, N) f32 that the K5
    forward writes beyond the function's output, and the backward reads."""
    return b * h * -(-s // 64) * n * n * 4


def wkv_sass() -> dict:
    """{kernel<N>: number of TF32 tensor-core instructions} in the SASS of
    the K5 library (``cuobjdump -sass``, beside nvcc): each chunk kernel
    must run its products as ``HMMA.1688.F32.TF32`` and the scans and the du
    sum none."""
    import re

    from repro_torch import compat
    from repro_torch.kernels import _build

    tool = Path(compat.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_build.KERNELS.path("wkv6"))],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*wkv\d+(\w+?_kernel)(?:IL[ib](\d+)E)?", line)
        if m:
            name = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
            counts[name] = 0
        elif name and re.search(r"\bHMMA\.1688\.F32\.TF32\b", line):
            counts[name] += 1
    for kernel, n in counts.items():
        chunk = kernel.split("<")[0] in ("state_kernel", "out_kernel",
                                         "xterm_kernel", "grad_kernel")
        require(n > 0 if chunk else n == 0,
                f"{kernel}: {n} TF32 HMMA instructions in its SASS")
    require(len(counts) == 15, f"K5 SASS holds the kernels {sorted(counts)}")
    return counts


def wkv_occupancy() -> dict:
    """{N: blocks an SM holds of state, out, xterm and grad kernels}; the
    chunk kernels at N = 64 must fit two."""
    import ctypes

    from repro_torch.kernels import _build

    lib = _build.KERNELS.library("wkv6")
    found = {}
    for n in (16, 32, 64):
        blocks = (ctypes.c_int * 4)()
        require(lib.repro_wkv6_occupancy(n, blocks) == 0, f"occupancy N={n}")
        found[f"N{n}"] = dict(zip(("state", "out", "xterm", "grad"), blocks))
    require(min(found["N64"].values()) >= 2,
            f"K5 chunk kernels at N = 64 hold {found['N64']} blocks an SM")
    return {k: json.dumps(v) for k, v in found.items()}


def phase_wkv(gen):
    """K5 against its plain versions, and its times at rwkv6_3b's shape."""
    from repro_torch.kernels import ops, ref

    log("kernels", name="K5 SASS", tf32_hmma=json.dumps(wkv_sass()))
    log("kernels", name="K5 blocks an SM holds", **wkv_occupancy())
    for case in WKV_SWEEP:
        for law in ("model", "mild"):
            _, errs = wkv_case(gen, *case, law)
            log("kernels", name="K5 sweep", shape=case, decays=law,
                errs=json.dumps({k: f"{v:.3e}" for k, v in errs.items()}))
    (r, k, v, lw, u, do, states), errs = wkv_case(gen, *WKV_MAIN, "mild")
    log("kernels", name="K5 main", shape=WKV_MAIN, decays="mild",
        errs=json.dumps({k: f"{v:.3e}" for k, v in errs.items()}))
    (r, k, v, lw, u, do, states), errs = wkv_case(gen, *WKV_MAIN, "model")
    b, s, h, n = WKV_MAIN  # the share of (chunk, channel) pairs whose
    # in-chunk log-decay passes -88.7, where e^{-lcw} leaves f32's range
    chunk_sums = lw.double().reshape(b, s // 64, 64, h, n).sum(dim=2)
    over = float((-chunk_sums > 88.7).double().mean())
    log("kernels", name="K5 main", shape=WKV_MAIN, decays="model",
        chunk_ends_past_88=f"{over:.3f}",
        errs=json.dumps({k: f"{v:.3e}" for k, v in errs.items()}))
    errs_by = {"wkv6_fwd": max(errs["out"], errs["states"]),
               "wkv6_bwd": max(errs[g] for g in ("dr", "dk", "dv", "dlogw",
                                                 "du"))}
    calls = {"wkv6_fwd": (lambda: ops.wkv6_fwd(r, k, v, lw, u),
                          lambda: ref.wkv6_fwd_ref(r, k, v, lw, u)),
             "wkv6_bwd": (lambda: ops.wkv6_bwd(r, k, v, lw, u, states, do),
                          lambda: ref.wkv6_bwd_ref(r, k, v, lw, u, do))}
    results = {}
    for name, (nbytes, flop) in wkv_work(*WKV_MAIN).items():
        kernel, plain = calls[name]
        # the products run on TF32 tensor cores in three passes (3xTF32):
        # the route's bound is its bytes or three times its FLOP at that
        # rate; the f32 SIMT bound of the same work is logged beside it
        t_bytes = nbytes / peaks().HBM_BW * 1e3
        t_ops = 3 * flop / TF32_TC_OPS_PER_S * 1e3
        b_ms, by = ((t_bytes, "bytes") if t_bytes >= t_ops
                    else (t_ops, "operations"))
        results[name] = dict(
            err=errs_by[name], ms=time_ms(kernel),
            plain_ms=time_ms(plain, warmup=1, iters=WKV_PLAIN_RUNS),
            library_ms=None, bound_ms=b_ms, bound_by=by,
            source=WKV_SOURCE, replaces=WKV_REPLACES[name])
        log("kernels", name=name, shape=WKV_MAIN, dtype="float32",
            ms=f"{results[name]['ms']:.4f}",
            plain_ms=f"{results[name]['plain_ms']:.4f}",
            plain_runs=WKV_PLAIN_RUNS, bound_ms=f"{b_ms:.4f}", bound_by=by,
            bytes=nbytes, flop=flop, err=f"{errs_by[name]:.3e}",
            state_bytes_beyond_bound=wkv_state_bytes(*WKV_MAIN))
        log("kernels", name=name, route="tensor cores (3xTF32 mma.sync)",
            bound_ms_bytes=f"{t_bytes:.4f}", bytes_rate="HBM3, 3.35 TB/s",
            bound_ms_tf32x3=f"{t_ops:.4f}",
            ops_rate="3 x FLOP at TF32 tensor cores, 495 TFLOP/s",
            bound_ms_f32_simt=f"{bound(nbytes, flop)[0]:.4f}",
            f32_simt_rate="f32 outside the tensor cores, 67 TFLOP/s")
    split = kernel_split({name: kernel for name, (kernel, _) in calls.items()})
    for name, by_kernel in split.items():
        traced = sum(by_kernel.values())
        results[name]["split_ms"] = {short_kernel_name(k): ms
                                     for k, ms in by_kernel.items()}
        log("kernels", name=f"{name} split", shape=WKV_MAIN,
            traced_ms=f"{traced:.4f}", kernels=json.dumps({
                short_kernel_name(k): f"{ms:.4f} ms ({ms / traced:.1%})"
                for k, ms in by_kernel.items()}))
        ran = {short_kernel_name(k).split("<")[0] for k in by_kernel}
        require(ran == WKV_KERNELS[name],
                f"{name} ran the kernels {sorted(ran)}, expected "
                f"{sorted(WKV_KERNELS[name])}")
    del r, k, v, lw, u, do, states
    torch.cuda.empty_cache()
    return results


def flat_args(**over):
    base = dict(arch="lm_350m", reduced=False, algorithm="local_sgd", rounds=3,
                cohort=4, local_steps=2, batch=4, seq=512, client_lr=0.05,
                compression="int8", stragglers=False,
                straggler_deadline_pct=90.0, log_every=1, seed=0,
                device="cuda", ckpt_dir=None, ckpt_every=20, fail_at=[])
    base.update(over)
    return argparse.Namespace(**base)


def require_flash_launches(counts: dict, args, layers: int) -> None:
    """Every layer of every client step ran the K2 forward twice (once
    more in the checkpoint recompute) and each backward kernel once, each
    launch on its route; a bf16 model at head dim 64 or 128 on the wgmma
    forward and bwd_dkdv (:func:`require_flash_entries`)."""
    from repro_torch.models import registry

    steps = args.rounds * args.cohort * args.local_steps * layers
    require(counts["flash_attention_fwd"] >= 2 * steps
            and counts["flash_attention_bwd_dq"] >= steps
            and counts["flash_attention_bwd_dkdv"] >= steps,
            f"K2 launched {counts}, need fwd >= {2 * steps}, each bwd >= {steps}")
    require_flash_entries(f"K2 of {args.arch}", wgmma=layers > 0
                          and wgmma_model(registry.get_config(args.arch)),
                          decode=False)


def wgmma_model(cfg) -> bool:
    """A model whose K2 calls take the wgmma forward, bwd_dq and
    bwd_dkdv."""
    return cfg.head_dim in WG_HEAD_DIMS and cfg.torch_dtype == torch.bfloat16


def require_lru_launches(counts: dict, args, layers: int) -> None:
    """Every recurrent layer of every client step ran the K4 forward twice
    (once more in the checkpoint recompute) and its backward once, and
    every K4 launch took the TMA route."""
    from repro_torch.kernels import rglru_scan as kl

    steps = args.rounds * args.cohort * args.local_steps * layers
    require(counts["lru_scan_fwd"] >= 2 * steps
            and counts["lru_scan_bwd"] >= steps,
            f"K4 launched {counts}, need fwd >= {2 * steps}, bwd >= {steps}")
    launched = counts["lru_scan_fwd"] + counts["lru_scan_bwd"]
    require(kl.ROUTE_LAUNCHES == {"tma": launched, "simt": 0},
            f"K4 launches by route {kl.ROUTE_LAUNCHES}: all {launched} must "
            f"take the TMA route")


def require_wkv_launches(counts: dict, args, layers: int) -> None:
    """Every rwkv layer of every client step ran the K5 forward twice (once
    more in the checkpoint recompute) and its backward once."""
    steps = args.rounds * args.cohort * args.local_steps * layers
    require(counts["wkv6_fwd"] >= 2 * steps and counts["wkv6_bwd"] >= steps,
            f"K5 launched {counts}, need fwd >= {2 * steps}, bwd >= {steps}")


def model_flop(cfg, args, n_params: int) -> float:
    """Model FLOP of one round, without the remat recompute: 6 x active
    params x tokens (an MoE layer's routed experts only: ``n_params`` less
    each layer's unrouted experts, ``layer_params - active_layer_params``),
    plus 12 x hd x query heads per visible (q, k) pair of every attention
    layer and sequence (forward 4 hd, backward 8 hd), plus the WKV's own 12
    x N^2 x heads per token of every rwkv layer (the state update and
    readout: forward 4 N^2, backward 8 N^2)."""
    from repro_torch.models import blocks, rwkv

    tokens = args.cohort * args.local_steps * args.batch * args.seq
    seqs = args.cohort * args.local_steps * args.batch
    window = cfg.window_size if cfg.attention == "local" else 0
    pairs = visible_pairs(args.seq, args.seq, True, window)
    kinds = blocks.layer_kinds(cfg)
    active = n_params - kinds.count("attention") * (
        cfg.layer_params() - cfg.active_layer_params())
    wkv = 12.0 * cfg.rwkv_head_dim ** 2 * rwkv.num_heads(cfg) * tokens
    return (6.0 * active * tokens
            + 12.0 * cfg.head_dim * cfg.num_heads * pairs
            * kinds.count("attention") * seqs
            + wkv * kinds.count("rwkv"))


def with_biases(params: dict, seed: int) -> dict:
    """``params`` with every qkv bias (zeros at init) drawn as 0.5 x N(0, 1),
    in place: zero biases would show nothing of the bias path."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    for name, t in params.items():
        if name.rsplit(".", 1)[-1] in ("bq", "bk", "bv"):
            t.copy_(0.5 * torch.randn(t.shape, generator=gen, device="cuda"))
    return params


def model_as(cfg, biases: bool = False):
    """``launch.train`` builds its model from ``registry.get_config(arch)``
    and ``registry.init_params``: have it build ``cfg`` (a full-width
    config at a cut depth) and, with ``biases``, draw its qkv biases."""
    import contextlib
    from unittest import mock

    from repro_torch.models import registry

    init = registry.init_params

    def init_params(c, *, seed=0, device="cuda"):
        params = init(c, seed=seed, device=device)
        return with_biases(params, seed) if biases else params

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(registry, "get_config",
                                          lambda arch: cfg))
    stack.enter_context(mock.patch.object(registry, "init_params",
                                          init_params))
    return stack


# phase name -> (cfg, args, round seconds, model_utilization) of every
# round phase_train ran, for [cost]
ROUNDS: dict = {}
COST_ROUNDS = ("flat", "long", "hybrid", "ssm", "dense configs")


def phase_train(phase: str, layers: int = 0, biases: bool = False, **over):
    """Flat rounds of a full-width model through ``launch.train``: lm_350m
    with int8 deltas, or (``arch``) another architecture, at ``layers`` of
    its depth when given, with its qkv biases drawn (``biases``)."""
    import contextlib
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import blocks, registry

    args = flat_args(**over)
    cfg = registry.get_config(args.arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with (model_as(cfg, biases) if layers or biases
          else contextlib.nullcontext()):
        result = train.train(args)
    summary, params, losses, seconds = (result.summary, result.params,
                                        result.losses, result.seconds)
    del result
    counts = ops.launch_counts()
    require(all(math.isfinite(v) for v in losses), f"non-finite losses {losses}")
    if args.compression == "int8":
        need = args.rounds * args.cohort
        require(counts["quantize"] >= need and counts["dequantize"] >= need,
                f"int8 kernels launched {counts}, need >= {need} each")
    kinds = blocks.layer_kinds(cfg)
    require_flash_launches(counts, args, kinds.count("attention"))
    if "recurrent" in kinds:
        require_lru_launches(counts, args, kinds.count("recurrent"))
    if "rwkv" in kinds:
        require_wkv_launches(counts, args, kinds.count("rwkv"))
    n_params = sum(p.numel() for p in params.values())
    tokens = args.cohort * args.local_steps * args.batch * args.seq
    extra = {}
    if args.arch != "lm_350m":
        flop = model_flop(cfg, args, n_params)
        extra = dict(model_flop_per_round=f"{flop:.4e}", model_utilization=[
            f"{flop / v / peaks().PEAK_FLOPS:.4f}" for v in seconds])
    ROUNDS[phase] = dict(cfg=cfg, args=args, seconds=list(seconds),
                         model_utilization=extra.get("model_utilization"))
    log(phase, arch=args.arch, layers=cfg.num_layers, params=n_params,
        seq=args.seq, tokens_per_round=tokens,
        losses=[round(v, 5) for v in losses],
        round_s=[round(v, 3) for v in seconds],
        tokens_per_s=[round(tokens / v, 1) for v in seconds], **extra,
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        launches=json.dumps(counts))
    print(json.dumps(summary), flush=True)
    del params
    # a round's closures hold tensors in reference cycles; collect them, or
    # the segments they pin fragment the next phase's memory
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_cost(names=COST_ROUNDS) -> dict:
    """[cost]: the port's cost model (``repro_torch.launch.analytic``, H100
    constants) against the card, with no new round.

    (a) For each round the smoke timed (``names``): the analytic bound of
    one round on one card (``analytic.round_roofline``: a client step's
    ``flops_cell`` and ``bytes_cell`` on a mesh of one chip, times cohort x
    local steps), each measured round's seconds over it, and the analytic
    model-FLOP utilization (6 x active params x tokens over the round's
    seconds at 989 TFLOP/s) beside the smoke's ``model_utilization``.

    (b) One full-width lm_350m client train step at the [flat] round's B 4
    x S 512 (its loss and gradients, remat as configured) under
    ``hlo_cost.count_flops``: the counted FLOPs over ``flops_cell`` within
    the reference's band [0.65, 1.5] (``tests/test_roofline.py``), and each
    K2 op's count equal to its launches times the call's FLOP
    (:func:`flash_work`). The step runs under the counter's dispatch mode,
    so its time is not a timing and is not reported."""
    from repro_torch.kernels import ops
    from repro_torch.launch import analytic, hlo_cost
    from repro_torch.models import registry

    t0 = time.perf_counter()
    out = {}
    for name in names:
        r = ROUNDS[name]
        cfg, args = r["cfg"], r["args"]
        rl = analytic.round_roofline(cfg, args.batch, args.seq,
                                     args.cohort * args.local_steps)
        bound_by = "operations" if rl["compute_s"] >= rl["memory_s"] \
            else "bytes"
        out[name] = dict(
            arch=args.arch, bound_s=rl["bound_s"], bound_by=bound_by,
            round_s=r["seconds"],
            over_bound=[v / rl["bound_s"] for v in r["seconds"]],
            mfu=[rl["model_flops"] / (v * hlo_cost.PEAK_FLOPS)
                 for v in r["seconds"]],
            smoke_model_utilization=r["model_utilization"])
        log("cost", round=name, arch=args.arch,
            bound_s=f"{rl['bound_s']:.4f}", bound_by=bound_by,
            compute_s=f"{rl['compute_s']:.4f}",
            memory_s=f"{rl['memory_s']:.4f}",
            round_s=[round(v, 3) for v in r["seconds"]],
            over_bound=[f"{v:.2f}" for v in out[name]["over_bound"]],
            analytic_mfu=[f"{v:.4f}" for v in out[name]["mfu"]],
            smoke_model_utilization=r["model_utilization"])

    cfg = registry.get_config("lm_350m")
    args = flat_args()
    params = registry.init_params(cfg, seed=args.seed, device="cuda")
    batch = registry.make_batch(cfg, args.batch, args.seq, seed=args.seed,
                                device="cuda")

    def client_step(p):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = registry.loss_fn(cfg, leaves, batch)
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    ops.reset_launches()
    (loss, grads), counted, by_op = hlo_cost.count_flops(client_step, params)
    launches = ops.launch_counts()
    require(math.isfinite(float(loss.detach()))
            and all(bool(torch.isfinite(g).all()) for g in grads),
            "[cost] the counted client step's loss or gradients are not "
            "finite")
    ana = analytic.flops_cell(cfg, "train", args.batch, args.seq)["total"]
    ratio = counted / ana
    require(0.65 <= ratio <= 1.5,
            f"[cost] counted FLOPs {counted} over the analytic {ana} = "
            f"{ratio:.4f}, outside [0.65, 1.5]")
    shape = (args.batch, args.seq, cfg.num_heads, cfg.head_dim)
    q = torch.empty(shape, dtype=cfg.torch_dtype, device="meta")
    k = torch.empty(shape[:2] + (cfg.num_kv_heads, cfg.head_dim),
                    dtype=cfg.torch_dtype, device="meta")
    work = flash_work(q, k, args.batch * cfg.num_heads
                      * visible_pairs(args.seq, args.seq, True, 0))
    k2 = {}
    for name in FLASH_NAMES:
        k2[name] = dict(counted=by_op.get(f"repro.{name}", 0),
                        launches=launches[name], per_call=work[name][1])
        require(launches[name] > 0 and k2[name]["counted"]
                == launches[name] * work[name][1],
                f"[cost] {name}: counted {k2[name]['counted']} FLOP over "
                f"{launches[name]} launches of {work[name][1]}")
    out["step"] = dict(counted=counted, analytic=ana, ratio=ratio, k2=k2,
                       by_op=by_op)
    del params, batch, grads
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log("cost", step="lm_350m client step, B 4 x S 512", counted=counted,
        analytic=f"{ana:.6e}", counted_over_analytic=f"{ratio:.4f}",
        k2=json.dumps(k2), by_op=json.dumps(by_op),
        seconds=f"{seconds:.1f}")
    out["seconds"] = seconds
    return out


def hier_round_fn(cfg, args, pods: int, fused, straggler: bool = False,
                  mesh=None):
    """The pod-hierarchical int8 round (``pods`` pods of ``args.cohort //
    pods`` clients), fused reduce+compress or the generic composition, or
    (``straggler``) the masked round, which compresses per client; on
    ``mesh`` with pods over "pod" and clients over "data"."""
    import functools

    from repro_torch.algorithms import rounds
    from repro_torch.launch import train
    from repro_torch.models import registry

    client_opt, server_opt = train.optimizers(args)
    round_cfg = rounds.LocalSGDConfig(
        partition_size=args.cohort // pods, num_local_steps=args.local_steps,
        grad_clip=1.0, compression="int8", num_pods=pods, fused_reduce=fused,
        straggler_mask=straggler, mesh=mesh,
        partition_axes=None if mesh is None else {"pods": "pod",
                                                  "clients": "data"})
    return rounds.make_hierarchical_local_sgd_round(
        functools.partial(registry.loss_fn, cfg), client_opt, server_opt,
        round_cfg), server_opt


# [hier] and [plan] at 8 of lm_350m's 24 layers: [plan]'s two traces of
# the round take time in proportion to the layers (160-245 s for the
# phase at 24 layers on H100 hosts, PERF.md) and the smoke has a time
# limit, and [plan] prices the wire bytes [hier] measures, so both run
# the same depth
HIER_LAYERS = 8


def hier_config(args):
    import dataclasses

    from repro_torch.models import registry

    return dataclasses.replace(registry.get_config(args.arch),
                               num_layers=HIER_LAYERS)


def phase_hier():
    from repro_torch.data.grouped import CohortSampler, GroupedCorpus
    from repro_torch.kernels import ops
    from repro_torch.models import registry

    args = flat_args(rounds=2)
    cfg = hier_config(args)
    params = registry.init_params(cfg, seed=args.seed, device="cuda")
    fused_fn, server_opt = hier_round_fn(cfg, args, pods=2, fused=True)
    unfused_fn, _ = hier_round_fn(cfg, args, pods=2, fused=False)
    state = server_opt.init(params)
    sampler = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                            cohort_size=args.cohort)

    def data(r):
        d = sampler.round_batch(r, args.local_steps, args.batch, args.seq,
                                device="cuda")
        return {k: d[k].reshape((2, 2) + tuple(d[k].shape[1:]))
                for k in ("tokens", "labels")}

    ops.reset_launches()
    losses, seconds, states = [], [], [(params, state)]
    for r in range(args.rounds):
        t0 = time.perf_counter()
        params, state, metrics = fused_fn(params, state, data(r))
        losses.append(float(metrics["loss"]))
        seconds.append(time.perf_counter() - t0)
        states.append((params, state))
    counts = ops.launch_counts()
    require(all(math.isfinite(v) for v in losses), f"non-finite losses {losses}")
    require(counts["reduce_compress_roundtrip"] >= args.rounds,
            f"fused kernel launched {counts}, need >= {args.rounds}")
    require_flash_launches(counts, args, cfg.num_layers)
    # the last round again from the same state, unfused
    base, base_state = states[-2]
    t0 = time.perf_counter()
    unfused, _, m_u = unfused_fn(base, base_state, data(args.rounds - 1))
    loss_u = float(m_u["loss"])
    unfused_s = time.perf_counter() - t0
    # The step of a row of the applied update (the mean of the two pods'
    # quantized partials) stands in for the partials' own steps; both forms
    # quantize the same rows, so they normally agree bitwise.
    steps = quant_steps({k: params[k].float() - base[k].float() for k in params})
    worst, equal = agree_within_step(params, unfused, steps, rel=2.0 ** -7)
    require(worst <= 1.0, f"fused vs unfused beyond one int8 step: {worst}")
    require(abs(loss_u - losses[-1]) <= 1e-5 * abs(losses[-1]),
            f"loss fused {losses[-1]} vs unfused {loss_u}")
    log("hier", losses=[round(v, 5) for v in losses],
        round_s=[round(v, 3) for v in seconds], unfused_s=round(unfused_s, 3),
        fused_vs_unfused_worst=f"{worst:.4f}", equal_fraction=f"{equal:.6f}",
        launches=json.dumps(counts))
    del unfused
    torch.cuda.empty_cache()
    wire_counts, payload = phase_wire(cfg, args, base, base_state,
                                      data(args.rounds - 1), params,
                                      server_opt)
    del states, base, params
    torch.cuda.empty_cache()
    return counts, wire_counts, payload


def phase_wire(cfg, args, base, base_state, batch, new_params, server_opt):
    """The [hier] wire step: the last fused round's stacked client deltas (2
    pods x 2 clients), rebuilt from the state it started from with the
    round's own client update through ``map_fn``, flat-packed as the round
    packs them, then K3a (each pod's int8 payload) and K3c (the cross-pod
    mean of the payloads), as a runtime with a slow cross-pod link would run
    them on each side of it. K3a's payload must be bitwise to its plain
    version and to K3b's, and its bytes those of ``cross_pod_bytes``; K3c
    must be bitwise to its plain version and within P 2^-23 mean_p
    |q_p s_p| per element (the FMA difference of ROADMAP.md R6) of the
    round's cross-pod mean, ``reduce_mean@pods`` of K3b's roundtrip
    partials. That mean, applied by the server optimizer, must give the
    round's new params within one int8 step (the rebuilt deltas are the
    round's). Returns the launches of K3a and K3c in this step and the
    payload's bytes."""
    import functools

    from repro_torch import core as drjax
    from repro_torch.algorithms import rounds
    from repro_torch.compression import api as compression
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import reduce_compress as krc
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.optim import apply_updates

    pods, per = 2, args.cohort // 2
    client_opt, _ = train.optimizers(args)
    client = rounds._make_client_update(
        functools.partial(registry.loss_fn, cfg), client_opt,
        rounds.LocalSGDConfig(partition_size=per,
                              num_local_steps=args.local_steps, grad_clip=1.0))

    @drjax.program(placements={"pods": pods, "clients": per})
    def deltas_of(global_params, round_data):
        params_b = drjax.broadcast(global_params)
        return drjax.map_fn(client, (params_b, round_data))[0]

    @drjax.program(placements={"pods": pods, "clients": per})
    def cross_pod_mean(partials):
        return drjax.reduce_mean(partials, placement="pods")

    with torch.no_grad():
        bufs, spec = compression.flat_pack(deltas_of(base, batch), lead_ndim=2)
    require(list(bufs) == ["float32"], f"packed dtypes {list(bufs)}")
    buf = bufs["float32"]
    rows = buf.shape[-2]
    ops.reset_launches()
    t0 = time.perf_counter()
    q, s = ops.reduce_compress(buf)
    mean = ops.dequant_accumulate(q, s)
    torch.cuda.synchronize()
    wire_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    require(counts["reduce_compress"] == 1 and counts["dequant_accumulate"] == 1,
            f"wire step launched {counts}")
    require_equal((q, s), ref.reduce_compress_ref(buf), "wire reduce_compress")
    require_equal((mean,), (ref.dequant_accumulate_ref(q, s),),
                  "wire dequant_accumulate")
    back, qb, sb = krc.reduce_compress_roundtrip(buf)
    require_equal((q, s), (qb, sb), "wire payload vs K3b's")
    del bufs, buf, qb, sb
    wire = drjax.cross_pod_bytes(rows * 1024, n=args.cohort,
                                 num_supergroups=pods, compress="int8")
    payload = q.numel() + 4 * s.numel()
    require(payload == wire["hierarchical_bytes"],
            f"payload {payload} B != cross_pod_bytes {wire['hierarchical_bytes']}")
    pod_mean = cross_pod_mean(back)
    del back
    limit = pods * 2.0 ** -23 * (q.to(torch.float32) * s).abs().mean(dim=0)
    diff = (mean - pod_mean).abs()
    excess = float((diff - limit).max())
    require(excess <= 0, f"K3c vs the round's cross-pod mean beyond the R6 "
            f"bound by {excess} (max abs diff {float(diff.max())})")
    worst_r6 = float((diff / limit.clamp_min(1e-30)).max())
    equal_k3c = float((mean == pod_mean).double().mean())
    del diff, limit, mean
    applied = compression.flat_unpack({"float32": pod_mean}, spec, lead_ndim=0)
    updates, _ = server_opt.update(applied, base_state, base)
    rebuilt = apply_updates(base, updates)
    del updates, applied
    steps = quant_steps({k: new_params[k].float() - base[k].float()
                         for k in new_params})
    worst, equal = agree_within_step(new_params, rebuilt, steps, rel=2.0 ** -7)
    require(worst <= 1.0, f"rebuilt round vs the round beyond one int8 step: "
            f"{worst}")
    log("hier", step="wire", packed_rows=rows, payload_bytes=payload,
        cross_pod_bytes=wire["hierarchical_bytes"],
        k3a_payload_equals_k3b=True, plain_bitwise=True,
        k3c_vs_pod_mean_worst_over_r6_bound=f"{worst_r6:.4f}",
        k3c_vs_pod_mean_equal_fraction=f"{equal_k3c:.6f}",
        rebuilt_vs_round_worst=f"{worst:.4f}",
        rebuilt_vs_round_equal_fraction=f"{equal:.6f}",
        wire_s=round(wire_s, 4), launches=json.dumps(counts))
    del q, s, pod_mean, rebuilt
    torch.cuda.empty_cache()
    return counts, payload


# The communication skeleton of the pod-hierarchical fused-int8 round:
# tests/test_torch_plan.py pins it, at reduced lm_350m, to the reference's
# plan of the same round.
PLAN_SKELETON = (
    ("COMM", ("BROADCAST@clients", "BROADCAST@pods")),
    "GROUP_COMPUTE",
    ("COMM", ("REDUCE_MEAN@clients[int8]", "REDUCE_MEAN@pods")),
    "SERVER_COMPUTE",
    ("COMM", ("REDUCE_MEAN@clients", "REDUCE_MEAN@pods")),
    "SERVER_COMPUTE",
)


def comm_label(stage) -> str:
    """``BROADCAST@pods``, ``REDUCE_MEAN@clients[int8]``: a communication
    stage's kind (a reduction's op), addressed placement and tag."""
    kind = stage.kind if stage.kind == "BROADCAST" else stage.op.upper()
    tag = f"[{stage.compress}]" if getattr(stage, "compress", None) else ""
    return f"{kind}@{stage.placement}{tag}"


def plan_skeleton(plan) -> tuple:
    """A plan's stages with each maximal run of communication stages as one
    block of the labels it holds (its stage count follows the number of
    parameter leaves, which the two packages differ in; the kinds and
    placements do not)."""
    out = []
    for s in plan.stages:
        if s.kind in ("BROADCAST", "REDUCE"):
            if out and isinstance(out[-1], list):
                out[-1].append(comm_label(s))
            else:
                out.append([comm_label(s)])
        else:
            out.append(s.kind)
    return tuple(("COMM", tuple(sorted(set(e)))) if isinstance(e, list) else e
                 for e in out)


def beam_undefined_names(text: str) -> list:
    """The generated names ``to_beam`` text uses before it defines them
    (the reference test's check, ``tests/test_interpreter_controlflow.py
    :53-72``); the text must also compile."""
    import re

    compile(text, "<to_beam>", "exec")
    pattern = re.compile(r"\b(?:t|o|r|bc|g|s|c|lit|x|undef|i|in_)\d+\b"
                         r"|\b(?:carry|ys)[\d_]+\b|\bnum_iters_[\w]+\b")
    defined, bad = set(), []
    if "undef" in text or "(bug?)" in text:
        bad.append("undef")
    for line in text.splitlines():
        code = line.split("#")[0]
        m = re.match(r"\s*(?:for\s+(\w+)\s+in\b|([A-Za-z_]\w*)\s*=[^=])",
                     code)
        lhs = (m.group(1) or m.group(2)) if m else None
        bad += [t.group(0) for t in pattern.finditer(code)
                if t.group(0) != lhs and t.group(0) not in defined]
        if lhs:
            defined.add(lhs)
    return bad


def graph_constants(gm) -> list:
    """(name, numel) of every tensor constant of a traced graph and of the
    sub-graphs it applies."""
    out = []
    for mod_name, mod in gm.named_modules():
        if not hasattr(mod, "graph"):
            continue
        for node in mod.graph.nodes:
            if node.op == "get_attr":
                val = getattr(mod, node.target)
                if isinstance(val, torch.Tensor):
                    out.append((f"{mod_name}.{node.target}".lstrip("."),
                                val.numel()))
    return out


def graph_nodes(gm) -> int:
    return sum(len(m.graph.nodes) for _, m in gm.named_modules()
               if hasattr(m, "graph"))


def round_depths(params, state, data, data_depth: int) -> list:
    """Lattice depths of a round's flat inputs, declared: params and server
    state at the server, the round data at ``data_depth`` (the depth
    heuristic would misplace a leaf whose leading dim equals a group
    count)."""
    from torch.utils import _pytree as pytree

    return ([0] * len(pytree.tree_leaves((params, state)))
            + [data_depth] * len(pytree.tree_leaves(data)))


def equal_leaves(a, b) -> bool:
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and bool(torch.equal(x, y))
        for x, y in zip(a, b))


def phase_plan(wire_payload: int):
    """[plan]: lm_350m's pod-hierarchical fused-int8 round at full width
    and ``HIER_LAYERS`` layers (the [hier] phase's: 2 pods x 2 clients, seq
    512, batch 4, 2 local steps) traced,
    planned and run by ``run_plan`` bitwise to the direct round with the
    same K2 and K3b launches, then compiled into one CUDA graph whose three
    rounds are bitwise three ``run_plan`` rounds; ``to_beam`` of the round;
    the static analyses (``plan.analyze`` with the carry donated, its comm
    model cross-validated by one round on the card): no error, the DCN stage over the
    packed delta priced at ``wire_payload``, the bytes of K3a's payload
    that the [hier] wire step measured, and a clean donation report of the
    compiled plan; a reduced flat int8 round the same way (K1 in its group
    stage)."""
    from torch.utils import _pytree as pytree

    from repro_torch.core import interpreter as interp
    from repro_torch.data.grouped import CohortSampler, GroupedCorpus
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.runtime import executor

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    args = flat_args(rounds=3)
    cfg = hier_config(args)
    params = registry.init_params(cfg, seed=args.seed, device="cuda")
    round_fn, server_opt = hier_round_fn(cfg, args, pods=2, fused=True)
    state = server_opt.init(params)
    sampler = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                            cohort_size=args.cohort)

    def data(r):
        d = sampler.round_batch(r, args.local_steps, args.batch, args.seq,
                                device="cuda")
        return {k: d[k].reshape((2, 2) + tuple(d[k].shape[1:]))
                for k in ("tokens", "labels")}

    def flat(p, s, d):
        return pytree.tree_leaves((p, s, d))

    n_carry = len(pytree.tree_leaves((params, state)))
    spec = pytree.tree_structure((params, state))

    def carry_of(outs):
        return pytree.tree_unflatten(list(outs[:n_carry]), spec)

    t0 = time.perf_counter()
    gm = interp.trace(round_fn, params, state, data(0))
    trace_s = time.perf_counter() - t0
    consts = graph_constants(gm)
    largest = max((n for _, n in consts), default=0)
    activation = args.batch * args.seq
    require(largest < activation,
            f"trace holds a constant of {largest} elements: {consts}")
    depths = round_depths(params, state, data(0), 2)
    t0 = time.perf_counter()
    plan = interp.build_plan(gm, {"pods": 2, "clients": 2},
                             partitioned_invars=depths)
    plan.check_locality()
    build_s = time.perf_counter() - t0
    skeleton = plan_skeleton(plan)
    require(skeleton == PLAN_SKELETON,
            f"plan skeleton {skeleton} != pinned {PLAN_SKELETON}")
    comm_lines = [ln.strip() for ln in plan.to_text().splitlines()
                  if "BROADCAST" in ln or "REDUCE" in ln]
    kinds = {}
    for s in plan.stages:
        key = (s.kind if s.kind not in ("BROADCAST", "REDUCE")
               else comm_label(s))
        kinds[key] = kinds.get(key, 0) + 1
    log("plan", step="build", trace_s=f"{trace_s:.2f}",
        build_plan_s=f"{build_s:.2f}", nodes=graph_nodes(gm),
        stages=len(plan.stages), stage_kinds=json.dumps(kinds),
        largest_constant=largest, skeleton=json.dumps(skeleton))
    log("plan", step="skeleton", first=comm_lines[0], last=" | ".join(
        comm_lines[-4:]), lines=len(comm_lines))

    # run_plan against the direct round, one round from the same inputs
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = pytree.tree_leaves(round_fn(params, state, data(0)))
    torch.cuda.synchronize()
    direct_first_s = time.perf_counter() - t0
    direct_counts = ops.launch_counts()
    ops.reset_launches()
    oracle = interp.run_plan(plan, *flat(params, state, data(0)))
    plan_counts = ops.launch_counts()
    require(equal_leaves(oracle, direct), "run_plan != the direct round")
    steps = args.cohort * args.local_steps * cfg.num_layers
    want = {"reduce_compress_roundtrip": 1, "flash_attention_fwd": 2 * steps,
            "flash_attention_bwd_dq": steps, "flash_attention_bwd_dkdv": steps}
    require(all(plan_counts[k] == v for k, v in want.items())
            and plan_counts == direct_counts,
            f"launches through the plan {plan_counts}, direct "
            f"{direct_counts}, want {want}")
    del direct, oracle
    peak_run = torch.cuda.max_memory_allocated()

    # three run_plan rounds (the oracle chain) and the direct rounds' times
    po, so = params, state
    oracle_rounds, plan_s = [], []
    for r in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = interp.run_plan(plan, *flat(po, so, data(r)))
        torch.cuda.synchronize()
        plan_s.append(time.perf_counter() - t0)
        oracle_rounds.append(outs)
        po, so = carry_of(outs)
    direct_s, pd, sd = [], params, state
    for r in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pd, sd, _ = round_fn(pd, sd, data(r))
        torch.cuda.synchronize()
        direct_s.append(time.perf_counter() - t0)
    del pd, sd

    # the compiled plan: one CUDA graph, carried state donated
    executor.clear_executor_cache()
    pc = {k: v.clone() for k, v in params.items()}
    sc = pytree.tree_map(lambda t: t.clone(), state)
    t0 = time.perf_counter()
    compiled = plan.compile(device="cuda", donate_argnums=range(n_carry))
    graph_build_s = time.perf_counter() - t0
    ops.reset_launches()
    t0 = time.perf_counter()
    for r in range(3):
        outs = compiled(*flat(pc, sc, data(r)))
        if r == 0:
            torch.cuda.synchronize()
            capture_s = time.perf_counter() - t0
        require(equal_leaves(outs, oracle_rounds[r]),
                f"compiled round {r} != run_plan round {r}")
    # the first calls' warm-up launches: a capture's do not count
    capture_counts = ops.launch_counts()
    require(compiled.trace_count == 1,
            f"trace_count {compiled.trace_count} after 3 rounds")
    ops.reset_launches()
    replay_s = []
    for r in range(3, 6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compiled(*flat(pc, sc, data(r)))
        torch.cuda.synchronize()
        replay_s.append(time.perf_counter() - t0)
    require(sum(ops.launch_counts().values()) == 0,
            f"a replay went through the launch counters: {ops.launch_counts()}")
    del oracle_rounds
    replay_args = flat(pc, sc, data(6))
    names = kernel_names({"replay": lambda: compiled(*replay_args)})["replay"]
    require(any("repro::flash::wg::wg_fwd_kernel" in n for n in names)
            and any("reduce_compress_kernel" in n for n in names),
            f"one replay ran no repro kernel by name: {names[:20]}")
    size = executor.executor_cache_size()
    t0 = time.perf_counter()
    plan2 = interp.build_plan(interp.trace(round_fn, params, state, data(0)),
                              {"pods": 2, "clients": 2},
                              partitioned_invars=depths)
    retrace_s = time.perf_counter() - t0
    compiled2 = plan2.compile(device="cuda", donate_argnums=range(n_carry))
    compiled2(*flat(pc, sc, data(7)))
    require(executor.executor_cache_size() == size
            and compiled2.trace_count == 1
            and compiled2.fingerprint == compiled.fingerprint,
            "a plan built again from a new trace missed the executor cache")
    beam = plan.to_beam()
    bad = beam_undefined_names(beam)
    require(not bad, f"to_beam uses undefined names {bad[:5]}")
    fns = plan.stage_fns()
    analysis = plan_analysis(plan, compiled, n_carry, wire_payload,
                             flat(pc, sc, data(8)))
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median
    log("plan", step="rounds", direct_s=f"{med(direct_s):.4f}",
        run_plan_s=f"{med(plan_s):.4f}", replay_s=f"{med(replay_s):.4f}",
        direct_first_s=f"{direct_first_s:.3f}",
        graph_build_s=f"{graph_build_s:.3f}", capture_s=f"{capture_s:.3f}",
        retrace_and_plan_s=f"{retrace_s:.2f}", trace_count=compiled.trace_count,
        cache_entries=size, units=compiled.num_units,
        stage_units=compiled.num_stage_units,
        launches=json.dumps({k: v for k, v in plan_counts.items() if v}),
        first_calls_launches=json.dumps({k: v for k, v in
                                         capture_counts.items() if v}),
        peak_run_plan_gib=f"{peak_run / 2**30:.2f}",
        peak_gib=f"{peak / 2**30:.2f}")
    log("plan", step="beam", chars=len(beam), stage_fns=len(fns),
        replay_kernels=len(names))
    log("plan", step="analyze", **analysis)
    del compiled, compiled2, plan, plan2, gm, params, state, pc, sc, po, so
    executor.clear_executor_cache()
    torch.cuda.empty_cache()
    reduced = phase_plan_flat_reduced()
    log("plan", seconds=f"{time.perf_counter() - t_phase:.1f}", **reduced,
        card=json.dumps(card_line()))
    return plan_counts


def plan_analysis(plan, compiled, n_carry: int, wire_payload: int,
                  args) -> dict:
    """``plan.analyze`` of the full-size hierarchical round with its carry
    donated and its comm model cross-validated by one ``run_plan`` round
    on ``args`` (each comm stage's bytes a run, the int8 one packed by
    K1a, and its number of runs, held to the model): no error;
    the ``reduce_mean@pods`` stage over the packed int8 delta (the one DCN
    stage in int8+scales) priced at exactly the K3a payload bytes the
    wire step measured; the compiled plan's donation report clean."""
    t0 = time.perf_counter()
    static = plan.analyze(donate_argnums=tuple(range(n_carry)))
    analyze_s = time.perf_counter() - t0
    require(static.ok, f"plan.analyze found errors: {static}")
    t0 = time.perf_counter()
    report = plan.analyze(donate_argnums=tuple(range(n_carry)),
                          cross_validate=True, device="cuda", args=args)
    torch.cuda.synchronize()
    cross_s = time.perf_counter() - t0
    require(report.ok and report.findings == static.findings,
            f"the cross-validation found errors: {report}")
    cost = report.comm_cost
    packed = [c for c in cost.per_stage if c.link == "dcn"
              and c.wire_format == "int8+scales"]
    require(len(packed) == 1 and packed[0].op == "reduce_mean"
            and packed[0].placement == "pods"
            and packed[0].wire_bytes == wire_payload,
            f"DCN int8 stages {[c.to_dict() for c in packed]}, want one "
            f"reduce_mean@pods of {wire_payload} B")
    donation = compiled.donation_report()
    require(not donation.findings, f"donation report: {donation}")
    codes: dict = {}
    for f in report.findings:
        codes[f.code] = codes.get(f.code, 0) + 1
    return dict(analyze_s=f"{analyze_s:.3f}",
                analyze_cross_validated_s=f"{cross_s:.3f}", ok=report.ok,
                codes=json.dumps(codes), dcn_bytes=int(cost.dcn_bytes),
                ici_bytes=int(cost.ici_bytes),
                dcn_packed_stage=packed[0].stage,
                dcn_packed_bytes=int(packed[0].wire_bytes),
                wire_step_payload=wire_payload, comm_stages=len(
                    cost.per_stage), donation_findings=0)


def phase_plan_flat_reduced() -> dict:
    """The reduced flat int8 round: K1a/K1b nodes in its group stage's map
    body, ``run_plan`` bitwise to the direct round, the compiled plan
    bitwise to ``run_plan``."""
    import functools

    from torch.utils import _pytree as pytree

    from repro_torch import optim
    from repro_torch.algorithms import rounds
    from repro_torch.core import interpreter as interp
    from repro_torch.data.grouped import CohortSampler, GroupedCorpus
    from repro_torch.kernels import ops
    from repro_torch.models import registry

    cfg = registry.get_config("lm_350m").reduced()
    params = registry.init_params(cfg, seed=0, device="cuda")
    server = optim.fedavg_momentum(1.0)
    round_fn = rounds.make_local_sgd_round(
        functools.partial(registry.loss_fn, cfg), optim.sgd(0.05), server,
        rounds.LocalSGDConfig(partition_size=4, num_local_steps=2,
                              grad_clip=1.0, compression="int8"))
    state = server.init(params)
    d = CohortSampler(GroupedCorpus(vocab_size=256), cohort_size=4
                      ).round_batch(0, 2, 2, 64, device="cuda")
    data = {k: d[k] for k in ("tokens", "labels")}
    gm = interp.trace(round_fn, params, state, data)
    plan = interp.build_plan(gm, 4, partitioned_invars=round_depths(
        params, state, data, 1))
    body_ops = []
    for s in plan.stages:
        if s.kind == "GROUP_COMPUTE":
            for n in s.nodes:
                for g in interp._subgraphs(n, gm):
                    body_ops += [interp._op_name(m) for m in g.graph.nodes
                                 if m.op == "call_function"]
    require(body_ops.count("quantize") >= 1 and body_ops.count("dequantize") >= 1,
            "the flat int8 round's group stage holds no K1 node")
    flat = pytree.tree_leaves((params, state, data))
    ops.reset_launches()
    direct = pytree.tree_leaves(round_fn(params, state, data))
    direct_counts = ops.launch_counts()
    ops.reset_launches()
    oracle = interp.run_plan(plan, *flat)
    require(equal_leaves(oracle, direct), "reduced flat int8: run_plan != direct")
    counts = ops.launch_counts()
    require(counts == direct_counts and counts["quantize"] >= 4
            and counts["dequantize"] >= 4,
            f"reduced flat int8: K1 launches {counts}, direct {direct_counts}")
    compiled = plan.compile(device="cuda")
    require(equal_leaves(compiled(*flat), oracle),
            "reduced flat int8: compiled != run_plan")
    return {"reduced_flat_k1_nodes": body_ops.count("quantize"),
            "reduced_flat_units": compiled.num_units}


ELASTIC_PODS = (3, 2, 3)  # the [elastic] steps' pod counts
# [elastic] at 6 of lm_350m's 24 layers: its per-client trace takes time
# in proportion to the layers (62 s at 24 on a slow host, PERF.md), and
# the whole smoke must end within 1200 s
ELASTIC_LAYERS = 6


def free_graphs() -> None:
    """Drop the executor's cached programs (their CUDA graphs' memory
    pools and static buffers) before the next phase."""
    import gc

    from repro_torch.runtime import executor

    executor.clear_executor_cache()
    gc.collect()
    torch.cuda.empty_cache()


def relative_worst(a: dict, b: dict) -> float:
    """max over leaves of max |a - b| / max |b|: 0 when bitwise."""
    worst = 0.0
    for k in b:
        x, y = a[k].float(), b[k].float()
        scale = float(y.abs().max())
        worst = max(worst, float((x - y).abs().max()) / max(scale, 1e-30))
    return worst


def phase_elastic():
    """[elastic]: lm_350m at full width and ``ELASTIC_LAYERS`` layers, at
    the [hier] shapes (seq 512, batch 4, 2 local steps, 2 clients per pod,
    bf16 K2 in every layer) through
    ``make_elastic_hierarchical_round``: three steps at 3, 2 and 3 pods,
    each bitwise the direct unfused hierarchical round at that pod count
    from the same state, with one trace of the per-client leg throughout
    and two cross-pod legs at the end. Then one masked step at full width
    and 2 layers (3 pods, one client and one whole pod masked) within 1e-6
    relative of the flat masked round over the same finishers."""
    import dataclasses
    import functools

    from repro_torch.algorithms import rounds
    from repro_torch.data.grouped import CohortSampler, GroupedCorpus
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.runtime.elastic import make_elastic_hierarchical_round

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    args = flat_args()
    per, most = 2, max(ELASTIC_PODS)
    cfg = dataclasses.replace(registry.get_config(args.arch),
                              num_layers=ELASTIC_LAYERS)
    loss_fn = functools.partial(registry.loss_fn, cfg)
    client_opt, server_opt = train.optimizers(args)
    round_cfg = rounds.LocalSGDConfig(partition_size=per,
                                      num_local_steps=args.local_steps,
                                      grad_clip=1.0)
    sampler = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                            cohort_size=most * per)

    def data(r, pods):
        d = sampler.round_batch(r, args.local_steps, args.batch, args.seq,
                                device="cuda")
        return {k: d[k].reshape((most, per) + tuple(d[k].shape[1:]))[:pods]
                for k in ("tokens", "labels")}

    params = registry.init_params(cfg, seed=args.seed, device="cuda")
    state = server_opt.init(params)
    elastic = make_elastic_hierarchical_round(loss_fn, client_opt,
                                              server_opt, round_cfg)
    ops.reset_launches()
    step_s, direct_s, traces = [], [], []
    for r, pods in enumerate(ELASTIC_PODS):
        batch = data(r, pods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_e, s_e, m_e = elastic.step(params, state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if r == 0:
            counts = ops.launch_counts()
        direct_fn = rounds.make_hierarchical_local_sgd_round(
            loss_fn, client_opt, server_opt,
            dataclasses.replace(round_cfg, num_pods=pods))
        t0 = time.perf_counter()
        p_d, s_d, m_d = direct_fn(params, state, batch)
        torch.cuda.synchronize()
        direct_s.append(time.perf_counter() - t0)
        bad = differing_leaves({"p": p_e, "s": s_e, "m": m_e},
                               {"p": p_d, "s": s_d, "m": m_d})
        require(not bad, f"elastic step {r} at {pods} pods != the direct "
                f"hierarchical round: {len(bad)} leaves differ {bad[:6]}")
        traces.append(elastic.client_trace_count)
        params, state = p_e, s_e
        del p_d, s_d, batch
    trace_s = elastic.client_trace_s
    require(traces == [1] * len(ELASTIC_PODS)
            and elastic.cross_compile_count == 2,
            f"client traces {traces}, cross legs "
            f"{elastic.cross_compile_count}, want [1, 1, 1] and 2")
    layers = cfg.num_layers
    require(counts["flash_attention_fwd"] >= per * args.local_steps * layers
            and counts["flash_attention_bwd_dq"] >= per * args.local_steps
            * layers, f"elastic launched {counts}")
    peak = torch.cuda.max_memory_allocated()
    del params, state, elastic, p_e, s_e
    free_graphs()
    masked = elastic_masked(dataclasses.replace(cfg, num_layers=2), args)
    free_graphs()
    log("elastic", pods=list(ELASTIC_PODS), bitwise=True,
        client_traces=traces, cross_legs=2,
        step_s=[f"{v:.3f}" for v in step_s],
        direct_s=[f"{v:.3f}" for v in direct_s],
        client_trace_s=f"{trace_s:.3f}",
        first_step_capture_and_run_s=f"{step_s[0] - trace_s:.3f}",
        peak_gib=f"{peak / 2**30:.2f}",
        launches=json.dumps({k: v for k, v in counts.items() if v}),
        **masked, seconds=f"{time.perf_counter() - t_phase:.1f}",
        card=json.dumps(card_line()))
    return counts


def elastic_masked(cfg, args) -> dict:
    """One straggler-masked elastic step (3 pods x 2 clients, client 1 of
    pod 0 and all of pod 1 masked) against the flat masked round over the
    six clients with the same mask."""
    import functools

    from repro_torch.algorithms import rounds
    from repro_torch.data.grouped import CohortSampler, GroupedCorpus
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.runtime.elastic import make_elastic_hierarchical_round

    loss_fn = functools.partial(registry.loss_fn, cfg)
    client_opt, server_opt = train.optimizers(args)
    params = registry.init_params(cfg, seed=args.seed, device="cuda")
    state = server_opt.init(params)
    elastic = make_elastic_hierarchical_round(
        loss_fn, client_opt, server_opt,
        rounds.LocalSGDConfig(partition_size=2,
                              num_local_steps=args.local_steps,
                              grad_clip=1.0, straggler_mask=True),
        straggler_mask=True)
    flat = rounds.make_local_sgd_round(
        loss_fn, client_opt, server_opt,
        rounds.LocalSGDConfig(partition_size=6,
                              num_local_steps=args.local_steps,
                              grad_clip=1.0, straggler_mask=True))
    d = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                      cohort_size=6).round_batch(0, args.local_steps,
                                                 args.batch, args.seq,
                                                 device="cuda")
    flat_data = {k: d[k] for k in ("tokens", "labels")}
    mask = torch.tensor([[1.0, 0.0], [0.0, 0.0], [1.0, 1.0]], device="cuda")
    t0 = time.perf_counter()
    p_e, _, m_e = elastic.step(params, state, {
        "data": {k: v.reshape((3, 2) + tuple(v.shape[1:]))
                 for k, v in flat_data.items()}, "mask": mask})
    torch.cuda.synchronize()
    masked_s = time.perf_counter() - t0
    p_f, _, m_f = flat(params, state, flat_data, mask.reshape(6))
    worst = relative_worst(p_e, p_f)
    loss_rel = abs(float(m_e["loss"]) - float(m_f["loss"])) / abs(
        float(m_f["loss"]))
    require(worst <= 1e-6 and loss_rel <= 1e-6
            and float(m_e["finishers"]) == 3.0,
            f"masked elastic vs flat masked: params {worst}, loss {loss_rel}, "
            f"finishers {float(m_e['finishers'])}")
    del params, state, p_e, p_f
    torch.cuda.empty_cache()
    return dict(masked_layers=cfg.num_layers,
                masked_params_worst_rel=f"{worst:.3e}",
                masked_loss_rel=f"{loss_rel:.3e}", masked_finishers=3,
                masked_step_s=f"{masked_s:.3f}")


def phase_loop():
    """[loop]: lm_350m at full width with 2 layers, flat int8 rounds of
    cohort 4, 2 rounds through ``make_multi_round``: traced and planned as
    one ``LOOP[scan]`` stage of trip count 2, ``run_plan`` bitwise the
    direct trainer, the compiled plan (carry donated; its body replayed
    once per round) bitwise ``run_plan`` with one build."""
    import dataclasses

    from torch.utils import _pytree as pytree

    from repro_torch.algorithms import rounds
    from repro_torch.core import interpreter as interp
    from repro_torch.data.grouped import CohortSampler, GroupedCorpus
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import registry

    t_phase = time.perf_counter()
    args = flat_args(rounds=2)
    cfg = dataclasses.replace(registry.get_config(args.arch), num_layers=2)
    round_fn, server_opt = train.build_round_fn(cfg, args)
    trainer = rounds.make_multi_round(round_fn, args.rounds)
    params = registry.init_params(cfg, seed=args.seed, device="cuda")
    state = server_opt.init(params)
    sampler = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                            cohort_size=args.cohort)
    batches = [sampler.round_batch(r, args.local_steps, args.batch, args.seq,
                                   device="cuda") for r in range(args.rounds)]
    stacked = {k: torch.stack([b[k] for b in batches])
               for k in ("tokens", "labels")}
    flat = pytree.tree_leaves((params, state, stacked))
    n_carry = len(pytree.tree_leaves((params, state)))
    t0 = time.perf_counter()
    gm = interp.trace(trainer, params, state, stacked)
    plan = interp.build_plan(gm, args.cohort,
                             partitioned_invars=[0] * len(flat))
    trace_s = time.perf_counter() - t0
    loops = [s for s in plan.stages if s.kind == "LOOP"]
    require(len(plan.stages) == 1 and len(loops) == 1
            and loops[0].loop_kind == "scan"
            and loops[0].trip_count == args.rounds,
            f"multi-round plan stages {[s.kind for s in plan.stages]}, want "
            f"one LOOP[scan] of trip count {args.rounds}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = pytree.tree_leaves(trainer(params, state, stacked))
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    ops.reset_launches()
    oracle = interp.run_plan(plan, *flat)
    counts = ops.launch_counts()
    require(equal_leaves(oracle, direct), "run_plan != the direct trainer")
    require(counts["quantize"] >= args.rounds * args.cohort
            and counts["flash_attention_fwd"] >= 2 * args.rounds
            * args.cohort * args.local_steps * cfg.num_layers,
            f"launches through the loop plan {counts}")
    compiled = plan.compile(device="cuda", donate_argnums=range(n_carry))
    require(not compiled.donation_report().errors, "loop donation report")
    carry = [t.clone() for t in flat[:n_carry]]
    t0 = time.perf_counter()
    outs = compiled(*carry, *flat[n_carry:])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    require(equal_leaves(outs, oracle), "compiled loop != run_plan")
    carry = [t.clone() for t in flat[:n_carry]]
    ops.reset_launches()
    t0 = time.perf_counter()
    outs = compiled(*carry, *flat[n_carry:])
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    require(equal_leaves(outs, oracle) and compiled.trace_count == 1
            and sum(ops.launch_counts().values()) == 0,
            f"second compiled call: trace_count {compiled.trace_count}, "
            f"launches {ops.launch_counts()}")
    log("loop", layers=cfg.num_layers, rounds=args.rounds, stages=1,
        trip_count=loops[0].trip_count, bitwise=True,
        trace_and_plan_s=f"{trace_s:.2f}",
        direct_s_per_round=f"{direct_s / args.rounds:.4f}",
        replay_s_per_round=f"{replay_s / args.rounds:.4f}",
        first_call_s=f"{first_s:.3f}", trace_count=compiled.trace_count,
        units=compiled.num_units,
        launches=json.dumps({k: v for k, v in counts.items() if v}),
        seconds=f"{time.perf_counter() - t_phase:.1f}")
    del compiled, plan, gm, params, state, stacked, outs, oracle, direct
    free_graphs()
    return counts


def phase_stragglers():
    """Straggler-masked rounds of full lm_350m: ``launch.train`` with
    ``--stragglers`` (deadline at the 90th percentile of the cohort's
    simulated durations, half the cohort kept), then, from the trained
    state on the last round's data, the round unmasked, with an all-ones
    mask (bitwise the unmasked round: 4 is a power of two), with an
    all-zero mask (params bitwise unchanged, loss 0), and one masked
    hierarchical int8 round (2 pods x 2 clients) that drops a whole pod
    (per-client K1, no K3b)."""
    from torch.utils import _pytree as pytree

    from repro_torch.data.grouped import CohortSampler, GroupedCorpus
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import registry

    args = flat_args(stragglers=True, straggler_deadline_pct=90.0)
    cfg = registry.get_config(args.arch)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    result = train.train(args)
    summary, params, state, losses, seconds, masks = (
        result.summary, result.params, result.server_state, result.losses,
        result.seconds, result.masks)
    del result
    counts = ops.launch_counts()
    require(all(math.isfinite(v) for v in losses), f"non-finite losses {losses}")
    need = args.rounds * args.cohort
    require(counts["quantize"] == need and counts["dequantize"] == need,
            f"masked rounds launched {counts}, need K1a/K1b {need} each")
    require(counts["reduce_compress_roundtrip"] == 0, f"K3b launched {counts}")
    require_flash_launches(counts, args, cfg.num_layers)
    kept = [int(m.sum()) for m in masks]
    require(min(kept) < args.cohort, f"no client dropped in any round: {kept}")
    log("stragglers", deadline_pct=args.straggler_deadline_pct,
        masks=[m.int().tolist() for m in masks],
        losses=[round(v, 5) for v in losses],
        round_s=[round(v, 3) for v in seconds],
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        launches=json.dumps(counts))
    print(json.dumps(summary), flush=True)

    sampler = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                            cohort_size=args.cohort)
    d = sampler.round_batch(args.rounds - 1, args.local_steps, args.batch,
                            args.seq, device="cuda")
    batch = {"tokens": d["tokens"], "labels": d["labels"]}
    round_fn, _ = train.build_round_fn(cfg, args)
    plain, _, m_plain = round_fn(params, state, batch)
    ones, _, m_ones = round_fn(params, state, batch,
                               torch.ones(args.cohort, device="cuda"))
    same = [k for k in plain if torch.equal(plain[k], ones[k])]
    require(len(same) == len(plain)
            and float(m_plain["loss"]) == float(m_ones["loss"]),
            f"all-ones mask != unmasked round: {len(plain) - len(same)} "
            f"leaves differ, loss {float(m_ones['loss'])} vs "
            f"{float(m_plain['loss'])}")
    del plain, ones
    zero, zero_state, m_zero = round_fn(params, state, batch,
                                        torch.zeros(args.cohort, device="cuda"))
    require(all(torch.equal(zero[k], params[k]) for k in params),
            "all-zero mask moved the params")
    require(float(m_zero["loss"]) == 0.0, f"all-zero loss {float(m_zero['loss'])}")
    require(all(bool(torch.isfinite(v).all())
                for v in pytree.tree_leaves(zero_state)),
            "all-zero mask: non-finite server state")
    del zero

    hier_fn, _ = hier_round_fn(cfg, args, pods=2, fused=None, straggler=True)
    pod_mask = torch.tensor([[1.0, 1.0], [0.0, 0.0]], device="cuda")
    hier_batch = {k: v.reshape((2, 2) + tuple(v.shape[1:]))
                  for k, v in batch.items()}
    ops.reset_launches()
    hier, _, m_hier = hier_fn(params, state, hier_batch, pod_mask)
    hier_counts = ops.launch_counts()
    require(all(bool(torch.isfinite(v).all()) for v in hier.values())
            and math.isfinite(float(m_hier["loss"])),
            "masked hierarchical round: non-finite params or loss")
    require(hier_counts["quantize"] == args.cohort
            and hier_counts["dequantize"] == args.cohort
            and hier_counts["reduce_compress_roundtrip"] == 0,
            f"masked hierarchical round launched {hier_counts}: need per-"
            f"client K1 ({args.cohort} each) and no K3b")
    log("stragglers", all_ones_equals_unmasked=True,
        all_zero_params_unchanged=True, all_zero_loss=float(m_zero["loss"]),
        hier_mask=pod_mask.int().tolist(), hier_loss=float(m_hier["loss"]),
        hier_launches=json.dumps(hier_counts))
    del params, hier
    torch.cuda.empty_cache()
    return counts


# ssm grads: the per-leaf limit of K5's gradients against the plain f32
# version's, in units of each leaf's largest magnitude. rwkv6_3b at init can
# be ill-conditioned in f32: at seed 0 some heads' WKV outputs have a mean
# square ~2e-7 against a median ~10, and the group norm (eps 1e-6)
# magnifies rounding there, so two f32 computations of the gradient that
# sum in another order differ by more than 1e-4 (the limit of the other
# models). On an H100, K5 read 8.2e-4 at seed 0 and ~4e-5 at seeds 1 and 2;
# the control (a WKV with a bf16 output) read 0.11, 8.7e-3 and 1.2e-2. The
# limit sits about 3x above the first and 3x below the least of the second.
SSM_GRAD_TOL = 2.5e-3


def phase_grads(phase: str = "grads", arch: str = "lm_350m", layers: int = 2,
                seq: int = 4096, tol: float = 1e-4, seeds=(0,),
                control: bool = False, biases: bool = False,
                patches: int = 0):
    """A full-width model with ``layers`` layers (an encoder-decoder's
    ``layers`` encoder and decoder layers, on ``seq`` frames), f32, batch
    1: loss and gradients through the kernels (K2, K4 in recurrent layers,
    K5 in rwkv layers) against the same through PyTorch's autograd of their
    plain forwards on the card, from the same parameters and tokens, drawn
    from each of ``seeds``: the loss within 1e-5 relative, each leaf within
    ``tol`` of its largest magnitude. The kernels' gradients wait on the
    host while the plain run takes the card's memory. An MoE layer runs
    the same code on both sides (no kernel computes it). ``biases``: the
    qkv biases drawn nonzero (:func:`with_biases`); ``patches``: a VLM's
    patch embeddings (1, patches, D) before ``seq - patches`` tokens, the
    loss on the text tail.

    ``control``: for each seed, the plain forward once more with the WKV's
    output (and so its gradient) rounded to bf16. Its worst leaf must be
    farther than ``tol`` from the plain f32 run's, or the limit could not
    tell a WKV of lower precision from K5."""
    import contextlib
    import dataclasses
    from unittest import mock

    import numpy as np

    from repro_torch.kernels import ops, ref
    from repro_torch.models import blocks, registry, rwkv

    cfg = dataclasses.replace(registry.get_config(arch), num_layers=layers,
                              dtype="float32")
    if cfg.is_encoder_decoder:
        # ``layers`` encoder and decoder layers; K2 in the encoder's
        # self-attention and the decoder's self- and cross-attention
        cfg = dataclasses.replace(cfg, encoder_layers=layers)
        kinds = ["encoder"] * layers + ["decoder"] * layers
        n_attn, n_rec, n_rwkv = 3 * layers, 0, 0
    else:
        kinds = blocks.layer_kinds(cfg)
        n_attn, n_rec = kinds.count("attention"), kinds.count("recurrent")
        n_rwkv = kinds.count("rwkv")

    def worst_leaf(grads, want):
        """(name, max over leaves of max |grads - want| / max |want|)."""
        name, worst = "", 0.0
        for key, w in want.items():
            w = w.double()
            top = max(float(w.abs().max()), 1e-30)
            ratio = float((grads[key].to(w.device).double() - w).abs().max()
                          ) / top
            if ratio >= worst:
                name, worst = key, ratio
        return name, worst

    def plain_wkv(*a):
        out, _, final = ref.wkv6_fwd_ref(*a)
        return out, final

    def plain_forwards(wkv6=plain_wkv):
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(
            ops, "flash_attention",
            lambda q, k, v, **kw: ref.flash_attention_ref(q, k, v, **kw)[0]))
        stack.enter_context(mock.patch.object(ops, "lru_scan", ref.lru_scan_ref))
        stack.enter_context(mock.patch.object(ops, "wkv6", wkv6))
        return stack

    for seed in seeds:
        torch.cuda.reset_peak_memory_stats()
        params = registry.init_params(cfg, seed=seed, device="cuda")
        if biases:
            with_biases(params, seed)
        toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                    (1, seq - patches + 1))
        toks = torch.from_numpy(toks.astype(np.int64)).cuda()
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.is_encoder_decoder:
            # seq frames (f32 normals) and max(seq // 8, 16) text tokens
            batch = registry.make_batch(cfg, 1, seq, seed=seed)
        if patches:
            batch["embeds"] = torch.randn(
                (1, patches, cfg.d_model), device="cuda",
                generator=torch.Generator(device="cuda").manual_seed(seed))

        def loss_and_grads():
            p = {k: v.detach().clone().requires_grad_()
                 for k, v in params.items()}
            loss = registry.loss_fn(cfg, p, batch)
            grads = torch.autograd.grad(loss, list(p.values()))
            return float(loss.detach()), dict(zip(p, grads))

        # the spread of the per-head mean squares the group norm divides by
        mean_squares = []

        def group_norm(x, scale, _norm=rwkv._group_norm):
            ms = torch.mean(x.detach() ** 2, dim=-1)
            mean_squares.append((float(ms.min()), float(ms.median())))
            return _norm(x, scale)

        ops.reset_launches()
        with mock.patch.object(rwkv, "_group_norm", group_norm):
            loss_k, grads_k = loss_and_grads()
        grads_k = {k: v.cpu() for k, v in grads_k.items()}
        counts = ops.launch_counts()
        # an encoder-decoder checkpoints no layer (the reference's scans
        # take no jax.checkpoint): one forward a layer, not two
        fwd = n_attn if cfg.is_encoder_decoder else 2 * n_attn
        require(counts["flash_attention_fwd"] >= fwd
                and counts["flash_attention_bwd_dq"] >= n_attn
                and counts["flash_attention_bwd_dkdv"] >= n_attn
                and counts["lru_scan_fwd"] >= 2 * n_rec
                and counts["lru_scan_bwd"] >= n_rec
                and counts["wkv6_fwd"] >= 2 * n_rwkv
                and counts["wkv6_bwd"] >= n_rwkv,
                f"{phase} phase: kernels launched {counts}")
        with plain_forwards():
            loss_p, grads_p = loss_and_grads()
        rel = abs(loss_k - loss_p) / abs(loss_p)
        require(rel <= 1e-5, f"loss kernels {loss_k} vs plain {loss_p}")
        name, worst = worst_leaf(grads_k, grads_p)
        require(worst <= tol, f"grad {name}: max abs err {worst:.3e} of its "
                f"largest magnitude > {tol:.3e}")
        extra = {}
        if control:
            def bf16_wkv(*a):
                out, final = plain_wkv(*a)
                return out.bfloat16().float(), final

            with plain_forwards(bf16_wkv):
                _, grads_c = loss_and_grads()
            c_name, c_worst = worst_leaf(grads_c, grads_p)
            require(c_worst > tol, f"control (bf16 WKV output) reads "
                    f"{c_worst:.3e} <= {tol:.3e}: the limit cannot tell it "
                    f"from the kernels")
            extra = dict(control_worst_leaf=c_name,
                         control_err_over_max=f"{c_worst:.3e}")
            del grads_c
        if mean_squares:
            extra["head_mean_square_min_median"] = [
                (f"{a:.3e}", f"{b:.3e}") for a, b in mean_squares]
        log(phase, arch=arch, seq=seq, seed=seed, layers=",".join(kinds),
            params=sum(v.numel() for v in params.values()),
            **(dict(patches=patches) if patches else {}),
            **(dict(biases="drawn") if biases else {}),
            peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
            loss_kernels=loss_k, loss_plain=loss_p, loss_rel_diff=f"{rel:.3e}",
            leaves=len(grads_p), worst_leaf=name,
            worst_err_over_max=f"{worst:.3e}", limit=f"{tol:.1e}", **extra,
            launches=json.dumps(counts))
        del params, grads_k, grads_p
        gc.collect()
        torch.cuda.empty_cache()
    return counts


def phase_reference(attn_impl: str, arch: str = "lm_350m",
                    stragglers: bool = False):
    """Reduced config (f32), one flat int8 round from the same parameters
    and data on the card (kernels) and on the CPU (plain versions). They
    agree within the mean over clients of each client delta's int8 step
    (the deltas are quantized one by one, then averaged). ``naive``
    attention holds the int8 kernels; ``blocked`` adds K2's forward and
    backward; the hybrid config adds K4 (recurrent layers, f32, seq 64
    beyond the reduced window of 32); the ssm config runs K5 (one head of
    64, seq 64, a whole chunk). ``stragglers``: a masked round of cohort 4
    with ``launch.train``'s first mask, and the mean of the steps of the
    clients it keeps."""
    import functools

    from repro_torch import optim
    from repro_torch.algorithms import rounds
    from repro_torch.data.grouped import CohortSampler, GroupedCorpus
    from repro_torch.launch import train
    from repro_torch.models import registry

    from repro_torch.runtime import StragglerSimulator

    args = flat_args(arch=arch, reduced=True, rounds=1,
                     cohort=4 if stragglers else 2, batch=2, seq=64,
                     stragglers=stragglers)
    cfg = registry.get_config(arch).reduced(attn_impl=attn_impl)
    weights = (train.round_mask(StragglerSimulator(), 0, args, "cpu")
               if stragglers else torch.ones(args.cohort))
    base = registry.init_params(cfg, seed=0, device="cpu")
    sampler = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                            cohort_size=args.cohort)
    out = {}
    for device in ("cuda", "cpu"):
        round_fn, server_opt = train.build_round_fn(cfg, args)
        params = {k: v.to(device) for k, v in base.items()}
        d = sampler.round_batch(0, args.local_steps, args.batch, args.seq,
                                device=device)
        batch = {"tokens": d["tokens"], "labels": d["labels"]}
        mask = weights.to(device) if stragglers else None
        new, _, metrics = round_fn(params, server_opt.init(params), batch,
                                   mask)
        out[device] = ({k: v.cpu() for k, v in new.items()},
                       float(metrics["loss"]))
    client = rounds._make_client_update(
        functools.partial(registry.loss_fn, cfg), optim.sgd(args.client_lr),
        rounds.LocalSGDConfig(partition_size=args.cohort,
                              num_local_steps=args.local_steps, grad_clip=1.0))
    with torch.no_grad():
        deltas = [client(base, {k: batch[k][c].cpu() for k in batch})[0]
                  for c in range(args.cohort)]
    per_client = [quant_steps(dl) for dl in deltas]
    w = weights.tolist()
    steps = {k: sum(wi * s[k] for wi, s in zip(w, per_client)) / sum(w)
             for k in base}
    worst, equal = agree_within_step(out["cpu"][0], out["cuda"][0], steps, rel=0.0)
    require(worst <= 1.0, f"card vs CPU beyond one int8 step: {worst}")
    require(abs(out["cuda"][1] - out["cpu"][1]) <= 1e-5 * abs(out["cpu"][1]),
            f"loss card {out['cuda'][1]} vs cpu {out['cpu'][1]}")
    log("reference", arch=arch, attn_impl=attn_impl,
        mask=weights.int().tolist() if stragglers else None,
        loss_card=out["cuda"][1],
        loss_cpu=out["cpu"][1],
        worst=f"{worst:.4f}", equal_fraction=f"{equal:.6f}")


# ---------------------------------------------------------------------------
# ckpt, topk and algorithms: lm_350m at full width (24 layers, bf16)
# ---------------------------------------------------------------------------

INT8_KERNELS = ("quantize", "dequantize", "reduce_compress_roundtrip",
                "reduce_compress", "dequant_accumulate")


def filesystem_of(path: str) -> tuple:
    """(mount point, type) of the filesystem that holds ``path``."""
    real = os.path.realpath(path)
    best = ("", "?")
    with open("/proc/mounts") as f:
        for line in f:
            mnt, fstype = line.split()[1:3]
            inside = real == mnt or real.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best[0]):
                best = (mnt, fstype)
    return best


def manifest(directory: str, step: int) -> dict:
    with open(os.path.join(directory, f"step_{step:09d}", "manifest.json")) as f:
        return json.load(f)


def differing_leaves(a, b) -> list:
    """Paths of the leaves in which two trees of tensors (one device)
    differ in dtype, shape or bits."""
    from torch.utils import _pytree as pytree

    la, lb = pytree.tree_flatten_with_path(a)[0], pytree.tree_leaves(b)
    require(len(la) == len(lb), f"trees of {len(la)} and {len(lb)} leaves")
    return [pytree.keystr(path) for (path, x), y in zip(la, lb)
            if not (x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x, y))]


# [ckpt] at 8 of lm_350m's 24 layers: its writes, hashes and restores take
# time in proportion to the bytes (115 s for the phase at 24 layers on a
# slow host, PERF.md)
CKPT_LAYERS = 8


def phase_ckpt():
    """Checkpointing and recovery of flat int8 FedAvg rounds (server
    momentum: an f32 tree beside the bf16 params) of lm_350m at full width
    and ``CKPT_LAYERS`` layers through ``launch.train``:
    run A, 4 rounds with a checkpoint every 2; run B, the same with a
    failure at round 3, which restores step 2 and replays round 2. B must
    end bitwise equal to A. Then on B's directory: the checkpoint restored
    with CPU example leaves equals the state's host copy; a corrupted step
    4 falls back to step 2, whose sha256 of every leaf are A's own step
    2's; a save killed before LATEST advances stays invisible. The
    directories live under the temporary directory and are removed."""
    import dataclasses
    import shutil
    import tempfile

    from torch.utils import _pytree as pytree

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import registry

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(registry.get_config("lm_350m"),
                              num_layers=CKPT_LAYERS)
    root = tempfile.mkdtemp(prefix="repro_ckpt_")
    try:
        mount, fstype = filesystem_of(root)
        free = shutil.disk_usage(root).free
        # bf16 params, f32 momentum, step (no vocabulary padding at 32768)
        state_bytes = cfg.param_count() * (2 + 4) + 4
        # A: steps 2 and 4; B: steps 2 and 4, the rewrite of the corrupted
        # step and the killed step 5; one more for the filesystem's slack
        need = 7 * state_bytes
        log("ckpt", dir=root, filesystem=f"{mount} ({fstype})", free_bytes=free,
            need_bytes=need)
        require(free >= need, f"{free} bytes free under {root}, need {need}")
        runs, counts, secs = {}, {}, {}
        for name, fail_at in (("A", []), ("B", [3])):
            args = flat_args(algorithm="fedavg", rounds=4, ckpt_every=2,
                             fail_at=fail_at, ckpt_dir=os.path.join(root, name))
            ops.reset_launches()
            t0 = time.perf_counter()
            with model_as(cfg):
                runs[name] = train.train(args)
            secs[name] = time.perf_counter() - t0
            counts[name] = ops.launch_counts()
        a, b = runs["A"], runs["B"]
        require(all(math.isfinite(v) for v in a.losses + b.losses),
                f"non-finite losses {a.losses} {b.losses}")
        require(a.recovery["restarts"] == 0, f"run A: {a.recovery}")
        require(b.recovery["restarts"] == 1 and b.recovery["restored_from"] == [2]
                and b.recovery["completed_steps"] == 4
                and b.recovery["replayed_steps"] == 1,
                f"run B: {b.recovery}, need 1 restart from step 2, 4 completed "
                "and 1 replayed")
        require(len(b.losses) == 5 and b.losses[2] == b.losses[3] == a.losses[2]
                and b.losses[4] == a.losses[3],
                f"losses A {a.losses} B {b.losses}")
        for name, rounds_run in (("A", 4), ("B", 5)):
            need_k1 = rounds_run * args.cohort
            c = counts[name]
            require(c["quantize"] == need_k1 and c["dequantize"] == need_k1,
                    f"run {name} launched {c}, need K1a/K1b {need_k1} each")
            require_flash_launches(c, flat_args(rounds=rounds_run),
                                   CKPT_LAYERS)
        a_losses = a.losses
        state_a = {"params": a.params, "server": a.server_state}
        state_b = {"params": b.params, "server": b.server_state}
        bad = differing_leaves(state_a, state_b)
        require(not bad, f"--fail-at 3 replay differs from the uninterrupted "
                f"run in {len(bad)} leaves: {bad[:8]}")
        del runs, a, state_a

        mgr = CheckpointManager(os.path.join(root, "B"), keep_last_n=3)
        cpu_state = pytree.tree_map(lambda t: t.cpu(), state_b)
        t0 = time.perf_counter()
        restored, meta = mgr.restore(4, cpu_state)
        restore_cpu_s = time.perf_counter() - t0
        bad = differing_leaves(restored, cpu_state)
        require(not bad and meta["step"] == 4,
                f"card-written step 4 restored on the host differs in {bad[:8]}")
        del restored
        mgr.inject_fault(4, "corrupt")
        step, fell_back, _ = mgr.restore_latest(cpu_state)
        # restore_latest verified every leaf against B's manifest of step
        # 2; equal manifests make it run A's own step 2, bit for bit
        hashes = {name: [leaf["sha256"] for leaf in manifest(
            os.path.join(root, name), 2)["leaves"]] for name in ("A", "B")}
        require(step == 2 and hashes["A"] == hashes["B"],
                f"corrupt step 4: restore_latest gave step {step}; step 2's "
                f"sha256 equal in A and B: {hashes['A'] == hashes['B']}")
        del fell_back, cpu_state
        mgr.kill_writer_at_byte("pre-latest")
        mgr.save(5, state_b)
        require(5 in mgr.killed_writes and mgr.latest_step() == 4
                and 5 in mgr._complete_steps(),
                f"kill@pre-latest: killed {mgr.killed_writes}, latest "
                f"{mgr.latest_step()}")
        save = mgr.last_save
        log("ckpt", runs="A 4 rounds, B 4 rounds --fail-at 3 (--ckpt-every 2)",
            losses_a=[round(v, 5) for v in a_losses],
            losses_b=[round(v, 5) for v in b.losses],
            round_s_b=[round(v, 3) for v in b.seconds],
            run_s={k: round(v, 2) for k, v in secs.items()},
            recovery_b=json.dumps(b.recovery), replay_bitwise=True,
            launches_a={k: counts["A"][k] for k in (
                "quantize", "dequantize", "flash_attention_fwd",
                "flash_attention_bwd_dq", "flash_attention_bwd_dkdv")},
            launches_b={k: counts["B"][k] for k in (
                "quantize", "dequantize", "flash_attention_fwd",
                "flash_attention_bwd_dq", "flash_attention_bwd_dkdv")})
        log("ckpt", leaves=save["leaves"], bytes=save["bytes"],
            host_copy_s=f"{save['host_copy_s']:.3f}",
            write_fsync_s=f"{save['write_s']:.3f}",
            sha256_s=f"{save['hash_s']:.3f}",
            restore_host_s=f"{restore_cpu_s:.3f}",
            corrupt_falls_back_to=2, pre_latest_kill_invisible=True,
            seconds=f"{time.perf_counter() - t_phase:.1f}")
        del b, state_b
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


def reference_leaves(tree: dict) -> dict:
    """The reference's leaves of a port dict: each name's layers stacked
    (a uniform stack, as ``topk_sparsify_layers`` groups them), the rest
    one by one. name -> list of port keys."""
    from repro_torch.compression.api import _uniform_layers

    groups = _uniform_layers(tree) or {}
    grouped = {k for keys in groups.values() for k in keys}
    return dict(groups, **{k: [k] for k in tree if k not in grouped})


def phase_topk():
    """Top-k rounds of lm_350m: 2 flat rounds through ``launch.train
    --compression topk`` (fraction 0.01), finite, with no K1 or K3 launch;
    one client's delta rebuilt and sparsified on the card and on the CPU,
    bitwise, each of the reference's leaves keeping exactly k entries (or
    its nonzeros, when fewer); then one hierarchical 2 x 2 top-k round,
    whose pod partials are sparsified: each leaf of the applied update
    changes at most k of the (2, ...) partial's entries, with no K1 or K3
    launch."""
    import functools

    from repro_torch.algorithms import rounds
    from repro_torch.compression import topk_sparsify_layers
    from repro_torch.data.grouped import CohortSampler, GroupedCorpus
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import registry

    t_phase = time.perf_counter()
    fraction = 0.01
    args = flat_args(rounds=2, compression="topk")
    cfg = registry.get_config(args.arch)
    ops.reset_launches()
    result = train.train(args)
    counts = ops.launch_counts()
    require(all(math.isfinite(v) for v in result.losses),
            f"non-finite losses {result.losses}")
    require(all(counts[k] == 0 for k in INT8_KERNELS),
            f"top-k rounds launched int8 kernels: {counts}")
    require_flash_launches(counts, args, cfg.num_layers)
    losses, seconds = result.losses, result.seconds
    del result

    params = registry.init_params(cfg, seed=args.seed, device="cuda")
    loss_fn = functools.partial(registry.loss_fn, cfg)
    client_opt, server_opt = train.optimizers(args)
    client = rounds._make_client_update(loss_fn, client_opt, rounds.LocalSGDConfig(
        partition_size=args.cohort, num_local_steps=args.local_steps,
        grad_clip=1.0))
    sampler = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                            cohort_size=args.cohort)
    d = sampler.round_batch(0, args.local_steps, args.batch, args.seq,
                            device="cuda")
    with torch.no_grad():
        delta, _ = client(params, {k: d[k][0] for k in ("tokens", "labels")})
    sparse = topk_sparsify_layers(delta, fraction)
    t0 = time.perf_counter()
    sparse_cpu = topk_sparsify_layers({k: v.cpu() for k, v in delta.items()},
                                      fraction)
    cpu_s = time.perf_counter() - t0
    bad = [k for k in delta if not torch.equal(sparse[k].cpu(), sparse_cpu[k])]
    require(not bad, f"top-k card != CPU in {len(bad)} leaves: {bad[:8]}")
    del sparse_cpu
    groups = reference_leaves(delta)
    for name, keys in groups.items():
        n = sum(delta[k].numel() for k in keys)
        k = max(int(n * fraction), 1)
        nnz = sum(int(torch.count_nonzero(delta[key])) for key in keys)
        kept = sum(int(torch.count_nonzero(sparse[key])) for key in keys)
        require(kept == min(k, nnz), f"{name}: kept {kept}, k {k}, nnz {nnz}")
    sparsify_ms = time_ms(lambda: topk_sparsify_layers(delta, fraction),
                          warmup=3, iters=20)
    delta_elems = sum(v.numel() for v in delta.values())
    del delta, sparse

    hier = rounds.make_hierarchical_local_sgd_round(
        loss_fn, client_opt, server_opt, rounds.LocalSGDConfig(
            partition_size=2, num_local_steps=args.local_steps, grad_clip=1.0,
            compression="topk", topk_fraction=fraction, num_pods=2))
    batch = {k: d[k].reshape((2, 2) + tuple(d[k].shape[1:]))
             for k in ("tokens", "labels")}
    ops.reset_launches()
    t0 = time.perf_counter()
    new, _, m = hier(params, server_opt.init(params), batch)
    hier_loss = float(m["loss"])
    hier_s = time.perf_counter() - t0
    hier_counts = ops.launch_counts()
    require(math.isfinite(hier_loss), f"hierarchical top-k loss {hier_loss}")
    require(all(hier_counts[k] == 0 for k in INT8_KERNELS),
            f"hierarchical top-k round launched int8 kernels: {hier_counts}")
    changed_total = 0
    for name, keys in groups.items():
        k = max(int(2 * sum(params[key].numel() for key in keys) * fraction), 1)
        changed = sum(int((new[key] != params[key]).sum()) for key in keys)
        require(changed <= k, f"{name}: {changed} entries moved, the pod "
                f"partials keep {k}")
        changed_total += changed
    require(changed_total > 0, "the hierarchical top-k round moved nothing")
    log("topk", fraction=fraction, losses=[round(v, 5) for v in losses],
        round_s=[round(v, 3) for v in seconds], delta_elements=delta_elems,
        reference_leaves=len(groups), card_equals_cpu=True,
        sparsify_ms=f"{sparsify_ms:.3f}", sparsify_cpu_s=f"{cpu_s:.2f}",
        launches=json.dumps({k: counts[k] for k in INT8_KERNELS}),
        hier_loss=round(hier_loss, 5), hier_s=round(hier_s, 3),
        hier_moved=changed_total,
        hier_launches=json.dumps({k: hier_counts[k] for k in INT8_KERNELS}),
        seconds=f"{time.perf_counter() - t_phase:.1f}")
    del params, new
    torch.cuda.empty_cache()


def phase_algorithms():
    """The other rounds at lm_350m's full width: a FedSGD round with
    learned weights (cohort 4, batch 4, seq 512) whose loss has a finite,
    nonzero gradient in the 4 weights; ``make_multi_round`` of 2 local-SGD
    int8 rounds bitwise equal to the same rounds one at a time; 2
    asynchronous rounds with finite losses. Then, on reduced lm_350m with
    ``blocked`` attention (K2 on the card), a FedSGD round with learned
    weights and two asynchronous rounds on the card and on the CPU agree
    within 1e-5 (loss relative, weights' gradient, params and pending
    delta absolute)."""
    import functools

    from repro_torch import optim
    from repro_torch.algorithms import async_rounds, rounds
    from repro_torch.data.grouped import CohortSampler, GroupedCorpus
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import registry

    t_phase = time.perf_counter()
    args = flat_args(rounds=2)
    cfg = registry.get_config(args.arch)
    loss_fn = functools.partial(registry.loss_fn, cfg)
    params = registry.init_params(cfg, seed=args.seed, device="cuda")
    sampler = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                            cohort_size=args.cohort)

    def data(r, steps=args.local_steps):
        d = sampler.round_batch(r, steps, args.batch, args.seq, device="cuda")
        return {k: d[k] for k in ("tokens", "labels")}

    server = optim.fedavg_momentum(1.0)
    fedsgd = rounds.make_fedsgd_round(
        loss_fn, server, rounds.LocalSGDConfig(partition_size=args.cohort,
                                               num_local_steps=1),
        learned_weights=True)
    w = torch.zeros(args.cohort, device="cuda", requires_grad=True)
    ops.reset_launches()
    t0 = time.perf_counter()
    _, _, m = fedsgd(params, server.init(params),
                     {k: v[:, 0] for k, v in data(0, 1).items()}, w)
    (grad_w,) = torch.autograd.grad(m["loss"], w)
    fedsgd_s = time.perf_counter() - t0
    fedsgd_loss = float(m["loss"].detach())
    fed_counts = ops.launch_counts()
    del m
    require(bool(torch.isfinite(grad_w).all()) and bool((grad_w != 0).any()),
            f"FedSGD learned weights: gradient {grad_w.tolist()}")
    require(fed_counts["flash_attention_fwd"] >= args.cohort * cfg.num_layers,
            f"FedSGD launched {fed_counts}")

    round_fn, server_opt = train.build_round_fn(cfg, args)
    batches = [data(r) for r in range(2)]
    stacked = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    t0 = time.perf_counter()
    mp, ms, mm = rounds.make_multi_round(round_fn, 2)(
        params, server_opt.init(params), stacked)
    multi_losses = mm["loss"].tolist()
    multi_s = time.perf_counter() - t0
    p, s = params, server_opt.init(params)
    single_losses = []
    for b in batches:
        p, s, m1 = round_fn(p, s, b)
        single_losses.append(float(m1["loss"]))
    bad = differing_leaves({"p": mp, "s": ms}, {"p": p, "s": s})
    require(not bad and multi_losses == single_losses,
            f"multi-round != single rounds: losses {multi_losses} vs "
            f"{single_losses}, {len(bad)} leaves differ {bad[:8]}")
    del mp, ms, p, s, stacked

    client_opt, server_opt = train.optimizers(args)
    async_round, init_pending = async_rounds.make_async_local_sgd_round(
        loss_fn, client_opt, server_opt, rounds.LocalSGDConfig(
            partition_size=args.cohort, num_local_steps=args.local_steps,
            grad_clip=1.0))
    p, pending, s = params, init_pending(params), server_opt.init(params)
    async_losses, async_s = [], []
    for b in batches:
        t0 = time.perf_counter()
        p, pending, s, m2 = async_round(p, pending, s, b)
        async_losses.append(float(m2["loss"]))
        async_s.append(time.perf_counter() - t0)
    require(all(math.isfinite(v) for v in async_losses),
            f"async losses {async_losses}")
    del p, pending, s, params, batches
    torch.cuda.empty_cache()
    worst = phase_algorithms_reference()
    log("algorithms", fedsgd_loss=round(fedsgd_loss, 5),
        fedsgd_grad_w=[f"{v:.4g}" for v in grad_w.tolist()],
        fedsgd_s=round(fedsgd_s, 3), multi_losses=multi_losses,
        multi_equals_single=True, multi_s=round(multi_s, 3),
        async_losses=[round(v, 5) for v in async_losses],
        async_s=[round(v, 3) for v in async_s],
        reduced_card_vs_cpu=json.dumps(worst),
        seconds=f"{time.perf_counter() - t_phase:.1f}")


def phase_algorithms_reference() -> dict:
    """Reduced lm_350m (``blocked`` attention: K2 on the card), from the
    same parameters and data on the card and on the CPU: a FedSGD round
    with learned weights and two asynchronous rounds. Returns the worst
    differences, each required within 1e-5."""
    import functools

    from repro_torch import optim
    from repro_torch.algorithms import async_rounds, rounds
    from repro_torch.data.grouped import CohortSampler, GroupedCorpus
    from repro_torch.models import registry

    cfg = registry.get_config("lm_350m").reduced(attn_impl="blocked")
    loss_fn = functools.partial(registry.loss_fn, cfg)
    base = registry.init_params(cfg, seed=0, device="cpu")
    sampler = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                            cohort_size=4)
    w0 = torch.tensor([0.3, -0.2, 0.0, 0.5])
    out = {}
    for device in ("cuda", "cpu"):
        params = {k: v.to(device) for k, v in base.items()}

        def data(r, steps):
            d = sampler.round_batch(r, steps, 2, 64, device=device)
            return {k: d[k] for k in ("tokens", "labels")}

        fedsgd = rounds.make_fedsgd_round(
            loss_fn, optim.fedavg_momentum(1.0),
            rounds.LocalSGDConfig(partition_size=4, num_local_steps=1),
            learned_weights=True)
        w = w0.to(device).requires_grad_(True)
        new, _, m = fedsgd(params, optim.fedavg_momentum(1.0).init(params),
                           {k: v[:, 0] for k, v in data(0, 1).items()}, w)
        (g,) = torch.autograd.grad(m["loss"], w)
        res = {"fedsgd_loss": float(m["loss"].detach()), "grad_w": g.cpu(),
               "fedsgd_params": {k: v.detach().cpu() for k, v in new.items()}}
        server = optim.fedavg_momentum(1.0)
        async_round, init_pending = async_rounds.make_async_local_sgd_round(
            loss_fn, optim.sgd(0.05), server,
            rounds.LocalSGDConfig(partition_size=4, num_local_steps=2,
                                  grad_clip=1.0))
        p, pending, s = params, init_pending(params), server.init(params)
        for r in range(2):
            p, pending, s, m = async_round(p, pending, s, data(r, 2))
        res.update(async_loss=float(m["loss"]),
                   async_params={k: v.cpu() for k, v in p.items()},
                   async_pending={k: v.cpu() for k, v in pending.items()})
        out[device] = res
    card, cpu = out["cuda"], out["cpu"]

    def tree_diff(a, b):
        return max(float((a[k].double() - b[k].double()).abs().max()) for k in a)

    worst = {
        "fedsgd_loss_rel": abs(card["fedsgd_loss"] - cpu["fedsgd_loss"])
        / abs(cpu["fedsgd_loss"]),
        "grad_w": float((card["grad_w"] - cpu["grad_w"]).abs().max()),
        "fedsgd_params": tree_diff(card["fedsgd_params"], cpu["fedsgd_params"]),
        "async_loss_rel": abs(card["async_loss"] - cpu["async_loss"])
        / abs(cpu["async_loss"]),
        "async_params": tree_diff(card["async_params"], cpu["async_params"]),
        "async_pending": tree_diff(card["async_pending"], cpu["async_pending"]),
    }
    require(all(v <= 1e-5 for v in worst.values()),
            f"reduced card vs CPU beyond 1e-5: {worst}")
    return {k: f"{v:.3g}" for k, v in worst.items()}


# [pipeline]: full lm_350m as PIPE_STAGES stages of its layers, fed
# PIPE_MICRO microbatches of PIPE_BATCH x PIPE_SEQ tokens.
PIPE_STAGES, PIPE_MICRO, PIPE_BATCH, PIPE_SEQ = 4, 8, 1, 512


def lm_head_loss(cfg, params, x, labels):
    """The model's head on activations: final norm, f32 logits,
    cross-entropy (``transformer.forward`` after its layers)."""
    from repro_torch.models import common

    x = common.rmsnorm_apply(params["final_ln.scale"], x, cfg.norm_eps)
    logits = torch.matmul(x.to(torch.float32),
                          params["lm_head.w"].to(torch.float32))
    return common.softmax_cross_entropy(logits, labels)


def phase_pipeline():
    """[pipeline]: full lm_350m (bf16, 24 layers, K2 in every layer) as
    4 stages of 6 layers (``transformer.apply_layers`` closures), 8
    microbatches of 1 x 512 embedded outside the pipeline. The direct
    round's outputs bitwise the 24 layers applied one microbatch at a time;
    a loss on them (final norm, f32 logits, cross-entropy) with gradients
    in every parameter within 1e-4 of each leaf's largest magnitude of the
    sequential run's; the round traced and planned (one ``LOOP[scan]`` of
    11 ticks with a ``TRANSFER`` in its body), ``run_plan`` bitwise the
    direct round, the compiled plan (the buffer donated) bitwise
    ``run_plan`` with one build, ``plan.analyze()`` without error and the
    transfer priced on ICI. Logs the bubble fraction, the seconds of the
    direct round, ``run_plan``, a replay and the one-time trace, peak GiB
    and the launches."""
    import functools

    from torch.utils import _pytree as pytree

    from repro_torch.algorithms import pipeline
    from repro_torch.core import interpreter as interp
    from repro_torch.kernels import ops
    from repro_torch.models import registry, transformer

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = registry.get_config("lm_350m")
    s, m, b, seq = PIPE_STAGES, PIPE_MICRO, PIPE_BATCH, PIPE_SEQ
    per = cfg.num_layers // s
    params = registry.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (m, b, seq + 1), generator=gen,
                         device="cuda")
    labels = toks[..., 1:]
    positions = torch.arange(seq, device="cuda").expand(b, seq)

    def stage(p, i, x):
        # the activation; lm_350m's layers add no aux loss
        return transformer.apply_layers(cfg, p, x, positions, i * per,
                                        (i + 1) * per)[0]

    def stages(p):
        return [functools.partial(stage, p, i) for i in range(s)]

    def sequential(p, mb):
        return torch.stack([transformer.apply_layers(cfg, p, mb[i],
                                                     positions)[0]
                            for i in range(m)])

    pcfg = pipeline.PipelineConfig(s, m)
    round_fn = pipeline.make_pipelined_round(stages(params), pcfg)
    with torch.no_grad():
        mb = torch.nn.functional.embedding(toks[..., :-1], params["embed.table"])
        act0 = torch.zeros((s,) + mb.shape[1:], dtype=mb.dtype, device="cuda")
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        outs, act_final = round_fn(mb, act0)
        torch.cuda.synchronize()
        direct_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        want = sequential(params, mb)
    ticks = m + s - 1
    require(torch.equal(outs, want),
            "pipelined outputs != the 24 layers one microbatch at a time")
    require(counts["flash_attention_fwd"] == ticks * cfg.num_layers,
            f"pipeline K2 forward launches {counts['flash_attention_fwd']}, "
            f"want {ticks} ticks x {cfg.num_layers} layers")

    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        emb = torch.nn.functional.embedding(toks[..., :-1],
                                            leaves["embed.table"])
        ops.reset_launches()
        out_g, _ = pipeline.make_pipelined_round(stages(leaves), pcfg)(
            emb, act0)
        grads = torch.autograd.grad(lm_head_loss(cfg, leaves, out_g, labels),
                                    list(leaves.values()))
        grad_counts = ops.launch_counts()
        del out_g, emb
        emb = torch.nn.functional.embedding(toks[..., :-1],
                                            leaves["embed.table"])
        want_g = torch.autograd.grad(
            lm_head_loss(cfg, leaves, sequential(leaves, emb), labels),
            list(leaves.values()))
        del emb
    worst = 0.0
    for name, g, w in zip(leaves, grads, want_g):
        err = float((g.double() - w.double()).abs().max())
        lim = 1e-4 * float(w.double().abs().max())
        require(err <= lim, f"pipeline grad {name}: {err} > {lim}")
        worst = max(worst, err / max(float(w.double().abs().max()), 1e-30))
    grads_bitwise = all(torch.equal(g, w) for g, w in zip(grads, want_g))
    del grads, want_g, leaves

    t0 = time.perf_counter()
    with torch.no_grad():
        gm = interp.trace(round_fn, mb, act0)
        plan = interp.build_plan(gm, round_fn.drjax_context,
                                 partitioned_invars=(0, 1))
    trace_s = time.perf_counter() - t0
    loops = [st for st in plan.stages if st.kind == "LOOP"]
    require(len(loops) == 1 and loops[0].loop_kind == "scan"
            and loops[0].trip_count == ticks
            and [st.kind for st in loops[0].body_plan.stages].count(
                "TRANSFER") == 1,
            f"pipeline plan: {plan.to_text()[:400]}")
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        oracle = interp.run_plan(plan, mb, act0)
        torch.cuda.synchronize()
        run_plan_s = time.perf_counter() - t0
    require(equal_leaves(oracle, [outs, act_final]),
            "pipeline run_plan != the direct round")
    t0 = time.perf_counter()
    report = plan.analyze()
    analyze_s = time.perf_counter() - t0
    (cost,) = [c for c in report.comm_cost.per_stage if c.kind == "TRANSFER"]
    require(report.ok and cost.link == "ici" and cost.endpoints == s - 1
            and cost.multiplier == ticks,
            f"pipeline analysis: {report}")
    compiled = plan.compile(device="cuda", donate_argnums=(1,))
    replay_s = []
    with torch.no_grad():
        for _ in range(2):
            buf = act0.clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = compiled(mb, buf)
            torch.cuda.synchronize()
            replay_s.append(time.perf_counter() - t0)
            require(res[1] is buf and equal_leaves(res, oracle),
                    "compiled pipeline != run_plan")
    require(compiled.trace_count == 1, "the compiled pipeline was rebuilt")
    log("pipeline", stages=s, layers_per_stage=per, microbatches=m,
        microbatch=f"{b} x {seq}", ticks=ticks,
        bubble_fraction=f"{pipeline.pipeline_bubble_fraction(s, m):.6f}",
        outputs_bitwise=True, grads_bitwise=grads_bitwise,
        grad_worst_rel=f"{worst:.3e}", direct_s=f"{direct_s:.4f}",
        run_plan_s=f"{run_plan_s:.4f}", first_compiled_call_s=f"{replay_s[0]:.3f}",
        replay_s=f"{replay_s[1]:.4f}", trace_and_plan_s=f"{trace_s:.2f}",
        analyze_s=f"{analyze_s:.2f}", ici_bytes=report.comm_cost.ici_bytes,
        transfer_payload_bytes=cost.payload_bytes, units=compiled.num_units,
        trace_count=compiled.trace_count,
        findings=json.dumps(sorted({f.code for f in report.findings})),
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        launches=json.dumps({k: v for k, v in counts.items() if v}),
        grad_launches=json.dumps({k: v for k, v in grad_counts.items() if v}),
        seconds=f"{time.perf_counter() - t_phase:.1f}")
    del compiled, plan, gm, oracle, res, outs, act_final, want, mb, params
    free_graphs()
    return counts


# [maml]: the example's setting (examples/parallel_maml.py) at full
# lm_350m: 4 tasks, support and query batches of 2 x 512.
MAML_TASKS, MAML_BATCH, MAML_SEQ = 4, 2, 512
MAML_INNER_LR, MAML_OUTER_LR = 0.05, 0.2
MAML_REL_L2, MAML_LEAF_REL = 2e-2, 5e-2


def phase_maml():
    """[maml]: full lm_350m (bf16, ``blocked`` attention: K2 in every
    layer, its second order through ``ops._FlashAttentionBackward``), 4
    tasks, one inner step. The outer gradient with K2 against the same
    gradient with ``naive`` attention (no kernel) on the card: within
    ``MAML_REL_L2`` in the L2 norm over all leaves and each leaf within
    ``MAML_LEAF_REL`` of its largest magnitude (bf16 attention in another
    order, amplified through the second order). Then two
    ``maml_train_step``s: finite meta-losses, the first step's new params
    bitwise the SGD step of the gradient taken before. Logs the K2 and
    second-order counts, seconds and peak GiB."""
    import dataclasses
    import functools

    from repro_torch.algorithms import maml
    from repro_torch.kernels import ops
    from repro_torch.models import registry

    t_phase = time.perf_counter()
    cfg = registry.get_config("lm_350m")
    params = registry.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size,
                         (2, MAML_TASKS, MAML_BATCH, MAML_SEQ + 1),
                         generator=gen, device="cuda")
    tasks = {part: {"tokens": toks[i, ..., :-1], "labels": toks[i, ..., 1:]}
             for i, part in enumerate(("support", "query"))}

    def outer_grad(attn_impl):
        c = dataclasses.replace(cfg, attn_impl=attn_impl)
        loss_fn, _ = maml.make_parallel_maml(
            functools.partial(registry.loss_fn, c), MAML_TASKS,
            inner_lr=MAML_INNER_LR)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        with torch.enable_grad():
            meta = loss_fn(leaves, tasks)
            grads = torch.autograd.grad(meta, list(leaves.values()))
        torch.cuda.synchronize()
        return (float(meta), dict(zip(leaves, grads)),
                time.perf_counter() - t0, ops.launch_counts(),
                ops.plain_counts(), torch.cuda.max_memory_allocated())

    meta_k, g_k, k_s, counts, plain, peak = outer_grad("blocked")
    require(counts["flash_attention_fwd"] > 0
            and counts["flash_attention_bwd_dq"] > 0
            and plain["flash_attention_bwd2_plain"]
            == MAML_TASKS * cfg.num_layers,
            f"MAML launches {counts}, second-order calls {plain}")
    meta_n, g_n, n_s, naive_counts, _, naive_peak = outer_grad("naive")
    require(sum(naive_counts.values()) == 0, f"naive MAML {naive_counts}")
    num = sum(float(((g_k[n].double() - g_n[n].double()) ** 2).sum())
              for n in g_n)
    den = sum(float((g_n[n].double() ** 2).sum()) for n in g_n)
    rel_l2 = math.sqrt(num / den)
    leaf_rel = max(float((g_k[n].double() - g_n[n].double()).abs().max())
                   / max(float(g_n[n].double().abs().max()), 1e-30)
                   for n in g_n)
    require(math.isfinite(meta_k) and math.isfinite(rel_l2)
            and rel_l2 <= MAML_REL_L2 and leaf_rel <= MAML_LEAF_REL,
            f"MAML K2 vs naive: meta {meta_k} vs {meta_n}, rel L2 {rel_l2}, "
            f"worst leaf {leaf_rel}")
    del g_n
    _, step = maml.make_parallel_maml(
        functools.partial(registry.loss_fn, cfg), MAML_TASKS,
        inner_lr=MAML_INNER_LR)
    step_s = []
    p = params
    metas = []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, meta = step(p, tasks, outer_lr=MAML_OUTER_LR)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        metas.append(float(meta))
        if i == 0:
            bad = [n for n in p if not torch.equal(
                p[n], (params[n].to(torch.float32)
                       - MAML_OUTER_LR * g_k[n]).to(params[n].dtype))]
            require(not bad, f"MAML step != the SGD step of its gradient: "
                    f"{bad[:4]}")
    require(all(math.isfinite(v) for v in metas), f"MAML metas {metas}")
    log("maml", tasks=MAML_TASKS, batch=f"{MAML_BATCH} x {MAML_SEQ}",
        inner_lr=MAML_INNER_LR, inner_steps=1, outer_lr=MAML_OUTER_LR,
        meta_loss_k2=f"{meta_k:.6f}", meta_loss_naive=f"{meta_n:.6f}",
        grad_rel_l2_vs_naive=f"{rel_l2:.3e}",
        grad_worst_leaf_rel_vs_naive=f"{leaf_rel:.3e}",
        step_meta_losses=[round(v, 6) for v in metas],
        outer_grad_s_k2=f"{k_s:.3f}", outer_grad_s_naive=f"{n_s:.3f}",
        step_s=[round(v, 3) for v in step_s],
        peak_gib_k2=f"{peak / 2**30:.2f}",
        peak_gib_naive=f"{naive_peak / 2**30:.2f}",
        second_order_calls=plain["flash_attention_bwd2_plain"],
        launches=json.dumps({k: v for k, v in counts.items() if v}),
        seconds=f"{time.perf_counter() - t_phase:.1f}")
    del p, params, g_k
    torch.cuda.empty_cache()
    return dict(counts, **plain)


# [btm]: the reference's test and example setting at full lm_350m: 4
# domains, 2 training steps of batch 4 x 512, ``optim.sgd(0.05)``.
BTM_DOMAINS, BTM_STEPS, BTM_BATCH, BTM_SEQ = 4, 2, 4, 512


def phase_btm():
    """[btm]: Branch-Train-Merge of full lm_350m (bf16, K2 in every
    layer). The mean merge bitwise the experts trained one by one with the
    same ``train_expert``, stacked, summed and multiplied by
    ``reciprocal(4)``; the weighted merge's metrics finite with max >=
    mean. Logs seconds, peak GiB and the launches."""
    import functools

    from repro_torch import optim
    from repro_torch.algorithms import btm
    from repro_torch.core.primitives import reciprocal
    from repro_torch.kernels import ops
    from repro_torch.models import registry

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = registry.get_config("lm_350m")
    loss_fn = functools.partial(registry.loss_fn, cfg)
    params = registry.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size,
                         (BTM_DOMAINS, BTM_STEPS, BTM_BATCH, BTM_SEQ + 1),
                         generator=gen, device="cuda")
    data = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    btm_fn = btm.branch_train_merge(loss_fn, optim.sgd(0.05), BTM_DOMAINS,
                                    BTM_STEPS)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        merged, metrics = btm_fn(params, data)
    torch.cuda.synchronize()
    mean_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    require(counts["flash_attention_fwd"] >= 2 * BTM_DOMAINS * BTM_STEPS
            * cfg.num_layers, f"BTM launches {counts}")
    experts = [btm_fn.train_expert(params, {k: v[i] for k, v in data.items()})[0]
               for i in range(BTM_DOMAINS)]
    bad = [n for n in merged if not torch.equal(
        merged[n], torch.stack([e[n] for e in experts]).sum(0)
        * reciprocal(BTM_DOMAINS))]
    require(not bad, f"BTM mean merge != the experts one by one: {bad[:4]}")
    del experts, merged
    weighted = btm.branch_train_merge(loss_fn, optim.sgd(0.05), BTM_DOMAINS,
                                      BTM_STEPS, merge="weighted")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        wmerged, wmetrics = weighted(params, data)
    torch.cuda.synchronize()
    weighted_s = time.perf_counter() - t0
    vals = {k: float(v) for k, v in wmetrics.items()}
    require(all(math.isfinite(v) for v in vals.values())
            and vals["max_final_loss"] >= vals["mean_final_loss"]
            and all(bool(torch.isfinite(t).all()) for t in wmerged.values()),
            f"BTM weighted metrics {vals}")
    log("btm", domains=BTM_DOMAINS, train_steps=BTM_STEPS,
        batch=f"{BTM_BATCH} x {BTM_SEQ}", lr=0.05, mean_merge_bitwise=True,
        mean_metrics=json.dumps({k: round(float(v), 6)
                                 for k, v in metrics.items()}),
        weighted_metrics=json.dumps({k: round(v, 6) for k, v in vals.items()}),
        mean_s=f"{mean_s:.3f}", weighted_s=f"{weighted_s:.3f}",
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        launches=json.dumps({k: v for k, v in counts.items() if v}),
        seconds=f"{time.perf_counter() - t_phase:.1f}")
    del wmerged, params
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# slice 13: K5 with a state, the K4/K5 second order, serving
# ---------------------------------------------------------------------------

WKV_STATE_SWEEP = (1, 37, 64, 200)  # ragged S of K5 with s0 and dfinal
WKV_SERVE_SHAPE = (1, 64, 40, 64)   # a serve chunk of full rwkv6_3b
WKV_SERVE_RAGGED = ((1, 2, 40, 64), (1, 37, 40, 64))  # its shorter chunks
LRU_P2 = (1, 256, 2560)             # K4's second order: S 256, full width
WKV_P2 = (1, 128, 4, 64)            # K5's second order


def wkv_state_case(gen, b, s, h, n):
    """K5 from an initial state s0 with the final state's gradient dfinal,
    against the plain versions: out within 1e-4 (rtol = atol), the final
    state and every gradient (ds0 included) within 1e-4 of their largest
    magnitude; the call without s0 and dfinal bitwise the call with zero
    ones (the training call keeps its results)."""
    from repro_torch.kernels import ops, ref

    r, k, v, lw, u, do = wkv_inputs(gen, b, s, h, n, "model")
    s0 = 0.3 * torch.randn((b, h, n, n), generator=gen, device="cuda")
    dfinal = torch.randn((b, h, n, n), generator=gen, device="cuda")
    what = f"K5 with state {(b, s, h, n)}"
    out, states, final = ops.wkv6_fwd(r, k, v, lw, u, s0)
    r_out, _, r_final = ref.wkv6_fwd_ref(r, k, v, lw, u, s0)
    errs = {"out": check_close(f"{what} out", out, r_out, 1e-4),
            "final": check_grad(f"{what} final", final, r_final,
                                torch.float32)}
    got = ops.wkv6_bwd(r, k, v, lw, u, states, do, s0, final, dfinal)
    want = ref.wkv6_bwd_ref(r, k, v, lw, u, do, s0, dfinal)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got, want):
        require(bool(torch.isfinite(g).all()), f"{what}: non-finite {name}")
        errs[name] = check_grad(f"{what} {name}", g, w, torch.float32)
    zero = torch.zeros_like(s0)
    plain_call = ops.wkv6_fwd(r, k, v, lw, u)
    zero_call = ops.wkv6_fwd(r, k, v, lw, u, zero)
    require(all(x is y or torch.equal(x, y)
                for x, y in zip(plain_call, zero_call)),
            f"{what}: no s0 != zero s0")
    g_plain = ops.wkv6_bwd(r, k, v, lw, u, plain_call[1], do)
    g_zero = ops.wkv6_bwd(r, k, v, lw, u, plain_call[1], do, zero,
                          plain_call[2], zero)
    require(all(torch.equal(x, y) for x, y in zip(g_plain[:5], g_zero[:5])),
            f"{what}: no dfinal != zero dfinal")
    return (r, k, v, lw, u, s0), errs


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def second_order_case(name, fn, plain, inputs, weights, flop: float):
    """The double backward of ``sum |g|^2`` (g the first-order gradients of
    ``sum outs . weights``) through ``fn`` (the kernels, then the plain
    recompute) against the same through ``plain`` (autograd through the
    plain loops), within 1e-4 of the largest magnitude; the first order
    bitwise the kernels' backward; one plain call; the second-order call's
    ms (CUDA events) and its bound: the inputs, the weights and the first
    order read once, a gradient of each input written once, and ``flop``
    at the f32 rate (the call's inputs are f32)."""
    from repro_torch.kernels import ops

    def second(f):
        xs = [t.detach().requires_grad_(True) for t in inputs]
        outs = f(*xs)
        loss = sum((o * w).sum() for o, w in zip(outs, weights))
        g1 = torch.autograd.grad(loss, xs, create_graph=True)
        total = sum((g ** 2).sum() for g in g1)
        return xs, g1, torch.autograd.grad(total, xs, retain_graph=True), total

    ops.reset_launches()
    xs, g1, got, total = second(fn)
    torch.cuda.synchronize()
    calls = ops.plain_counts()[f"{name}_bwd2_plain"]
    require(calls == 1, f"{name} second order: {calls} plain calls")
    ms = time_ms(lambda: torch.autograd.grad(total, xs, retain_graph=True),
                 warmup=1, iters=3)
    g1 = [g.detach() for g in g1]
    nbytes = tensor_bytes(*inputs, *weights, *g1, *inputs)
    b_ms, by = bound(nbytes, flop)
    _, _, want, _ = second(plain)
    errs = {}
    for i, (g, w) in enumerate(zip(got, want)):
        errs[f"in{i}"] = check_grad(f"{name} second order input {i}", g, w,
                                    torch.float32)
    return g1, ms, errs, dict(bound_ms=b_ms, bound_by=by, bytes=nbytes,
                              flop=flop)


def phase_state_and_second_order(gen) -> dict:
    """K5 with a state (ragged S, and its times at a serve chunk of full
    rwkv6_3b), and the second order of K4 and K5 on the card (a plain
    recompute, as K2's)."""
    from repro_torch.kernels import ops, ref

    shapes = [(2, s, 2, 64) for s in WKV_STATE_SWEEP] + list(WKV_SERVE_RAGGED)
    for shape in shapes:
        _, errs = wkv_state_case(gen, *shape)
        log("kernels", name="K5 with state", shape=shape,
            errs=json.dumps({k: f"{v:.3e}" for k, v in errs.items()}))
    (r, k, v, lw, u, s0), errs = wkv_state_case(gen, *WKV_SERVE_SHAPE)
    nbytes, flop = wkv_work(*WKV_SERVE_SHAPE)["wkv6_fwd"]
    b, s, h, n = WKV_SERVE_SHAPE
    nbytes += 2 * b * h * n * n * 4  # s0 read, the final state written
    t_bytes = nbytes / peaks().HBM_BW * 1e3
    t_ops = 3 * flop / TF32_TC_OPS_PER_S * 1e3
    b_ms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    state = dict(shape=f"{WKV_SERVE_SHAPE} f32, model-like decays, s0",
                 err=max(errs.values()),
                 ms=time_ms(lambda: ops.wkv6_fwd(r, k, v, lw, u, s0)),
                 plain_ms=time_ms(lambda: ref.wkv6_fwd_ref(r, k, v, lw, u, s0),
                                  warmup=1, iters=WKV_PLAIN_RUNS),
                 bound_ms=b_ms, bound_by=by)
    log("kernels", name="wkv6_fwd with state", shape=WKV_SERVE_SHAPE,
        ms=f"{state['ms']:.4f}", plain_ms=f"{state['plain_ms']:.4f}",
        bound_ms=f"{b_ms:.4f}", bound_by=by, bytes=nbytes, flop=flop,
        errs=json.dumps({k_: f"{v_:.3e}" for k_, v_ in errs.items()}))
    del r, k, v, lw, u, s0

    out = {"with_state": state}
    bl, sl, wl = LRU_P2
    a = torch.rand(LRU_P2, generator=gen, device="cuda") * 0.9
    x = torch.randn(LRU_P2, generator=gen, device="cuda")
    h0 = torch.randn((bl, wl), generator=gen, device="cuda")
    w = [torch.randn(LRU_P2, generator=gen, device="cuda")]
    # FLOP: the forward's 2 and the backward's 3 per element (dh_t = dout_t
    # + a_{t+1} dh_{t+1}, da_t = dh_t h_{t-1}) recomputed, and the two
    # products of each in their transpose: 15 per element
    g1, ms, errs, b2 = second_order_case(
        "lru_scan", lambda *t: (ops.lru_scan(*t),),
        lambda *t: (ref.lru_scan_ref(*t),), (a, x, h0), w,
        flop=15.0 * a.numel())
    first = ops.lru_scan_bwd(a, ops.lru_scan_fwd(a, x, h0), w[0], h0)
    require(all(torch.equal(p, q) for p, q in zip(g1, first)),
            "K4 second order: first order != the kernels")
    out["lru_scan_bwd"] = {"ms": ms, "calls": 1, "shape": f"{LRU_P2} f32, h0",
                           "bound_ms": b2["bound_ms"],
                           "bound_by": b2["bound_by"]}
    log("kernels", name="K4 second order (plain recompute)", shape=LRU_P2,
        ms=f"{ms:.4f}", bound_ms=f"{b2['bound_ms']:.4f}",
        bound_by=b2["bound_by"], bytes=b2["bytes"], flop=b2["flop"],
        first_order_bitwise=True,
        errs=json.dumps({k_: f"{v_:.3e}" for k_, v_ in errs.items()}))
    r, k, v, lw, u, _ = wkv_inputs(gen, *WKV_P2, "model")
    b, s, h, n = WKV_P2
    s0 = 0.3 * torch.randn((b, h, n, n), generator=gen, device="cuda")
    w = [torch.randn(WKV_P2, generator=gen, device="cuda"),
         0.3 * torch.randn((b, h, n, n), generator=gen, device="cuda")]
    # FLOP: the forward's 4 N^2 and the backward's 8 N^2 per token and
    # head (``model_flop``'s WKV counts) recomputed, and twice that for
    # their transpose: 36 N^2
    g1, ms, errs, b2 = second_order_case(
        "wkv6", ops.wkv6, lambda *t: ref.wkv6_fwd_ref(*t)[::2],
        (r, k, v, lw, u, s0), w, flop=36.0 * n * n * b * s * h)
    _, states, final = ops.wkv6_fwd(r, k, v, lw, u, s0)
    first = ops.wkv6_bwd(r, k, v, lw, u, states, w[0], s0, final, w[1])
    require(all(torch.equal(p, q) for p, q in zip(g1, first)),
            "K5 second order: first order != the kernels")
    out["wkv6_bwd"] = {"ms": ms, "calls": 1,
                       "shape": f"{WKV_P2} f32, s0 and the final state",
                       "bound_ms": b2["bound_ms"], "bound_by": b2["bound_by"]}
    log("kernels", name="K5 second order (plain recompute)", shape=WKV_P2,
        ms=f"{ms:.4f}", bound_ms=f"{b2['bound_ms']:.4f}",
        bound_by=b2["bound_by"], bytes=b2["bytes"], flop=b2["flop"],
        first_order_bitwise=True,
        errs=json.dumps({k_: f"{v_:.3e}" for k_, v_ in errs.items()}))
    torch.cuda.empty_cache()
    return out


# [serve]: full-width models through launch.serve's schedulers. The main
# cell is the reference serve's default arch; the shorter runs drive the
# chunk steps of the hybrid (K4 with h0) and ssm (K5 with s0) families.
SERVE_RUNS = {
    "stablelm_3b": dict(requests=16, slots=4, lens=(16, 512), max_new=32,
                        chunk=64, max_len=576),
    "recurrentgemma_2b": dict(requests=6, slots=2, lens=(16, 300),
                              max_new=16, chunk=64, max_len=320),
    "rwkv6_3b": dict(requests=6, slots=2, lens=(16, 300), max_new=16,
                     chunk=64, max_len=320),
}
# [serve moe]: phi35_moe at 8 of its 32 layers (10.67 B parameters), bf16.
# MoE capacity depends on the chunk, so chunked prefill equals full prefill
# only for a prompt that fits one chunk: power-of-two prompts of 8-64
# tokens (``lens`` lists each request's; the reference's MoE serve test
# keeps the same constraint), and one warm-up request of 127 that builds
# every chunk bucket (hence max_len 144).
SERVE_MOE_RUN = dict(requests=8, slots=2,
                     prompt_lens=(64, 8, 32, 16, 64, 8, 16, 32),
                     max_new=16, chunk=64, max_len=144, layers=8)
SERVE_ORACLE_REQUESTS = 4      # requests checked against prefill + decode_step
SERVE_LOGITS_TOL = 2.0 ** -4   # prefill (K2) vs chunks, of max |logits|
SERVE_MOE_F32_TOL = 1e-3       # the same in f32 for MoE, of max |logits|


def serve_requests(serve_lib, cfg, seed, n, lens, max_new, sizes=None):
    """``n`` requests of seeded prompts, ``sizes`` long or, without them,
    of uniform lengths in ``lens`` (lo, hi)."""
    rng = np.random.default_rng(seed)
    if sizes is None:
        sizes = rng.integers(lens[0], lens[1] + 1, size=n)
    return [serve_lib.Request(
        rid=i, prompt=rng.integers(0, cfg.vocab_size, (int(m),)).astype(
            np.int32), max_new=max_new) for i, m in enumerate(sizes)]


def latency_stats(reqs, seconds: float) -> dict:
    """tokens/s over the run's wall seconds; TTFT (first token - arrival)
    and ITL (between a request's tokens) p50/p99 on the scheduler clock."""
    ttft = [r.t_first - r.arrival for r in reqs]
    itl = [b - a for r in reqs for a, b in zip(r.token_times,
                                               r.token_times[1:])]
    tokens = sum(len(r.generated) for r in reqs)
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else float("nan")
    return {"tokens": tokens, "seconds": seconds,
            "tokens_per_s": tokens / seconds,
            "ttft_p50_s": pct(ttft, 50), "ttft_p99_s": pct(ttft, 99),
            "itl_p50_ms": 1e3 * pct(itl, 50), "itl_p99_ms": 1e3 * pct(itl, 99)}


def serve_counts(eager: dict, replayed: dict) -> dict:
    """Kernel launches of a run: the wrappers' (eager calls) and the CUDA
    graph replays' (``replayed``)."""
    return {k: {"eager": eager[k], "replayed": replayed.get(k, 0)}
            for k in eager if eager[k] or replayed.get(k)}


def run_scheduler(serve_lib, cls, cfg, params, run, seed):
    """A scheduler over a warm-up request of 2 chunk - 1 tokens (every
    bucket built), then the seeded trace; the build counts flat across the
    trace. Returns (scheduler, requests, latency stats, counts, K4's
    routes in the warm-up's eager calls)."""
    from repro_torch.kernels import ops, rglru_scan

    sched = cls(cfg, params, run["slots"], max_len=run["max_len"],
                chunk=run["chunk"])
    ops.reset_launches()
    warm = serve_requests(serve_lib, cfg, seed + 100, 1,
                          (2 * run["chunk"] - 1,) * 2, 2)
    sched.run(warm)
    routes = dict(rglru_scan.ROUTE_LAUNCHES)
    builds = (sched.prefill_traces, sched.decode_traces)
    buckets = len(serve_lib.chunk_schedule(2 * run["chunk"] - 1, run["chunk"]))
    require(builds == (buckets, 1), f"{cls.__name__} builds {builds}, "
            f"expected ({buckets}, 1)")
    reqs = serve_requests(serve_lib, cfg, seed, run["requests"],
                          run.get("lens"), run["max_new"],
                          run.get("prompt_lens"))
    torch.cuda.synchronize()
    ops.reset_launches()
    before = sched.replayed_launches()
    t0 = time.perf_counter()
    sched.run(reqs)
    torch.cuda.synchronize()
    stats = latency_stats(reqs, time.perf_counter() - t0)
    replayed = {k: n - before.get(k, 0)
                for k, n in sched.replayed_launches().items()}
    counts = serve_counts(ops.launch_counts(), replayed)
    require((sched.prefill_traces, sched.decode_traces) == builds,
            f"{cls.__name__}: builds grew to "
            f"{(sched.prefill_traces, sched.decode_traces)} from {builds}")
    require(all(r.done and len(r.generated) == r.max_new for r in reqs),
            f"{cls.__name__}: unfinished requests")
    return sched, reqs, stats, counts, routes


# the kernels one replay of a full chunk step must run once per layer
SERVE_CHUNK_KERNELS = {"recurrent": ("tma_fwd_kernel",),
                       "rwkv": ("state_kernel", "scan_kernel", "out_kernel")}


def serve_chunk_replay(cont, cfg, params, reqs, c, kinds) -> dict:
    """The continuous scheduler's fused step for a full chunk of ``c``
    prompt tokens (first chunk of a request, into slot 0), replayed from
    its CUDA graph, bitwise the same step run eagerly on a copy of the pool
    and token feed; then one replay traced by kernel name: each kernel of
    ``SERVE_CHUNK_KERNELS`` once per layer of its kind, and no SIMT K4
    kernel."""
    from repro_torch.launch import steps
    from torch.utils import _pytree as pytree

    prompt = next(r.prompt for r in reqs if len(r.prompt) >= c)
    ctokens = cont._set_chunk(0, prompt, 0, c, True, True)
    args = (cont._tokens, cont._pool, cont._cslot, ctokens, cont._cpos,
            cont._cfirst, cont._cemit)
    tokens_copy = cont._tokens.clone()
    pool_copy = pytree.tree_map(torch.clone, cont._pool)
    replays = cont._serve.replays
    cont._serve(c, params, *args)
    steps.make_serve_step(cfg)(params, tokens_copy, pool_copy, *args[2:])
    torch.cuda.synchronize()
    require(cont._serve.replays == replays + 1,
            f"[serve] {cfg.name}: the {c}-token chunk step did not replay")
    require(torch.equal(cont._tokens, tokens_copy) and all(
        torch.equal(x, y) for x, y in zip(pytree.tree_leaves(cont._pool),
                                          pytree.tree_leaves(pool_copy))),
        f"[serve] {cfg.name}: replayed {c}-token chunk step != eager step")
    del pool_copy, tokens_copy
    want = {name: kinds.count(kind) for kind, names in
            SERVE_CHUNK_KERNELS.items() for name in names if kind in kinds}
    ran = {}
    if want:
        group = traced_calls({"chunk": lambda: cont._serve(c, params, *args)})
        for name, _ in group["chunk"]:
            if "repro::" in name:
                short = short_kernel_name(name).split("<")[0]
                ran[short] = ran.get(short, 0) + 1
        require(all(ran.get(k) == n for k, n in want.items())
                and not any(k.startswith("simt_") for k in ran),
                f"[serve] {cfg.name}: one replay of the {c}-token chunk "
                f"step ran {ran}, want {want} (once per layer)")
    log("serve", arch=cfg.name, check=f"{c}-token chunk step replay",
        bitwise_eager=True, replay_kernels=json.dumps(ran),
        want_per_layer=json.dumps(want))
    return {"bitwise": True, "kernels": ran}


def serve_per_slot(cont, cfg, params, trials: int = 4) -> dict:
    """MoE routing per slot: from the continuous scheduler's pool after its
    run, a slot decode step's logits for each slot are bitwise the same
    whatever token the other slot holds (``trials`` seeded tokens). The
    control routes both slots as one group (``moe.apply``'s own grouping,
    patched in): the first row's choices take the expert slots first, so
    the second row's logits can move with the first row's token; how
    often they did is logged."""
    from unittest import mock

    from repro_torch.models import moe, registry
    from torch.utils import _pytree as pytree

    decode = registry.make_decode_fn(cfg, route_rows=True)
    apply = moe.apply

    def logits(tokens, joint=False):
        routed = ((lambda cfg, p, x, group_size=None: apply(cfg, p, x))
                  if joint else apply)
        with torch.no_grad(), mock.patch.object(moe, "apply", routed):
            return decode(params, tokens,
                          pytree.tree_map(torch.clone, cont._pool))[0]

    base_tokens = cont._tokens.clone()
    base = logits(base_tokens)
    joint_base = logits(base_tokens, joint=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    moved = 0
    for _ in range(trials):
        other = torch.randint(0, cfg.vocab_size, (1,), generator=gen,
                              device="cuda", dtype=torch.int32)
        for slot in (0, 1):
            tokens = base_tokens.clone()
            tokens[1 - slot] = other
            require(torch.equal(logits(tokens)[slot], base[slot]),
                    f"[serve] {cfg.name}: slot {slot}'s decode logits moved "
                    f"with slot {1 - slot}'s token")
            moved += not torch.equal(logits(tokens, joint=True)[slot],
                                     joint_base[slot])
    log("serve", arch=cfg.name, check="MoE routing per slot",
        trials=trials, per_slot_bitwise=True,
        joint_routing_moved=f"{moved}/{2 * trials}")
    return {"bitwise": True, "joint_moved": moved}


def serve_moe_f32(cfg, reqs, run, layers: int = 2) -> dict:
    """The MoE prefill (K2 in every layer) against the chunked path (plain
    attention over the cache) in f32, at full width and ``layers``, on the
    first ``SERVE_ORACLE_REQUESTS`` prompts (each fits one chunk, so both
    paths route the same groups): last logits within ``SERVE_MOE_F32_TOL``
    of the largest, argmax equal. In bf16 the two attention paths differ by
    bf16 steps, which tip routing choices, and at init a layer's expert
    outputs dwarf the residual stream, so a tipped choice moves the logits
    wholesale: the bf16 comparison is logged, this one gated."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import registry, transformer

    cfg32 = dataclasses.replace(cfg, num_layers=layers, dtype="float32")
    params = registry.init_params(cfg32, seed=0, device="cuda")
    prefill = steps.make_prefill_step(cfg32, max_len=run["max_len"])
    chunk_fn = registry.make_chunk_prefill_fn(cfg32)
    worst, same = 0.0, 0
    ops.reset_launches()
    for r in reqs[:SERVE_ORACLE_REQUESTS]:
        require(len(r.prompt) <= run["chunk"], "[serve] MoE prompts must fit "
                "one chunk")
        prompt = torch.from_numpy(r.prompt)[None].cuda()
        with torch.no_grad():
            last, _ = prefill(params, {"tokens": prompt})
            caches = transformer.init_caches(cfg32, 1, run["max_len"],
                                             ring=False, device="cuda")
            clast, _ = chunk_fn(params, prompt, caches, 0)
        worst = max(worst, float((last - clast).abs().max()
                                 / last.abs().max()))
        same += int(torch.equal(last.argmax(-1), clast.argmax(-1)))
    k2 = ops.launch_counts()["flash_attention_fwd"]
    require(k2 == SERVE_ORACLE_REQUESTS * layers,
            f"[serve] f32 MoE prefill launched K2 {k2} times")
    require(worst <= SERVE_MOE_F32_TOL and same == SERVE_ORACLE_REQUESTS,
            f"[serve] f32 MoE prefill vs chunk: {worst:.3e} of max |logits|, "
            f"argmax equal {same}/{SERVE_ORACLE_REQUESTS}")
    log("serve", arch=cfg.name, check=f"f32 prefill (K2) vs chunk, {layers} "
        "layers", max_abs_over_max_logits=f"{worst:.3e}",
        gate=f"{SERVE_MOE_F32_TOL:.0e}",
        argmax_equal=f"{same}/{SERVE_ORACLE_REQUESTS}", k2_launches=k2)
    del params
    torch.cuda.empty_cache()
    return {"rel": worst, "k2_launches": k2}


def phase_serve(arch: str, seed: int = 0, run: dict = None) -> dict:
    """One architecture at full width (``run``, default ``SERVE_RUNS[arch]``;
    its ``layers`` cut the depth) through both schedulers: token for token,
    flat builds, the K4/K5 chunk launches, a replayed decode step bitwise
    the eager one with both timed; for the dense main cell and the MoE cell
    also prefill's last logits (K2) against the chunked path's and the
    share of tokens that agree with the batch-1 greedy oracle (gated for
    the dense cell only: in bf16 the two attention paths can tip an MoE
    routing choice); for MoE the per-slot routing (:func:`serve_per_slot`)."""
    import dataclasses

    from repro_torch.kernels import ops, rglru_scan
    from repro_torch.launch import serve as serve_lib
    from repro_torch.launch import steps
    from repro_torch.models import blocks, registry, transformer
    from torch.utils import _pytree as pytree

    t_phase = time.perf_counter()
    run = run or SERVE_RUNS[arch]
    cfg = registry.get_config(arch)
    if run.get("layers"):
        cfg = dataclasses.replace(cfg, num_layers=run["layers"])
    torch.cuda.reset_peak_memory_stats()
    params = registry.init_params(cfg, seed=seed, device="cuda")
    kinds = blocks.layer_kinds(cfg)
    cont, creqs, cstats, ccounts, routes = run_scheduler(
        serve_lib, serve_lib.ContinuousBatchingScheduler, cfg, params, run,
        seed)
    stat, sreqs, sstats, scounts, _ = run_scheduler(
        serve_lib, serve_lib.StaticWaveScheduler, cfg, params, run, seed)
    same = [c.generated == s.generated for c, s in zip(creqs, sreqs)]
    require(all(same), f"[serve] {arch}: continuous != static for requests "
            f"{[i for i, ok in enumerate(same) if not ok]}")
    chunks = [c for r in creqs for c in serve_lib.chunk_schedule(
        len(r.prompt), run["chunk"])]
    for name, kind, steps_run in (
            ("lru_scan_fwd", "recurrent", len(chunks)),
            ("wkv6_fwd", "rwkv", sum(c > 1 for c in chunks))):
        layers = kinds.count(kind)
        if not layers:
            continue
        for label, counts in (("continuous", ccounts), ("static", scounts)):
            got = counts.get(name, {"eager": 0, "replayed": 0})
            total = got["eager"] + got["replayed"]
            require(total == steps_run * layers,
                    f"[serve] {arch} {label}: {name} launched {got}, "
                    f"{steps_run} chunk steps x {layers} layers")
    log("serve", arch=arch, layers=cfg.num_layers, d_model=cfg.d_model,
        dtype=cfg.dtype, requests=run["requests"], slots=run["slots"],
        prompts=(json.dumps(run["prompt_lens"]) if "prompt_lens" in run
                 else f"{run['lens'][0]}-{run['lens'][1]}"),
        prompt_tokens=sum(len(r.prompt) for r in creqs),
        max_new=run["max_new"], chunk=run["chunk"], max_len=run["max_len"],
        continuous_equals_static=True,
        builds=f"prefill {cont.prefill_traces} decode {cont.decode_traces}",
        pool_mb=f"{registry.slot_pool_bytes(cfg, run['slots'], run['max_len']) / 2**20:.2f}")
    for label, stats, counts in (("continuous", cstats, ccounts),
                                 ("static", sstats, scounts)):
        log("serve", arch=arch, scheduler=label,
            tokens=stats["tokens"], seconds=f"{stats['seconds']:.3f}",
            tokens_per_s=f"{stats['tokens_per_s']:.1f}",
            ttft_p50_s=f"{stats['ttft_p50_s']:.4f}",
            ttft_p99_s=f"{stats['ttft_p99_s']:.4f}",
            itl_p50_ms=f"{stats['itl_p50_ms']:.3f}",
            itl_p99_ms=f"{stats['itl_p99_ms']:.3f}",
            launches=json.dumps(counts))
    if "recurrent" in kinds:
        like = lambda s: torch.empty((1, s, cfg.lru_width), device="cuda")
        h0 = torch.empty((1, cfg.lru_width), device="cuda")
        # the warm-up's eager chunk calls (one of each bucket, 64 down to
        # 1) ran K4 by the wrappers, which count the route they took
        log("serve", arch=arch, k4_route_s1=rglru_scan.route(like(1), like(1), h0),
            k4_route_s37=rglru_scan.route(like(37), like(37), h0),
            k4_warmup_routes=json.dumps(routes))
        require(routes["simt"] == 0 and routes["tma"] > 0,
                f"[serve] K4's routes in the warm-up {routes}")

    # a replayed decode step bitwise the eager step, and both timed
    decode = steps.make_slot_decode_step(cfg)
    tokens_copy = cont._tokens.clone()
    pool_copy = pytree.tree_map(torch.clone, cont._pool)
    cont._decode_all()
    decode(params, tokens_copy, pool_copy)
    torch.cuda.synchronize()
    require(torch.equal(cont._tokens, tokens_copy) and all(
        torch.equal(x, y) for x, y in zip(pytree.tree_leaves(cont._pool),
                                          pytree.tree_leaves(pool_copy))),
        f"[serve] {arch}: replayed decode step != eager step")
    replay_ms = time_ms(cont._decode_all, warmup=2, iters=10)
    eager_ms = time_ms(lambda: decode(params, tokens_copy, pool_copy),
                       warmup=2, iters=10)
    result = {"continuous": cstats, "static": sstats,
              "counts": {"continuous": ccounts, "static": scounts},
              "decode_replay_ms": replay_ms, "decode_eager_ms": eager_ms}
    result["chunk_step"] = serve_chunk_replay(cont, cfg, params, creqs,
                                              run["chunk"], kinds)
    if cfg.family == "moe":
        result["per_slot"] = serve_per_slot(cont, cfg, params)
    if arch == "stablelm_3b":
        # the decode step's kernels (run eagerly: the replay runs the same
        # ones): how many, and their device time summed
        group = traced_calls({"decode": lambda: decode(
            params, tokens_copy, pool_copy)})["decode"]
        busy = sum(us for _, us in group) / 1e3
        result.update(decode_kernels=len(group), decode_busy_ms=busy)
        log("serve", arch=arch, check="decode step trace (eager)",
            kernels=len(group), device_busy_ms=f"{busy:.4f}",
            top=json.dumps(sorted(
                ((short_kernel_name(n)[:60], round(us, 1)) for n, us in group),
                key=lambda t: -t[1])[:5]))
    del pool_copy, tokens_copy

    if arch == "stablelm_3b" or cfg.family == "moe":
        # prefill (K2 in every layer) against the chunked path, and the
        # greedy oracle (prefill + decode_step, batch 1)
        prefill_step = steps.make_prefill_step(cfg, max_len=run["max_len"])
        decode_step = steps.make_decode_step(cfg)
        chunk_fn = registry.make_chunk_prefill_fn(cfg)
        ops.reset_launches()
        agree, total, diverge = 0, 0, []
        worst, top_same = 0.0, 0
        for r in creqs[:SERVE_ORACLE_REQUESTS]:
            prompt = torch.from_numpy(r.prompt)[None].cuda()
            last, caches = prefill_step(params, {"tokens": prompt})
            with torch.no_grad():
                cc = transformer.init_caches(cfg, 1, run["max_len"],
                                             ring=False, device="cuda")
                pos = 0
                for c in serve_lib.chunk_schedule(len(r.prompt), run["chunk"]):
                    clast, cc = chunk_fn(params, prompt[:, pos:pos + c], cc,
                                         pos)
                    pos += c
                worst = max(worst, float((last - clast).abs().max()
                                         / last.abs().max()))
                top_same += int(torch.equal(last.argmax(-1), clast.argmax(-1)))
                del cc
            tok, out = last.argmax(-1)[:, None].to(torch.int32), []
            for _ in range(r.max_new):
                out.append(int(tok[0, 0]))
                logits, caches = decode_step(params, tok, caches)
                tok = logits.argmax(-1)[:, None].to(torch.int32)
            same_tok = [a == b for a, b in zip(out, r.generated)]
            agree += sum(same_tok)
            total += len(same_tok)
            diverge.append(same_tok.index(False) if False in same_tok
                           else len(same_tok))
            del caches
        counts = ops.launch_counts()
        require(counts["flash_attention_fwd"]
                == SERVE_ORACLE_REQUESTS * cfg.num_layers,
                f"[serve] prefill launched K2 {counts['flash_attention_fwd']} "
                f"times")
        require_flash_entries(f"[serve] {arch} prefill",
                              wgmma=wgmma_model(cfg),
                              need=("repro_flash_wg_fwd",))
        gated = cfg.family != "moe"
        require(worst <= SERVE_LOGITS_TOL or not gated,
                f"[serve] prefill vs chunks: {worst:.3e} of max |logits|")
        result.update(prefill_k2_launches=counts["flash_attention_fwd"],
                      logits_rel=worst, oracle_share=agree / total)
        log("serve", arch=arch,
            check=f"prefill (K2, hd {cfg.head_dim}) vs chunks",
            max_abs_over_max_logits=f"{worst:.3e}",
            gate=f"{SERVE_LOGITS_TOL:.4f}" if gated else "none (MoE)",
            argmax_equal=f"{top_same}/{SERVE_ORACLE_REQUESTS}",
            k2_launches=counts["flash_attention_fwd"])
        log("serve", arch=arch, check="greedy oracle (prefill + decode_step)",
            agree=f"{agree}/{total}", share=f"{agree / total:.3f}",
            first_divergence=json.dumps(diverge), gated=False)
    if cfg.family == "moe":
        result["f32_prefill_vs_chunk"] = serve_moe_f32(cfg, creqs, run)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # a decode step reads every weight but the embedding table once
    weight_bytes = sum(p.numel() * p.element_size() for k, p in params.items()
                       if k != "embed.table")
    log("serve", arch=arch, decode_step_replay_ms=f"{replay_ms:.4f}",
        decode_step_eager_ms=f"{eager_ms:.4f}", replay_bitwise_eager=True,
        decode_weight_bytes=weight_bytes,
        decode_weight_bytes_ms=f"{weight_bytes / peaks().HBM_BW * 1e3:.4f}",
        peak_gib=f"{peak:.2f}", seconds=f"{time.perf_counter() - t_phase:.1f}")
    result["peak_gib"] = peak
    del cont, stat, params
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# the remaining decoder architectures: K2 at their widths, the MoE layer,
# the VLM frontend
# ---------------------------------------------------------------------------

# K2 at the new configs' full-width attention (bf16, causal, hd 128), as
# the slice-14 phases run it: lm_1b's 16:16 (G 1) at [dense configs]'s
# batch 4 x seq 512, qwen2_72b's 64:8 (G 8), phi35_moe's 32:8 (G 4),
# qwen3_moe's 64:4 (G 16) and llava_next_34b's 56:8 (yi_34b's backbone,
# G 7)
FLASH_WIDE = {"lm_1b": (4, 512, 16, 16, 128),
              "qwen2_72b": (1, 4096, 64, 8, 128),
              "phi35_moe": (1, 4096, 32, 8, 128),
              "qwen3_moe": (1, 4096, 64, 4, 128),
              "llava_next_34b": (1, 4096, 56, 8, 128)}


def phase_flash_wide(gen) -> dict:
    """K2 forward and both backward kernels at ``FLASH_WIDE``'s shapes
    against their plain versions, timed beside their bounds, the plain
    versions and SDPA (:func:`flash_measure`), their kernels checked by
    name in one trace of all three shapes. Returns {kernel: {arch: row}}."""
    measured = {arch: flash_measure(gen, b, s, hq, hkv, hd, 0)
                for arch, (b, s, hq, hkv, hd) in FLASH_WIDE.items()}
    traced = kernel_names({(arch, label): fn for arch, m in measured.items()
                           for label, fn in m["calls"].items()})
    out = {}
    for arch, m in measured.items():
        mine = {label: names for (a, label), names in traced.items()
                if a == arch}
        for name, r in flash_report(m, mine).items():
            out.setdefault(name, {})[arch] = r
    del measured
    torch.cuda.empty_cache()
    return out


# K2 in the encoder-decoder's regimes (seamless_m4t_medium: 16:16 heads of
# 64, bf16): the encoder's non-causal self-attention over 4096 frames, the
# decoder's cross-attention of 512 text tokens (train) and of one token (a
# decode step, B 4) against the 4096-frame memory.
FLASH_ENCDEC = {"encoder": (2, 4096, 4096, 16, 16, 64),
                "cross_train": (2, 512, 4096, 16, 16, 64),
                "cross_decode": (4, 1, 4096, 16, 16, 64)}
FLASH_ENCDEC_SWEEP = tuple(  # (B, Sq, Skv, Hq, Hkv, hd, causal, window)
    (b, sq, skv, hq, hkv, hd, False, 0)
    for b, sq, skv, hq, hkv, hd in tuple(FLASH_ENCDEC.values())
    + ((1, 100, 1000, 4, 2, 64),))  # ragged: Sq, Skv not tile multiples


def phase_flash_encdec(gen) -> dict:
    """K2 non-causal at ``FLASH_ENCDEC``'s shapes and a ragged case, f32
    and bf16, forward and both backward kernels against their plain
    versions (:func:`flash_sweep`: the gates and the route of each
    dtype); then in bf16 the times of the three shapes beside their
    bounds, the plain versions and SDPA (:func:`flash_measure`), and the
    decode cross-attention's forward against the plain einsum form
    (``attention.naive_attention``, information). Returns {kernel:
    {shape name: row}} and the decode comparison."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention

    flash_sweep(gen, FLASH_ENCDEC_SWEEP, "kernels", "K2 encdec sweep")
    torch.cuda.empty_cache()
    measured = {name: flash_measure(gen, b, sq, hq, hkv, hd, 0, skv=skv,
                                    causal=False)
                for name, (b, sq, skv, hq, hkv, hd) in FLASH_ENCDEC.items()}
    traced = kernel_names({(name, label): fn for name, m in measured.items()
                           for label, fn in m["calls"].items()})
    out = {}
    for name, m in measured.items():
        mine = {label: names for (a, label), names in traced.items()
                if a == name}
        for kernel, r in flash_report(m, mine).items():
            out.setdefault(kernel, {})[name] = r
    del measured
    b, sq, skv, hq, hkv, hd = FLASH_ENCDEC["cross_decode"]
    q = torch.randn((b, sq, hq, hd), generator=gen, device="cuda").bfloat16()
    k = torch.randn((b, skv, hkv, hd), generator=gen, device="cuda").bfloat16()
    v = torch.randn((b, skv, hkv, hd), generator=gen, device="cuda").bfloat16()
    with torch.no_grad():
        k2 = ops.flash_attention(q, k, v, causal=False)
        einsum = attention.naive_attention(q, k, v, causal=False)
        err = float((k2.double() - einsum.double()).abs().max())
        decode = dict(
            k2_ms=time_ms(lambda: ops.flash_attention(q, k, v, causal=False)),
            einsum_ms=time_ms(
                lambda: attention.naive_attention(q, k, v, causal=False)),
            max_abs_diff=err)
    log("kernels", name="K2 cross decode vs plain einsum (information)",
        shape=(b, sq, skv, f"{hq}:{hkv}", hd), k2_ms=f"{decode['k2_ms']:.4f}",
        einsum_ms=f"{decode['einsum_ms']:.4f}", max_abs_diff=f"{err:.3e}")
    torch.cuda.empty_cache()
    return {"kernels": out, "decode": decode}


def bf16_within(what, got, want) -> float:
    """A bf16 result against the same computed in f32: ``|got - want| <=
    2^-6 |want| + 1e-2 max |want|`` (two bf16 steps, plus a floor for the
    sums of bf16-rounded products that cancel); returns max |err| / max
    |want|."""
    diff = (got.double() - want.double()).abs()
    top = float(want.double().abs().max())
    excess = float((diff - 2.0 ** -6 * want.double().abs() - 1e-2 * top).max())
    require(excess <= 0, f"{what}: beyond two bf16 steps + 1e-2 max|f32| by "
            f"{excess} (max abs err {float(diff.max())}, max {top})")
    return float(diff.max()) / top


def phase_moe_layer(tokens: int = 4096) -> dict:
    """[moe layer]: one full-width MoE layer of phi35_moe (16 experts, top
    2) and of qwen3_moe (128 experts, top 8) on ``tokens`` bf16 tokens,
    against the same layer in f32 (its bf16 weights and input in f32; the
    router is f32 in both): the same choices kept and dropped, bitwise
    (the router sees the same values); the output within
    :func:`bf16_within`; the aux loss within 1e-3 relative. Logs the
    dropped share and each dtype's ms (CUDA events)."""
    import dataclasses

    from repro_torch.models import moe, registry

    out = {}
    for arch in ("phi35_moe", "qwen3_moe"):
        cfg = dataclasses.replace(registry.get_config(arch), dtype="bfloat16")
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        gen = torch.Generator(device="cuda").manual_seed(0)
        with torch.no_grad():
            p16 = {k: v.detach() for k, v in
                   moe.MoE(cfg, gen, device="cuda").named_parameters()}
            p32 = {k: v.float() for k, v in p16.items()}
            x = torch.randn((1, tokens, cfg.d_model), generator=gen,
                            device="cuda").bfloat16()
            gs = moe._group_size(tokens)
            r16 = moe.route(cfg, p16, x.reshape(-1, gs, cfg.d_model))
            r32 = moe.route(cfg32, p32, x.float().reshape(-1, gs, cfg.d_model))
            require(torch.equal(r16.onehot, r32.onehot)
                    and torch.equal(r16.kept, r32.kept),
                    f"[moe layer] {arch}: bf16 and f32 route differently")
            chosen = int(r16.onehot.sum())
            dropped = chosen - int(r16.kept.sum())
            out16, aux16 = moe.apply(cfg, p16, x)
            out32, aux32 = moe.apply(cfg32, p32, x.float())
            err = bf16_within(f"[moe layer] {arch} out", out16, out32)
            aux_rel = abs(float(aux16) - float(aux32)) / abs(float(aux32))
            require(aux_rel <= 1e-3, f"[moe layer] {arch}: aux bf16 "
                    f"{float(aux16)} vs f32 {float(aux32)}")
            ms16 = time_ms(lambda: moe.apply(cfg, p16, x), 2, 10)
            ms32 = time_ms(lambda: moe.apply(cfg32, p32, x.float()), 2, 10)
        out[arch] = dict(err=err, aux_rel=aux_rel, dropped=dropped,
                         chosen=chosen, ms_bf16=ms16, ms_f32=ms32)
        log("moe layer", arch=arch, tokens=tokens, experts=cfg.num_experts,
            top_k=cfg.experts_per_token, group=gs, capacity=r16.capacity,
            routing_equal=True, chosen=chosen, dropped=dropped,
            dropped_share=f"{dropped / chosen:.4f}",
            out_err_over_max=f"{err:.3e}", aux_bf16=float(aux16),
            aux_f32=float(aux32), aux_rel=f"{aux_rel:.3e}",
            ms_bf16=f"{ms16:.4f}", ms_f32=f"{ms32:.4f}")
        del p16, p32, out16, out32, r16, r32
        torch.cuda.empty_cache()
    return out


def phase_vlm(layers: int = 2, patches: int = 2880, text: int = 1216,
              new: int = 8) -> dict:
    """[vlm]: llava_next_34b at full width and ``layers`` of its 60 layers.
    Loss and gradients with ``patches`` patch embeddings and ``text``
    tokens (f32, :func:`phase_grads`), then in bf16 ``make_prefill_fn``
    with the embeddings (K2 once a layer) and ``new`` greedy decode steps:
    the prefill's and the last decode step's logits each within
    ``SERVE_LOGITS_TOL`` of the largest of ``transformer.forward``'s last
    logits over the same embeddings and tokens (K2 in every layer; the
    decode steps attend the cache in plain PyTorch, as the reference's
    einsums)."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.models import registry, transformer

    t0 = time.perf_counter()
    grad_launches = phase_grads("vlm grads", "llava_next_34b", layers=layers,
                                seq=patches + text, patches=patches)
    cfg = dataclasses.replace(registry.get_config("llava_next_34b"),
                              num_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    params = registry.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    embeds = torch.randn((1, patches, cfg.d_model), generator=gen,
                         device="cuda").bfloat16()
    prompt = torch.randint(0, cfg.vocab_size, (1, text), generator=gen,
                           device="cuda")
    prefill = registry.make_prefill_fn(cfg, max_len=patches + text + new)
    decode = registry.make_decode_fn(cfg)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    with torch.no_grad():
        ops.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        last, caches = prefill(params, {"tokens": prompt, "embeds": embeds})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        k2 = ops.launch_counts()["flash_attention_fwd"]
        require(k2 == layers, f"[vlm] prefill launched K2 {k2} times")
        require(caches[0]["k"].shape[1] == patches + text + new
                and int(caches[0]["pos"]) == patches + text,
                "[vlm] prefill caches")
        tokens, step_s = [], []
        logits = last
        for _ in range(new):
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            tokens.append(tok)
            t = time.perf_counter()
            logits, caches = decode(params, tok, caches)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
        require(bool(torch.isfinite(logits).all()), "[vlm] decode logits")
        want_prefill = transformer.forward(cfg, params, prompt,
                                           embeds=embeds)[:, -1]
        full = torch.cat([prompt] + [t.long() for t in tokens], dim=1)
        want_last = transformer.forward(cfg, params, full,
                                        embeds=embeds)[:, -1]
    prefill_rel, decode_rel = rel(last, want_prefill), rel(logits, want_last)
    require(prefill_rel <= SERVE_LOGITS_TOL and decode_rel <= SERVE_LOGITS_TOL,
            f"[vlm] prefill {prefill_rel:.3e} / decode {decode_rel:.3e} of "
            f"max |logits| from the forward's")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log("vlm", layers=layers, d_model=cfg.d_model, heads=f"{cfg.num_heads}:"
        f"{cfg.num_kv_heads}", dtype=cfg.dtype, patches=patches, text=text,
        params=sum(v.numel() for v in params.values()), prefill_k2=k2,
        prefill_s=f"{prefill_s:.4f}",
        decode_step_ms=[round(1e3 * v, 3) for v in step_s],
        prefill_vs_forward=f"{prefill_rel:.3e}",
        decode_vs_forward=f"{decode_rel:.3e}", gate=f"{SERVE_LOGITS_TOL:.4f}",
        tokens=[int(t) for t in tokens], peak_gib=f"{peak:.2f}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    del params, caches
    torch.cuda.empty_cache()
    return {"grad_launches": grad_launches, "prefill_k2_launches": k2,
            "prefill_rel": prefill_rel, "decode_rel": decode_rel}


# [encdec]: seamless_m4t_medium at full width and depth (12 + 12 layers,
# bf16): flat local-SGD rounds on frames batches, gradients at 2 + 2 f32
# layers, prefill and greedy decode with memory K/V.
ENCDEC = "seamless_m4t_medium"
ENCDEC_ROUNDS = dict(rounds=2, cohort=2, local_steps=2, batch=2, frames=4096)
ENCDEC_SERVE = dict(prompts=4, frames=4096, text=64, new=32)


def phase_encdec_rounds() -> dict:
    """``ENCDEC_ROUNDS['rounds']`` flat local-SGD rounds of full
    seamless_m4t_medium through ``algorithms.rounds.make_local_sgd_round``
    (``launch.train.build_round_fn``'s round, no compression;
    ``launch.train.train`` itself refuses an encoder-decoder, as the
    reference's), each round's
    data a ``registry.make_batch`` frames batch of (cohort, local steps)
    x B frames x max(frames // 8, 16) text tokens made on the host before
    its clock starts. Every client step runs each encoder and decoder
    layer once (no checkpoint: the reference scans both stacks without
    one), so a round launches K2's forward and each backward kernel
    exactly cohort x steps x (12 encoder + 12 self + 12 cross) times.
    Logs losses, seconds, tokens/s (frames and text), peak memory and the
    launches of each round."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import registry

    run = ENCDEC_ROUNDS
    cfg = registry.get_config(ENCDEC)
    args = flat_args(arch=ENCDEC, rounds=run["rounds"], cohort=run["cohort"],
                     local_steps=run["local_steps"], batch=run["batch"],
                     seq=run["frames"], compression="none")
    torch.cuda.reset_peak_memory_stats()
    params = registry.init_params(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in params.values())
    round_fn, server_opt = train.build_round_fn(cfg, args)
    state = server_opt.init(params)
    steps = run["cohort"] * run["local_steps"]
    per_step = cfg.encoder_layers + 2 * cfg.num_layers
    text = max(run["frames"] // 8, 16)
    losses, seconds, launches = [], [], []
    for r in range(run["rounds"]):
        data = registry.make_batch(cfg, run["batch"], run["frames"], seed=r,
                                   lead=(run["cohort"], run["local_steps"]))
        ops.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, state, metrics = round_fn(params, state, data)
        losses.append(float(metrics["loss"]))
        seconds.append(time.perf_counter() - t)
        counts = ops.launch_counts()
        launches.append({k: v for k, v in counts.items() if v})
        want = steps * per_step
        require_flash_entries(f"[encdec] round {r}", wgmma=wgmma_model(cfg),
                              decode=False)
        require(counts["flash_attention_fwd"] == want
                and counts["flash_attention_bwd_dq"] == want
                and counts["flash_attention_bwd_dkdv"] == want,
                f"[encdec] round {r}: K2 launched {counts}, want {want} of "
                f"each")
        del data
    require(all(math.isfinite(v) for v in losses),
            f"[encdec] non-finite losses {losses}")
    tokens = steps * run["batch"] * (run["frames"] + text)
    log("encdec", step="rounds", arch=ENCDEC, layers=f"{cfg.encoder_layers}"
        f"+{cfg.num_layers}", params=n_params, dtype=cfg.dtype,
        cohort=run["cohort"], local_steps=run["local_steps"],
        batch=run["batch"], frames=run["frames"], text=text,
        losses=[round(v, 5) for v in losses],
        round_s=[round(v, 3) for v in seconds],
        tokens_per_s=[round(tokens / v, 1) for v in seconds],
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        launches_per_round=json.dumps(launches[-1]))
    del params, state, round_fn
    gc.collect()
    torch.cuda.empty_cache()
    return launches[-1]


def phase_encdec_serve() -> dict:
    """``ENCDEC_SERVE``: full seamless_m4t_medium (bf16), ``encdec.prefill``
    of 4 prompts of 64 text tokens over 4096 frames (K2: 12 non-causal
    encoder, 12 causal decoder and 12 cross calls), then 32 greedy
    ``launch.steps.make_decode_step`` steps with the memory K/V (K2 once a
    decoder layer, Sq = 1 against the memory). Prefill's last logits
    within one bf16 step (:func:`check_bf16`) of a train-mode
    ``decode_stack``'s over the prompt at that position (the same kernels
    at the same shapes); each decoded step's logits within
    ``SERVE_LOGITS_TOL`` of the largest of a teacher-forced train-mode
    ``decode_stack`` over the prompt and the decoded tokens (the decode
    steps attend the cache in plain PyTorch, bf16 probabilities, as the
    reference's einsums), their worst one-bf16-step excess logged; every
    greedy token equal to the teacher-forced argmax, except where that
    position's two top logits lie within twice the step's logits
    difference (counted)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import encdec, registry

    run = ENCDEC_SERVE
    cfg = registry.get_config(ENCDEC)
    torch.cuda.reset_peak_memory_stats()
    params = registry.init_params(cfg, seed=1, device="cuda")
    batch = registry.make_batch(cfg, run["prompts"], run["frames"], seed=11)
    frames, prompt = batch["frames"], batch["tokens"][:, :run["text"]]
    decode = steps.make_decode_step(cfg)
    per_layer = cfg.encoder_layers + 2 * cfg.num_layers
    with torch.no_grad():
        ops.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        last, caches, mkv = encdec.prefill(cfg, params, frames, prompt,
                                           max_len=run["text"] + run["new"])
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        prefill_k2 = ops.launch_counts()["flash_attention_fwd"]
        require(prefill_k2 == per_layer,
                f"[encdec] prefill launched K2 {prefill_k2} times, want "
                f"{per_layer}")
        toks, outs, step_s = [last.argmax(-1)[:, None].to(torch.int32)], [], []
        ops.reset_launches()
        for _ in range(run["new"]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, caches = decode(params, toks[-1], caches, mkv)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            outs.append(logits)
            toks.append(logits.argmax(-1)[:, None].to(torch.int32))
        decode_s = sum(step_s)
        decode_k2 = ops.launch_counts()["flash_attention_fwd"]
        require(decode_k2 == run["new"] * cfg.num_layers,
                f"[encdec] decode launched K2 {decode_k2} times")
        # every cross-attention call of a decode step (Sq 1, 16:16 heads)
        # took the split-KV decode kernels
        require_flash_entries("[encdec] decode steps", decode=True)
        decode_route = {k: n for k, n in fa.ROUTE_LAUNCHES.items()
                        if k[0] == "repro_flash_decode"}
        require(sum(decode_route.values()) == decode_k2,
                f"[encdec] decode steps: {decode_route} of {decode_k2} K2 "
                f"launches on the decode kernels")
        require(int(caches[0]["pos"]) == run["text"] + run["new"],
                "[encdec] decode caches")
        train_last = encdec.decode_stack(cfg, params, prompt, None,
                                         memory_kv=mkv)[0][:, -1]
        full = torch.cat([prompt] + toks[:-1], dim=1)
        tf, _ = encdec.decode_stack(cfg, params, full, None, memory_kv=mkv)
    prefill_err = check_bf16("[encdec] prefill vs train-mode decode_stack",
                             last, train_last)
    top = float(tf.abs().max())
    worst_rel, worst_excess, ties, checked = 0.0, -math.inf, 0, 0
    for i, got in enumerate(outs):
        want = tf[:, run["text"] + i]
        diff = (got.double() - want.double()).abs()
        worst_rel = max(worst_rel, float(diff.max()) / top)
        lim = 2.0 ** -7 * want.double().abs() + 1e-3 * float(
            want.double().abs().max())
        worst_excess = max(worst_excess, float((diff - lim).max()))
        top2 = want.topk(2, dim=-1).values
        for row in range(want.shape[0]):
            checked += 1
            if int(toks[i + 1][row]) == int(want[row].argmax()):
                continue
            gap = float(top2[row, 0] - top2[row, 1])
            require(gap <= 2 * float(diff[row].max()),
                    f"[encdec] step {i} row {row}: greedy token "
                    f"{int(toks[i + 1][row])} is not the teacher-forced "
                    f"argmax {int(want[row].argmax())} (gap {gap})")
            ties += 1
    require(worst_rel <= SERVE_LOGITS_TOL,
            f"[encdec] decode logits {worst_rel:.3e} of max |logits| from "
            f"the teacher-forced forward's")
    new_tokens = run["prompts"] * run["new"]
    log("encdec", step="serve", prompts=run["prompts"], frames=run["frames"],
        text=run["text"], new=run["new"], prefill_k2=prefill_k2,
        decode_k2=decode_k2, decode_route=json.dumps(
            {k[0]: n for k, n in decode_route.items()}),
        prefill_s=f"{prefill_s:.4f}",
        decode_s=f"{decode_s:.4f}",
        decode_tokens_per_s=f"{new_tokens / decode_s:.1f}",
        decode_step_ms_first=f"{1e3 * step_s[0]:.3f}",
        decode_step_ms_median=f"{1e3 * statistics.median(step_s):.3f}",
        prefill_vs_train_max_abs=f"{prefill_err:.3e}",
        decode_vs_forward=f"{worst_rel:.3e}", gate=f"{SERVE_LOGITS_TOL:.4f}",
        decode_one_step_excess=f"{worst_excess:.3e}",
        greedy_checked=checked, greedy_near_ties=ties,
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    del params, caches, mkv, tf
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill_k2": prefill_k2, "decode_k2": decode_k2,
            "tokens_per_s": new_tokens / decode_s}


# the bf16 FFN products at lm_350m's FFN (8192 tokens: B 2 x S 4096) and
# at phi35_moe's experts (4096 tokens in groups of 512: 640 slots an
# expert)
FFN_PRODUCTS = {"lm_350m": ((8192, 1024), (1024, 4096)),
                "phi35_moe": ((16, 640, 4096), (16, 4096, 6400))}


def bf16_steps_beyond(got, want) -> int:
    """Elements of ``got`` more than one bf16 step (``2^-7 |want| + 1e-3
    max |want|``) from ``want``."""
    want = want.double()
    lim = 2.0 ** -7 * want.abs() + 1e-3 * float(want.abs().max())
    return int(((got.double() - want).abs() > lim).sum())


def phase_ffn_f32_products(gen) -> dict:
    """[encdec] step=bf16 ffn: ``common.matmul_f32`` (one cuBLAS call with
    bf16 inputs and an f32 output, ``aten::mm.dtype`` / ``bmm.dtype``) at
    ``FFN_PRODUCTS`` against the f32 product of f32 copies of the same
    bf16 inputs (exact products; only the order of the f32 sums differs):
    max abs error within 2e-5 of the largest magnitude. Its gradients, the
    reference's transpose of an f32-output product (the f32 cotangent
    against the bf16 operand, through ``common.split3_bf16``), are within
    one bf16 step of bf16 of the f32 product of f32 copies, zero elements
    beyond; so are they under non-reentrant checkpointing, bitwise. The
    old backward (the cotangent rounded to bf16 once, autograd of
    ``matmul(a, b).float()``) is the control: its count beyond is logged.
    Logs the ms of the three forward forms and of the old and new backward
    (CUDA events)."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models import common

    require(hasattr(torch.ops.aten.mm, "dtype"),
            f"torch {torch.__version__} has no aten::mm.dtype")
    out = {}
    for arch, (sa, sb) in FFN_PRODUCTS.items():
        a = torch.randn(sa, generator=gen, device="cuda").bfloat16()
        b = (torch.randn(sb, generator=gen, device="cuda")
             / math.sqrt(sb[-2])).bfloat16()
        got = common.matmul_f32(a, b)
        want = torch.matmul(a.float(), b.float())
        require(got.dtype == torch.float32, "[encdec] matmul_f32 dtype")
        err = float((got.double() - want.double()).abs().max())
        rel = err / float(want.abs().max())
        require(rel <= 2e-5, f"[encdec] matmul_f32 {arch}: {rel:.3e} of the "
                f"largest magnitude from the f32 product")
        del want
        g = torch.randn(got.shape, generator=gen, device="cuda")
        want_grads = (
            torch.matmul(g, b.float().transpose(-1, -2)).bfloat16(),
            torch.matmul(a.float().transpose(-1, -2), g).bfloat16())
        grads = {}
        for form, fn in (("old", lambda x, y: torch.matmul(x, y).float()),
                         ("new", common.matmul_f32),
                         ("new_ckpt", lambda x, y: checkpoint(
                             common.matmul_f32, x, y, use_reentrant=False))):
            x, y = (t.detach().requires_grad_() for t in (a, b))
            grads[form] = torch.autograd.grad(fn(x, y), (x, y), g)
        beyond = {form: [bf16_steps_beyond(p, q) for p, q in
                         zip(grads[form], want_grads)] for form in grads}
        require(beyond["new"] == [0, 0] and all(
            p.dtype == torch.bfloat16 for p in grads["new"]),
            f"[encdec] matmul_f32 {arch}: gradients (da, db) beyond one bf16 "
            f"step of the f32 product's: {beyond['new']}")
        require(all(torch.equal(p, q) for p, q in
                    zip(grads["new_ckpt"], grads["new"])),
                f"[encdec] matmul_f32 {arch}: checkpointed gradients differ")
        ms = time_ms(lambda: common.matmul_f32(a, b))
        old_ms = time_ms(lambda: torch.matmul(a, b).float())
        up_ms = time_ms(lambda: torch.matmul(a.float(), b.float()))
        g16 = g.bfloat16()
        bwd_old_ms = time_ms(lambda: (
            torch.matmul(g16, b.transpose(-1, -2)),
            torch.matmul(a.transpose(-1, -2), g16)))
        bwd_new_ms = time_ms(lambda: common.matmul_f32_grads(a, b, g))
        out[arch] = dict(rel=rel, ms=ms, bf16_out_ms=old_ms,
                         f32_upcast_ms=up_ms, bwd_old_ms=bwd_old_ms,
                         bwd_new_ms=bwd_new_ms, beyond=beyond)
        log("encdec", step="bf16 ffn", arch=arch, a=tuple(sa), b=tuple(sb),
            torch=torch.__version__, err_over_max=f"{rel:.3e}", limit="2e-5",
            grads_beyond_one_bf16_step_new=beyond["new"],
            grads_beyond_one_bf16_step_old=beyond["old"],
            grad_elements=[a.numel(), b.numel()],
            ckpt_grads_bitwise_new=True, ms_mm_dtype=f"{ms:.4f}",
            ms_bf16_out_then_f32=f"{old_ms:.4f}",
            ms_f32_upcast=f"{up_ms:.4f}",
            ms_backward_old_one_rounding=f"{bwd_old_ms:.4f}",
            ms_backward_new_split3=f"{bwd_new_ms:.4f}")
        del a, b, got, grads, want_grads, g, g16
    torch.cuda.empty_cache()
    return out


def phase_encdec(gen) -> dict:
    """[encdec]: rounds, grads (2 + 2 f32 layers at 4096 frames and 512
    text tokens), serve and the bf16 FFN products."""
    t0 = time.perf_counter()
    rounds = phase_encdec_rounds()
    grads = phase_grads("encdec grads", ENCDEC, layers=2, seq=4096)
    served = phase_encdec_serve()
    ffn = phase_ffn_f32_products(gen)
    log("encdec", step="done", seconds=f"{time.perf_counter() - t0:.1f}")
    return {"rounds": rounds, "grads": grads, "serve": served, "ffn": ffn}


def phase_chaos(smi: str) -> dict:
    """[chaos]: ``runtime.chaos.run_chaos_soak(ChaosConfig(device="cuda"))``
    at the reference's full-soak defaults (48 rounds, 4 pods x 2 clients, 2
    device failures, 4 elastic events, 2 checkpoint faults, serve bursts
    through reduced stablelm_3b every 16 rounds with the injected scheduler
    fault). ``run_chaos_soak`` asserts every invariant; the phase requires
    again the bitwise oracle, one client-leg trace, one cross leg per pod
    count, every kill survived and the serve builds flat after the
    warm-up, and logs the report's counters, ``wall_s``,
    ``serve_p99_contended``, the straggler percentiles and the kernels'
    launches in the soak (its regression and the continuous scheduler's
    chunked prefill launch none: the reference's chunk step attends over
    the cache without the flash kernel)."""
    import dataclasses

    from repro_torch.kernels import ops
    from repro_torch.runtime import chaos

    t0 = time.perf_counter()
    cfg = chaos.ChaosConfig(device="cuda")
    ops.reset_launches()
    report = chaos.run_chaos_soak(cfg)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    seconds = time.perf_counter() - t0
    serve = report.serve
    require(report.oracle_bitwise_equal, "[chaos] final state is not bitwise "
            "the uninterrupted oracle's")
    require(report.client_leg_traces == 1 and report.oracle_extra_traces == 0,
            f"[chaos] client-leg traces {report.client_leg_traces}, oracle "
            f"extra {report.oracle_extra_traces}")
    require(report.cross_compiles == len(report.pods_seen),
            f"[chaos] {report.cross_compiles} cross legs for pod counts "
            f"{report.pods_seen}")
    require(report.device_failures == cfg.num_device_failures
            and len(report.elastic_events) == cfg.num_elastic_events
            and len(report.ckpt_faults_injected) == cfg.num_ckpt_faults,
            f"[chaos] faults injected: {report.device_failures} failures, "
            f"{len(report.elastic_events)} elastic events, "
            f"{report.ckpt_faults_injected}")
    require(report.mid_write_kills_survived == report.mid_write_kills_injected,
            f"[chaos] kills survived {report.mid_write_kills_survived} of "
            f"{report.mid_write_kills_injected}")
    require(serve is not None and serve["flat_traces"]
            and serve["completed"] == serve["requests"]
            and serve["faults_injected"] == 1 and serve["recoveries"] >= 1,
            f"[chaos] serve: {serve}")
    j = report.to_json()
    for key in ("restarts", "scratch_restarts", "completed_steps",
                "replayed_steps", "failure_rounds", "restores",
                "fallback_restores", "ckpt_faults_injected",
                "elastic_events", "pods_seen", "client_leg_traces",
                "cross_compiles", "oracle_extra_traces",
                "mid_write_kills_injected", "mid_write_kills_survived"):
        log("chaos", **{key: json.dumps(j[key])})
    log("chaos", straggler=json.dumps(report.straggler),
        audit=json.dumps(report.audit))
    log("chaos", serve=json.dumps(serve),
        serve_p99_contended=report.serve_p99_contended)
    log("chaos", loss_first=report.loss_first, loss_final=report.loss_final,
        oracle_bitwise_equal=report.oracle_bitwise_equal,
        wall_s=report.wall_s, phase_seconds=f"{seconds:.1f}",
        kernel_launches=json.dumps({k: n for k, n in counts.items() if n}),
        config=json.dumps({k: v for k, v in dataclasses.asdict(cfg).items()
                           if k in ("rounds", "num_pods", "clients_per_pod",
                                    "num_device_failures",
                                    "num_elastic_events", "num_ckpt_faults",
                                    "serve_every", "serve_arch")}),
        card=smi)
    return {"report": j, "seconds": seconds, "launches": counts}


# [mesh]: the distributed layer on the card. The card machine has one
# H100, so (a) is a one-rank NCCL mesh in this process, and (b) and (c)
# are gloo worlds whose ranks share the card (gloo carries broadcast and
# all_reduce of CUDA tensors): they run the multi-rank paths, they do not
# time a multi-card run. The spawned ranks run this file with
# ``--mesh-rank`` and load the kernels [build] built.
MESH_TIMEOUT_S = 300.0
MESH_SOAK = dict(rounds=20, seed=1, num_pods=4, clients_per_pod=2,
                 num_device_failures=1, num_elastic_events=2,
                 num_ckpt_faults=1, checkpoint_every=4, audit_every=8,
                 serve_traffic=False)


def mesh_flat_round(mesh=None, ann: bool = True):
    """[flat]'s int8 round of full lm_350m (cohort 4, seq 512), its clients
    over "data" of ``mesh`` when given."""
    import functools

    from repro_torch.algorithms import rounds
    from repro_torch.launch import train
    from repro_torch.models import registry

    args = flat_args()
    cfg = registry.get_config(args.arch)
    client_opt, server_opt = train.optimizers(args)
    round_cfg = rounds.LocalSGDConfig(
        partition_size=args.cohort, num_local_steps=args.local_steps,
        grad_clip=1.0, compression="int8",
        partition_axes="data" if mesh is not None else None, mesh=mesh,
        use_sharding_annotations=ann)
    return cfg, args, rounds.make_local_sgd_round(
        functools.partial(registry.loss_fn, cfg), client_opt, server_opt,
        round_cfg), server_opt


def mesh_rounds(fn, params, state, data, rounds: int) -> dict:
    """``rounds`` rounds from ``params``: losses, seconds, launches, peak."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    losses, seconds = [], []
    for r in range(rounds):
        t0 = time.perf_counter()
        params, state, metrics = fn(params, state, data(r))
        losses.append(float(metrics["loss"]))
        seconds.append(time.perf_counter() - t0)
    return dict(params=params, losses=losses, seconds=seconds,
                launches=ops.launch_counts(),
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def flat_data(cfg, args):
    from repro_torch.data.grouped import CohortSampler, GroupedCorpus

    sampler = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                            cohort_size=args.cohort)

    def data(r):
        d = sampler.round_batch(r, args.local_steps, args.batch, args.seq,
                                device="cuda")
        return {"tokens": d["tokens"], "labels": d["labels"]}

    return data


def phase_mesh_one_rank(workdir: str) -> dict:
    """[mesh] (a): a (pod 1, data 1) mesh from ``mesh_for_placements`` in a
    world of one NCCL rank. [flat]'s int8 round (K1a, K1b, K2) with its
    clients over "data", and [hier]'s fused int8 round 2 x 2 at
    ``HIER_LAYERS`` layers (K2, K3b) with pods over "pod" and clients over
    "data": losses and parameters bitwise the mesh-free rounds', launch
    counts equal. Saves
    the mesh-free flat round's first parameters for (b)."""
    import torch.distributed as dist

    from repro_torch import compat
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import registry

    backend = compat.init_process_group(
        0, 1, init_method=f"file://{workdir}/rendezvous_a", device="cuda")
    require(backend == "nccl", f"one-rank mesh on {backend}, not nccl")
    mesh = mesh_lib.mesh_for_placements({"pods": 1, "clients": 1},
                                        device="cuda")
    out = {}
    cfg, args, plain_fn, server_opt = mesh_flat_round()
    _, _, mesh_fn, _ = mesh_flat_round(mesh)
    data = flat_data(cfg, args)
    params = registry.init_params(cfg, seed=args.seed, device="cuda")
    state = server_opt.init(params)
    one = mesh_rounds(plain_fn, params, state, data, 1)
    torch.save({k: v.cpu() for k, v in params.items()},
               os.path.join(workdir, "base.pt"))
    torch.save({k: v.cpu() for k, v in one["params"].items()},
               os.path.join(workdir, "round1.pt"))
    del one
    plain = mesh_rounds(plain_fn, params, state, data, 2)
    meshed = mesh_rounds(mesh_fn, params, state, data, 2)
    require_flash_entries("[mesh] flat", wgmma=wgmma_model(cfg))
    require(plain["losses"] == meshed["losses"],
            f"[mesh] flat losses {meshed['losses']} != mesh-free "
            f"{plain['losses']}")
    require_equal([meshed["params"][k] for k in plain["params"]],
                  list(plain["params"].values()), "[mesh] flat params")
    require(plain["launches"] == meshed["launches"]
            and meshed["launches"]["quantize"] >= 2 * args.cohort
            and meshed["launches"]["flash_attention_fwd"] > 0,
            f"[mesh] flat launches {meshed['launches']} vs mesh-free "
            f"{plain['launches']}")
    out["flat"] = meshed["launches"]
    log("mesh", step="a", round="flat", mesh="(pod 1, data 1)",
        backend=backend, losses=[round(v, 5) for v in meshed["losses"]],
        round_s=[round(v, 3) for v in meshed["seconds"]],
        mesh_free_round_s=[round(v, 3) for v in plain["seconds"]],
        bitwise=True, launches=json.dumps(meshed["launches"]))
    del plain, meshed, params, state
    gc.collect()
    torch.cuda.empty_cache()

    hargs = flat_args(rounds=2)
    hcfg = hier_config(hargs)
    hparams = registry.init_params(hcfg, seed=hargs.seed, device="cuda")
    plain_h, hserver = hier_round_fn(hcfg, hargs, pods=2, fused=True)
    mesh_h, _ = hier_round_fn(hcfg, hargs, pods=2, fused=True, mesh=mesh)
    hstate = hserver.init(hparams)
    hflat = flat_data(hcfg, hargs)

    def hdata(r):
        return {k: v.reshape((2, 2) + tuple(v.shape[1:]))
                for k, v in hflat(r).items()}

    hruns = {name: mesh_rounds(fn, hparams, hstate, hdata, 2)
             for name, fn in (("plain", plain_h), ("mesh", mesh_h))}
    plain, meshed = hruns["plain"], hruns["mesh"]
    require(plain["losses"] == meshed["losses"],
            f"[mesh] hier losses {meshed['losses']} != {plain['losses']}")
    require_equal([meshed["params"][k] for k in plain["params"]],
                  list(plain["params"].values()), "[mesh] hier params")
    require(plain["launches"] == meshed["launches"]
            and meshed["launches"]["reduce_compress_roundtrip"] >= 2,
            f"[mesh] hier launches {meshed['launches']} vs "
            f"{plain['launches']}")
    out["hier"] = meshed["launches"]
    log("mesh", step="a", round="hier", layers=hcfg.num_layers,
        mesh="(pod 1, data 1)", backend=backend,
        losses=[round(v, 5) for v in meshed["losses"]],
        round_s=[round(v, 3) for v in meshed["seconds"]],
        mesh_free_round_s=[round(v, 3) for v in plain["seconds"]],
        bitwise=True, launches=json.dumps(meshed["launches"]))
    del hruns, hparams, hstate
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_world(kind: str, world: int, workdir: str) -> list:
    """Spawn ``world`` ranks of this file (``--mesh-rank``) on a gloo world
    sharing the card, wait for them all under one deadline (killing them
    all on a failure or at the deadline) and return each rank's JSON."""
    rdzv = os.path.join(workdir, f"rendezvous_{kind}")
    procs = []
    for rank in range(world):
        log_path = os.path.join(workdir, f"{kind}_rank{rank}.log")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--mesh-rank", kind,
             str(rank), str(world), rdzv, workdir],
            stdout=open(log_path, "w"), stderr=subprocess.STDOUT))
    deadline = time.monotonic() + MESH_TIMEOUT_S
    while any(p.poll() is None for p in procs):
        if (any(p.poll() not in (None, 0) for p in procs)
                or time.monotonic() > deadline):
            break
        time.sleep(0.1)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    results, bad = [], []
    for rank, p in enumerate(procs):
        path = os.path.join(workdir, f"{kind}_rank{rank}.json")
        if p.returncode != 0 or not os.path.exists(path):
            with open(os.path.join(workdir, f"{kind}_rank{rank}.log")) as fh:
                bad.append(f"rank {rank} exit {p.returncode}:\n"
                           f"{fh.read()[-3000:]}")
            continue
        with open(path) as fh:
            results.append(json.load(fh))
    require(not bad, f"[mesh] {kind} world failed:\n" + "\n".join(bad))
    return results


def mesh_rank_main(kind: str, rank: int, world: int, rdzv: str,
                   workdir: str) -> int:
    """One rank of a [mesh] gloo world (``python3 chip_smoke.py
    --mesh-rank <kind> <rank> <world> <rendezvous> <dir>``)."""
    from repro_torch import compat
    from repro_torch.kernels import _build

    require(all(_build.KERNELS.path(n).exists() for n in _build.SOURCES),
            "[mesh] a spawned rank found no built kernels under build/")
    compat.init_process_group(rank, world, init_method=f"file://{rdzv}",
                              device="cuda", backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if kind in ("tp", "tpc"):
        out = tp_rank_main(kind, rank, world, workdir)
    else:
        out = (mesh_rank_flat(rank, world, workdir) if kind == "b"
               else mesh_rank_soak(rank, world, workdir))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(workdir, f"{kind}_rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    return 0


def mesh_rank_flat(rank: int, world: int, workdir: str) -> dict:
    """(b) on one rank: [flat]'s first round with the 4 clients sharded 2 a
    rank over "data", then with ``use_sharding_annotations=False``
    (DrJAX-NS, 4 clients a rank): each one's peak and the parameters held
    to (a)'s mesh-free round (rank 0)."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import registry

    mesh = mesh_lib.make_mesh((world,), ("data",), device="cuda")
    out = {}
    want = (torch.load(os.path.join(workdir, "round1.pt")) if rank == 0
            else None)
    base = (torch.load(os.path.join(workdir, "base.pt")) if rank == 0
            else None)
    for name, ann in (("drjax", True), ("ns", False)):
        cfg, args, fn, server_opt = mesh_flat_round(mesh, ann)
        params = registry.init_params(cfg, seed=args.seed, device="cuda")
        run = mesh_rounds(fn, params, server_opt.init(params),
                          flat_data(cfg, args), 1)
        got = {k: v.cpu() for k, v in run["params"].items()}
        res = dict(loss=run["losses"][0], round_s=run["seconds"][0],
                   peak_gib=run["peak_gib"], launches=run["launches"])
        if rank == 0:
            steps = quant_steps({k: want[k].float() - base[k].float()
                                 for k in want})
            res["worst"], res["equal"] = agree_within_step(
                got, want, steps, rel=2.0 ** -7)
            res["bitwise"] = all(torch.equal(got[k], want[k]) for k in want)
        out[name] = res
        del params, run, got
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_rank_soak(rank: int, world: int, workdir: str) -> dict:
    """(c) on one rank: the physical chaos soak at the reference's
    acceptance config (``tests/test_chaos.py:194-201``) on the card."""
    from repro_torch.runtime import chaos

    rep = chaos.run_chaos_soak(chaos.ChaosConfig(
        **MESH_SOAK, physical_mesh=True, device="cuda",
        ckpt_dir=os.path.join(workdir, "soak_ckpt")))
    return rep.to_json()


def phase_mesh() -> dict:
    """[mesh]: (a) one NCCL rank in this process, (b) the flat int8 round on
    2 gloo ranks sharing the card against (a) and against DrJAX-NS (the
    paper's Fig. 6 as client copies a rank, 2 against 4), (c) the physical
    chaos soak on 8 gloo ranks sharing the card, every invariant
    required."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="mesh_") as workdir:
        counts = phase_mesh_one_rank(workdir)
        t_a = time.perf_counter() - t0
        flat = mesh_world("b", 2, workdir)
        r0 = flat[0]
        for name in ("drjax", "ns"):
            require(r0[name]["worst"] <= 1.0,
                    f"[mesh] (b) {name} beyond the int8 round tolerance of "
                    f"(a)'s mesh-free round: {r0[name]['worst']}")
            require(all(r[name]["loss"] == r0[name]["loss"] for r in flat),
                    f"[mesh] (b) {name} losses differ between ranks")
        log("mesh", step="b", ranks=2, backend="gloo",
            clients_per_rank={"drjax": 2, "ns": 4},
            peak_gib={name: [round(r[name]["peak_gib"], 2) for r in flat]
                      for name in ("drjax", "ns")},
            round_s={name: [round(r[name]["round_s"], 3) for r in flat]
                     for name in ("drjax", "ns")},
            loss={name: r0[name]["loss"] for name in ("drjax", "ns")},
            worst_over_tolerance={name: round(r0[name]["worst"], 4)
                                  for name in ("drjax", "ns")},
            equal_fraction={name: round(r0[name]["equal"], 6)
                            for name in ("drjax", "ns")},
            ns_bitwise=r0["ns"]["bitwise"],
            launches=json.dumps({name: r0[name]["launches"]
                                 for name in ("drjax", "ns")}))
        t_b = time.perf_counter() - t0 - t_a
        soak = mesh_world("c", 8, workdir)
    rep = soak[0]
    require(all(r["oracle_bitwise_equal"] and r["physical_mesh"]
                for r in soak), "[mesh] (c) soak not bitwise its oracle")
    require(rep["reshards"] >= len(rep["elastic_events"]) >= 1
            and rep["cross_compiles"] == rep["meshes_seen"] >= 2
            and rep["mesh_migrate_ms"] > 0,
            f"[mesh] (c) reshards {rep['reshards']}, cross legs "
            f"{rep['cross_compiles']}, meshes {rep['meshes_seen']}, "
            f"migrate {rep['mesh_migrate_ms']} ms")
    log("mesh", step="c", ranks=8, backend="gloo", reshards=rep["reshards"],
        meshes_seen=rep["meshes_seen"], cross_compiles=rep["cross_compiles"],
        mesh_migrate_ms=rep["mesh_migrate_ms"],
        elastic_events=json.dumps(rep["elastic_events"]),
        restarts=rep["restarts"], fallback_restores=rep["fallback_restores"],
        loss_first=rep["loss_first"], loss_final=rep["loss_final"],
        wall_s=[r["wall_s"] for r in soak])
    log("mesh", seconds=f"{time.perf_counter() - t0:.1f}",
        one_rank_s=f"{t_a:.1f}", two_ranks_s=f"{t_b:.1f}",
        soak_s=f"{time.perf_counter() - t0 - t_a - t_b:.1f}")
    return counts



# [tp]: the model-parallel half of the distributed layer on the card, in
# gloo worlds whose ranks share it, as [mesh]'s (b) and (c): (a) and (b)
# on a (data 1, model 2) mesh of 2 ranks, (c) on a (data 2, model 2) mesh
# of 4. The multi-rank paths run; a multi-card run is not timed.
TP_TRAIN = dict(arch="lm_1b", batch=4, seq=512, steps=2, lr=3e-4)
TP_PREFILL = dict(arch="qwen2_72b", layers=2, batch=4, seq=512)
TP_ROUND = dict(arch="lm_350m", partition=4, local_steps=2, batch=2,
                seq=512)
# (a) the mesh step's parameter update against the mesh-free step's: the
# worst leaf's ||mesh - mesh-free|| / ||mesh-free - start|| (an update
# that is unchanged reads 1; the mesh-free update from half the batch is
# run beside it as a second control, and both controls must fail the
# gate). On the H100 the sound run reads 0.177, the controls 1 and 0.970;
# AdamW's step is blind to a gradient's scale, which the CPU world's SGD
# steps check. The losses within 2^-10 relative (4.3e-5 read)
TP_TRAIN_UPDATE_GAP = 2.0 ** -2
TP_TRAIN_LOSS_REL = 2.0 ** -10
# (c) the round's loss within PR 27's reduce tolerance of the mesh-free
# round's
TP_LOSS_REL = 2.0 ** -7
# (b) the int8 prefill's logits against the bf16-wire prefill's
TP_INT8_COSINE = 0.9999
# (c) the round's new parameters: within 2^-4 of each leaf's largest
# round update plus four bf16 steps of the parameter (its two local
# steps, the clients' mean and the server step each round once; two
# steps read 0.889 of the gate on the card)
TP_ROUND_UPDATE_REL = 2.0 ** -4
TP_ROUND_ULPS = 4


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 at each |x| (at least the smallest normal's)."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


def tp_spies(heads: list, worst: list):
    """Record each K2 call's query heads (``ops.flash_attention``) and each
    int8 reduction's worst ``|int8 sum - exact| / (sum_j s_j + m ulps)``
    (``tpcomm.int8_sum``; the exact sum by an all_reduce of the f32
    partials). Returns the function that removes them."""
    from repro_torch.kernels import ops
    from repro_torch.models import partitioning, tpcomm

    real_fa, real_sum = ops.flash_attention, tpcomm.int8_sum

    def fa(q, *args, **kwargs):
        heads.append(int(q.shape[2]))
        return real_fa(q, *args, **kwargs)

    def int8_sum(part):
        out = real_sum(part)
        dims = partitioning.model_dims()
        exact = partitioning.all_reduce_sum(part, dims)
        _, s = tpcomm._quant_rows(part)
        scales = partitioning.all_reduce_sum(s, dims)
        m = partitioning.model_size()
        ulp = torch.nextafter(exact.abs(), torch.full_like(exact, math.inf)) \
            - exact.abs()
        worst.append(float(((out - exact).abs() / (scales + m * ulp)).max()))
        return out

    # models/attention.py calls K2 through this module attribute
    ops.flash_attention, tpcomm.int8_sum = fa, int8_sum

    def undo():
        ops.flash_attention, tpcomm.int8_sum = real_fa, real_sum

    return undo


def tp_entries() -> dict:
    from repro_torch.kernels import flash_attention as fa

    out = {}
    for (entry, _, _), n in fa.ROUTE_LAUNCHES.items():
        out[entry] = out.get(entry, 0) + n
    return out


def tp_rank_train(rank: int, world: int, workdir: str) -> dict:
    """(a) on one rank: two AdamW steps of whole lm_1b on the (data 1,
    model 2) mesh, parameters and moments as DTensors; rank 0 then runs
    the mesh-free steps from the same parameters and holds the mesh's to
    them."""
    import torch.distributed as dist

    from repro_torch import optim
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import partitioning, registry

    run = TP_TRAIN
    mesh = mesh_lib.make_mesh((1, world), ("data", "model"), device="cuda")
    cfg = registry.get_config(run["arch"])
    whole = registry.init_params(cfg, seed=0, device="cuda")
    batches = [registry.make_batch(cfg, run["batch"], run["seq"], seed=s,
                                   device="cuda") for s in (1, 2)]
    opt = optim.adamw(run["lr"])
    step, _ = steps.make_sgd_train_step(cfg, mesh, lr=run["lr"], fsdp=False)
    p_axes = registry.param_axes(cfg)
    params = steps.shard_tree(whole, p_axes, mesh, steps.strategy_rules(
        cfg, False))
    state = opt.init(params)
    heads, worst = [], []
    undo = tp_spies(heads, worst)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    partitioning.reset_routes()
    losses, seconds = [], []
    for b in batches:
        t0 = time.perf_counter()
        params, state, loss = step(params, state, b)
        losses.append(float(loss))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    undo()
    out = dict(losses=losses, step_s=seconds,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=ops.launch_counts(), entries=tp_entries(),
               heads=sorted(set(heads)), routes=_routes(),
               local_wq=tuple(params["layers.0.attn.wq"].to_local().shape))
    got = {k: partitioning.full(v) for k, v in params.items()}
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        plain, _ = steps.make_sgd_train_step(cfg, lr=run["lr"], fsdp=False)

        def mesh_free(rows):
            p, o, losses = whole, opt.init(whole), []
            for b in batches:
                p, o, loss = plain(p, o, {k: v[:rows] for k, v in b.items()})
                losses.append(float(loss))
            return p, losses

        want, plain_losses = mesh_free(run["batch"])
        equal, total = 0, 0
        for k, w in want.items():
            equal += int((got[k] == w).sum())
            total += w.numel()
        # the controls: the start (no update) and the mesh-free update from
        # half the batch's rows
        half, _ = mesh_free(run["batch"] // 2)
        out.update(plain_losses=plain_losses,
                   update_gap=update_gap(got, want, whole),
                   control_gap={"unchanged": update_gap(whole, want, whole),
                                "half_batch": update_gap(half, want, whole)},
                   equal_fraction=equal / total)
    dist.barrier()
    return out


def update_gap(got: dict, want: dict, start: dict) -> float:
    """The worst leaf's ``||got - want|| / ||want - start||``: how far an
    update from ``start`` lands from the update ``want`` made, relative to
    that update's size (0 where both leave a leaf as it was)."""
    worst = 0.0
    for k, w in want.items():
        gap = float((got[k].float() - w.float()).norm())
        size = float((w.float() - start[k].float()).norm())
        worst = max(worst, gap / size if size else
                    (0.0 if gap == 0 else math.inf))
    return worst


def _routes() -> dict:
    from repro_torch.models import partitioning

    return {(k if isinstance(k, str) else "/".join(k)): v
            for k, v in partitioning.ROUTES.items()}


def tp_rank_prefill(rank: int, world: int, workdir: str) -> dict:
    """(b) on one rank: the prefill of qwen2_72b at 2 of 80 layers, full
    width, on the (data 1, model 2) mesh, with the bf16 wire and with
    ``tp_comm="int8"``; rank 0 also runs the mesh-free prefill."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import partitioning, registry, tpcomm

    run = TP_PREFILL
    mesh = mesh_lib.make_mesh((1, world), ("data", "model"), device="cuda")
    cfg = dataclasses.replace(registry.get_config(run["arch"]),
                              num_layers=run["layers"])
    params = registry.init_params(cfg, seed=0, device="cuda")
    batch = {"tokens": registry.make_batch(cfg, run["batch"], run["seq"],
                                           seed=3, device="cuda")["tokens"]}
    out, logits = {}, {}
    for wire in ("bf16", "int8"):
        step = steps.make_prefill_step(cfg, mesh, tp_comm=wire,
                                       max_len=run["seq"])
        # an untimed call with the spies (K2's heads and each int8
        # reduction against its exact sum, an all_reduce of the f32
        # partials), then the timed call without them
        heads, worst = [], []
        undo = tp_spies(heads, worst)
        try:
            step(params, batch)
        finally:
            undo()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        partitioning.reset_routes()
        t0 = time.perf_counter()
        logits[wire], caches = step(params, batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        out[wire] = dict(seconds=seconds,
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                         launches=ops.launch_counts(), entries=tp_entries(),
                         heads=sorted(set(heads)), routes=_routes(),
                         bound=max(worst) if worst else None,
                         cache=str(caches[0]["k"].placements))
        del caches
    a, b = logits["int8"].double(), logits["bf16"].double()
    out["cosine"] = float((a * b).sum() / a.norm() / b.norm())
    t = run["batch"] * run["seq"]
    out["wire_bytes"] = run["layers"] * tpcomm.int8_wire_bytes(
        world * t, cfg.d_model, world)
    out["bf16_wire_bytes"] = run["layers"] * tpcomm.bf16_wire_bytes(
        t, cfg.d_model, world)
    if rank == 0:
        plain = steps.make_prefill_step(cfg, max_len=run["seq"])(params,
                                                                 batch)[0]
        diff = (logits["bf16"].double() - plain.double()).abs()
        out["plain_rel"] = float(diff.max() / plain.double().abs().max())
    dist.barrier()
    return out


def tp_rank_round(rank: int, world: int, workdir: str) -> dict:
    """(c) on one rank: the DrJAX round of lm_350m (dp strategy) on the
    (data 2, model 2) mesh, every all_reduce's group recorded; rank 0 then
    runs the mesh-free round."""
    import torch.distributed as dist

    from repro_torch import optim
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import registry

    run = TP_ROUND
    mesh = mesh_lib.make_mesh((2, world // 2), ("data", "model"),
                              device="cuda")
    cfg = registry.get_config(run["arch"])
    params = registry.init_params(cfg, seed=0, device="cuda")
    data = registry.make_batch(cfg, run["batch"], run["seq"], seed=5,
                               lead=(run["partition"], run["local_steps"]),
                               device="cuda")
    state = optim.fedavg_momentum(1.0).init(params)
    fn, *_ = steps.make_drjax_round_step(
        cfg, mesh, partition_size=run["partition"],
        num_local_steps=run["local_steps"])
    groups, heads = [], []
    real = dist.all_reduce

    def spy(t, *args, group=None, **kwargs):
        if group is not None:
            groups.append(tuple(dist.get_process_group_ranks(group)))
        return real(t, *args, group=group, **kwargs)

    undo = tp_spies(heads, [])
    dist.all_reduce = spy
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    try:
        new, _, metrics = fn({k: v.clone() for k, v in params.items()},
                             state, data)
        torch.cuda.synchronize()
    finally:
        dist.all_reduce = real
        undo()
    out = dict(loss=float(metrics["loss"]), round_s=time.perf_counter() - t0,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=ops.launch_counts(), entries=tp_entries(),
               heads=sorted(set(heads)), groups=sorted(set(groups)),
               data_group=[int(r) for r in mesh["data"].mesh.tolist()],
               model_group=[int(r) for r in mesh["model"].mesh.tolist()])
    if rank == 0:
        plain, *_ = steps.make_drjax_round_step(
            cfg, partition_size=run["partition"],
            num_local_steps=run["local_steps"])
        want, _, pm = plain({k: v.clone() for k, v in params.items()},
                            state, data)
        worst = 0.0
        for k, w in want.items():
            update = float((w.float() - params[k].float()).abs().max())
            diff = (new[k].float() - w.float()).abs()
            tol = (TP_ROUND_UPDATE_REL * update
                   + TP_ROUND_ULPS * bf16_ulp(w.float().abs()))
            worst = max(worst, float((diff / tol).max()))
        out.update(plain_loss=float(pm["loss"]), param_worst=worst)
    dist.barrier()
    return out


def tp_rank_main(kind: str, rank: int, world: int, workdir: str) -> dict:
    if kind == "tp":
        train = tp_rank_train(rank, world, workdir)
        # rank 0's mesh-free steps leave their blocks cached: the ranks
        # share the card
        gc.collect()
        torch.cuda.empty_cache()
        return {"train": train,
                "prefill": tp_rank_prefill(rank, world, workdir)}
    return {"round": tp_rank_round(rank, world, workdir)}


def phase_tp() -> dict:
    """[tp]: (a) ``make_sgd_train_step`` of whole lm_1b (24 x d 2048, 16
    heads x 128, tp, AdamW, FSDP off) on B 4 x S 512, 2 steps, on a (data
    1, model 2) mesh of 2 gloo ranks sharing the card; (b) the prefill of
    qwen2_72b at 2 of 80 layers, full width, B 4 x S 512, bf16 wire and
    int8; (c) ``make_drjax_round_step`` of lm_350m (dp), partition 4, 2
    local steps, B 2 x S 512, on a (data 2, model 2) mesh of 4 ranks.
    Each held to the mesh-free step of rank 0 within its stated
    tolerance; no part catches a failure."""
    import tempfile

    from repro_torch.models import registry

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tp_") as workdir:
        ab = mesh_world("tp", 2, workdir)
        t_ab = time.perf_counter() - t0
        c = mesh_world("tpc", 4, workdir)
    # (a)
    tr = [r["train"] for r in ab]
    a0 = tr[0]
    cfg = registry.get_config(TP_TRAIN["arch"])
    local_heads = cfg.num_heads // 2
    for r in tr:
        require(r["heads"] == [local_heads],
                f"[tp] (a) K2 ran on {r['heads']} heads, not {local_heads}")
        require(all(r["entries"].get(e, 0) > 0 for e in
                    ("repro_flash_wg_fwd", "repro_flash_wg_bwd_dq",
                     "repro_flash_wg_bwd_dkdv")),
                f"[tp] (a) the wgmma K2 kernels did not all launch: "
                f"{r['entries']}")
        require(r["losses"] == a0["losses"], "[tp] (a) ranks' losses differ")
    for got, want in zip(a0["losses"], a0["plain_losses"]):
        require(abs(got - want) <= TP_TRAIN_LOSS_REL * abs(want),
                f"[tp] (a) loss {got} vs mesh-free {want}")
    require(a0["update_gap"] <= TP_TRAIN_UPDATE_GAP,
            f"[tp] (a) the mesh step's update is {a0['update_gap']} of the "
            f"mesh-free step's away from it (gate {TP_TRAIN_UPDATE_GAP})")
    require(all(v > TP_TRAIN_UPDATE_GAP for v in a0["control_gap"].values()),
            f"[tp] (a) a control passes the update gate "
            f"{TP_TRAIN_UPDATE_GAP}: {a0['control_gap']}")
    route = "all_reduce" if "gather/all_reduce" in a0["routes"] else \
        "all_gather"
    log("tp", step="a", arch=TP_TRAIN["arch"], mesh="(data 1, model 2)",
        ranks=2, backend="gloo", batch=TP_TRAIN["batch"], seq=TP_TRAIN["seq"],
        losses=a0["losses"], mesh_free_losses=a0["plain_losses"],
        update_gap=a0["update_gap"], update_gate=TP_TRAIN_UPDATE_GAP,
        control_gap=json.dumps(a0["control_gap"]),
        equal_fraction=round(a0["equal_fraction"], 6),
        step_s=[[round(v, 3) for v in r["step_s"]] for r in tr],
        peak_gib=[round(r["peak_gib"], 2) for r in tr],
        local_heads=local_heads, local_wq=a0["local_wq"],
        k2_launches=[{e: n for e, n in r["entries"].items()} for r in tr],
        gather_route=route, routes=json.dumps(a0["routes"]))
    # (b)
    pf = [r["prefill"] for r in ab]
    b0 = pf[0]
    qcfg = registry.get_config(TP_PREFILL["arch"])
    for r in pf:
        for wire in ("bf16", "int8"):
            require(r[wire]["heads"] == [qcfg.num_heads // 2],
                    f"[tp] (b) {wire} K2 heads {r[wire]['heads']}")
            require(r[wire]["entries"].get("repro_flash_wg_fwd", 0) > 0,
                    f"[tp] (b) {wire}: no wgmma K2 forward")
        i8 = r["int8"]["routes"]
        require(i8.get("int8 gathers", 0) >= TP_PREFILL["layers"],
                f"[tp] (b) int8 gathers {i8.get('int8 gathers')}")
        require("int8 gathers" not in r["bf16"]["routes"],
                "[tp] (b) the bf16 prefill gathered int8")
        require(i8.get("int8 payload bytes") == r["wire_bytes"],
                f"[tp] (b) int8 payload {i8.get('int8 payload bytes')} != "
                f"int8_wire_bytes {r['wire_bytes']}")
        require(r["int8"]["bound"] is not None and r["int8"]["bound"] <= 1.0,
                f"[tp] (b) an int8 reduction beyond its bound: "
                f"{r['int8']['bound']}")
        require(r["cosine"] > TP_INT8_COSINE,
                f"[tp] (b) int8 logits' cosine {r['cosine']}")
    require(b0["plain_rel"] <= 2.0 ** -6,
            f"[tp] (b) bf16 TP prefill vs mesh-free: {b0['plain_rel']} of "
            "the largest logit")
    log("tp", step="b", arch=TP_PREFILL["arch"],
        layers=f"{TP_PREFILL['layers']} of {qcfg.num_layers}", ranks=2,
        batch=TP_PREFILL["batch"], seq=TP_PREFILL["seq"],
        cosine=b0["cosine"], int8_bound=b0["int8"]["bound"],
        bf16_vs_mesh_free=b0["plain_rel"],
        int8_gathers=b0["int8"]["routes"]["int8 gathers"],
        int8_payload_bytes=b0["int8"]["routes"]["int8 payload bytes"],
        int8_wire_bytes=b0["wire_bytes"], bf16_wire_bytes=b0["bf16_wire_bytes"],
        prefill_s={w: [round(r[w]["seconds"], 3) for r in pf]
                   for w in ("bf16", "int8")},
        peak_gib={w: [round(r[w]["peak_gib"], 2) for r in pf]
                  for w in ("bf16", "int8")},
        cache=b0["int8"]["cache"],
        k2_launches={w: [r[w]["entries"] for r in pf]
                     for w in ("bf16", "int8")},
        gather_route="all_reduce" if "gather/all_reduce" in
        b0["int8"]["routes"] else "all_gather",
        routes=json.dumps(b0["int8"]["routes"]))
    # (c)
    rd = [r["round"] for r in c]
    c0 = rd[0]
    rcfg = registry.get_config(TP_ROUND["arch"])
    for r in rd:
        groups = {tuple(g) for g in r["groups"]}
        require(tuple(r["data_group"]) in groups,
                f"[tp] (c) no all_reduce over 'data' {r['data_group']}: "
                f"{r['groups']}")
        require(tuple(r["model_group"]) in groups,
                f"[tp] (c) no all_reduce over 'model' {r['model_group']} "
                f"(a client's batch): {r['groups']}")
        require(r["heads"] == [rcfg.num_heads],
                f"[tp] (c) K2 heads {r['heads']}")
        require(r["launches"].get("flash_attention_fwd", 0) > 0,
                "[tp] (c) no K2 launch")
        require(r["loss"] == c0["loss"], "[tp] (c) ranks' losses differ")
    require(abs(c0["loss"] - c0["plain_loss"]) <= TP_LOSS_REL
            * abs(c0["plain_loss"]),
            f"[tp] (c) loss {c0['loss']} vs mesh-free {c0['plain_loss']}")
    require(c0["param_worst"] <= 1.0,
            f"[tp] (c) parameters {c0['param_worst']} of their tolerance")
    log("tp", step="c", arch=TP_ROUND["arch"], mesh="(data 2, model 2)",
        ranks=4, backend="gloo", partition=TP_ROUND["partition"],
        local_steps=TP_ROUND["local_steps"], batch=TP_ROUND["batch"],
        seq=TP_ROUND["seq"], loss=c0["loss"], mesh_free_loss=c0["plain_loss"],
        param_worst=round(c0["param_worst"], 4),
        round_s=[round(r["round_s"], 3) for r in rd],
        peak_gib=[round(r["peak_gib"], 2) for r in rd],
        all_reduce_groups=c0["groups"],
        k2_launches=[r["entries"] for r in rd])
    log("tp", seconds=f"{time.perf_counter() - t0:.1f}",
        two_ranks_s=f"{t_ab:.1f}",
        four_ranks_s=f"{time.perf_counter() - t0 - t_ab:.1f}")
    return {"a": tr, "b": pf, "c": rd}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; no card",
              file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port's sources are not at {src}", file=sys.stderr)
        return 3
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--mesh-rank"]:  # a rank of a [mesh] gloo world
        kind, rank, world, rdzv, workdir = sys.argv[2:7]
        return mesh_rank_main(kind, int(rank), int(world), rdzv, workdir)

    t_start = time.perf_counter()
    smi = phase_build()
    from repro_torch.models import registry, transformer

    cfg = registry.get_config("lm_350m")
    shapes_params = registry.init_params(cfg, seed=0, device="cuda")
    rows = sum(-(-p.numel() // 256) for p in shapes_params.values())
    del shapes_params
    gen = torch.Generator(device="cuda").manual_seed(0)
    kernels = phase_kernels(rows, gen)
    flash = phase_flash(gen)
    flash_wide = phase_flash_wide(gen)
    flash_encdec = phase_flash_encdec(gen)
    second_order = phase_flash_second_order(gen)
    # The slice-14 phases that need most of the card run before any
    # full-size round: after the later phases, 11.93 GiB of the card stay
    # reserved and unusable for their 4.64 GiB blocks (PERF.md).
    # qwen2_72b's round runs at 1 of 80 layers: at 2 layers and cohort 2
    # it needs about 87 GiB
    t_early14 = time.perf_counter()
    bias_counts = phase_train(
        "qkv bias", arch="qwen2_72b", layers=1, biases=True, rounds=1,
        cohort=2, local_steps=2, batch=1, seq=4096, compression="none")
    phase_grads("qkv bias grads", "qwen2_72b", layers=2, biases=True)
    moe_grad_counts = phase_grads("moe grads", "qwen3_moe", layers=1)
    free_graphs()
    t_early14 = time.perf_counter() - t_early14
    flat_counts = phase_train("flat")
    torch.cuda.reset_peak_memory_stats()
    hier_counts, wire_counts, wire_payload = phase_hier()
    log("hier", peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    plan_counts = phase_plan(wire_payload)
    t_slice = time.perf_counter()
    elastic_counts = phase_elastic()
    loop_counts = phase_loop()
    log("slice phases", seconds=f"{time.perf_counter() - t_slice:.1f}",
        allocated_after_gib=f"{torch.cuda.memory_allocated() / 2**30:.2f}")
    phase_stragglers()
    long_counts = phase_train("long", rounds=2, batch=2, seq=4096)
    phase_grads()
    phase_reference("naive")
    phase_reference("blocked")
    phase_reference("naive", stragglers=True)
    lru = phase_lru(gen)
    flash256 = phase_flash_hd256(gen)
    hybrid_counts = phase_train(
        "hybrid", arch="recurrentgemma_2b", rounds=2, cohort=2, local_steps=2,
        batch=1, seq=4096, compression="none")
    phase_grads("hybrid grads", "recurrentgemma_2b", layers=3)
    phase_reference("blocked", "recurrentgemma_2b")
    wkv = phase_wkv(gen)
    t_slice13 = time.perf_counter()
    state_p2 = phase_state_and_second_order(gen)
    t_slice13 = time.perf_counter() - t_slice13
    ssm_counts = phase_train(
        "ssm", arch="rwkv6_3b", rounds=2, cohort=2, local_steps=2, batch=1,
        seq=4096, compression="none")
    phase_grads("ssm grads", "rwkv6_3b", layers=2, tol=SSM_GRAD_TOL,
                seeds=(0, 1), control=True)
    phase_reference("naive", "rwkv6_3b")
    t_new = time.perf_counter()
    phase_ckpt()
    phase_topk()
    phase_algorithms()
    t_slice12 = time.perf_counter()
    pipeline_counts = phase_pipeline()
    maml_counts = phase_maml()
    btm_counts = phase_btm()
    log("slice 12 phases", seconds=f"{time.perf_counter() - t_slice12:.1f}")
    t_serve = time.perf_counter()
    served = {arch: phase_serve(arch) for arch in SERVE_RUNS}
    t_serve = time.perf_counter() - t_serve
    log("slice 13 phases", seconds=f"{t_serve + t_slice13:.1f}",
        serve_seconds=f"{t_serve:.1f}",
        state_and_second_order_seconds=f"{t_slice13:.1f}")
    t_slice14 = time.perf_counter()
    free_graphs()
    dense_counts = phase_train("dense configs", arch="lm_1b", rounds=2)
    phase_cost()
    moe_counts = phase_train(
        "moe", arch="phi35_moe", layers=2, rounds=2, cohort=2, local_steps=2,
        batch=1, seq=4096, compression="none")
    free_graphs()
    phase_moe_layer()
    vlm = phase_vlm()
    free_graphs()
    served_moe = phase_serve("phi35_moe", run=SERVE_MOE_RUN)
    log("slice 14 phases",
        seconds=f"{time.perf_counter() - t_slice14 + t_early14:.1f}",
        early_seconds=f"{t_early14:.1f}")
    free_graphs()
    encdec = phase_encdec(gen)
    free_graphs()
    phase_chaos(smi)
    free_graphs()
    phase_mesh()
    free_graphs()
    phase_tp()
    log("new phases", seconds=f"{time.perf_counter() - t_new:.1f}")
    launches = {"quantize": flat_counts["quantize"],
                "dequantize": flat_counts["dequantize"],
                "reduce_compress_roundtrip": hier_counts["reduce_compress_roundtrip"],
                "reduce_compress": wire_counts["reduce_compress"],
                "dequant_accumulate": wire_counts["dequant_accumulate"],
                "lru_scan_fwd": hybrid_counts["lru_scan_fwd"],
                "lru_scan_bwd": hybrid_counts["lru_scan_bwd"],
                "wkv6_fwd": ssm_counts["wkv6_fwd"],
                "wkv6_bwd": ssm_counts["wkv6_bwd"]}

    def entry(name, r, n, **extra):
        return {"name": name, "route": "cuda", "source": r["source"],
                "replaces": r["replaces"], "launches": n,
                "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r.get("library_ms"), **extra}

    line = {"kernels": [entry(name, r, launches[name])
                        for name, r in kernels.items()]}
    def flash_entry(name, r, n, shape, entry_name=None):
        # bf16 K2 runs on tensor cores: its bound is at their rate, with the
        # f32 SIMT bound of the f32 route beside it; at head dims 64 and
        # 128 on wgmma, and a forward of few query rows on the split-KV
        # decode kernels
        decode = DECODE_KERNELS[0] in r["kernels"]
        wg = r["hd"] in WG_HEAD_DIMS and not decode
        source = (FLASH_DECODE_SOURCE if decode else
                  FLASH_SM90_SOURCE if wg else {})
        detail = ("split-KV (bf16, mma.sync m16 of the query rows, hi/lo "
                  "split, splits folded in order)" if decode else
                  "tensor cores (bf16, wgmma from TMA rings, "
                  "warp-specialised, hi/lo split)" if wg else
                  "tensor cores (bf16, mma.sync, hi/lo split)")
        return entry(entry_name or name,
                     {**r, **FLASH_SOURCE[name], **source},
                     n, shape=shape, device_kernels=r["kernels"],
                     route_detail=detail,
                     bound_rate="bf16 tensor cores, 989 TFLOP/s",
                     bound_ms_f32_simt=r["bound_ms_f32_simt"])

    for name, by_shape in flash.items():
        # the seq-512 flat rounds' shape and launches, seq 4096's and the
        # hybrid rounds' head dim 256 beside them
        e512, e4096 = (
            flash_entry(name, by_shape[key], n,
                        f"B {b} x S {s} x 16 heads x 64, bf16, causal")
            for key, (b, s), n in (
                ("seq512", FLASH_MAIN["seq512"], flat_counts[name]),
                ("seq4096", FLASH_MAIN["seq4096"], long_counts[name])))
        e256 = flash_entry(name, flash256[name], hybrid_counts[name],
                           "B 1 x S 4096 x 10:1 heads x 256, bf16, causal, "
                           "window 2048")
        # the new configs' widths, with the launches of the phase that ran
        # each: [dense configs]' and [qkv bias]'s rounds, [moe]'s rounds,
        # [moe grads] and [vlm grads]
        wide_launches = {"lm_1b": dense_counts[name],
                         "qwen2_72b": bias_counts[name],
                         "phi35_moe": moe_counts[name],
                         "qwen3_moe": moe_grad_counts[name],
                         "llava_next_34b": vlm["grad_launches"][name]}
        wide = {arch: flash_entry(
            name, flash_wide[name][arch], wide_launches[arch],
            f"B {b} x S {s} x {hq}:{hkv} heads x {hd}, bf16, causal")
            for arch, (b, s, hq, hkv, hd) in FLASH_WIDE.items()}
        # the encoder-decoder's non-causal shapes: the encoder's and the
        # training cross-attention's with [encdec]'s rounds' launches (each
        # round's K2 calls: 12 encoder, 12 decoder, 12 cross a client
        # step), the decode step's with its serve launches
        ed = encdec["rounds"][name]
        ed_launches = {"encoder": ed, "cross_train": ed,
                       "cross_decode": encdec["serve"]["decode_k2"]
                       if name == "flash_attention_fwd" else 0}
        ed_rows = {shape: flash_entry(
            name, flash_encdec["kernels"][name][shape], ed_launches[shape],
            f"B {b} x Sq {sq} x Skv {skv} x {hq}:{hkv} heads x {hd}, bf16, "
            f"non-causal")
            for shape, (b, sq, skv, hq, hkv, hd) in FLASH_ENCDEC.items()}
        if name == "flash_attention_fwd":
            ed_rows["cross_decode"]["vs_plain_einsum"] = flash_encdec["decode"]
        line["kernels"].append(dict(
            e512, seq4096=e4096, hd256=e256, wide=wide, encdec=ed_rows))
    # the split-KV decode forward on its own line: the encoder-decoder's
    # decode-step cross-attention, with the launches of [encdec]'s 32
    # decode steps (every one on the decode kernels)
    b, sq, skv, hq, hkv, hd = FLASH_ENCDEC["cross_decode"]
    line["kernels"].append(flash_entry(
        "flash_attention_fwd",
        flash_encdec["kernels"]["flash_attention_fwd"]["cross_decode"],
        encdec["serve"]["decode_k2"],
        f"B {b} x Sq {sq} x Skv {skv} x {hq}:{hkv} heads x {hd}, bf16, "
        f"non-causal", entry_name="flash_attention_fwd_decode"))
    line["kernels"] += [
        entry(name, r, launches[name],
              shape=f"{LRU_MAIN} f32 (hybrid rounds)",
              plain_runs=LRU_PLAIN_RUNS,
              route_detail=r["route_detail"], split_ms=r["split_ms"])
        for name, r in lru.items()]
    line["kernels"] += [
        entry(name, r, launches[name],
              shape=f"{WKV_MAIN} f32, model-like decays (ssm rounds)",
              plain_runs=WKV_PLAIN_RUNS,
              route_detail="tensor cores (3xTF32 mma.sync m16n8k8)",
              bound_rate="HBM3 3.35 TB/s, or 3 x FLOP at TF32 tensor cores "
              "495 TFLOP/s", split_ms=r["split_ms"])
        for name, r in wkv.items()]
    def chunk_launches(arch, name):
        # eager calls and CUDA graph replays of the chunk steps
        return {f"{arch} {sched}": served[arch]["counts"][sched].get(name)
                for sched in ("continuous", "static")}

    serve_launches = {
        "flash_attention_fwd": {
            "stablelm_3b prefill": served["stablelm_3b"]["prefill_k2_launches"],
            "phi35_moe prefill": served_moe["prefill_k2_launches"],
            "llava_next_34b prefill": vlm["prefill_k2_launches"],
            "seamless_m4t_medium prefill": encdec["serve"]["prefill_k2"],
            "seamless_m4t_medium 32 decode steps":
                encdec["serve"]["decode_k2"]},
        "lru_scan_fwd": chunk_launches("recurrentgemma_2b", "lru_scan_fwd"),
        "wkv6_fwd": chunk_launches("rwkv6_3b", "wkv6_fwd"),
    }
    for e in line["kernels"]:
        name = e["name"]
        if name in serve_launches:
            e["serve_launches"] = serve_launches[name]
        if name == "wkv6_fwd":
            e["with_state"] = state_p2["with_state"]
        if name in ("quantize", "dequantize"):
            e["lm_1b_launches"] = dense_counts[name]
        if name in ("lru_scan_bwd", "wkv6_bwd"):
            e["second_order_plain"] = state_p2[name]
        for key, counts in (("plan_launches", plan_counts),
                            ("elastic_launches", elastic_counts),
                            ("loop_launches", loop_counts)):
            if counts.get(e["name"]):
                e[key] = counts[e["name"]]
        if e["name"] in FLASH_SOURCE:
            e.update(pipeline_launches=pipeline_counts[e["name"]],
                     maml_launches=maml_counts[e["name"]],
                     btm_launches=btm_counts[e["name"]])
            if e["name"] == "flash_attention_bwd_dkdv":
                # the second order no kernel computes (plain recompute)
                e["second_order_plain"] = {
                    "maml_calls": maml_counts["flash_attention_bwd2_plain"],
                    "ms": {dt: r["ms"] for dt, r in second_order.items()},
                    "bound_ms": {dt: r["bound_ms"]
                                 for dt, r in second_order.items()},
                    "bound_by": {dt: r["bound_by"]
                                 for dt, r in second_order.items()},
                    "shape": "B 2 x S 512 x 16 heads x 64, causal"}
    log("done", seconds=f"{time.perf_counter() - t_start:.1f}",
        padded_vocab=transformer.padded_vocab(cfg), packed_rows=rows, card=smi)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
