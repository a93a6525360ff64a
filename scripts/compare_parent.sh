#!/bin/bash
# Run the kernel phases and the direct [flat] and [hier] rounds of
# chip_smoke.py from two checkouts on one card, in turns (parent, change,
# change, parent; PAIRS=n repeats that n times), so their kernel times and
# peak memory compare within one machine. Phase flash runs K2's sweeps
# and every shape the smoke times it at (FLASH_MAIN, FLASH_WIDE,
# FLASH_ENCDEC). Phases k2dev (K2 at the main shapes, and the forward and
# SDPA's at the decode step's cross-attention) and int8dev (K1a,
# K1b, K3a, K3b, K3c at lm_350m's packed delta) call the kernels through
# kernels/ops.py and split each one's event time into device time
# (kernels only, from one torch.profiler trace) and the host's launch
# path (back-to-back calls).
# Usage, from the root of the
# change's checkout with the parent unpacked under build/parent
# (git archive <parent> | tar -x -C build/parent):
#     [PHASES="kernels flash k2dev int8dev lru wkv flat hier"] [PAIRS=1] \
#         scripts/compare_parent.sh [build/parent]
# Each run's full log goes to chiprun_out/compare_<i>_<tree>.log; the
# lines that carry times and peaks are printed.
set -euo pipefail
parent=${1:-build/parent}
export PHASES=${PHASES:-kernels flash lru wkv flat hier}
mkdir -p chiprun_out
i=0
for _ in $(seq "${PAIRS:-1}"); do
  for tree in parent change change parent; do
    i=$((i + 1))
    dir=.
    [ "$tree" = parent ] && dir=$parent
    log=$PWD/chiprun_out/compare_${i}_${tree}.log
    (cd "$dir" && PYTHONPATH=src python3 -c "
import os, chip_smoke as c, torch
phases = os.environ['PHASES'].split()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
c.phase_build()
gen = torch.Generator(device='cuda').manual_seed(0)
if 'kernels' in phases:
    from repro_torch.models import registry
    p = registry.init_params(registry.get_config('lm_350m'), seed=0,
                             device='cuda')
    rows = sum(-(-v.numel() // 256) for v in p.values())
    del p
    c.phase_kernels(rows, gen)
if 'flash' in phases:
    c.phase_flash(gen)
    c.phase_flash_wide(gen)
    c.phase_flash_encdec(gen)
def split(phase, shape, calls):
    # event time against device time (one trace) and the launch path
    import time
    dev = c.kernel_split(calls, reps=10)
    for name, fn in calls.items():
        event_ms = c.time_ms(fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            fn()
        host_us = (time.perf_counter() - t0) / 50 * 1e6
        torch.cuda.synchronize()
        c.log(phase, shape=shape, name=name, event_ms=f'{event_ms:.4f}',
              device_ms=f'{sum(dev[name].values()):.4f}',
              host_us_per_call=f'{host_us:.1f}')
if 'k2dev' in phases:
    from repro_torch.kernels import ops
    for key, (b, s) in c.FLASH_MAIN.items():
        (q, k, v, do, out32, lse, delta), _, _ = c.flash_case(
            gen, b, s, s, 16, 16, 64, True, 0, torch.bfloat16)
        split('k2dev', key, {
            'fwd': lambda: ops.flash_attention_fwd(q, k, v),
            'bwd_dq': lambda: ops.flash_attention_bwd_dq(q, k, v, out32, lse, do),
            'bwd_dkdv': lambda: ops.flash_attention_bwd_dkdv(q, k, v, lse,
                                                             delta, do),
        })
        del q, k, v, do, out32, lse, delta
        torch.cuda.empty_cache()
    # the encoder-decoder's decode-step cross-attention (a forward only:
    # decoding has no backward), beside SDPA's forward on the same inputs
    b, sq, skv, hq, hkv, hd = c.FLASH_ENCDEC['cross_decode']
    (q, k, v, do, out32, lse, delta), _, _ = c.flash_case(
        gen, b, sq, skv, hq, hkv, hd, False, 0, torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    split('k2dev', 'cross_decode', {
        'fwd': lambda: ops.flash_attention_fwd(q, k, v, causal=False),
        'sdpa_fwd': lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True),
    })
    del q, k, v, do, out32, lse, delta, qt, kt, vt
    torch.cuda.empty_cache()
if 'int8dev' in phases:
    # the int8 kernels through ops, the main path's entry points, at
    # lm_350m's packed delta (2 pods x 2 clients for K3a/K3b)
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    p = registry.init_params(registry.get_config('lm_350m'), seed=0,
                             device='cuda')
    rows = sum(-(-v.numel() // 256) for v in p.values())
    del p
    x = torch.randn((rows, 256), generator=gen, device='cuda') * 1e-3
    q, sc = ops.quantize(x)
    split('int8dev', (rows, 256), {
        'quantize': lambda: ops.quantize(x),
        'dequantize': lambda: ops.dequantize(q, sc, torch.float32)})
    del x, q, sc
    x4 = torch.randn((2, 2, rows, 256), generator=gen, device='cuda') * 1e-3
    split('int8dev', tuple(x4.shape), {
        'reduce_compress_roundtrip': lambda: ops.reduce_compress_roundtrip(
            x4, axis=1),
        'reduce_compress': lambda: ops.reduce_compress(x4)})
    q, sc = ops.reduce_compress(x4)
    del x4
    torch.cuda.empty_cache()
    split('int8dev', tuple(q.shape), {
        'dequant_accumulate': lambda: ops.dequant_accumulate(q, sc)})
    del q, sc
    torch.cuda.empty_cache()
if 'lru' in phases:
    c.phase_lru(gen)
if 'wkv' in phases:
    c.phase_wkv(gen)
if 'flat' in phases:
    torch.cuda.reset_peak_memory_stats()
    c.phase_train('flat')
    c.log('flat', peak_gib=f'{torch.cuda.max_memory_allocated() / 2**30:.4f}')
if 'hier' in phases:
    torch.cuda.reset_peak_memory_stats()
    c.phase_hier()
    c.log('hier', peak_gib=f'{torch.cuda.max_memory_allocated() / 2**30:.4f}')
") > "$log" 2>&1
    echo "=== $i $tree"
    grep -E "ms=|_ms|_us|peak_gib|round_s" "$log" | cut -c1-400
  done
done
