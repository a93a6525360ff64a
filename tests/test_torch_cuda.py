"""The CUDA kernels against their plain versions, on a card.

Marked ``cuda``: they skip without a compute-capability 9.x card (the
decision is made inside the fixture). The file imports no JAX, so it runs
on a card machine without one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import functools
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import compat  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


@pytest.fixture
def card():
    if not compat.is_hopper():
        pytest.skip("needs a compute-capability 9.x CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(card, dtype):
    gen = torch.Generator(device=card).manual_seed(0)
    x = (torch.randn((1029, 256), generator=gen, device=card) * 1e-2).to(dtype)
    x[:5] = 0
    ops.reset_launches()
    q, s = ops.quantize(x)
    qr, sr = ref.quantize_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(ops.dequantize(q, s, dtype), ref.dequantize_ref(q, s, dtype))
    x4 = (torch.randn((2, 3, 515, 256), generator=gen, device=card)).to(dtype)
    back = ops.reduce_compress_roundtrip(x4, axis=1)
    assert torch.equal(back, ref.reduce_compress_roundtrip_ref(x4)[0])
    assert ops.launch_counts() == {
        "quantize": 1, "dequantize": 1, "reduce_compress_roundtrip": 1,
        "reduce_compress": 0, "dequant_accumulate": 0,
        "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
        "flash_attention_bwd_dkdv": 0, "lru_scan_fwd": 0, "lru_scan_bwd": 0,
        "wkv6_fwd": 0, "wkv6_bwd": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wire_kernels_match_plain(card, dtype):
    """K3a and K3c bitwise to their plain versions, K3a's payload bitwise to
    K3b's, each launch counted, and a CUDA tensor never takes the plain
    path."""
    from unittest import mock

    from repro_torch.kernels import reduce_compress as krc

    gen = torch.Generator(device=card).manual_seed(1)
    x = torch.randn((2, 3, 1027, 256), generator=gen, device=card).to(dtype)
    x[:, :, :5] = 0
    ops.reset_launches()
    with mock.patch.object(ref, "reduce_compress_ref", side_effect=AssertionError), \
            mock.patch.object(ref, "dequant_accumulate_ref",
                              side_effect=AssertionError):
        q, s = ops.reduce_compress(x)
        outs = {p: ops.dequant_accumulate(q[:1].expand(p, -1, -1).contiguous(),
                                          s[:1].expand(p, -1, -1).contiguous())
                for p in (1, 3, 4)}
        mean = ops.dequant_accumulate(q, s)
    assert torch.equal(q, ref.reduce_compress_ref(x)[0])
    assert torch.equal(s, ref.reduce_compress_ref(x)[1])
    _, qb, sb = krc.reduce_compress_roundtrip(x)
    assert torch.equal(q, qb) and torch.equal(s, sb)
    assert torch.equal(mean, ref.dequant_accumulate_ref(q, s))
    for p, out in outs.items():
        qp = q[:1].expand(p, -1, -1)
        assert torch.equal(out, ref.dequant_accumulate_ref(qp, s[:1].expand(p, -1, -1)))
    counts = ops.launch_counts()
    assert counts["reduce_compress"] == 1 and counts["dequant_accumulate"] == 4


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    # A quant axis before the reduced axis has no kernel (as in the
    # reference): the plain form runs on the card, launching nothing, and
    # gives the CPU's result within one int8 step of each row.
    x4 = torch.randn((2, 3, 4, 256), device=card,
                     generator=torch.Generator(device=card).manual_seed(2))
    ops.reset_launches()
    got = ops.reduce_compress_roundtrip(x4, axis=1, qaxis=0)
    assert sum(ops.launch_counts().values()) == 0
    want = ops.reduce_compress_roundtrip(x4.cpu(), axis=1, qaxis=0)
    step = x4.cpu().mean(dim=1).abs().amax(dim=0, keepdim=True) / 127
    assert bool(((got.cpu() - want).abs() <= step * 1.0001).all())
    with pytest.raises(ValueError, match="256"):
        ops.quantize(torch.zeros((4, 128), device=card))
    with pytest.raises(ValueError, match="contiguous"):
        ops.quantize(torch.zeros((256, 8), device=card).t())
    with pytest.raises(TypeError):
        ops.quantize(torch.zeros((4, 256), device=card, dtype=torch.float16))
    q8 = torch.zeros((2, 4, 256), device=card, dtype=torch.int8)
    with pytest.raises(ValueError, match="scales"):
        ops.dequant_accumulate(q8, torch.zeros((2, 4), device=card))
    with pytest.raises(TypeError):
        ops.dequant_accumulate(q8.float(), torch.zeros((2, 4, 1), device=card))


@pytest.mark.cuda
def test_round_on_card_matches_cpu(card):
    """A reduced flat int8 round: the card (kernels) and the CPU (plain
    versions) give the same loss."""
    import argparse

    from repro_torch.data.grouped import CohortSampler, GroupedCorpus
    from repro_torch.launch import train
    from repro_torch.models import registry

    args = argparse.Namespace(algorithm="local_sgd", cohort=2, local_steps=2,
                              client_lr=0.05, compression="int8",
                              stragglers=False)
    cfg = registry.get_config("lm_350m").reduced()
    base = registry.init_params(cfg, seed=0, device="cpu")
    sampler = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                            cohort_size=2)
    losses = {}
    for device in ("cuda", "cpu"):
        round_fn, server_opt = train.build_round_fn(cfg, args)
        params = {k: v.to(device) for k, v in base.items()}
        d = sampler.round_batch(0, 2, 2, 32, device=device)
        _, _, m = round_fn(params, server_opt.init(params),
                           {"tokens": d["tokens"], "labels": d["labels"]})
        losses[device] = float(m["loss"])
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduce_mean_on_card_bitwise_to_cpu(card, dtype):
    """P1: at n = 3 the card's reduce_mean and its gradient multiply by
    f32(1/3) as the CPU's do (a division by a Python scalar would take the
    reciprocal on the card and divide on the CPU)."""
    from repro_torch import core as drjax

    gen = torch.Generator().manual_seed(3)
    x = torch.randn((3, 4096), generator=gen).to(dtype)
    ct = torch.randn(4096, generator=gen).to(dtype)
    mean = drjax.program(partition_size=3)(lambda v: drjax.reduce_mean(v))
    out = {}
    for dev in ("cpu", card):
        xl = x.to(dev).requires_grad_()
        y = mean(xl)
        (g,) = torch.autograd.grad((y * ct.to(dev)).sum(), xl)
        out[str(dev)] = (y.detach().cpu(), g.cpu())
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    assert torch.equal(out["cpu"][1], out["cuda"][1])


def _qkvd(card, b, sq, skv, hq, hkv, hd, dtype, seed=0):
    gen = torch.Generator(device=card).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=card).to(dtype)
                 for shape in ((b, sq, hq, hd), (b, skv, hkv, hd),
                               (b, skv, hkv, hd), (b, sq, hq, hd)))


def _assert_within_bf16_step(got, want):
    """``|got - want| <= 2^-7 |want| + 1e-3 max|want|``: one bf16 step of
    each value, plus a floor for values that cancel to near 0."""
    diff = (got.double() - want.double()).abs()
    lim = 2.0 ** -7 * want.double().abs() + 1e-3 * want.double().abs().max()
    assert bool((diff <= lim).all()), float((diff - lim).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,sq,skv,hq,hkv,hd,causal,window",
    [
        (2, 130, 130, 4, 4, 16, True, 0),
        (1, 200, 200, 14, 2, 80, True, 0),      # G = 7
        (1, 150, 150, 8, 1, 128, True, 0),      # G = 8, hd 128
        (1, 300, 300, 4, 2, 64, True, 100),     # window, ragged
        (1, 24, 56, 4, 2, 32, False, 0),        # non-causal, Sq != Skv
        (1, 150, 150, 10, 1, 256, True, 64),    # recurrentgemma: MQA, hd 256
        (2, 70, 70, 2, 2, 256, True, 0),        # hd 256, G = 1
        (1, 24, 56, 4, 1, 256, False, 0),       # hd 256, non-causal
        (1, 1100, 1100, 4, 4, 64, True, 0),     # many kv tiles, ragged tail
        (1, 1030, 1030, 10, 1, 256, True, 512),  # MQA window: the G-sum
        # the encoder-decoder (seamless_m4t_medium): encoder self-attention,
        # cross-attention in training and in a decode step, non-causal
        (2, 4096, 4096, 16, 16, 64, False, 0),
        (2, 512, 4096, 16, 16, 64, False, 0),
        (4, 1, 4096, 16, 16, 64, False, 0),
        (1, 100, 1000, 4, 2, 64, False, 0),     # ragged Sq and Skv
        # the wgmma kernels' 128-row tiles (bf16, hd 64 and 128): Sq and
        # Skv of 1, 63, 65, 127, 129 and 1000; G 1, 4, 7, 8, 16
        (1, 1, 129, 4, 4, 64, False, 0),
        (2, 63, 65, 4, 1, 128, False, 0),
        (1, 127, 127, 7, 1, 64, True, 0),
        (1, 129, 129, 8, 1, 128, True, 0),
        (1, 65, 1000, 16, 1, 64, False, 0),
        (1, 1000, 1000, 16, 2, 128, True, 256),  # window 256
        (1, 1000, 63, 4, 4, 128, False, 0),      # Sq > Skv
        # the split-KV decode forward (bf16, Sq * G <= 16 query rows a kv
        # head): Sq * G of 1, 4, 16 and 17 (the route's boundary: the
        # full-sequence kernels), Skv of 2, 63, 257 and 4097 (Skv 1, where
        # p = 1 and dq is 0 up to rounding, is held by the forward-only
        # test_flash_decode_forward_repeats_bitwise), every head dim
        (3, 1, 2, 4, 4, 64, False, 0),           # Sq * G 1, Skv 2
        (2, 1, 4097, 8, 2, 128, False, 0),       # 4, 33 splits
        (1, 1, 257, 16, 1, 64, False, 0),        # 16, MQA
        (1, 4, 63, 16, 4, 80, True, 32),         # 16, window
        (2, 2, 257, 16, 2, 256, False, 0),       # 16, hd 256
        (1, 16, 4097, 2, 2, 32, True, 0),        # 16, causal Sq 16
        (1, 2, 63, 8, 4, 16, False, 0),          # 4, hd 16
        (1, 17, 257, 4, 4, 64, False, 0),        # 17: wgmma forward
        (1, 1, 4097, 17, 1, 128, False, 0),      # 17 by G
        (2, 17, 63, 2, 2, 80, True, 0),          # 17: mma.sync forward
    ],
)
def test_flash_attention_matches_plain(card, b, sq, skv, hq, hkv, hd, causal,
                                       window, dtype):
    """K2 forward and backward through the autograd function against
    PyTorch's autograd through the plain forward: f32 output and L within
    2e-5, gradients within 1e-4 of their largest magnitude; bf16 output and
    gradients within one bf16 step (both round an f32 value once) plus
    1e-3 of the largest magnitude."""
    q, k, v, do = _qkvd(card, b, sq, skv, hq, hkv, hd, dtype)
    kw = dict(causal=causal, window=window)
    ops.reset_launches()
    out, out32, lse = ops.flash_attention_fwd(q, k, v, **kw)
    r_out, r_out32, r_lse = ref.flash_attention_ref(q, k, v, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(out, r_out, rtol=2e-5, atol=2e-5)
    else:
        _assert_within_bf16_step(out, r_out)
    torch.testing.assert_close(lse, r_lse, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(out32, r_out32, rtol=2e-5, atol=2e-5)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    got = torch.autograd.grad(ops.flash_attention(qg, kg, vg, **kw),
                              (qg, kg, vg), do)
    want = torch.autograd.grad(ref.flash_attention_ref(qg, kg, vg, **kw)[0],
                               (qg, kg, vg), do)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        if dtype == torch.float32:
            err = float((g - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()), err
        else:
            _assert_within_bf16_step(g, w)
    counts = ops.launch_counts()
    assert (counts["flash_attention_fwd"], counts["flash_attention_bwd_dq"],
            counts["flash_attention_bwd_dkdv"]) == (2, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,window", [
    ((2, 256, 256, 8, 2, 64), 0),      # wgmma bwd_dkdv, G 4
    ((1, 700, 700, 10, 1, 256), 256),  # hd 256 MQA: per-head partials
    ((1, 700, 700, 16, 1, 128), 0),    # wgmma bwd_dkdv, G 16
    ((1, 600, 600, 16, 2, 128), 128),  # wgmma bwd_dq and bwd_dkdv, G 8
])
def test_flash_attention_backward_is_deterministic_under_checkpoint(
        card, shape, window):
    q, k, v, do = _qkvd(card, *shape, torch.bfloat16, seed=1)

    def grads():
        qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
        out = torch.utils.checkpoint.checkpoint(
            lambda a, b, c: ops.flash_attention(a, b, c, window=window),
            qg, kg, vg, use_reentrant=False)
        return torch.autograd.grad(out, (qg, kg, vg), do)

    for a, b in zip(grads(), grads()):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 200, 200, 4, 4, 64),
                                   (1, 150, 150, 8, 2, 128),
                                   (1, 150, 150, 10, 1, 256),
                                   (1, 1, 300, 8, 2, 64),
                                   (1, 2, 300, 4, 4, 80)])
def test_flash_attention_route_by_dtype(card, shape, dtype):
    """bf16 K2 at head dim 64 or 128 launches the wgmma forward, bwd_dq
    and bwd_dkdv (no per-head partials to sum); at other head dims the
    mma.sync kernels (and, for Hq > Hkv, the ordered sum of the per-head
    partials); a bf16 forward of at most 16 query rows a kv head the
    split-KV decode kernels instead; f32 K2 only the SIMT kernels. Names
    from ``torch.profiler``."""
    import time

    q, k, v, do = _qkvd(card, *shape, dtype)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    # A trace of a second or two can lose its kernel events on the card
    # machines; traces of several seconds keep them (chip_smoke.kernel_names).
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(1.0)
        torch.autograd.grad(ops.flash_attention(qg, kg, vg), (qg, kg, vg), do)
        torch.cuda.synchronize()
        time.sleep(6.0)
    names = {e.key for e in prof.key_averages()
             if e.device_type.name == "CUDA" and "repro::flash::" in e.key}
    short = {n.split("(")[0].split("::")[-1].split("<")[0] for n in names}
    decode = {"decode_split_kernel", "decode_combine_kernel"}
    few_rows = shape[1] * (shape[3] // shape[4]) <= 16
    if dtype == torch.bfloat16 and shape[5] in (64, 128):
        want = {"wg_fwd_kernel", "wg_bwd_dq_kernel", "wg_bwd_dkdv_kernel"}
        if few_rows:
            want = want - {"wg_fwd_kernel"} | decode
        assert short == want, names
    elif dtype == torch.bfloat16:
        want = {"tc_fwd_kernel", "tc_bwd_dq_kernel", "tc_bwd_dkdv_kernel"}
        if shape[3] > shape[4]:
            want.add("tc_sum_heads_kernel")
        if few_rows:
            want = want - {"tc_fwd_kernel"} | decode
        assert short == want, names
    else:
        assert short == {"fwd_kernel", "bwd_dq_kernel", "bwd_dkdv_kernel"}, names


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_wgmma_forward_replays_in_a_cuda_graph(card, hd):
    """The wgmma forward captured in a CUDA graph (its tensor maps hold the
    raw pointers of the captured call) replays bitwise the eager call."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _ = _qkvd(card, 2, 300, 300, 8, 2, hd, torch.bfloat16)
    eager = fa.fwd(q, k, v, causal=True, window=0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa.fwd(q, k, v, causal=True, window=0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    fa.reset_route_launches()
    with torch.cuda.graph(graph):
        captured = fa.fwd(q, k, v, causal=True, window=0)
    assert fa.ROUTE_LAUNCHES == {("repro_flash_wg_fwd", torch.bfloat16,
                                  hd): 1}
    for t in captured:
        t.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(captured, eager):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape", [
    ("bwd_dq", (2, 300, 300, 8, 2, 64)),
    ("bwd_dq", (1, 200, 200, 16, 2, 128)),
    ("fwd_decode", (4, 1, 4096, 16, 16, 64)),
    ("fwd_decode", (2, 2, 1000, 16, 2, 128)),
])
def test_flash_new_kernels_replay_in_a_cuda_graph(card, kernel, shape):
    """The wgmma bwd_dq (tensor maps of the captured call's pointers) and
    the split-KV decode forward (its scratch allocated in the graph's
    pool) captured in a CUDA graph replay bitwise the eager call, twice,
    and the capture took the route's entry point."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, do = _qkvd(card, *shape, torch.bfloat16)
    if kernel == "bwd_dq":
        _, out32, lse = fa.fwd(q, k, v, causal=True, window=0)
        call = lambda: fa.bwd_dq(q, k, v, out32, lse, do, causal=True,  # noqa: E731
                                 window=0)
        entry = "repro_flash_wg_bwd_dq"
    else:
        call = lambda: fa.fwd(q, k, v, causal=False, window=0)  # noqa: E731
        entry = "repro_flash_decode"
    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    fa.reset_route_launches()
    with torch.cuda.graph(graph):
        captured = call()
    assert fa.ROUTE_LAUNCHES == {(entry, torch.bfloat16, shape[5]): 1}
    for _ in range(2):
        for t in captured:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1, 4096, 16, 16, 64),
                                   (1, 3, 5000, 20, 4, 128),
                                   (2, 1, 777, 8, 8, 256),
                                   (3, 1, 1, 4, 4, 64),
                                   (2, 16, 1, 2, 2, 80)])
def test_flash_decode_forward_repeats_bitwise(card, shape):
    """The split-KV decode forward gives bitwise the same out, out32 and
    L from run to run (the splits are folded in a fixed order), within the
    forward's gates of the plain version; Skv 1 included."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _ = _qkvd(card, *shape, torch.bfloat16, seed=3)
    fa.reset_route_launches()
    first = fa.fwd(q, k, v, causal=False, window=0)
    for got, want in zip(fa.fwd(q, k, v, causal=False, window=0), first):
        assert torch.equal(got, want)
    assert fa.ROUTE_LAUNCHES == {("repro_flash_decode", torch.bfloat16,
                                  shape[5]): 2}
    r_out, r_out32, r_lse = ref.flash_attention_ref(q, k, v, causal=False)
    _assert_within_bf16_step(first[0], r_out)
    torch.testing.assert_close(first[1], r_out32, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(first[2], r_lse, rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_flash_wrappers_refuse_what_the_kernels_do_not_take(card):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _ = _qkvd(card, 1, 16, 16, 4, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        fa.fwd(q[..., :48].contiguous(), k[..., :48].contiguous(),
               v[..., :48].contiguous(), causal=True, window=0)
    with pytest.raises(ValueError, match="contiguous"):
        fa.fwd(q.transpose(1, 2), k, v, causal=True, window=0)
    with pytest.raises(TypeError):
        fa.fwd(q, k.bfloat16(), v, causal=True, window=0)
    with pytest.raises(TypeError):
        fa.fwd(q.half(), k.half(), v.half(), causal=True, window=0)
    with pytest.raises(ValueError, match="Hkv dividing Hq"):
        fa.fwd(q[:, :, :3].contiguous(), k, v, causal=True, window=0)


def _lru_inputs(card, b, s, w, dtype, with_h0, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    a = torch.sigmoid(torch.randn((b, s, w), generator=gen, device=card)).to(dtype)
    x = torch.randn((b, s, w), generator=gen, device=card).to(dtype)
    g = torch.randn((b, s, w), generator=gen, device=card).to(dtype)
    h0 = torch.randn((b, w), generator=gen, device=card) if with_h0 else None
    return a, x, g, h0


@functools.cache
def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _lru_route(w, dtype):
    """The route K4 takes for fresh (aligned) tensors, by the smoke's
    oracle (``chip_smoke.lru_route``), not the launchers' own rule."""
    return _chip_smoke().lru_route(w, dtype)


def _lru_check(a, x, g, h0):
    """K4 forward and backward through the launchers, bitwise against the
    plain versions; returns the route counts of the two launches."""
    from repro_torch.kernels import rglru_scan as kl

    kl.reset_route_launches()
    h = kl.fwd(a, x, h0)
    want_h = ref.lru_scan_ref(a, x, h0)
    assert h.dtype == a.dtype and torch.equal(h, want_h)
    got = kl.bwd(a, want_h, g, h0)
    want = ref.lru_scan_bwd_ref(a, want_h, g, h0)
    for gt, wt in zip(got, want):
        assert gt.dtype == wt.dtype and torch.equal(gt, wt)
    return dict(kl.ROUTE_LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("b,s,w", [(1, 1000, 2560), (2, 37, 45), (3, 16, 1),
                                   (1, 4096, 2560), (2, 129, 2560),
                                   (3, 1000, 100), (2, 37, 2560),
                                   (1, 1, 2560), (1, 64, 2560)])
def test_lru_scan_bitwise_to_plain(card, b, s, w, with_h0, dtype):
    """K4 forward and backward equal their plain versions bitwise (both
    round the product, then the sum), at ragged S and W, on the route the
    shape and dtype take: TMA for W 2560 (and W 100 in f32), SIMT for W
    45, 1 and 100 in bf16. (2, 37, 2560) is shorter than one tile; (1, 1,
    2560) and (1, 64, 2560) are serve chunks of recurrentgemma_2b."""
    a, x, g, h0 = _lru_inputs(card, b, s, w, dtype, with_h0, b * s + w)
    ops.reset_launches()
    h = ops.lru_scan_fwd(a, x, h0)
    want_h = ref.lru_scan_ref(a, x, h0)
    assert h.dtype == dtype and torch.equal(h, want_h)
    got = ops.lru_scan_bwd(a, want_h, g, h0)
    want = ref.lru_scan_bwd_ref(a, want_h, g, h0)
    for gt, wt in zip(got, want):
        assert gt.dtype == wt.dtype and torch.equal(gt, wt)
    counts = ops.launch_counts()
    assert (counts["lru_scan_fwd"], counts["lru_scan_bwd"]) == (1, 1)
    from repro_torch.kernels import rglru_scan as kl

    assert kl.ROUTE_LAUNCHES[_lru_route(w, dtype)] == 2, kl.ROUTE_LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lru_scan_tma_ragged_width_bitwise(card, dtype):
    """The TMA route at a ragged S and a W that is not a multiple of a
    block's 32 chains, on three batch rows."""
    w = 2568  # aligned in f32 and bf16, 8 past a multiple of 32
    a, x, g, h0 = _lru_inputs(card, 3, 300, w, dtype, True, 32)
    assert _lru_check(a, x, g, h0) == {"tma": 2, "simt": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lru_scan_unaligned_view_takes_simt(card, dtype):
    """A contiguous view whose data pointer is 4 bytes off 16-byte
    alignment takes the SIMT route and stays bitwise."""
    b, s, w = 2, 300, 2560
    n = b * s * w
    a, x, g, h0 = _lru_inputs(card, b, s, w, dtype, True, 11)

    def shifted(t):
        off = 4 // t.element_size()
        buf = torch.empty(n + off, dtype=t.dtype, device=card)
        view = buf[off:].view(b, s, w)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        return view

    a, x, g = shifted(a), shifted(x), shifted(g)
    assert _lru_check(a, x, g, h0) == {"tma": 0, "simt": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4096, 2560), (2, 45, 45)])
def test_lru_scan_repeats_bitwise(card, shape):
    """Two calls on the same inputs give the same bits, on either route."""
    a, x, g, h0 = _lru_inputs(card, *shape, torch.float32, True, 3)
    first = (ops.lru_scan_fwd(a, x, h0),) + ops.lru_scan_bwd(a, x, g, h0)
    second = (ops.lru_scan_fwd(a, x, h0),) + ops.lru_scan_bwd(a, x, g, h0)
    for p, q in zip(first, second):
        assert torch.equal(p, q)


@pytest.mark.cuda
def test_lru_scan_autograd_under_checkpoint(card):
    gen = torch.Generator(device=card).manual_seed(5)
    a = torch.sigmoid(torch.randn((2, 300, 96), generator=gen, device=card))
    x = torch.randn((2, 300, 96), generator=gen, device=card)
    h0 = torch.randn((2, 96), generator=gen, device=card)
    g = torch.randn((2, 300, 96), generator=gen, device=card)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (a, x, h0)]
        out = torch.utils.checkpoint.checkpoint(fn, *leaves,
                                                use_reentrant=False)
        return torch.autograd.grad(out, leaves, g)

    ops.reset_launches()
    got = grads(ops.lru_scan)
    assert ops.launch_counts()["lru_scan_fwd"] == 2  # with the recompute
    want = grads(ref.lru_scan_ref)
    for gt, wt in zip(got, want):
        err = float((gt - wt).abs().max())
        assert err <= 1e-5 * float(wt.abs().max()), err


@pytest.mark.cuda
def test_lru_wrappers_refuse_what_the_kernels_do_not_take(card):
    from repro_torch.kernels import rglru_scan as kl

    a = torch.rand((1, 8, 4), device=card)
    with pytest.raises(TypeError):
        kl.fwd(a, a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        kl.fwd(a.transpose(1, 2).contiguous().transpose(1, 2), a)
    with pytest.raises(ValueError, match="h0"):
        kl.fwd(a, a, torch.zeros((1, 4), device=card, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        kl.fwd(a.half(), a.half())


@pytest.mark.cuda
@pytest.mark.parametrize("w", [2560, 45])
def test_lru_wrappers_refuse_on_both_routes(card, w):
    """What neither route takes is refused before any launch, whether the
    shape would go to TMA (W 2560) or to SIMT (W 45): f16 and f64,
    non-contiguous inputs, an empty S and a bad h0."""
    from repro_torch.kernels import rglru_scan as kl

    a = torch.rand((2, 70, w), device=card)
    g = torch.rand((2, 70, w), device=card)
    kl.reset_route_launches()
    for bad in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            kl.fwd(a.to(bad), a.to(bad))
        with pytest.raises(TypeError):
            kl.bwd(a.to(bad), a.to(bad), g.to(bad))
    strided = torch.rand((2, w, 70), device=card).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        kl.fwd(strided, a)
    with pytest.raises(ValueError, match="contiguous"):
        kl.bwd(a, strided, g)
    empty = a[:, :0]
    with pytest.raises(ValueError, match="S, W > 0"):
        kl.fwd(empty, empty)
    with pytest.raises(ValueError, match="h0"):
        kl.bwd(a, a, g, torch.zeros((2, w + 1), device=card))
    assert kl.ROUTE_LAUNCHES == {"tma": 0, "simt": 0}


def _wkv_inputs(card, b, s, h, n, law, seed=0):
    """r, k, v, the output gradient and u standard normal (u x 0.5); logw
    mild (``-exp(0.5 N(0, 1))``, the reference test's) or as the model
    draws it (``-exp(w0 + lora)``, w0 ~ N(0, 0.5) per channel), whose
    cumulative log-decay passes -88 inside a 64-step chunk."""
    gen = torch.Generator(device=card).manual_seed(seed)
    r, k, v, do = (torch.randn((b, s, h, n), generator=gen, device=card)
                   for _ in range(4))
    if law == "mild":
        lw = -torch.exp(0.5 * torch.randn((b, s, h, n), generator=gen,
                                          device=card))
    else:
        w0 = 0.5 * torch.randn((h, n), generator=gen, device=card)
        lw = -torch.exp(w0 + 0.3 * torch.randn((b, s, h, n), generator=gen,
                                               device=card))
    u = 0.5 * torch.randn((h, n), generator=gen, device=card)
    return r, k, v, lw, u, do


@pytest.mark.cuda
@pytest.mark.parametrize("law", ["mild", "model"])
@pytest.mark.parametrize("b,s,h,n", [
    (1, 300, 3, 64), (2, 1000, 2, 32), (2, 37, 3, 16), (1, 64, 1, 64),
    # S that ends inside a 16-step sub-chunk or just past a chunk
    (2, 1, 2, 64), (1, 15, 2, 64), (2, 17, 1, 32), (1, 63, 2, 64),
    (1, 65, 2, 16),
    # the narrow tiles at the main path's length
    (1, 4096, 2, 16), (1, 4096, 2, 32)])
def test_wkv6_matches_plain(card, b, s, h, n, law):
    """K5 forward within 1e-4 (rtol = atol, the reference's WKV tolerance)
    of the sequential plain version, its chunk states within 1e-4 of their
    largest magnitude; the backward, given the plain chunk states, within
    1e-4 of each gradient's largest magnitude; every output finite."""
    r, k, v, lw, u, do = _wkv_inputs(card, b, s, h, n, law, seed=b * s + n)
    ops.reset_launches()
    out, states, final = ops.wkv6_fwd(r, k, v, lw, u)
    r_out, r_states, r_final = ref.wkv6_fwd_ref(r, k, v, lw, u)
    assert torch.isfinite(out).all()
    err = float((final - r_final).abs().max())
    assert err <= 1e-4 * max(float(r_final.abs().max()), 1.0), err
    torch.testing.assert_close(out, r_out, rtol=1e-4, atol=1e-4)
    err = float((states - r_states).abs().max())
    assert err <= 1e-4 * max(float(r_states.abs().max()), 1.0), err
    got = ops.wkv6_bwd(r, k, v, lw, u, r_states, do)
    want = ref.wkv6_bwd_ref(r, k, v, lw, u, do)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (name, err)
    counts = ops.launch_counts()
    assert (counts["wkv6_fwd"], counts["wkv6_bwd"]) == (1, 1)


@pytest.mark.cuda
def test_wkv6_autograd_under_checkpoint(card):
    r, k, v, lw, u, do = _wkv_inputs(card, 2, 200, 2, 64, "model", seed=5)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (r, k, v, lw, u)]
        out = torch.utils.checkpoint.checkpoint(fn, *leaves,
                                                use_reentrant=False)
        return torch.autograd.grad(out, leaves, do)

    ops.reset_launches()
    got = grads(lambda *t: ops.wkv6(*t)[0])
    counts = ops.launch_counts()
    assert (counts["wkv6_fwd"], counts["wkv6_bwd"]) == (2, 1)  # the recompute
    want = grads(ref.wkv6_ref)
    for gt, wt in zip(got, want):
        err = float((gt - wt).abs().max())
        assert err <= 1e-4 * float(wt.abs().max()), err
    again = grads(lambda *t: ops.wkv6(*t)[0])  # no atomics: the same bits twice
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    # du sums per-chunk partials over (batch, chunk) in a fixed order, and
    # dlogw sums within each chunk: both bitwise from one call to the next
    _, states, _ = ops.wkv6_fwd(r, k, v, lw, u)
    first = ops.wkv6_bwd(r, k, v, lw, u, states, do)
    for _ in range(3):
        dlogw, du = ops.wkv6_bwd(r, k, v, lw, u, states, do)[3:5]
        assert torch.equal(dlogw, first[3]) and torch.equal(du, first[4])


@pytest.mark.cuda
def test_wkv6_takes_unaligned_views(card):
    """Contiguous views that start off a 16-byte boundary, the chunk states
    included, give the results of aligned copies."""
    b, s, h, n = 1, 130, 2, 32

    def shifted(t):
        flat = torch.empty(t.numel() + 1, device=card)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16
        return view

    inputs = _wkv_inputs(card, b, s, h, n, "model", seed=3)
    r, k, v, lw, u, do = (shifted(t) for t in inputs)
    s0 = shifted(inputs[0].new_ones((b, h, n, n)) * 0.1)
    out, states, final = ops.wkv6_fwd(r, k, v, lw, u, s0)
    want_out, want_states, want_final = ops.wkv6_fwd(
        *(t.clone() for t in (r, k, v, lw, u, s0)))
    assert torch.equal(out, want_out) and torch.equal(states, want_states)
    assert torch.equal(final, want_final)
    dfinal = shifted(final * 0.5)
    got = ops.wkv6_bwd(r, k, v, lw, u, shifted(states), do, s0,
                       shifted(final), dfinal)
    want = ops.wkv6_bwd(*(t.clone() for t in (r, k, v, lw, u, states, do, s0,
                                              final, dfinal)))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_wkv6_wrappers_refuse_what_the_kernels_do_not_take(card):
    from repro_torch.kernels import wkv6 as kw

    r, k, v, lw, u, do = _wkv_inputs(card, 1, 16, 2, 64, "mild")
    with pytest.raises(ValueError, match="CUDA"):
        kw.fwd(r.cpu(), k.cpu(), v.cpu(), lw.cpu(), u.cpu())
    with pytest.raises(TypeError, match="float32"):
        kw.fwd(r.bfloat16(), k.bfloat16(), v.bfloat16(), lw.bfloat16(), u)
    with pytest.raises(ValueError, match="head dim"):
        kw.fwd(*(t[..., :48].contiguous() for t in (r, k, v, lw)),
               u[:, :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        kw.fwd(r.transpose(1, 2), k, v, lw, u)
    with pytest.raises(ValueError, match="u must be"):
        kw.fwd(r, k, v, lw, u[:1])
    _, states, _ = kw.fwd(r, k, v, lw, u)
    with pytest.raises(ValueError, match="states"):
        kw.bwd(r, k, v, lw, u, states[:, :1, :, :8], do)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_on_card_bitwise_to_cpu(card, dtype):
    """``topk_sparsify`` selects the same entries, ties included, on the
    card as on the CPU: a bf16-rounded tensor with many ties at the
    cutoff, and a stacked-layer dict."""
    from repro_torch.compression import topk_sparsify, topk_sparsify_layers

    gen = torch.Generator(device=card).manual_seed(3)
    x = (torch.randn((1 << 20,), generator=gen, device=card) * 1e-3)
    x = x.to(torch.bfloat16).to(dtype)
    for fraction in (0.01, 0.05, 0.5):
        got = topk_sparsify(x, fraction)
        want = topk_sparsify(x.cpu(), fraction)
        assert got.dtype == dtype
        assert torch.equal(got.cpu(), want)
        k = max(int(x.numel() * fraction), 1)
        assert int(torch.count_nonzero(got)) == min(k, int(torch.count_nonzero(x)))
    tree = {f"layers.{i}.w": torch.randn((64, 300), generator=gen, device=card)
            for i in range(3)}
    got = topk_sparsify_layers(tree, 0.01)
    want = topk_sparsify_layers({k: v.cpu() for k, v in tree.items()}, 0.01)
    assert all(torch.equal(got[k].cpu(), want[k]) for k in tree)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(card, tmp_path):
    """A state on the card (bf16 params, f32 moments, an int32 step) saved
    asynchronously restores bitwise onto the card and onto the host."""
    from repro_torch.checkpoint import CheckpointManager

    gen = torch.Generator(device=card).manual_seed(4)
    state = {"params": {"w": torch.randn((257, 33), generator=gen,
                                         device=card).to(torch.bfloat16)},
             "server": {"step": torch.tensor(3, dtype=torch.int32, device=card),
                        "mu": {"w": torch.randn((257, 33), generator=gen,
                                                device=card)}}}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, state, blocking=False)
    mgr.wait()
    for example, device in ((state, card), (
            {"params": {"w": torch.zeros((257, 33), dtype=torch.bfloat16)},
             "server": {"step": torch.zeros((), dtype=torch.int32),
                        "mu": {"w": torch.zeros((257, 33))}}},
            torch.device("cpu"))):
        step, got, _ = mgr.restore_latest(example)
        assert step == 2
        for a, b in ((got["params"]["w"], state["params"]["w"]),
                     (got["server"]["step"], state["server"]["step"]),
                     (got["server"]["mu"]["w"], state["server"]["mu"]["w"])):
            assert a.device.type == device.type and a.dtype == b.dtype
            assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("compression", ["int8", "topk"])
def test_fail_at_replay_bitwise_on_card(card, tmp_path, compression):
    """Reduced lm_350m with ``blocked`` attention (K2 on the card), the
    ``launch.train``'s FedAvg round and recovery loop, 4 rounds with a checkpoint
    every 2: a failure at round 3 restores step 2 and replays; params and
    server state end bitwise equal to the uninterrupted run."""
    from torch.utils import _pytree as pytree

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.grouped import CohortSampler, GroupedCorpus
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.runtime import FailureInjector, run_with_recovery

    cfg = registry.get_config("lm_350m").reduced(attn_impl="blocked")
    args = train.parse_args(["--cohort", "4", "--local-steps", "2",
                             "--algorithm", "fedavg", "--compression",
                             compression])
    round_fn, server_opt = train.build_round_fn(cfg, args)
    sampler = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                            cohort_size=4)
    runs = {}
    for name, fail_at in (("clean", []), ("failed", [3])):
        params = registry.init_params(cfg, seed=0, device=card)
        injector = FailureInjector(fail_at)
        losses = []

        def step_fn(r, state):
            injector.check(r)
            d = sampler.round_batch(r, 2, 2, 64, device=card)
            p, s, m = round_fn(state["params"], state["server"],
                               {k: d[k] for k in ("tokens", "labels")})
            losses.append(float(m["loss"]))
            return {"params": p, "server": s}

        runs[name] = run_with_recovery(
            step_fn, {"params": params, "server": server_opt.init(params)}, 4,
            CheckpointManager(str(tmp_path / name)), checkpoint_every=2)
        runs[name] += (losses,)
    (clean, _, clean_losses), (failed, stats, losses) = runs["clean"], runs["failed"]
    assert stats["restarts"] == 1 and stats["replayed_steps"] == 1
    assert losses[3] == losses[2] == clean_losses[2]
    a, b = pytree.tree_leaves(clean), pytree.tree_leaves(failed)
    assert len(a) == len(b)
    assert all(x.device.type == "cuda" and torch.equal(x, y)
               for x, y in zip(a, b))


def _graph_replay(fn, args):
    """``fn(*args)`` captured into a CUDA graph after a warm-up on a side
    stream, then replayed once on fresh copies of ``args``."""
    static = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="global"):
        outs = fn(*static)
    graph.replay()
    torch.cuda.synchronize()
    return outs


@pytest.mark.cuda
def test_kernel_ops_replay_from_a_graph(card):
    """Every kernel op captured in a CUDA graph (global capture mode: K2's
    and K5's per-launch ``cudaFuncSetAttribute``, K4's host-encoded TMA
    maps) and replayed equals its eager launch bitwise."""
    from torch.utils import _pytree as pytree

    gen = torch.Generator(device=card).manual_seed(7)

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=card) * scale).to(dtype)

    x = rnd(515, 256, scale=1e-2)
    q, s = ops.quantize(x)
    qkv = rnd(2, 128, 4, 64, dtype=torch.bfloat16)
    out, out32, lse = ops.flash_attention_fwd(qkv, qkv, qkv)
    _, delta = ops.flash_attention_bwd_dq(qkv, qkv, qkv, out32, lse, qkv)
    a, b = rnd(1, 300, 2560).sigmoid(), rnd(1, 300, 2560)
    h = ops.lru_scan_fwd(a, b)
    r = rnd(1, 130, 2, 64, scale=0.3)
    logw = -torch.exp(rnd(1, 130, 2, 64, scale=0.3)) * 0.3
    u = rnd(2, 64, scale=0.3)
    wo, states, _ = ops.wkv6_fwd(r, r, r, logw, u)
    x4 = rnd(2, 2, 300, 256, scale=1e-2)
    qp, sp = ops.reduce_compress(x4)
    calls = {
        "quantize": (ops.quantize, (x,)),
        "dequantize": (ops.dequantize, (q, s)),
        "reduce_compress_roundtrip": (lambda t: ops.reduce_compress_roundtrip(
            t, axis=1), (x4,)),
        "reduce_compress": (ops.reduce_compress, (x4,)),
        "dequant_accumulate": (ops.dequant_accumulate, (qp, sp)),
        "flash_attention_fwd": (ops.flash_attention_fwd, (qkv, qkv, qkv)),
        "flash_attention_bwd_dq": (ops.flash_attention_bwd_dq,
                                   (qkv, qkv, qkv, out32, lse, qkv)),
        "flash_attention_bwd_dkdv": (ops.flash_attention_bwd_dkdv,
                                     (qkv, qkv, qkv, lse, delta, qkv)),
        "lru_scan_fwd": (ops.lru_scan_fwd, (a, b)),
        "lru_scan_bwd": (ops.lru_scan_bwd, (a, h, b)),
        "wkv6_fwd": (ops.wkv6_fwd, (r, r, r, logw, u)),
        "wkv6_bwd": (ops.wkv6_bwd, (r, r, r, logw, u, states, wo)),
    }
    assert set(calls) == {f.__name__ for f in ops.KERNEL_WRAPPERS}
    for name, (fn, args) in calls.items():
        eager = [t for t in pytree.tree_leaves(fn(*args))
                 if isinstance(t, torch.Tensor)]
        replayed = [t for t in pytree.tree_leaves(_graph_replay(fn, args))
                    if isinstance(t, torch.Tensor)]
        assert len(eager) == len(replayed), name
        for e, g in zip(eager, replayed):
            assert torch.equal(e, g), name


@pytest.mark.cuda
def test_reduced_round_cuda_graph_bitwise_to_run_plan(card):
    """Reduced lm_350m's hierarchical fused-int8 round (``blocked``
    attention: K2 on the card, and K3b): ``run_plan`` bitwise the direct
    round with the same launches, and two rounds of the compiled plan (one
    CUDA graph, params and server state donated) bitwise two ``run_plan``
    rounds, built once."""
    import functools

    from torch.utils import _pytree as pytree

    from repro_torch import optim
    from repro_torch.algorithms import rounds
    from repro_torch.core import interpreter as interp
    from repro_torch.data.grouped import CohortSampler, GroupedCorpus
    from repro_torch.models import registry

    cfg = registry.get_config("lm_350m").reduced(attn_impl="blocked")
    params = registry.init_params(cfg, seed=0, device=card)
    server = optim.fedavg_momentum(1.0)
    round_fn = rounds.make_hierarchical_local_sgd_round(
        functools.partial(registry.loss_fn, cfg), optim.sgd(0.05), server,
        rounds.LocalSGDConfig(partition_size=2, num_local_steps=2,
                              grad_clip=1.0, compression="int8", num_pods=2))
    state = server.init(params)
    sampler = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                            cohort_size=4)

    def data(r):
        d = sampler.round_batch(r, 2, 2, 64, device=card)
        return {k: d[k].reshape((2, 2) + tuple(d[k].shape[1:]))
                for k in ("tokens", "labels")}

    n_carry = len(pytree.tree_leaves((params, state)))
    depths = [0] * n_carry + [2] * 2
    plan = interp.build_plan(interp.trace(round_fn, params, state, data(0)),
                             {"pods": 2, "clients": 2},
                             partitioned_invars=depths)
    ops.reset_launches()
    direct = pytree.tree_leaves(round_fn(params, state, data(0)))
    counts = ops.launch_counts()
    ops.reset_launches()
    oracle = interp.run_plan(plan, *pytree.tree_leaves((params, state, data(0))))
    assert ops.launch_counts() == counts
    assert counts["reduce_compress_roundtrip"] == 1
    assert counts["flash_attention_fwd"] > 0
    assert all(torch.equal(a, b) for a, b in zip(oracle, direct))
    compiled = plan.compile(device="cuda", donate_argnums=range(n_carry))
    carried = [t.clone() for t in pytree.tree_leaves((params, state))]
    spec = pytree.tree_structure((params, state))
    po, so = params, state
    for r in range(2):
        want = interp.run_plan(plan, *pytree.tree_leaves((po, so, data(r))))
        got = compiled(*carried, *pytree.tree_leaves(data(r)))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(x is y for x, y in zip(got[:n_carry], carried))
        po, so = pytree.tree_unflatten(list(want[:n_carry]), spec)
    assert compiled.trace_count == 1


@pytest.mark.cuda
def test_elastic_round_on_card_bitwise_to_hierarchical_round(card):
    """Reduced lm_350m (``blocked`` attention: K2 on the card) through the
    elastic round at 2, 1 and 2 pods of 2 clients: each step bitwise the
    direct uncompressed hierarchical round at that pod count, one trace of
    the per-client leg, two cross-pod legs."""
    import dataclasses
    import functools

    from torch.utils import _pytree as pytree

    from repro_torch import optim
    from repro_torch.algorithms import rounds
    from repro_torch.data.grouped import CohortSampler, GroupedCorpus
    from repro_torch.models import registry
    from repro_torch.runtime.elastic import make_elastic_hierarchical_round

    cfg = registry.get_config("lm_350m").reduced(attn_impl="blocked")
    loss = functools.partial(registry.loss_fn, cfg)
    params = registry.init_params(cfg, seed=0, device=card)
    server = optim.fedavg_momentum(1.0)
    round_cfg = rounds.LocalSGDConfig(partition_size=2, num_local_steps=2,
                                      grad_clip=1.0)
    elastic = make_elastic_hierarchical_round(loss, optim.sgd(0.05), server,
                                              round_cfg)
    d = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                      cohort_size=4).round_batch(0, 2, 2, 64, device=card)
    data = {k: d[k].reshape((2, 2) + tuple(d[k].shape[1:]))
            for k in ("tokens", "labels")}
    state = server.init(params)
    for pods in (2, 1, 2):
        batch = {k: v[:pods] for k, v in data.items()}
        hier = rounds.make_hierarchical_local_sgd_round(
            loss, optim.sgd(0.05), server,
            dataclasses.replace(round_cfg, num_pods=pods))
        got = pytree.tree_leaves(elastic.step(params, state, batch))
        want = pytree.tree_leaves(hier(params, state, batch))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert elastic.client_trace_count == 1
    assert elastic.cross_compile_count == 2


@pytest.mark.cuda
def test_multi_round_loop_plan_on_card(card):
    """Reduced lm_350m's 2-round trainer (flat int8, ``blocked``
    attention) is one LOOP[scan] stage; ``run_plan`` bitwise the direct
    trainer, the compiled plan (carry donated) bitwise ``run_plan``."""
    import functools

    from torch.utils import _pytree as pytree

    from repro_torch import optim
    from repro_torch.algorithms import rounds
    from repro_torch.core import interpreter as interp
    from repro_torch.data.grouped import CohortSampler, GroupedCorpus
    from repro_torch.models import registry

    cfg = registry.get_config("lm_350m").reduced(attn_impl="blocked")
    params = registry.init_params(cfg, seed=0, device=card)
    server = optim.fedavg_momentum(1.0)
    trainer = rounds.make_multi_round(rounds.make_local_sgd_round(
        functools.partial(registry.loss_fn, cfg), optim.sgd(0.05), server,
        rounds.LocalSGDConfig(partition_size=2, num_local_steps=2,
                              grad_clip=1.0, compression="int8")), 2)
    sampler = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                            cohort_size=2)
    batches = [sampler.round_batch(r, 2, 2, 64, device=card)
               for r in range(2)]
    stacked = {k: torch.stack([b[k] for b in batches])
               for k in ("tokens", "labels")}
    state = server.init(params)
    args = pytree.tree_leaves((params, state, stacked))
    n_carry = len(pytree.tree_leaves((params, state)))
    plan = interp.build_plan(interp.trace(trainer, params, state, stacked),
                             2, partitioned_invars=[0] * len(args))
    assert [(s.kind, s.trip_count) for s in plan.stages] == [("LOOP", 2)]
    direct = pytree.tree_leaves(trainer(params, state, stacked))
    oracle = interp.run_plan(plan, *args)
    assert all(torch.equal(a, b) for a, b in zip(oracle, direct))
    compiled = plan.compile(device="cuda", donate_argnums=range(n_carry))
    for _ in range(2):
        carry = [t.clone() for t in args[:n_carry]]
        got = compiled(*carry, *args[n_carry:])
        assert all(torch.equal(a, b) for a, b in zip(got, oracle))
    assert compiled.trace_count == 1


@pytest.mark.cuda
def test_comm_cost_cross_validates_on_card(card):
    """``cross_validate`` runs the plan once on the card and measures what
    each comm stage carried: clean at model scale 1, every stage a
    mismatch at 1.1; an int8-fused hierarchical reduce's DCN stage in
    K1a's packed rows, clean."""
    from repro_torch import core as drjax
    from repro_torch.analysis import commcost
    from repro_torch.compression import int8_roundtrip
    from repro_torch.core import interpreter as interp

    @drjax.program(placements={"pods": 2, "clients": 4})
    def f(x, data):
        z = drjax.map_fn(lambda a, b: a * b, (drjax.broadcast(x), data))
        return drjax.reduce_mean(drjax.reduce_mean(z, placement="clients"),
                                 placement="pods")

    args = (torch.tensor(2.0), torch.zeros((2, 4, 64)))
    plan = interp.build_plan(interp.trace(f, *args),
                             {"pods": 2, "clients": 4})
    assert commcost.cross_validate(plan, device="cuda") == []
    bad = commcost.cross_validate(plan, device="cuda", model_scale=1.1)
    assert [f.code for f in bad] == ["commcost/model-mismatch"] * len(
        plan.comm_cost().per_stage)

    @drjax.program(partition_size=8)
    def g(xs):
        return drjax.hierarchical_reduce_mean(xs, num_supergroups=2,
                                              compress_fn=int8_roundtrip)

    plan8 = interp.build_plan(interp.trace(g, torch.zeros((8, 512))), 8)
    xs = torch.randn((8, 512), generator=torch.Generator().manual_seed(0))
    assert commcost.cross_validate(plan8, [xs.cuda()], device="cuda") == []


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_second_order_on_card(card, dtype):
    """P3 on the card: the double backward through ``ops.flash_attention``
    (the K2 kernels, then the plain recompute of the second order) against
    autograd's double backward through the plain forward (in bf16 a
    Hessian-vector product, so both sides take the same cotangent), at the
    tolerance ``ops._FlashAttentionBackward`` states; the first order
    bitwise the kernels called directly; one call of each."""
    gen = torch.Generator(device=card).manual_seed(7)
    q, k, v, w = (torch.randn((2, 128, 4, 64), generator=gen,
                              device=card).to(dtype) for _ in range(4))

    u = [torch.randn((2, 128, 4, 64), generator=gen, device=card)
         for _ in range(3)]

    def second(attend):
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        g1 = torch.autograd.grad(attend(qq, kk, vv), (qq, kk, vv), w,
                                 create_graph=True)
        if dtype == torch.float32:
            total = sum((g ** 2).sum() for g in g1)
        else:  # the same cotangent on both sides (a Hessian-vector product)
            total = sum((g.float() * uu).sum() for g, uu in zip(g1, u))
        return g1, torch.autograd.grad(total, (qq, kk, vv))

    ops.reset_launches()
    g1, got = second(lambda *t: ops.flash_attention(*t, causal=True,
                                                    window=100))
    counts = ops.launch_counts()
    assert (counts["flash_attention_fwd"], counts["flash_attention_bwd_dq"],
            counts["flash_attention_bwd_dkdv"]) == (1, 1, 1)
    assert ops.plain_counts() == {"flash_attention_bwd2_plain": 1,
                                  "lru_scan_bwd2_plain": 0,
                                  "wkv6_bwd2_plain": 0}
    out, out32, lse = ops.flash_attention_fwd(q, k, v, causal=True,
                                              window=100)
    dq, delta = ops.flash_attention_bwd_dq(q, k, v, out32, lse, w,
                                           causal=True, window=100)
    dk, dv = ops.flash_attention_bwd_dkdv(q, k, v, lse, delta, w,
                                          causal=True, window=100)
    for a, b in zip(g1, (dq, dk, dv)):
        assert torch.equal(a.detach(), b)
    _, want = second(lambda *t: ref.flash_attention_ref(*t, causal=True,
                                                        window=100)[0])
    for g, p in zip(got, want):
        diff = (g.double() - p.double()).abs()
        top = float(p.double().abs().max())
        if dtype == torch.float32:
            assert float(diff.max()) <= 1e-4 * top
        else:
            assert bool((diff <= 2.0 ** -6 * p.double().abs()
                         + 1e-2 * top).all())


@pytest.mark.cuda
def test_lru_and_wkv_second_order_on_card(card):
    """K4's and K5's second order on the card: the double backward through
    ``ops.lru_scan`` (with h0) and ``ops.wkv6`` (with s0, and the final
    state in the loss) against autograd's double backward through the
    plain loops, within 1e-4 of the largest magnitude; the first order
    bitwise the kernels called directly; one plain recompute each. Small S
    (the recompute is a Python loop of S steps)."""
    gen = torch.Generator(device=card).manual_seed(8)

    def second(fn, inputs, weights):
        xs = [t.detach().requires_grad_(True) for t in inputs]
        outs = fn(*xs)
        loss = sum((o * w).sum() for o, w in zip(outs, weights))
        g1 = torch.autograd.grad(loss, xs, create_graph=True)
        return g1, torch.autograd.grad(sum((g ** 2).sum() for g in g1), xs)

    def close(got, want):
        for g, w in zip(got, want):
            top = float(w.abs().max())
            assert float((g - w).abs().max()) <= 1e-4 * top

    a = torch.rand((2, 70, 48), generator=gen, device=card) * 0.9
    b = torch.randn((2, 70, 48), generator=gen, device=card)
    h0 = torch.randn((2, 48), generator=gen, device=card)
    wl = [torch.randn((2, 70, 48), generator=gen, device=card)]
    ops.reset_launches()
    g1, got = second(lambda *t: (ops.lru_scan(*t),), (a, b, h0), wl)
    assert ops.plain_counts()["lru_scan_bwd2_plain"] == 1
    counts = ops.launch_counts()
    assert (counts["lru_scan_fwd"], counts["lru_scan_bwd"]) == (1, 1)
    da, db, dh0 = ops.lru_scan_bwd(a, ops.lru_scan_fwd(a, b, h0), wl[0], h0)
    for x, y in zip(g1, (da, db, dh0)):
        assert torch.equal(x.detach(), y)
    close(got, second(lambda *t: (ref.lru_scan_ref(*t),), (a, b, h0), wl)[1])

    shape = (1, 70, 2, 64)
    r, kk, vv = (torch.randn(shape, generator=gen, device=card) * 0.5
                 for _ in range(3))
    logw = -torch.rand(shape, generator=gen, device=card) - 0.05
    u = torch.randn((2, 64), generator=gen, device=card) * 0.5
    s0 = torch.randn((1, 2, 64, 64), generator=gen, device=card) * 0.1
    ww = [torch.randn(shape, generator=gen, device=card),
          torch.randn((1, 2, 64, 64), generator=gen, device=card) * 0.1]
    ops.reset_launches()
    g1, got = second(ops.wkv6, (r, kk, vv, logw, u, s0), ww)
    assert ops.plain_counts()["wkv6_bwd2_plain"] == 1
    counts = ops.launch_counts()
    assert (counts["wkv6_fwd"], counts["wkv6_bwd"]) == (1, 1)
    _, states, final = ops.wkv6_fwd(r, kk, vv, logw, u, s0)
    first = ops.wkv6_bwd(r, kk, vv, logw, u, states, ww[0], s0, final, ww[1])
    for x, y in zip(g1, first):
        assert torch.equal(x.detach(), y)
    want = second(lambda *t: ref.wkv6_fwd_ref(*t)[::2],
                  (r, kk, vv, logw, u, s0), ww)[1]
    close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h", [(2, 1, 2), (2, 37, 2), (2, 64, 2),
                                   (2, 200, 2), (1, 37, 40)])
def test_wkv6_initial_and_final_state(card, b, s, h):
    """K5 from an initial state s0, with the final state as an output and
    its gradient in the backward, against the plain versions at ragged S:
    out within 1e-4, the final state within 1e-4 of its largest magnitude,
    every gradient (ds0 too) within 1e-4 of its largest magnitude. The
    padded tail leaves the final state as the last real step left it.
    (1, 37, 40) is a ragged serve chunk of full rwkv6_3b."""
    r, k, v, lw, u, do = _wkv_inputs(card, b, s, h, 64, "model", seed=s)
    gen = torch.Generator(device=card).manual_seed(s)
    s0 = torch.randn((b, h, 64, 64), generator=gen, device=card) * 0.3
    dfinal = torch.randn((b, h, 64, 64), generator=gen, device=card)
    out, states, final = ops.wkv6_fwd(r, k, v, lw, u, s0)
    r_out, _, r_final = ref.wkv6_fwd_ref(r, k, v, lw, u, s0)
    torch.testing.assert_close(out, r_out, rtol=1e-4, atol=1e-4)
    assert float((final - r_final).abs().max()) <= 1e-4 * float(
        r_final.abs().max())
    got = ops.wkv6_bwd(r, k, v, lw, u, states, do, s0, final, dfinal)
    want = ref.wkv6_bwd_ref(r, k, v, lw, u, do, s0, dfinal)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du", "ds0"), got, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        err = float((g - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), (name, err)
    # no initial state, no final gradient: the training call, bitwise as
    # from a zero s0 and a zero dfinal
    zero = torch.zeros_like(s0)
    a = ops.wkv6_fwd(r, k, v, lw, u)
    z = ops.wkv6_fwd(r, k, v, lw, u, zero)
    assert all(torch.equal(x, y) for x, y in zip(a, z))
    ga = ops.wkv6_bwd(r, k, v, lw, u, a[1], do)
    gz = ops.wkv6_bwd(r, k, v, lw, u, a[1], do, zero, a[2], zero)
    for x, y in zip(ga[:5], gz[:5]):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["stablelm_3b", "recurrentgemma_2b",
                                  "rwkv6_3b"])
def test_serve_step_replay_bitwise_to_eager(card, arch):
    """A fused serve step and a decode step of a reduced model, replayed
    from their CUDA graphs, bitwise the same steps run eagerly on a copy of
    the pool; replays count their kernels in ``CudaGraphs.replayed``, not
    in the wrappers' counters."""
    from torch.utils import _pytree as pytree

    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.runtime.executor import CudaGraphs, TraceCounter

    cfg = registry.get_config(arch).reduced()
    params = registry.init_params(cfg, seed=0, device="cuda")
    pool = registry.init_slot_pool(cfg, 2, 32, device="cuda")
    tokens = torch.tensor([[3], [5]], dtype=torch.int32, device=card)
    cslot = torch.tensor([1], device=card)
    ctoks = torch.arange(8, dtype=torch.int32, device=card) + 7
    cpos = torch.zeros((), dtype=torch.int32, device=card)
    first = torch.ones((), dtype=torch.bool, device=card)
    emit = torch.ones((), dtype=torch.bool, device=card)
    serve = steps.make_serve_step(cfg)
    decode = steps.make_slot_decode_step(cfg)
    graphed = CudaGraphs(serve, device=card, counter=TraceCounter())
    graphed_decode = CudaGraphs(decode, device=card, counter=TraceCounter())
    graphed(8, params, tokens, pool, cslot, ctoks, cpos, first, emit)
    graphed_decode("d", params, tokens, pool)
    clone = lambda tree: pytree.tree_map(torch.clone, tree)
    eager_pool, eager_tokens = clone(pool), tokens.clone()
    first.fill_(False)
    cpos.fill_(8)
    ops.reset_launches()
    graphed(8, params, tokens, pool, cslot, ctoks, cpos, first, emit)
    graphed_decode("d", params, tokens, pool)
    serve(params, eager_tokens, eager_pool, cslot, ctoks, cpos, first, emit)
    decode(params, eager_tokens, eager_pool)
    assert torch.equal(tokens, eager_tokens)
    for x, y in zip(pytree.tree_leaves(pool), pytree.tree_leaves(eager_pool)):
        assert torch.equal(x, y)
    assert graphed.replays == 1 and graphed_decode.replays == 1
    counts = ops.launch_counts()
    kernel = {"recurrentgemma_2b": "lru_scan_fwd",
              "rwkv6_3b": "wkv6_fwd"}.get(arch)
    if kernel:
        assert graphed.replayed[kernel] == counts[kernel] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("sa,sb", [((2, 4096, 1024), (1024, 4096)),
                                   ((16, 640, 4096), (16, 4096, 6400))])
def test_matmul_f32_matches_the_f32_product(card, sa, sb):
    """``common.matmul_f32`` of bf16 inputs (lm_350m's FFN; phi35_moe's
    experts, batched): one GEMM with an f32 output, within 2e-5 of the
    largest magnitude of the f32 product of f32 copies (the same exact
    products, summed in another order); its gradients, the reference's
    transpose (the f32 cotangent against the bf16 operand), within one
    bf16 step (``2^-7 |want| + 1e-3 max |want|``) of bf16 of the f32
    product of f32 copies, zero elements beyond."""
    from repro_torch.models import common

    gen = torch.Generator(device=card).manual_seed(0)
    a = torch.randn(sa, generator=gen, device=card).bfloat16()
    b = (torch.randn(sb, generator=gen, device=card)
         / sb[-2] ** 0.5).bfloat16()
    got = common.matmul_f32(a, b)
    want = torch.matmul(a.float(), b.float())
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max())
    g = torch.randn(got.shape, generator=gen, device=card)
    x, y = (t.detach().requires_grad_() for t in (a, b))
    grads = torch.autograd.grad(common.matmul_f32(x, y), (x, y), g)
    if b.ndim == 2:  # the 2-d weight's gradient sums over every token
        a2, g2 = a.reshape(-1, sa[-1]), g.reshape(-1, sb[-1])
    else:
        a2, g2 = a, g
    wants = (torch.matmul(g, b.float().transpose(-1, -2)),
             torch.matmul(a2.float().transpose(-1, -2), g2))
    for p, w in zip(grads, wants):
        w = w.bfloat16().double()
        lim = 2.0 ** -7 * w.abs() + 1e-3 * float(w.abs().max())
        assert p.dtype == torch.bfloat16
        assert int(((p.double() - w).abs() > lim).sum()) == 0


@pytest.mark.cuda
def test_chaos_soak_on_card(card, tmp_path):
    """The chaos soak at the CI shape (20 rounds, a failure, an elastic
    event, a killed checkpoint, serve off) on the card: every invariant,
    the final state bitwise the oracle's, one client-leg trace."""
    from repro_torch.runtime import chaos

    rep = chaos.run_chaos_soak(chaos.ChaosConfig(
        rounds=20, seed=1, num_device_failures=1, num_elastic_events=1,
        num_ckpt_faults=1, checkpoint_every=4, audit_every=8,
        serve_traffic=False, ckpt_dir=str(tmp_path), device="cuda"))
    assert rep.oracle_bitwise_equal
    assert rep.client_leg_traces == 1 and rep.oracle_extra_traces == 0
    assert rep.mid_write_kills_injected == rep.mid_write_kills_survived == 1
    assert rep.audit["max_rel_err"] <= 1e-6


@pytest.mark.cuda
def test_remat_dots_bitwise_to_none_on_card(card):
    """2 layers of lm_350m at full width, bf16, B 2 x S 512: loss and every
    gradient under ``remat="dots"`` (the products without batch dims saved,
    ``aten.mm.dtype`` among them; K2 and the rest recomputed) bitwise
    those of ``remat="none"``."""
    import dataclasses

    from repro_torch.models import registry

    cfg = dataclasses.replace(registry.get_config("lm_350m"), num_layers=2)
    params = registry.init_params(cfg, seed=0, device="cuda")
    batch = registry.make_batch(cfg, 2, 512, seed=0, device="cuda")
    runs = []
    for remat in ("none", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        p = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss = registry.loss_fn(c, p, batch)
        runs.append((loss.detach(), torch.autograd.grad(loss, list(p.values()))))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_one_rank_nccl_mesh_rounds_bitwise(card, tmp_path):
    """[mesh] (a) at reduced lm_350m: a (pod 1, data 1) mesh from
    ``mesh_for_placements`` in a world of one NCCL rank. The flat int8
    round with its clients over "data" and the hierarchical fused int8
    round 2 x 2 with pods over "pod": losses and parameters bitwise the
    mesh-free rounds', the kernel launches equal."""
    import argparse
    import functools

    import torch.distributed as dist

    from repro_torch.algorithms import rounds
    from repro_torch.data.grouped import CohortSampler, GroupedCorpus
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train
    from repro_torch.models import registry

    assert compat.init_process_group(
        0, 1, init_method=f"file://{tmp_path}/rendezvous",
        device="cuda") == "nccl"
    try:
        mesh = mesh_lib.mesh_for_placements({"pods": 1, "clients": 1},
                                            device="cuda")
        cfg = registry.get_config("lm_350m").reduced()
        args = argparse.Namespace(algorithm="local_sgd", client_lr=0.05)
        sampler = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                                cohort_size=4)
        d = sampler.round_batch(0, 2, 2, 32, device="cuda")
        flat = {"tokens": d["tokens"], "labels": d["labels"]}
        hier = {k: v.reshape((2, 2) + tuple(v.shape[1:]))
                for k, v in flat.items()}
        for pods, data, axes in ((0, flat, "data"),
                                 (2, hier, {"pods": "pod", "clients": "data"})):
            runs = []
            for on_mesh in (False, True):
                client_opt, server_opt = train.optimizers(args)
                rcfg = rounds.LocalSGDConfig(
                    partition_size=4 // max(pods, 1), num_local_steps=2,
                    grad_clip=1.0, compression="int8", num_pods=pods,
                    mesh=mesh if on_mesh else None,
                    partition_axes=axes if on_mesh else None)
                make = (rounds.make_hierarchical_local_sgd_round if pods
                        else rounds.make_local_sgd_round)
                fn = make(functools.partial(registry.loss_fn, cfg),
                          client_opt, server_opt, rcfg)
                params = registry.init_params(cfg, seed=0, device="cuda")
                ops.reset_launches()
                new, _, m = fn(params, server_opt.init(params), data)
                runs.append((float(m["loss"]), new, ops.launch_counts()))
            (la, pa, ca), (lb, pb, cb) = runs
            assert la == lb and ca == cb
            assert ca["reduce_compress_roundtrip" if pods else "quantize"] > 0
            for k in pa:
                assert torch.equal(pa[k], pb[k]), k
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_int8_tp_reduction_on_one_nccl_rank(card, tmp_path):
    """``tpcomm`` on the card: the int8 sum of one rank's partial is its
    plain version (``ref.quantize_ref`` and the product of q and s)
    bitwise, the forced gather over a model dim of one rank takes NCCL's
    ``all_gather`` and returns the int8 bits as they were, and the
    mesh-free ``int8_matmul_reduce`` is the f32-accumulated product."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import common, partitioning, tpcomm

    gen = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(512, 1024, generator=gen, device=card).bfloat16()
    w = torch.randn(1024, 768, generator=gen, device=card).bfloat16()
    want = common.matmul_f32(x, w)
    got = tpcomm.int8_matmul_reduce(x, w, out_dtype=torch.float32)
    assert torch.equal(got, want)
    assert compat.init_process_group(
        0, 1, init_method=f"file://{tmp_path}/rendezvous",
        device="cuda") == "nccl"
    try:
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), device="cuda")
        partitioning.reset_routes()
        with partitioning.axis_rules(mesh):
            out = tpcomm.int8_sum(want)
            q, s = ref.quantize_ref(want)
            assert torch.equal(out, q.float() * s)
            gathered = partitioning.gather_exact(q[None], 0, (1,))
            assert torch.equal(gathered[0], q)
            assert partitioning.gather_route(q, 1) == "all_gather"
        assert partitioning.ROUTES[("gather", "all_gather")] == 1
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv,ranks", [(16, 16, 2), (64, 8, 2),
                                          (64, 8, 16)])
def test_flash_on_a_ranks_heads_is_its_slice_of_the_whole(card, hq, hkv,
                                                          ranks):
    """K2 on one rank's query heads (and the kv heads they read,
    ``attention.local_kv``'s choice) is bitwise those heads of the call on
    every head, forward and both backward kernels: what the
    tensor-parallel attention runs on each rank."""
    b, s, hd = 2, 256, 128
    gen = torch.Generator(device=card).manual_seed(1)
    q, k, v = (torch.randn(b, s, h, hd, generator=gen, device=card)
               .bfloat16().requires_grad_(True) for h in (hq, hkv, hkv))
    out = ops.flash_attention(q, k, v, causal=True)
    dout = torch.randn_like(out)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), dout)
    g, hl = hq // hkv, hq // ranks
    for r in range(ranks):
        first, n = r * hl // g, max(hl // g, 1)
        ql = q.detach()[:, :, r * hl:(r + 1) * hl].contiguous()
        ql.requires_grad_(True)
        kl, vl = (t.detach()[:, :, first:first + n].contiguous()
                  .requires_grad_(True) for t in (k, v))
        ol = ops.flash_attention(ql, kl, vl, causal=True)
        assert torch.equal(ol, out[:, :, r * hl:(r + 1) * hl])
        dql, _, _ = torch.autograd.grad(
            ol, (ql, kl, vl), dout[:, :, r * hl:(r + 1) * hl].contiguous())
        assert torch.equal(dql, dq[:, :, r * hl:(r + 1) * hl])
    if hq == hkv:  # each kv head read by one rank's heads alone
        for r in range(ranks):
            kl, vl = (t.detach()[:, :, r * hl:(r + 1) * hl].contiguous()
                      .requires_grad_(True) for t in (k, v))
            ql = (q.detach()[:, :, r * hl:(r + 1) * hl].contiguous()
                  .requires_grad_(True))
            ol = ops.flash_attention(ql, kl, vl, causal=True)
            _, dkl, dvl = torch.autograd.grad(
                ol, (ql, kl, vl), dout[:, :, r * hl:(r + 1) * hl].contiguous())
            assert torch.equal(dkl, dk[:, :, r * hl:(r + 1) * hl])
            assert torch.equal(dvl, dv[:, :, r * hl:(r + 1) * hl])


@pytest.mark.cuda
def test_mesh_free_serve_step_builds_one_graph_a_bucket(card):
    """``make_serve_step(cfg)`` (``mesh=None``) through the serve runtime's
    ``CudaGraphs``: one build for each chunk bucket and replays after it,
    its tokens bitwise the eager step's."""
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.runtime.executor import CudaGraphs, TraceCounter

    cfg = registry.get_config("lm_350m").reduced(dtype="bfloat16")
    params = registry.init_params(cfg, seed=0, device="cuda")
    step = steps.make_serve_step(cfg)
    assert not hasattr(step, "shardings_for")
    counter = TraceCounter()
    graphs = CudaGraphs(step, device="cuda", counter=counter)
    slots, max_len = 2, 64

    def inputs(c):
        pool = registry.init_slot_pool(cfg, slots, max_len, device="cuda")
        return (params, torch.zeros(slots, 1, dtype=torch.int32,
                                    device=card), pool,
                torch.zeros(1, dtype=torch.int64, device=card),
                torch.arange(c, dtype=torch.int32, device=card) % 97,
                torch.zeros((), dtype=torch.int32, device=card),
                torch.ones((), dtype=torch.bool, device=card),
                torch.ones((), dtype=torch.bool, device=card))

    for c in (8, 16):
        args = inputs(c)
        eager = steps.make_serve_step(cfg)(*inputs(c))[0].clone()
        for _ in range(3):
            fresh = inputs(c)
            for a, f in zip(pytree_leaves(args[1:]), pytree_leaves(fresh[1:])):
                a.copy_(f)
            tokens, _ = graphs(c, *args)
            assert torch.equal(tokens, eager)
    assert counter.count == 2 and graphs.replays == 4


def pytree_leaves(tree):
    from torch.utils import _pytree as pytree

    return pytree.tree_leaves(tree)


@pytest.mark.cuda
def test_moe_routing_groups_span_two_ranks_on_card(card, tmp_path):
    """[serve mesh] (b)'s routing on the card: one full-width phi35_moe
    MoE layer (bf16, seeded) on B 8 x S 64 (one routing group of 512
    tokens over both ranks) and on a decode batch of 8 tokens, in a gloo
    world of 2 ranks sharing the card on a (data 2) mesh: each rank's
    tokens' expert choices, kept choices, slots and weights bitwise those
    of the one-rank run of the whole batch, and its rows within one bf16
    step of the largest magnitude (``_torch_dist_checks.moe_mesh_card``)."""
    import sys

    here = str(Path(__file__).resolve().parent)
    if here not in sys.path:
        sys.path.insert(0, here)
    import _torch_dist

    ranks = _torch_dist.run_world(2, ["moe_mesh_card"],
                                  str(tmp_path))["moe_mesh_card"]
    for rank, res in enumerate(ranks):
        for name, r in res.items():
            assert r["spans"], name
            assert all(r["routing_equal"].values()), (rank, name,
                                                      r["routing_equal"])
            assert r["max_abs"] <= 2.0 ** -7 * r["want_max"], (rank, name)
