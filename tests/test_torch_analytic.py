"""The port's cost model (``repro_torch/launch/{analytic,hlo_cost}.py``)
against the reference's (``repro/launch/{analytic,hlo_cost}.py``).

* Given the reference's chip constants as a ``Chip``, the port's analytic
  model equals the reference's exactly (``==``) on every arch × shape cell
  × single/multi mesh.
* ``tests/test_roofline.py``'s cell checks on the H100's constants.
* The FLOPs that ``hlo_cost.count_flops`` counts for a reduced lm_350m
  train and prefill step against ``flops_cell``, in the reference's bands,
  with plain attention and on the route through the K2 ops.
* Each kernel op's FLOP formula against a hand count.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import analytic as ref_analytic  # noqa: E402
from repro.launch import hlo_cost as ref_hlo  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import analytic, hlo_cost  # noqa: E402
from repro_torch.models import registry  # noqa: E402

REF_CHIP = hlo_cost.Chip("reference", ref_hlo.PEAK_FLOPS, ref_hlo.HBM_BW,
                         ref_hlo.LINK_BW)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so this file's tests do not crowd
    out the suite's other workers; the worker's count comes back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the analytic model, bit for bit
# ---------------------------------------------------------------------------


def test_shape_cells_are_the_reference_s():
    assert registry.SHAPE_CELLS == ref_registry.SHAPE_CELLS
    assert registry.SUBQUADRATIC == ref_registry.SUBQUADRATIC
    assert registry.ARCH_IDS == tuple(sorted(
        ref_registry.ARCH_IDS, key=registry.ARCH_IDS.index))


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
@pytest.mark.parametrize("cell", list(ref_registry.SHAPE_CELLS))
@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_analytic_equals_reference(arch, cell, mesh_kind):
    cfg, rcfg = registry.get_config(arch), ref_registry.get_config(arch)
    shape = registry.SHAPE_CELLS[cell]
    kind, b, s = shape["kind"], shape["global_batch"], shape["seq_len"]
    mesh = getattr(analytic.MeshModel, mesh_kind)()
    rmesh = getattr(ref_analytic.MeshModel, mesh_kind)()
    assert dataclasses.asdict(mesh) == dataclasses.asdict(rmesh)
    assert analytic.flops_cell(cfg, kind, b, s) == \
        ref_analytic.flops_cell(rcfg, kind, b, s)
    assert analytic.bytes_cell(cfg, kind, b, s, mesh) == \
        ref_analytic.bytes_cell(rcfg, kind, b, s, rmesh)
    assert analytic.collective_bytes_cell(cfg, kind, b, s, mesh) == \
        ref_analytic.collective_bytes_cell(rcfg, kind, b, s, rmesh)
    assert analytic.analytic_roofline(cfg, kind, b, s, mesh,
                                      chip=REF_CHIP) == \
        ref_analytic.analytic_roofline(rcfg, kind, b, s, rmesh)
    assert analytic.causal_pair_fraction(s, cfg.q_block, cfg.kv_block) == \
        ref_analytic.causal_pair_fraction(s, rcfg.q_block, rcfg.kv_block)


def test_no_tpu_constants_and_h100_terms():
    assert (hlo_cost.PEAK_FLOPS, hlo_cost.HBM_BW, hlo_cost.LINK_BW) == \
        (989e12, 3.35e12, 450e9)
    t = hlo_cost.roofline_terms(989e12, 3.35e12, 450e9)
    assert t == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0}
    t = hlo_cost.roofline_terms(197e12, 819e9, 50e9, chip=REF_CHIP)
    assert t == ref_hlo.roofline_terms(197e12, 819e9, 50e9)


def test_causal_pair_fraction():
    # nq = nk = 4 equal blocks: visible pairs = 4+3+2+1 = 10 of 16
    assert analytic.causal_pair_fraction(2048, 512, 512) == 10 / 16
    f = analytic.causal_pair_fraction(1 << 18, 512, 1024)
    assert 0.5 < f < 0.52


# ---------------------------------------------------------------------------
# tests/test_roofline.py's cell checks on the H100
# ---------------------------------------------------------------------------


def test_decode_is_memory_bound_for_dense():
    cfg = registry.get_config("qwen2_72b")
    r = analytic.analytic_roofline(cfg, "decode", 128, 32768,
                                   analytic.MeshModel.single())
    assert r["memory_s"] > r["compute_s"]
    assert r["dominant"] in ("memory_s", "collective_s")


def test_train_compute_vs_collective_qwen2():
    cfg = registry.get_config("qwen2_72b")
    r = analytic.analytic_roofline(cfg, "train", 256, 4096,
                                   analytic.MeshModel.single())
    # 72B dense at TP=16: compute and the TP collectives are the two big
    # terms on NVLink's 450 GB/s as on the reference's links
    assert r["compute_s"] > r["memory_s"]
    assert r["collective_s"] > r["memory_s"]


def test_multi_pod_halves_compute_term():
    cfg = registry.get_config("qwen2_72b")
    single = analytic.analytic_roofline(cfg, "train", 256, 4096,
                                        analytic.MeshModel.single())
    multi = analytic.analytic_roofline(cfg, "train", 256, 4096,
                                       analytic.MeshModel.multi())
    np.testing.assert_allclose(multi["compute_s"], single["compute_s"] / 2,
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ["stablelm_3b", "phi35_moe", "rwkv6_3b"])
def test_param_count_matches_init(arch):
    cfg = registry.get_config(arch).reduced()
    params = registry.init_params(cfg, seed=0, device="cpu")
    actual = sum(p.numel() for p in params.values())
    # the vocabulary is padded to multiples of 512
    padded = dataclasses.replace(cfg,
                                 vocab_size=-(-cfg.vocab_size // 512) * 512)
    expected = padded.param_count()
    assert abs(actual - expected) / expected < 0.25, (
        f"{arch}: init {actual} vs formula {expected}")


def test_round_roofline_on_one_card():
    """One round of cohort x local steps client steps on one card: the
    client step's terms times the steps, no collective term."""
    cfg = registry.get_config("lm_350m")
    r = analytic.round_roofline(cfg, 4, 512, steps=8)
    fl = analytic.flops_cell(cfg, "train", 4, 512)["total"] * 8
    one = analytic.MeshModel(chips=1, data=1, model=1)
    by = analytic.bytes_cell(cfg, "train", 4, 512, one)["total"] * 8
    assert r["compute_s"] == fl / 989e12
    assert r["memory_s"] == by / 3.35e12
    assert r["collective_s"] == 0.0
    assert r["bound_s"] == max(r["compute_s"], r["memory_s"])
    assert r["model_flops"] == 6.0 * cfg.active_param_count() * 4 * 512 * 8


# ---------------------------------------------------------------------------
# counted FLOPs of a step against the analytic model
# ---------------------------------------------------------------------------


def _small(attn_impl):
    return registry.get_config("lm_350m").reduced(
        num_layers=2, d_model=128, num_heads=4, head_dim=32, d_ff=512,
        vocab_size=2048, scan_layers=False, remat="none",
        attn_impl=attn_impl, dtype="float32")


def _params_and_batch(cfg, b, s):
    params = registry.init_params(cfg, seed=0, device="cpu")
    return params, registry.make_batch(cfg, b, s, seed=1, device="cpu")


@pytest.mark.parametrize("attn_impl", ["naive", "blocked"])
def test_train_flops_match(attn_impl):
    cfg = _small(attn_impl)
    b, s = 2, 128
    params, batch = _params_and_batch(cfg, b, s)

    def step(p):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = registry.loss_fn(cfg, leaves, batch)
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    _, counted, by_op = hlo_cost.count_flops(step, params)
    k2 = {k for k in by_op if k.startswith("repro.flash_attention")}
    if attn_impl == "naive":
        causal = 1.0
        assert not k2
    else:
        causal = None  # the block-skipping schedule's fraction
        assert k2 == {"repro.flash_attention_fwd",
                      "repro.flash_attention_bwd_dq",
                      "repro.flash_attention_bwd_dkdv"}
    ana = analytic.flops_cell(cfg, "train", b, s, causal_factor=causal,
                              remat="none")
    ratio = ana["total"] / counted
    assert 0.65 < ratio < 1.5, f"analytic/counted = {ratio:.2f}"


@pytest.mark.parametrize("attn_impl", ["naive", "blocked"])
def test_prefill_flops_match(attn_impl):
    cfg = _small(attn_impl)
    b, s = 2, 128
    params, batch = _params_and_batch(cfg, b, s)
    with torch.no_grad():
        _, counted, by_op = hlo_cost.count_flops(registry.loss_fn, cfg,
                                                 params, batch)
    assert ("repro.flash_attention_fwd" in by_op) == (attn_impl != "naive")
    ana = analytic.flops_cell(
        cfg, "prefill", b, s,
        causal_factor=1.0 if attn_impl == "naive" else None)
    # prefill analytic excludes the loss/softmax; generous band
    ratio = ana["total"] / counted
    assert 0.5 < ratio < 1.5, f"analytic/counted = {ratio:.2f}"


# ---------------------------------------------------------------------------
# the kernel ops' formulas against hand counts
# ---------------------------------------------------------------------------


def _visible(sq, skv, causal, window):
    return sum(1 for i in range(sq) for j in range(skv)
               if (not causal or j <= i) and (window <= 0 or j > i - window))


FLASH_CASES = [
    # (b, sq, skv, hq, hkv, hd, causal, window)
    (1, 5, 5, 2, 1, 4, True, 2),
    (2, 7, 9, 4, 2, 8, True, 0),
    (1, 3, 6, 2, 2, 4, False, 0),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_formulas(case):
    b, sq, skv, hq, hkv, hd, causal, window = case
    pairs = _visible(sq, skv, causal, window)
    assert pairs == int(ref.visible_mask(sq, skv, causal, window,
                                         "cpu").sum())
    assert ops.visible_pairs(sq, skv, causal, window) == pairs
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, sq, hq, hd, generator=g)
    k = torch.randn(b, skv, hkv, hd, generator=g)
    v = torch.randn(b, skv, hkv, hd, generator=g)
    out, out32, lse = ops.flash_attention_fwd(q, k, v, causal=causal,
                                              window=window)
    dout = torch.randn_like(out)
    _, fwd, _ = hlo_cost.count_flops(ops.flash_attention_fwd, q, k, v,
                                     causal=causal, window=window)
    (_, delta), dq, _ = hlo_cost.count_flops(
        ops.flash_attention_bwd_dq, q, k, v, out32, lse, dout,
        causal=causal, window=window)
    _, dkdv, _ = hlo_cost.count_flops(
        ops.flash_attention_bwd_dkdv, q, k, v, lse, delta, dout,
        causal=causal, window=window)
    per = b * hq * hd * pairs
    assert (fwd, dq, dkdv) == (4 * per, 6 * per, 8 * per)
    assert fwd > 0


@pytest.mark.parametrize("shape,with_h0", [((2, 5, 3), False),
                                           ((1, 9, 4), True)])
def test_lru_formulas(shape, with_h0):
    b, s, w = shape
    g = torch.Generator().manual_seed(0)
    a = torch.rand(shape, generator=g)
    x = torch.randn(shape, generator=g)
    h0 = torch.randn(b, w, generator=g) if with_h0 else None
    h, fwd, _ = hlo_cost.count_flops(ops.lru_scan_fwd, a, x, h0)
    _, bwd, _ = hlo_cost.count_flops(ops.lru_scan_bwd, a, h,
                                     torch.randn_like(h), h0)
    assert fwd == 2 * b * s * w
    assert bwd == 3 * b * s * w + (b * w if with_h0 else 0)


@pytest.mark.parametrize("shape", [(1, 10, 2, 4), (2, 70, 1, 8)])
def test_wkv_formulas(shape):
    b, s, h, n = shape
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(shape, generator=g) for _ in range(3))
    logw = -torch.rand(shape, generator=g)
    u = torch.randn(h, n, generator=g)
    (out, states, _), fwd, _ = hlo_cost.count_flops(ops.wkv6_fwd, r, k, v,
                                                    logw, u)
    _, bwd, _ = hlo_cost.count_flops(ops.wkv6_bwd, r, k, v, logw, u, states,
                                     torch.randn_like(out))
    chunks = [min(64, s - 64 * c) for c in range(-(-s // 64))]
    assert fwd == b * h * sum(2 * L * L * n + 4 * L * n * n for L in chunks)
    assert bwd == b * h * sum(5 * L * L * n + 8 * L * n * n for L in chunks)


def test_int8_kernels_count_no_flops():
    x = torch.randn(4, 256)
    (q, s), n, _ = hlo_cost.count_flops(ops.quantize, x)
    assert n == 0
    _, n, _ = hlo_cost.count_flops(ops.dequantize, q, s)
    assert n == 0


def test_f32_output_products_count_their_flops():
    """The card's bf16-in, f32-out products (``common._mm_f32``: ``aten.mm.
    dtype`` and ``aten.bmm.dtype``, here on fake tensors, which run their
    meta kernels) count 2 m k n a product; torch's own ``bmm`` formula
    misreads ``out_dtype``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        a = torch.empty(3, 4, 5, dtype=torch.bfloat16)
        b = torch.empty(3, 5, 6, dtype=torch.bfloat16)
        out, n3, _ = hlo_cost.count_flops(torch.bmm, a, b,
                                          out_dtype=torch.float32)
        _, n2, _ = hlo_cost.count_flops(torch.mm, a[0], b[0],
                                        out_dtype=torch.float32)
    assert out.dtype == torch.float32
    assert (n3, n2) == (2 * 3 * 4 * 5 * 6, 2 * 4 * 5 * 6)
