"""K2's route table (``kernels/flash_attention.py:ROUTES``) on the CPU.

Every (dtype, head dim) the launchers take maps each of the four kernels
to exactly one extern "C" entry point that the build binds
(``_build.SIGNATURES``) and that its source defines with as many
parameters as the binding passes; bf16 at head dims 64 and 128 takes the
wgmma forward, ``bwd_dq`` and ``bwd_dkdv`` of ``flash_attention_sm90.cu``,
every other call ``flash_attention.cu``, and a bf16 forward of at most
``DECODE_ROWS`` query rows a kv head the split-KV kernels of
``flash_decode.cu``. No card is needed: nothing is built or launched. The
decode forward's combine rule (per-split partials folded in split order)
is held, on the plain version's f32 partials, to the JAX package's Pallas
kernel in interpret mode.
"""

import math

import re

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models.attention import _flash_fwd_core  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

KERNELS = ("fwd", "bwd_dq", "bwd_dkdv", "fwd_decode")
FLASH_LIBRARIES = ("flash_attention", "flash_attention_sm90", "flash_decode")
CASES = [(dtype, hd) for dtype in (torch.float32, torch.bfloat16)
         for hd in fa.HEAD_DIMS]


def _c_params(library: str, entry: str) -> int:
    """The number of parameters of ``entry``'s definition in
    ``csrc/<library>.cu``."""
    text = (_build.CSRC / f"{library}.cu").read_text()
    m = re.search(rf"\bint {entry}\(([^)]*)\)\s*\{{", text)
    assert m, f"{entry} is not defined in {library}.cu"
    return len([p for p in m.group(1).split(",") if p.strip()])


def test_routes_cover_exactly_the_head_dims_and_dtypes():
    assert set(fa.ROUTES) == set(CASES)
    assert all(set(route) == set(KERNELS) for route in fa.ROUTES.values())


@pytest.mark.parametrize("dtype,hd", CASES)
def test_each_kernel_has_one_bound_entry_point(dtype, hd):
    route = fa.ROUTES[(dtype, hd)]
    assert set(route) == set(KERNELS)
    for kernel in KERNELS:
        library, entry = route[kernel]
        assert library in _build.SOURCES
        assert entry in _build.SIGNATURES[library], (library, entry)
        assert _c_params(library, entry) == len(
            _build.SIGNATURES[library][entry]), (library, entry)


@pytest.mark.parametrize("dtype,hd", CASES)
def test_bf16_at_64_and_128_takes_the_wgmma_kernels(dtype, hd):
    route = fa.ROUTES[(dtype, hd)]
    wgmma = dtype == torch.bfloat16 and hd in (64, 128)
    assert route["fwd"] == (("flash_attention_sm90", "repro_flash_wg_fwd")
                            if wgmma else
                            ("flash_attention", "repro_flash_fwd"))
    assert route["bwd_dkdv"] == (
        ("flash_attention_sm90", "repro_flash_wg_bwd_dkdv") if wgmma
        else ("flash_attention", "repro_flash_bwd_dkdv"))
    assert route["bwd_dq"] == (
        ("flash_attention_sm90", "repro_flash_wg_bwd_dq") if wgmma
        else ("flash_attention", "repro_flash_bwd_dq"))


@pytest.mark.parametrize("hd", [64, 128])
def test_bf16_bwd_dq_at_64_and_128_is_bound_to_the_wgmma_entry(hd):
    """bf16 ``bwd_dq`` at head dims 64 and 128 takes
    ``repro_flash_wg_bwd_dq``, bound with repro_flash_bwd_dq's C
    signature, and the f32 call keeps the SIMT entry."""
    library, entry = fa.ROUTES[(torch.bfloat16, hd)]["bwd_dq"]
    assert (library, entry) == ("flash_attention_sm90",
                                "repro_flash_wg_bwd_dq")
    assert (_build.SIGNATURES[library][entry]
            == _build.SIGNATURES["flash_attention"]["repro_flash_bwd_dq"])
    assert _c_params(library, entry) == len(_build.SIGNATURES[library][entry])
    assert "wg_bwd_dq_kernel<HD>" in (_build.CSRC / f"{library}.cu").read_text()
    assert fa.ROUTES[(torch.float32, hd)]["bwd_dq"] == (
        "flash_attention", "repro_flash_bwd_dq")


@pytest.mark.parametrize("dtype,hd", CASES)
def test_decode_forward_route_and_binding(dtype, hd):
    """bf16 decode calls take flash_decode.cu's entry, whose C parameters
    are repro_flash_fwd's and the per-split scratch; f32 decode calls keep
    the SIMT forward."""
    route = fa.ROUTES[(dtype, hd)]
    if dtype == torch.bfloat16:
        assert route["fwd_decode"] == ("flash_decode", "repro_flash_decode")
        sig = _build.SIGNATURES["flash_decode"]["repro_flash_decode"]
        fwd_sig = _build.SIGNATURES["flash_attention"]["repro_flash_fwd"]
        assert sig == fwd_sig[:7] + (_build._P,) + fwd_sig[7:]
        assert _c_params("flash_decode", "repro_flash_decode") == len(sig)
    else:
        assert route["fwd_decode"] == ("flash_attention", "repro_flash_fwd")


def _record_fwd_kernel(monkeypatch, q, k):
    """The kernel name and argument count ``fa.fwd`` passes to its launch
    for CPU tensors of these shapes (the checks, the chunk query and the
    launch replaced)."""
    seen = {}

    def launch(what, q_, kernel, *args):
        seen.update(kernel=kernel, args=len(args))

    b, sq, hq, hd = q.shape
    monkeypatch.setattr(fa, "_check_qkv", lambda what, q_, k_, v_: (
        b, sq, k.shape[1], hq, k.shape[2], hd))
    monkeypatch.setattr(fa, "_decode_chunk", lambda hd_: 256)
    monkeypatch.setattr(fa, "_stream", lambda t: 0)
    monkeypatch.setattr(fa, "_launch", launch)
    fa.fwd(q, k, k, causal=False, window=0)
    return seen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("sq,hq,hkv", [(1, 4, 4), (1, 16, 1), (4, 8, 2),
                                       (16, 2, 2), (2, 16, 2), (17, 2, 2),
                                       (1, 17, 1), (3, 12, 2), (5, 4, 1)])
def test_fwd_takes_decode_exactly_for_few_bf16_rows(monkeypatch, sq, hq,
                                                      hkv, hd, dtype):
    """``fwd()`` takes ``fwd_decode`` exactly when the call is bf16 and
    Sq * Hq / Hkv <= DECODE_ROWS (16), at every head dim, and passes the
    decode entry one argument more (the scratch)."""
    q = torch.zeros((1, sq, hq, hd), dtype=dtype)
    k = torch.zeros((1, 5, hkv, hd), dtype=dtype)
    seen = _record_fwd_kernel(monkeypatch, q, k)
    want = dtype == torch.bfloat16 and sq * (hq // hkv) <= 16
    assert fa.takes_decode(dtype, sq, hq, hkv) == want
    assert seen["kernel"] == ("fwd_decode" if want else "fwd")
    library, entry = fa.ROUTES[(dtype, hd)][seen["kernel"]]
    assert seen["args"] == len(_build.SIGNATURES[library][entry])


def test_every_bound_flash_entry_point_is_routed_or_a_query():
    """No bound K2 entry point is left unreachable: each launch entry is in
    the table, and the rest report shared memory or the decode split."""
    routed = {e for route in fa.ROUTES.values() for e in route.values()}
    for library in FLASH_LIBRARIES:
        for entry in _build.SIGNATURES[library]:
            assert (library, entry) in routed or entry.endswith(
                ("_smem", "_chunk")), entry


def test_the_wgmma_source_is_built_and_encodes_its_maps_through_common():
    """flash_attention_sm90.cu compiles with the others and, like
    rglru_scan.cu, reaches cuTensorMapEncodeTiled only through
    common.cuh's run-time lookup (no -lcuda)."""
    assert "flash_attention_sm90" in _build.SOURCES
    assert "-lcuda" not in _build.NVCC_FLAGS
    lookup = re.compile(r"cudaGetDriverEntryPoint\w*\(")
    assert lookup.search((_build.CSRC / "common.cuh").read_text())
    for name in ("flash_attention_sm90.cu", "rglru_scan.cu"):
        text = (_build.CSRC / name).read_text()
        assert "encode_tiled()" in text
        assert not lookup.search(text), name


def test_no_mma_sync_instantiation_serves_the_wgmma_head_dims():
    """No mma.sync kernel (forward, bwd_dq or bwd_dkdv) is instantiated at
    the head dims the wgmma kernels serve: each entry dispatches through
    REPRO_FLASH_DISPATCH, which takes only f32 at 64 and 128, and the
    shared-memory query knows no mma.sync kernel there."""
    text = (_build.CSRC / "flash_attention.cu").read_text()
    for entry in ("repro_flash_fwd", "repro_flash_bwd_dq",
                  "repro_flash_bwd_dkdv"):
        body = text[text.index(f"int {entry}("):]
        body = body[:body.index("\n}\n")]
        assert "REPRO_FLASH_DISPATCH(" in body, entry
    macro = text[text.index("#define REPRO_FLASH_DISPATCH"):]
    macro = macro[:macro.index("while (0)")]
    for hd in (64, 128):
        assert f"REPRO_FLASH_F32_ONLY(SIMT, TC, {hd}," in macro, hd
        assert f"REPRO_FLASH_CASE(SIMT, TC, {hd}," not in macro, hd
    for hd in (16, 32, 80, 256):
        assert f"REPRO_FLASH_CASE(SIMT, TC, {hd}," in macro, hd
    smem = text[text.index("int repro_flash_tc_smem("):]
    smem = smem[:smem.index("\n}\n")]
    assert "case 64" not in smem and "case 128" not in smem
    assert "REPRO_FLASH_SMEM(64)" not in smem


def test_uncounted_keeps_the_route_launches():
    """``ops.uncounted`` (a CUDA graph capture) leaves K2's launches by
    entry point as they were."""
    ops.reset_launches()
    assert fa.ROUTE_LAUNCHES == {}
    key = ("repro_flash_wg_fwd", torch.bfloat16, 64)
    fa.ROUTE_LAUNCHES[key] = 2
    with ops.uncounted():
        fa.ROUTE_LAUNCHES[key] += 1
        fa.ROUTE_LAUNCHES[("repro_flash_bwd_dq", torch.bfloat16, 64)] = 1
    assert fa.ROUTE_LAUNCHES == {key: 2}
    ops.reset_launches()
    assert fa.ROUTE_LAUNCHES == {}


def test_cpu_tensors_never_reach_a_launcher():
    """On the CPU the ops take the plain versions; the launchers refuse
    CPU tensors before any route is looked up."""
    q = torch.zeros((1, 4, 2, 64), dtype=torch.bfloat16)
    ops.reset_launches()
    ops.flash_attention_fwd(q, q, q)
    assert fa.ROUTE_LAUNCHES == {}
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.fwd(q, q, q, causal=True, window=0)


# -- the decode forward's combine rule --------------------------------------


def _split_partials(q, k, v, causal, window, splits):
    """The f32 partials (m, l, acc) of each contiguous kv split of
    ``ceil(Skv / splits)`` rows, from the plain version's scores, by the
    decode kernel's rule: m the row's max visible score in the split, p =
    exp(s - m), l = sum p, acc = sum p v; a row with no visible score in
    the split m = -1e30, l = 0, acc = 0. Returns lists over the splits, in
    the (B, Hkv, G, Sq, ...) layout."""
    s = ref._scores(q, k, causal, window)  # (B, Hkv, G, Sq, Skv)
    ok = ref.visible_mask(q.shape[1], k.shape[1], causal, window, "cpu")
    chunk = -(-k.shape[1] // splits)
    v32 = v.to(torch.float32)
    parts = []
    for c0 in range(0, k.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        sc, seen = s[..., sl], ok[:, sl].any(dim=-1)[:, None]
        m = torch.amax(sc, dim=-1, keepdim=True)
        m = torch.where(seen, m, torch.full_like(m, ref.NEG_INF))
        p = torch.where(seen, torch.exp(sc - m), torch.zeros_like(sc))
        acc = torch.einsum("bhgqk,bkhd->bhgqd", p, v32[:, sl])
        parts.append((m, p.sum(dim=-1, keepdim=True), acc))
    return parts


def _fold(parts):
    """The combine kernel's rule, in split order: m = max m_i, l = sum
    e^(m_i - m) l_i, out = sum e^(m_i - m) acc_i / max(l, 1e-30), L = m +
    log(max(l, 1e-30)). Returns (out32 (B, Sq, Hq, hd), L (B, Sq, Hq))."""
    m = parts[0][0]
    for mi, _, _ in parts[1:]:
        m = torch.maximum(m, mi)
    l, acc = torch.zeros_like(m), torch.zeros_like(parts[0][2])
    for mi, li, ai in parts:
        w = torch.exp(mi - m)
        l = l + w * li
        acc = acc + w * ai
    ls = torch.clamp_min(l, 1e-30)
    out = acc / ls
    lse = (m + torch.log(ls))[..., 0]
    b, hkv, g, sq, hd = out.shape
    return (out.permute(0, 3, 1, 2, 4).reshape(b, sq, hkv * g, hd),
            lse.permute(0, 3, 1, 2).reshape(b, sq, hkv * g))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)],
                         ids=["causal", "window", "non-causal"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("sq", [1, 3])
def test_decode_combine_rule_matches_the_pallas_kernel(sq, g, causal, window):
    """The decode forward's per-split partials folded in split order give
    the reference's output (the Pallas kernel in interpret mode) and L
    (``_flash_fwd_core``) within 2e-5, over 1, 2, 7 and 16 splits of 48
    keys: causal calls leave every split past the first hidden (m = -1e30,
    l = 0), the window hides keys of the first."""
    b, skv, hkv, hd = 2, 48, 2, 16
    rng = np.random.default_rng(sq * 10 + g)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, sq, hkv * g, hd), (b, skv, hkv, hd), (b, skv, hkv, hd)))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jops.flash_attention(
        jq, jk, jv, causal=causal, window=window, q_block=8, kv_block=16,
        interpret=True), np.float32)
    _, want_lse = _flash_fwd_core(jq, jk, jv, causal, window, 8, 16)
    want_lse = np.asarray(want_lse, np.float32).reshape(b, sq, hkv * g)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for splits in (1, 2, 7, 16):
        parts = _split_partials(tq, tk, tv, causal, window, splits)
        assert len(parts) == -(-skv // -(-skv // splits))
        out32, lse = _fold(parts)
        np.testing.assert_allclose(out32.numpy(), want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(lse.numpy(), want_lse, rtol=2e-5,
                                   atol=2e-5)
        hidden = [bool((m == ref.NEG_INF).all()) for m, _, _ in parts]
        assert any(hidden) == (causal and splits > 1 and skv // splits >= sq)
