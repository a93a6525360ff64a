"""K2's route table (``kernels/flash_attention.py:ROUTES``) on the CPU.

Every (dtype, head dim) the launchers take maps each of the three kernels
to exactly one extern "C" entry point that the build binds
(``_build.SIGNATURES``) and that its source defines with as many
parameters as the binding passes; bf16 at head dims 64 and 128 takes the
wgmma forward and ``bwd_dkdv`` of ``flash_attention_sm90.cu``, every other
call ``flash_attention.cu``. No card is needed: nothing is built or
launched.
"""

import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

KERNELS = ("fwd", "bwd_dq", "bwd_dkdv")
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
    assert route["bwd_dq"] == ("flash_attention", "repro_flash_bwd_dq")


def test_every_bound_flash_entry_point_is_routed_or_a_query():
    """No bound K2 entry point is left unreachable: each launch entry is in
    the table, and the rest report shared memory."""
    routed = {e for route in fa.ROUTES.values() for e in route.values()}
    for library in ("flash_attention", "flash_attention_sm90"):
        for entry in _build.SIGNATURES[library]:
            assert (library, entry) in routed or entry.endswith("_smem"), entry


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
    """The mma.sync forward and bwd_dkdv are not instantiated at the head
    dims the wgmma kernels serve: their dispatch takes only f32 there."""
    text = (_build.CSRC / "flash_attention.cu").read_text()
    for entry in ("repro_flash_fwd", "repro_flash_bwd_dkdv"):
        body = text[text.index(f"int {entry}("):]
        body = body[:body.index("\n}\n")]
        assert "REPRO_FLASH_F32_ONLY" in body, entry
    body = text[text.index("int repro_flash_bwd_dq("):]
    assert "REPRO_FLASH_CASE," in body[:body.index("\n}\n")]


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
