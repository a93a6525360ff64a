"""The port's kernels (plain versions on the CPU) against the reference's
Pallas kernels, run in interpret mode as the reference's own tests run them.

K1 (quantize/dequantize) must be bitwise. K3a and K3b (reduce_compress
and its roundtrip) sum over G in order; XLA's order of that sum is not
pinned, which would allow q within 1 and back within one step, but on these
shapes the two agree bitwise (G = 2, 3 and 4), so bitwise is asserted. K3c
(dequant_accumulate) is bitwise too, against the kernel as XLA compiles it
(fused multiply-adds, ROADMAP.md R6). The CUDA kernels are held to the
plain versions in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import reduce_compress as jrc  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def to_torch(a) -> "torch.Tensor":
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_numpy(t) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def ref_numpy(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _rows(rows, zero_rows, seed, scale=1e-2):
    x = np.random.default_rng(seed).standard_normal((rows, 256)) * scale
    x[:zero_rows] = 0.0
    return x.astype(np.float32)


@pytest.mark.parametrize(
    "rows,zero_rows,dtype",
    [
        (300, 0, jnp.float32),     # ragged: 300 = 256 + 44
        (513, 7, jnp.float32),     # zero rows (flat-pack padding)
        (37, 3, jnp.bfloat16),
        (1, 1, jnp.float32),       # a single all-zero row
    ],
)
def test_quantize_dequantize_bitwise(rows, zero_rows, dtype):
    jx = jnp.asarray(_rows(rows, zero_rows, seed=rows), dtype)
    q_ref, s_ref = jops.quantize(jx, interpret=True)
    back_ref = jops.dequantize(q_ref, s_ref, dtype=dtype, interpret=True)

    x = to_torch(jx)
    q, s = ops.quantize(x)
    back = ops.dequantize(q, s, x.dtype)
    assert q.dtype == torch.int8 and s.shape == (rows, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(to_numpy(back), ref_numpy(back_ref))
    if zero_rows:
        assert (s[:zero_rows] == np.float32(1e-12)).all()
        assert not q[:zero_rows].any()


def _canonical_ref(x3):
    """The reference kernel per pod: (L, G, R, C) -> back, q, s."""
    return jax.vmap(lambda p: jrc.reduce_compress_roundtrip(p, interpret=True))(x3)


@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((2, 2, 300, 256), jnp.float32),   # the hierarchical 2x2 shape
        ((1, 2, 40, 256), jnp.bfloat16),
        ((2, 4, 33, 256), jnp.float32),    # G = 4
        ((3, 3, 9, 256), jnp.float32),     # G = 3
    ],
)
def test_reduce_compress_roundtrip_vs_kernel(shape, dtype):
    x = np.random.default_rng(sum(shape)).standard_normal(shape) * 1e-3
    jx = jnp.asarray(x.astype(np.float32), dtype)
    back_ref, q_ref, s_ref = (np.asarray(a) for a in _canonical_ref(jx))
    back, q, s = ref.reduce_compress_roundtrip_ref(to_torch(jx))
    np.testing.assert_array_equal(q.numpy(), q_ref)
    np.testing.assert_array_equal(s.numpy(), s_ref)
    np.testing.assert_array_equal(to_numpy(back), ref_numpy(back_ref))


@pytest.mark.parametrize("axis,qaxis", [(1, -1), (0, -1), (1, 1), (2, 0)])
def test_reduce_compress_roundtrip_canonicalization(axis, qaxis):
    """The ops wrapper's (L, G, R, C) folding against the reference's ops
    wrapper's Pallas kernel. A quant axis among the lead axes has no
    kernel in either package: both run the plain form, held in
    ``test_reduce_compress_roundtrip_lead_qaxis``."""
    x = np.random.default_rng(axis * 7 + qaxis % 3).standard_normal((2, 2, 6, 256))
    x = (x * 1e-2).astype(np.float32)
    if qaxis % 3 < axis:
        test_reduce_compress_roundtrip_lead_qaxis(axis, qaxis, jnp.float32)
        return
    want = jops.reduce_compress_roundtrip(jnp.asarray(x), axis=axis, qaxis=qaxis,
                                          backend="pallas", interpret=True)
    got = ops.reduce_compress_roundtrip(torch.from_numpy(x), axis=axis,
                                        qaxis=qaxis)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("axis,qaxis,dtype", [(2, 0, jnp.float32),
                                              (2, 1, jnp.float32),
                                              (1, 0, jnp.float32),
                                              (2, 0, jnp.bfloat16)])
def test_reduce_compress_roundtrip_lead_qaxis(axis, qaxis, dtype):
    """A quant axis before the reduced axis, against the reference's
    ``ops.reduce_compress_roundtrip`` (its plain form on every backend).
    bf16 is bitwise: the same f32 sum times 1/G. f32 is within one int8
    step of each row's scale: the reference takes that mean as a gemm with
    weights 1/G (ROADMAP R7), the port as a sum times 1/G."""
    x = np.random.default_rng(axis * 7 + qaxis).standard_normal((2, 2, 6, 256))
    jx = jnp.asarray((x * 1e-2).astype(np.float32), dtype)
    want = ref_numpy(jops.reduce_compress_roundtrip(
        jx, axis=axis, qaxis=qaxis, backend="pallas", interpret=True))
    got = to_numpy(ops.reduce_compress_roundtrip(to_torch(jx), axis=axis,
                                                 qaxis=qaxis))
    assert got.shape == want.shape
    if dtype == jnp.bfloat16:
        np.testing.assert_array_equal(got, want)
        return
    part = np.moveaxis(np.asarray(jx, np.float32).mean(axis=axis), qaxis, -1)
    step = np.abs(part).max(axis=-1, keepdims=True) / 127.0
    diff = np.abs(np.moveaxis(got, qaxis, -1) - np.moveaxis(want, qaxis, -1))
    assert np.all(diff <= step * (1 + 1e-5) + 1e-6)


def _payload_input(shape, dtype, zero_rows, seed):
    x = np.random.default_rng(seed).standard_normal(shape) * 1e-3
    x[..., :zero_rows, :] = 0.0
    return jnp.asarray(x.astype(np.float32), dtype)


@pytest.mark.parametrize(
    "shape,dtype,zero_rows",
    [
        ((2, 2, 300, 256), jnp.float32, 5),   # the wire step's 2 x 2 layout
        ((1, 3, 9, 256), jnp.float32, 0),
        ((2, 2, 1027, 256), jnp.bfloat16, 3),
        ((1, 4, 1, 256), jnp.float32, 1),     # a single all-zero row
    ],
)
def test_reduce_compress_vs_kernel(shape, dtype, zero_rows):
    """K3a's plain version bitwise to the interpreted Pallas kernel, per
    pod, and the ops wrapper's folding of the pod axes against a vmap."""
    jx = _payload_input(shape, dtype, zero_rows, seed=sum(shape))
    q_ref, s_ref = (np.asarray(a) for a in jax.vmap(
        lambda p: jrc.reduce_compress(p, interpret=True))(jx))
    q, s = ref.reduce_compress_ref(to_torch(jx))
    np.testing.assert_array_equal(q.numpy(), q_ref)
    np.testing.assert_array_equal(s.numpy(), s_ref)
    if zero_rows:
        assert (s[:, :zero_rows] == np.float32(1e-12)).all()
    # two leading pod axes through the wrapper: (1, L, G, R, C)
    q5, s5 = ops.reduce_compress(to_torch(jx)[None])
    assert q5.shape == (1,) + q_ref.shape and s5.shape == (1,) + s_ref.shape
    np.testing.assert_array_equal(q5[0].numpy(), q_ref)
    np.testing.assert_array_equal(s5[0].numpy(), s_ref)


def _payloads(p, rows, zero_rows, seed):
    """P pods' int8 payloads of random partials, quantized by the
    reference."""
    x = np.random.default_rng(seed).standard_normal((p, rows, 256)) * 1e-2
    x[:, :zero_rows] = 0.0
    qs = [jops.quantize(jnp.asarray(x[i].astype(np.float32)), interpret=True)
          for i in range(p)]
    return jnp.stack([a for a, _ in qs]), jnp.stack([b for _, b in qs])


@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("rows,zero_rows", [(9, 2), (1027, 0)])
def test_dequant_accumulate_vs_kernel(p, rows, zero_rows):
    """K3c's plain version bitwise to the interpreted Pallas kernel, which
    XLA compiles into a chain of fused multiply-adds (ROADMAP.md R6)."""
    jq, js = _payloads(p, rows, zero_rows, seed=10 * p + rows)
    want = np.asarray(jrc.dequant_accumulate(jq, js, interpret=True))
    got = ops.dequant_accumulate(to_torch(jq), to_torch(js))
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, 256)
    np.testing.assert_array_equal(got.numpy(), want)
    if zero_rows:
        assert not got[:zero_rows].any()


def test_r6_dequant_accumulate_is_not_a_plain_mean():
    """R6: the interpreted kernel (and its jitted oracle) are fused
    multiply-adds, so ``sum(q * s) / P`` in f32, which rounds each product
    first, differs from it in the last bit in places, even at P = 2; the
    difference stays within the R6 bound P 2^-23 mean_p |q_p s_p|."""
    from repro.kernels import ref as jref

    jq, js = _payloads(2, 37, 0, seed=6)
    kernel = np.asarray(jrc.dequant_accumulate(jq, js, interpret=True))
    np.testing.assert_array_equal(
        np.asarray(jax.jit(jref.dequant_accumulate_ref)(jq, js)), kernel)
    q, s = to_torch(jq), to_torch(js)
    prods = q.to(torch.float32) * s
    plain = (prods.sum(0) * 0.5).numpy()
    assert (plain != kernel).any()
    bound = 2 * 2.0 ** -23 * prods.abs().mean(0).numpy()
    assert (np.abs(plain - kernel) <= bound).all()


@pytest.mark.parametrize("g", [2, 3])
def test_wire_pair_against_pod_mean(g):
    """The wire pair on one packed buffer of 2 pods: K3a's payload is K3b's
    (q, s), its bytes are ``cross_pod_bytes(compress="int8")``'s, and K3c
    gives the pod mean of K3b's roundtrip partials within the R6 bound."""
    from repro_torch.core import hierarchical

    x = torch.from_numpy(
        _rows(2 * g * 300, 0, seed=g).reshape(2, g, 300, 256) * 10)
    q, s = ops.reduce_compress(x)
    back, q_b, s_b = ref.reduce_compress_roundtrip_ref(x)
    assert torch.equal(q, q_b) and torch.equal(s, s_b)
    rows = x.shape[2]
    wire = hierarchical.cross_pod_bytes(rows * 1024, n=2 * g,
                                        num_supergroups=2, compress="int8")
    assert q.numel() + 4 * s.numel() == wire["hierarchical_bytes"]
    mean = ops.dequant_accumulate(q, s)
    pod_mean = back.sum(0) / 2
    bound = 2 * 2.0 ** -23 * (q.to(torch.float32) * s).abs().mean(0)
    assert bool(((mean - pod_mean).abs() <= bound).all())


def test_cpu_path_launches_nothing():
    ops.reset_launches()
    x = torch.ones((3, 256))
    ops.dequantize(*ops.quantize(x))
    ops.reduce_compress_roundtrip(torch.ones((2, 3, 256)))
    ops.dequant_accumulate(*ops.reduce_compress(torch.ones((2, 2, 3, 256))))
    a = torch.full((1, 4, 3), 0.5)
    ops.lru_scan_bwd(a, ops.lru_scan_fwd(a, a), a)
    w = torch.full((1, 4, 1, 16), -0.5)
    out, states, _ = ops.wkv6_fwd(w, w, w, w, w[0, 0])
    ops.wkv6_bwd(w, w, w, w, w[0, 0], states, out)
    assert ops.launch_counts() == {
        "quantize": 0, "dequantize": 0, "reduce_compress_roundtrip": 0,
        "reduce_compress": 0, "dequant_accumulate": 0,
        "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
        "flash_attention_bwd_dkdv": 0, "lru_scan_fwd": 0, "lru_scan_bwd": 0,
        "wkv6_fwd": 0, "wkv6_bwd": 0}
