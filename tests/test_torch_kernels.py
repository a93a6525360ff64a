"""The port's kernels (plain versions on the CPU) against the reference's
Pallas kernels, run in interpret mode as the reference's own tests run them.

K1 (quantize/dequantize) must be bitwise. K3 (reduce_compress_roundtrip)
sums over G in order; XLA's order of that sum is not pinned, which would
allow q within 1 and back within one step, but on these shapes the two agree
bitwise (G = 2, 3 and 4), so bitwise is asserted. The CUDA kernels are
held to the plain versions in ``tests/test_torch_cuda.py``.
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
    wrapper's Pallas kernel. A quant axis among the lead axes is not ported
    and raises on every device."""
    x = np.random.default_rng(axis * 7 + qaxis % 3).standard_normal((2, 2, 6, 256))
    x = (x * 1e-2).astype(np.float32)
    if qaxis % 3 < axis:
        with pytest.raises(NotImplementedError, match="quant axis"):
            ops.reduce_compress_roundtrip(torch.from_numpy(x), axis=axis,
                                          qaxis=qaxis)
        return
    want = jops.reduce_compress_roundtrip(jnp.asarray(x), axis=axis, qaxis=qaxis,
                                          backend="pallas", interpret=True)
    got = ops.reduce_compress_roundtrip(torch.from_numpy(x), axis=axis,
                                        qaxis=qaxis)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_path_launches_nothing():
    ops.reset_launches()
    x = torch.ones((3, 256))
    ops.dequantize(*ops.quantize(x))
    ops.reduce_compress_roundtrip(torch.ones((2, 3, 256)))
    a = torch.full((1, 4, 3), 0.5)
    ops.lru_scan_bwd(a, ops.lru_scan_fwd(a, a), a)
    w = torch.full((1, 4, 1, 16), -0.5)
    out, states = ops.wkv6_fwd(w, w, w, w, w[0, 0])
    ops.wkv6_bwd(w, w, w, w, w[0, 0], states, out)
    assert ops.launch_counts() == {
        "quantize": 0, "dequantize": 0, "reduce_compress_roundtrip": 0,
        "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
        "flash_attention_bwd_dkdv": 0, "lru_scan_fwd": 0, "lru_scan_bwd": 0,
        "wkv6_fwd": 0, "wkv6_bwd": 0}
