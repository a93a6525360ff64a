"""The int8 tensor-parallel reduction of the port (``repro_torch/models/
tpcomm.py``) held to the reference's (``repro/models/tpcomm.py``).

* ``_quant_rows`` is bitwise ``jax.jit(repro.models.tpcomm._quant_rows)``
  on seeded rows with all-zero and +-huge rows;
* the dequant-sum is bitwise the jitted reference's
  ``jnp.sum(qg.astype(f32) * sg, axis=0)``, which XLA compiles into fused
  multiply-adds in shard order (as K3c's, caveat R6); the sum of rounded
  products, the control, is not;
* ``int8_matmul_reduce`` on 2- and 4-rank gloo worlds ((data 1, model m)
  meshes, one module-scoped world each) against the reference's own
  per-shard body (``tpcomm.py:65-75``) run shard by shard here: within one
  int8 step of each shard's scale plus m f32 ulps (the local partial
  products are f32 sums in another order than XLA's, so a value can round
  to the next int8 step); the collective is an int8 gather whose received
  bytes equal ``int8_wire_bytes``, and the exact ``all_reduce`` gather
  (the route of CUDA tensors on gloo) gives the same bits;
* without a mesh it is the f32 product (``tests/test_tpcomm.py:11-24``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
import _torch_dist_checks as checks
from repro.models import tpcomm as ref_tpcomm
from repro_torch.models import partitioning, tpcomm

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return _torch_dist.run_worlds({
        m: (m, ["tpcomm_reduce", "constraint_redistributes"],
            str(tmp_path_factory.mktemp(f"tp{m}")))
        for m in WORLDS})


def _rows(seed=0, n=64, d=96):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) *
         rng.uniform(1e-3, 1e3, (n, 1))).astype(np.float32)
    x[0] = 0.0
    x[1] *= np.float32(1e35)
    x[2] *= np.float32(-1e35)
    x[3, :5] = np.float32(3.0e38)
    return x


def test_quant_rows_bitwise_to_jitted_reference():
    x = _rows()
    q, s = tpcomm._quant_rows(torch.from_numpy(x))
    rq, rs = jax.jit(ref_tpcomm._quant_rows)(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == (x.shape[0], 1)
    np.testing.assert_array_equal(q.numpy()[0], 0)


@pytest.mark.parametrize("m", [2, 4, 16])
def test_dequant_sum_is_the_jitted_fma_form(m):
    rng = np.random.default_rng(m)
    parts = (rng.standard_normal((m, 40, 96)) *
             rng.uniform(0.1, 100, (m, 40, 1))).astype(np.float32)
    rq, rs = jax.jit(ref_tpcomm._quant_rows)(jnp.asarray(parts))
    want = np.asarray(jax.jit(
        lambda q, s: jnp.sum(q.astype(jnp.float32) * s, axis=0))(rq, rs))
    q, s = torch.from_numpy(np.array(rq)), torch.from_numpy(np.array(rs))
    np.testing.assert_array_equal(tpcomm._dequant_sum(q, s).numpy(), want)
    control = (q.float() * s).sum(0).numpy()  # rounded products, summed
    assert not np.array_equal(control, want)


def test_fallback_matches_matmul_without_mesh():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    w = rng.standard_normal((16, 4)).astype(np.float32)
    out = tpcomm.int8_matmul_reduce(torch.from_numpy(x), torch.from_numpy(w),
                                    out_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), x @ w, rtol=1e-5, atol=1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    out = tpcomm.int8_matmul_reduce(xb, wb)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out.float().numpy(), (xb.float() @ wb.float()).bfloat16().float()
        .numpy())


def test_wire_byte_model():
    bf = tpcomm.bf16_wire_bytes(4096, 8192, 16)
    i8 = tpcomm.int8_wire_bytes(4096, 8192, 16)
    assert 3.5 < bf / i8 < 4.2
    assert bf == ref_tpcomm.bf16_wire_bytes(4096, 8192, 16)
    assert i8 == ref_tpcomm.int8_wire_bytes(4096, 8192, 16)


def test_int8_reduce_refuses_gradients():
    part = torch.ones(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        tpcomm.int8_reduce(part * 2.0, torch.float32)


def _reference_per_shard(m):
    """The reference's ``local`` body (``tpcomm.py:65-75``) run shard by
    shard: each shard's f32 partial, ``_quant_rows``, then the jitted
    dequant-sum of the stacked shards."""
    x, w = checks.tpcomm_inputs(m)
    f = x.shape[1] // m
    dot = jax.jit(lambda a, b: jax.lax.dot_general(
        a, b, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32))
    qs, ss = zip(*(jax.jit(ref_tpcomm._quant_rows)(
        dot(jnp.asarray(x[:, j * f:(j + 1) * f]),
            jnp.asarray(w[j * f:(j + 1) * f]))) for j in range(m)))
    qg, sg = jnp.stack(qs), jnp.stack(ss)
    out = jax.jit(lambda q, s: jnp.sum(q.astype(jnp.float32) * s, axis=0))(
        qg, sg)
    return np.asarray(out), np.asarray(sg)


@pytest.mark.parametrize("m", WORLDS)
def test_int8_matmul_reduce_on_gloo_worlds(worlds, m):
    want, scales = _reference_per_shard(m)
    results = worlds[m]["tpcomm_reduce"]
    bound = scales.sum(0) + m * np.spacing(np.abs(want))
    for rank, res in enumerate(results):
        got = res["out"]
        assert got.shape == want.shape
        assert np.all(np.abs(got - want) <= bound), rank
        np.testing.assert_array_equal(got, results[0]["out"])
        routes = res["routes"]
        assert routes["int8 gathers"] == 1
        assert routes["int8 payload bytes"] == tpcomm.int8_wire_bytes(
            m * res["rows"], res["d"], m)
        # the int8 values and the f32 scales, each one all_gather over
        # "model" on CPU gloo
        assert routes[("gather", "all_gather")] == 2
        assert routes["all_gather bytes"] == tpcomm.int8_wire_bytes(
            m * res["rows"], res["d"], m)
        # the all_reduce route gathers the same int8 bits
        np.testing.assert_array_equal(res["by_reduce"], got)
        assert res["reduce_routes"][("gather", "all_reduce")] == 2
        assert res["reduce_routes"]["all_reduce bytes"] == \
            routes["all_gather bytes"]
    zero = want[0]
    np.testing.assert_array_equal(results[0]["out"][0], zero)


def test_gather_route_names_the_collective():
    """On gloo with a CUDA tensor the exact all_reduce gather, else
    all_gather (checked against the route rule, no card needed)."""
    class _G:
        pass

    import torch.distributed as dist

    orig = dist.get_backend
    try:
        dist.get_backend = lambda group=None: "gloo"
        mesh = type("M", (), {"get_group": lambda self, d: _G(),
                              "mesh_dim_names": ("model",),
                              "mesh": np.zeros((2,))})()
        with partitioning.axis_rules(mesh):
            t = torch.zeros(2)
            assert partitioning.gather_route(t, 0) == "all_gather"
            cuda_like = type("T", (), {"is_cuda": True})()
            assert partitioning.gather_route(cuda_like, 0) == "all_reduce"
            dist.get_backend = lambda group=None: "nccl"
            assert partitioning.gather_route(cuda_like, 0) == "all_gather"
    finally:
        dist.get_backend = orig


@pytest.mark.parametrize("m", WORLDS)
def test_constraint_redistributes_dtensors(worlds, m):
    """On a mesh ``with_logical_constraint`` moves a DTensor to its spec
    through the routed collectives and leaves a rank's plain tensor as
    it is."""
    for rank, res in enumerate(worlds[m]["constraint_redistributes"]):
        # batch over "data" (one rank), heads over "model"
        assert res["placements"] == "(Shard(dim=0), Shard(dim=1))"
        np.testing.assert_array_equal(res["local"],
                                      res["whole"][:, 2 * rank:2 * rank + 2])
        assert res["plain_same"]
        np.testing.assert_array_equal(res["back"], res["whole"])
