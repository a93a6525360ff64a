"""The port's DrJAX core against the reference: primitives and their
gradients, the hierarchical reduction (fused and unfused), flat packing.

Values and gradients of the plain primitives match the reference at
rtol = atol = 1e-6 (f32). Through the int8 reductions an element may differ
by one quantization step of its 256-wide row (a 1-ulp difference before
quantization can flip one int8 value). The bar of the fused path: its
gradient is bitwise the unfused one's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import compression as jcomp  # noqa: E402
from repro import core as jdrjax  # noqa: E402
from repro_torch import compression as tcomp  # noqa: E402
from repro_torch import core as drjax  # noqa: E402
from repro.core import primitives as jprims  # noqa: E402
from repro.kernels import ops as jkops  # noqa: E402
from repro_torch.core import primitives as tprims  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _torch_grads(fn, *arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    grads = torch.autograd.grad(out.sum(), ts)
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jgrads(fn, *arrays):
    args = [jnp.asarray(a) for a in arrays]
    out = fn(*args)
    grads = jax.grad(lambda *a: fn(*a).sum(), argnums=tuple(range(len(args))))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _programs(mod, n):
    @mod.program(partition_size=n)
    def flat(x, w):
        y = mod.broadcast(x)
        z = mod.map_fn(lambda a, b: a * b + a * a, (y, w))
        return mod.reduce_mean(z) + mod.reduce_sum(z)

    @mod.program(placements={"pods": 2, "clients": 3})
    def nested(x, w):
        y = mod.broadcast(x)                                   # (2, 3, d)
        z = mod.map_fn(lambda a, b: a * b, (y, w))
        partial = mod.reduce_mean(z, placement="clients")      # (2, d)
        u = mod.map_fn(lambda p: p * p, partial, placement="pods")
        return mod.reduce_sum(u, placement="pods")

    return flat, nested


def test_primitives_values_and_grads():
    x, w = _inputs(0, (5,), (4, 5))
    jflat, jnested = _programs(jdrjax, 4)
    tflat, tnested = _programs(drjax, 4)
    want, wgrads = _jgrads(jflat, x, w)
    got, ggrads = _torch_grads(tflat, x, w)
    np.testing.assert_allclose(got, want, **TOL)
    for g, wg in zip(ggrads, wgrads):
        np.testing.assert_allclose(g, wg, **TOL)

    x, w = _inputs(1, (7,), (2, 3, 7))
    want, wgrads = _jgrads(jnested, x, w)
    got, ggrads = _torch_grads(tnested, x, w)
    np.testing.assert_allclose(got, want, **TOL)
    for g, wg in zip(ggrads, wgrads):
        np.testing.assert_allclose(g, wg, **TOL)


def test_broadcast_transposes_to_reduce_sum():
    """d(broadcast@p)^T = reduce_sum@p: the gradient of a broadcast
    contracted with a cotangent is the cotangent summed over the groups."""
    (ct,) = _inputs(2, (3, 6))

    @drjax.program(partition_size=3)
    def f(x):
        return drjax.broadcast(x)

    x = torch.zeros(6, requires_grad=True)
    (g,) = torch.autograd.grad((f(x) * torch.from_numpy(ct)).sum(), x)
    np.testing.assert_allclose(g.numpy(), ct.sum(0), **TOL)
    with pytest.raises(ValueError, match="partition size"):
        drjax.program(partition_size=3)(lambda v: drjax.reduce_sum(v))(
            torch.zeros(4, 2))


def _hier_programs(mod, comp, n, pods, use_fused):
    @mod.program(partition_size=n)
    def flat_api(tree):
        return mod.hierarchical_reduce_mean(
            tree, num_supergroups=pods, compress_fn=comp.int8_roundtrip,
            use_fused=use_fused)

    @mod.program(placements={"pods": pods, "clients": n // pods})
    def nested(tree):
        return mod.hierarchical_reduce_mean(
            tree, compress_fn=comp.int8_roundtrip, use_fused=use_fused)

    return flat_api, nested


def _step(values: np.ndarray) -> np.ndarray:
    """Per element, the int8 step of its 256-wide row (leaf padded)."""
    flat = values.reshape(-1)
    pad = (-flat.size) % 256
    rows = np.pad(np.abs(flat), (0, pad)).reshape(-1, 256)
    step = rows.max(axis=1, keepdims=True) / 127.0
    return np.broadcast_to(step, rows.shape).reshape(-1)[: flat.size].reshape(values.shape)


@pytest.mark.parametrize("form", ["flat_api", "nested"])
def test_hierarchical_reduce_mean(form):
    n, pods = 4, 2
    a, b = _inputs(3, (n, 3, 100), (n, 300))
    b[:, :10] *= 1e-4  # a small-magnitude span beside larger values
    tree = {"a": a, "b": b}
    lead = (n,) if form == "flat_api" else (pods, n // pods)
    shaped = {k: v.reshape(lead + v.shape[1:]) for k, v in tree.items()}

    jfn = dict(zip(("flat_api", "nested"),
                   _hier_programs(jdrjax, jcomp, n, pods, None)))[form]
    want = jfn({k: jnp.asarray(v) for k, v in shaped.items()})

    outs, grads = {}, {}
    cts = {k: np.random.default_rng(9).standard_normal(v.shape[len(lead):])
           .astype(np.float32) for k, v in shaped.items()}
    for fused in (True, False):
        tfn = dict(zip(("flat_api", "nested"),
                       _hier_programs(drjax, tcomp, n, pods, fused)))[form]
        leaves = {k: torch.tensor(v, requires_grad=True) for k, v in shaped.items()}
        out = tfn(leaves)
        loss = sum((out[k] * torch.from_numpy(cts[k])).sum() for k in out)
        g = torch.autograd.grad(loss, list(leaves.values()))
        outs[fused] = {k: v.detach().numpy() for k, v in out.items()}
        grads[fused] = [x.numpy() for x in g]
    for fg, ug in zip(grads[True], grads[False]):
        np.testing.assert_array_equal(fg, ug)  # fused grad == unfused, bitwise
    for k in want:
        ref = np.asarray(want[k])
        tol = _step(ref) + 1e-6
        for fused in (True, False):
            assert (np.abs(outs[fused][k] - ref) <= tol).all(), (k, fused)


def test_fused_path_engages_and_keeps_small_leaf():
    """A tagged compressor takes the fused reduce (the kernel wrapper);
    ``use_fused=False`` and REPRO_NO_FUSED_REDUCE force the composition;
    a small leaf beside a huge one keeps its own scale."""
    from repro_torch.core import hierarchical

    tree = {"big": torch.full((4, 10), 1e4), "small": torch.full((4, 10), 1e-3)}
    with drjax.placement_context(drjax.make_context(placements={"pods": 2,
                                                                "clients": 2})):
        ctx = drjax.current_context()
        shaped = {k: v.reshape(2, 2, 10) for k, v in tree.items()}
        assert hierarchical._fusable(shaped, ctx, tcomp.int8_roundtrip, None)
        assert not hierarchical._fusable(shaped, ctx, tcomp.int8_roundtrip, False)
        assert not hierarchical._fusable(shaped, ctx, lambda t: t, None)
        with pytest.raises(ValueError, match="fusable"):
            hierarchical._fusable(shaped, ctx, lambda t: t, True)
        out = drjax.hierarchical_reduce_mean(
            shaped, compress_fn=tcomp.int8_roundtrip)
    np.testing.assert_allclose(out["small"].numpy(), np.full(10, 1e-3), rtol=0.01)
    np.testing.assert_allclose(out["big"].numpy(), np.full(10, 1e4), rtol=0.01)


def test_no_fused_env(monkeypatch):
    from repro_torch.core import hierarchical

    monkeypatch.setenv("REPRO_NO_FUSED_REDUCE", "1")
    ctx = drjax.make_context(placements={"pods": 2, "clients": 2})
    tree = {"a": torch.ones(2, 2, 3)}
    assert not hierarchical._fusable(tree, ctx, tcomp.int8_roundtrip, None)
    assert hierarchical._fusable(tree, ctx, tcomp.int8_roundtrip, True)


class TestFlatPack:
    def test_roundtrip_bitwise_mixed_dtypes(self):
        tree = {
            "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": torch.linspace(-1, 1, 5),
            "step": torch.arange(3, dtype=torch.int32),
            "h": torch.ones((2, 2), dtype=torch.bfloat16),
            "scalar": torch.tensor(3.5),
        }
        bufs, spec = tcomp.flat_pack(tree, lead_ndim=0)
        assert set(bufs) == {"float32", "int32", "bfloat16"}
        for buf in bufs.values():
            assert buf.shape[-1] == tcomp.PACK_COLS
        back = tcomp.flat_unpack(bufs, spec, lead_ndim=0)
        for k in tree:
            assert back[k].dtype == tree[k].dtype
            assert torch.equal(back[k], tree[k])

    def test_layout_matches_reference(self):
        """Same buffers as the reference for a tree whose key order both
        flatten alike (sorted keys, one per dtype)."""
        a, b = _inputs(4, (2, 3, 5), (2, 3, 300))
        want, _ = jcomp.flat_pack({"a": jnp.asarray(a), "b": jnp.asarray(b)},
                                  lead_ndim=2)
        got, _ = tcomp.flat_pack({"a": torch.from_numpy(a),
                                  "b": torch.from_numpy(b)}, lead_ndim=2)
        np.testing.assert_array_equal(got["float32"].numpy(),
                                      np.asarray(want["float32"]))

    def test_lead_axes_preserved_and_reducible(self):
        tree = {"a": torch.ones((2, 4, 3)), "b": torch.zeros((2, 4, 5, 2))}
        bufs, spec = tcomp.flat_pack(tree, lead_ndim=2)
        (buf,) = bufs.values()
        assert tuple(buf.shape[:2]) == (2, 4)
        reduced = {k: v.mean(dim=(0, 1)) for k, v in bufs.items()}
        out = tcomp.flat_unpack(reduced, spec, lead_ndim=0)
        assert tuple(out["a"].shape) == (3,) and tuple(out["b"].shape) == (5, 2)

    def test_mismatched_lead_raises(self):
        with pytest.raises(ValueError, match="lead axes"):
            tcomp.flat_pack({"a": torch.ones((2, 3)), "b": torch.ones((4, 3))},
                            lead_ndim=1)

    def test_scale_blocks_never_span_leaves(self):
        tree = {"big": torch.full((10,), 1e4), "small": torch.full((10,), 1e-3)}
        back = tcomp.int8_roundtrip(tree)
        np.testing.assert_allclose(back["small"].numpy(), np.full(10, 1e-3),
                                   rtol=0.01)
        want = jcomp.int8_roundtrip({k: jnp.asarray(v.numpy())
                                     for k, v in tree.items()})
        for k in tree:
            np.testing.assert_array_equal(back[k].numpy(), np.asarray(want[k]))

    def test_int8_roundtrip_is_straight_through(self):
        x = torch.tensor(_inputs(5, (3, 70))[0], requires_grad=True)
        (g,) = torch.autograd.grad((tcomp.int8_roundtrip({"x": x})["x"] * 3).sum(), x)
        assert torch.equal(g, torch.full_like(x, 3.0))


def test_wire_model_matches_reference():
    assert drjax.int8_wire_ratio() == jdrjax.int8_wire_ratio()
    for kw in ({}, {"compress": "int8"}, {"compress_ratio": 0.5}):
        assert drjax.cross_pod_bytes(1e9, 64, 4, **kw) == \
            jdrjax.cross_pod_bytes(1e9, 64, 4, **kw)


# P1: the reference's driver always jits, and XLA compiles reduce_mean's
# ``sum / n`` (and its transpose's ``ct / n``) as a product with f32(1/n).
# The port multiplies by the same reciprocal; a division differs from it in
# the last bit of many elements at n = 3, 5 and 6.
def _p1_programs(mod, prims, n, compress):
    @mod.program(partition_size=n)
    def mean(x):
        if compress:
            return prims(x, compress="int8")
        return mod.reduce_mean(x)

    return mean


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "int8_fused"])
@pytest.mark.parametrize("n", [3, 5, 6, 8])
def test_p1_reduce_mean_bitwise_to_jitted_reference(n, compress):
    """Values and gradients bitwise to ``jax.jit`` of the reference, plain
    and int8-fused. The fused forward is held to the jitted plain mean
    followed by the reference's int8 row roundtrip, which is what its
    kernel computes (off the TPU the reference's fused reduce forms the
    mean another way, ROADMAP R7); its gradient is straight-through."""
    (x,) = _inputs(100 + n, (n, 4096))
    ct = np.random.default_rng(n).standard_normal(4096).astype(np.float32)
    jmean = _p1_programs(jdrjax, jprims.bind_reduce_mean, n, compress)
    tmean = _p1_programs(drjax, tprims.reduce_mean, n, compress)
    if compress:
        plain = _p1_programs(jdrjax, None, n, False)
        want = jax.jit(lambda v: jkops._roundtrip_rows(plain(v), 0))(x)
    else:
        want = jax.jit(jmean)(x)
    # ct enters as an argument: a closed-over constant would be folded
    # (divided exactly) at compile time, as no driver's cotangent is.
    wgrad = jax.jit(jax.grad(lambda v, c: (jmean(v) * c).sum()))(x, ct)
    xt = torch.tensor(x, requires_grad=True)
    got = tmean(xt)
    (ggrad,) = torch.autograd.grad((got * torch.from_numpy(ct)).sum(), xt)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(ggrad.numpy(), np.asarray(wgrad))
    if not compress and n in (3, 6):  # where a division differs
        assert (np.asarray(want) != x.sum(0) / np.float32(n)).any()


@pytest.mark.parametrize("n", [3, 5, 6])
def test_p1_bf16_leaves_follow_the_jitted_reference(n):
    """bf16 leaves (rwkv6_3b's): the jitted reference rounds the sum to
    bf16, multiplies by f32(1/n) in f32 and rounds once more; its gradient
    is bf16(f32(ct) * f32(1/n)). The port's value and gradient equal it
    bitwise. A product with the bf16-rounded reciprocal would not."""
    (x,) = _inputs(200 + n, (n, 4096))
    ct = np.random.default_rng(n).standard_normal(4096).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jct = jnp.asarray(ct).astype(jnp.bfloat16)
    jmean = _p1_programs(jdrjax, None, n, False)
    want = np.asarray(jax.jit(jmean)(jx).astype(jnp.float32))
    wgrad = np.asarray(jax.jit(jax.grad(lambda v, c: (jmean(v) * c).sum()))(
        jx, jct).astype(jnp.float32))
    xt = torch.tensor(x).bfloat16().requires_grad_()
    ctt = torch.tensor(ct).bfloat16()
    got = _p1_programs(drjax, None, n, False)(xt)
    (ggrad,) = torch.autograd.grad((got * ctt).sum(), xt)
    assert got.dtype == torch.bfloat16 and ggrad.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.detach().float().numpy(), want)
    np.testing.assert_array_equal(ggrad.float().numpy(), wgrad)
    r32 = torch.tensor(1.0 / n, dtype=torch.float32)
    formula = (xt.detach().sum(0).float() * r32).bfloat16()
    np.testing.assert_array_equal(formula.float().numpy(), want)
    bf16_recip = xt.detach().sum(0) * torch.tensor(1.0 / n).bfloat16()
    assert (bf16_recip.float().numpy() != want).any()
