"""The port's primitives as registered ``drjax`` ops against the reference:
``reduce_max`` and its subgradient (ties included), the traced gradient
programs (only ``drjax`` communication nodes, the backward of a broadcast
a ``reduce_sum`` and of a reduction a ``broadcast``), and ``torch.func``
transforms over programs (vmap over a program, over a partitioned
argument and with an unbatched broadcast operand, vmap of grad, second
order), on the direct form and on the recorded ops.

The references run un-jitted. Values and gradients agree within 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import core as jdrjax  # noqa: E402
from repro_torch import core as drjax  # noqa: E402
from repro_torch.core import interpreter as interp  # noqa: E402
from repro_torch.core import primitives as prims  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
FORMS = ["direct", "recorded"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so this file's tests do not crowd
    out the suite's other workers; the worker's count comes back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _form(form):
    """The primitives' direct form, or their registered ops (run eagerly:
    the ops' own autograd and vmap rules)."""
    import contextlib

    return prims.recording() if form == "recorded" else contextlib.nullcontext()


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("xs", [[1.0, 5.0, 3.0, 2.0], [5.0, 1.0, 5.0, 2.0],
                                [2.0, 2.0, 2.0, 2.0]])
def test_reduce_max_value_and_subgradient(form, xs):
    """``tests/test_ad.py:102`` with ties: the gradient is split evenly
    over the tied arg-max groups."""
    def jf(v):
        return jdrjax.program(partition_size=4)(jdrjax.reduce_max)(v)

    tf = drjax.program(partition_size=4)(drjax.reduce_max)
    x = np.asarray(xs, np.float32)
    want, wgrad = np.asarray(jf(jnp.asarray(x))), np.asarray(
        jax.grad(jf)(jnp.asarray(x)))
    with _form(form):
        v = _t(x).requires_grad_(True)
        out = tf(v)
        (g,) = torch.autograd.grad(out, v)
    np.testing.assert_allclose(out.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(g.numpy(), wgrad, **TOL)


def test_reduce_max_nested_rows():
    """reduce_max at an inner placement over rows, with ties in a row."""
    x = np.random.default_rng(0).integers(0, 3, (2, 3, 4)).astype(np.float32)

    def make(mod):
        @mod.program(placements={"pods": 2, "clients": 3})
        def f(v):
            return mod.reduce_max(mod.reduce_max(v, placement="clients"),
                                  placement="pods").sum()
        return f

    jf, tf = make(jdrjax), make(drjax)
    v = _t(x).requires_grad_(True)
    (g,) = torch.autograd.grad(tf(v), v)
    np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(jf)(jnp.asarray(x))),
                               **TOL)
    np.testing.assert_allclose(tf(_t(x)).numpy(), np.asarray(jf(jnp.asarray(x))),
                               **TOL)


def _maml(mod, grad):
    def loss(x, y):
        return (x - y) ** 2

    def maml_loss(model, lr, task):
        g = grad(loss)(model, task)
        return loss(model - lr * g, task)

    @mod.program(partition_size=3)
    def f(model, lr, tasks):
        losses = mod.map_fn(maml_loss, (mod.broadcast(model),
                                        mod.broadcast(lr), tasks))
        return mod.reduce_mean(losses)

    return f


MAML_ARGS = (0.1, 0.05, [1.0, 2.0, 3.0])


def _torch_grad_of(f, argnum=0):
    def g(*args):
        args = list(args)
        x = args[argnum].detach().requires_grad_(True)
        args[argnum] = x
        with torch.enable_grad():
            (out,) = torch.autograd.grad(f(*args), x)
        return out
    return g


def test_traced_gradient_program_stays_in_the_primitive_set():
    """``tests/test_ad.py:44``: the traced gradient of parallel MAML has
    the reference's primitive counts (the transpose of broadcast is
    reduce_sum), and no group axis is summed by a plain ``aten`` op: every
    communication is a ``drjax`` node."""
    jf = _maml(jdrjax, jax.grad)
    tf = _maml(drjax, torch.func.grad)
    jargs = tuple(jnp.asarray(a, jnp.float32) for a in MAML_ARGS)
    targs = tuple(_t(a) for a in MAML_ARGS)
    want = jdrjax.count_primitives(jax.make_jaxpr(jax.grad(jf))(*jargs))
    gm = interp.trace(_torch_grad_of(tf), *targs)
    assert interp.count_primitives(gm) == want
    assert want["drjax_reduce_sum"] >= 1 and want["drjax_broadcast"] >= 1
    plan = interp.build_plan(gm, 3)
    for s in plan.stages:
        if isinstance(s, interp.LocalCompute):
            for n in s.nodes:
                assert interp._op_name(n) not in ("sum", "expand", "mean")
    comm = [(s.kind, getattr(s, "op", None))
            for s in plan.communication_stages()]
    assert comm == [("BROADCAST", None), ("BROADCAST", None),
                    ("REDUCE", "reduce_mean"), ("BROADCAST", None),
                    ("REDUCE", "reduce_sum")]
    np.testing.assert_allclose(interp.run_plan(plan, *targs)[0].numpy(),
                               np.asarray(jax.grad(jf)(*jargs)), **TOL)


@pytest.mark.parametrize("form", FORMS)
def test_vmap_over_program(form):
    """``tests/test_primitives.py:162``."""
    @drjax.program(partition_size=3)
    def f(x):
        return drjax.reduce_sum(drjax.broadcast(x))

    @jdrjax.program(partition_size=3)
    def jf(x):
        return jdrjax.reduce_sum(jdrjax.broadcast(x))

    x = np.arange(5, dtype=np.float32)
    with _form(form):
        out = torch.func.vmap(f)(_t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jax.vmap(jf)(x)), **TOL)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("op", ["reduce_sum", "reduce_mean", "reduce_max"])
def test_vmap_over_partitioned_arg(form, op):
    """``tests/test_primitives.py:170``, for every reduction."""
    f = drjax.program(partition_size=3)(getattr(drjax, op))
    jf = jdrjax.program(partition_size=3)(getattr(jdrjax, op))
    xs = np.random.default_rng(1).standard_normal((4, 3)).astype(np.float32)
    with _form(form):
        out = torch.func.vmap(f)(_t(xs))
    np.testing.assert_allclose(out.numpy(), np.asarray(jax.vmap(jf)(xs)), **TOL)


@pytest.mark.parametrize("form", FORMS)
def test_vmap_unbatched_broadcast_operand(form):
    """``tests/test_primitives.py:213``: a broadcast whose operand is not
    batched composes with a batched map and reduction."""
    def make(mod):
        @mod.program(partition_size=3)
        def f(scale, xs):
            y = mod.broadcast(scale)
            return mod.reduce_sum(mod.map_fn(lambda a, b: a * b, (y, xs)))
        return f

    xs = np.arange(12, dtype=np.float32).reshape(4, 3)
    want = jax.vmap(make(jdrjax), in_axes=(None, 0))(jnp.float32(2.0), xs)
    with _form(form):
        out = torch.func.vmap(make(drjax), in_dims=(None, 0))(_t(2.0), _t(xs))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("form", FORMS)
def test_vmap_of_grad(form):
    """Per-example gradients of a program: vmap of grad."""
    def make(mod):
        @mod.program(partition_size=4)
        def f(x, ys):
            y = mod.broadcast(x)
            z = mod.map_fn(lambda a, b: (a - b) ** 2 * b, (y, ys))
            return mod.reduce_mean(z) + mod.reduce_max(z)
        return f

    xs = np.linspace(-1, 1, 5).astype(np.float32)
    ys = np.random.default_rng(2).standard_normal(4).astype(np.float32)
    want = jax.vmap(jax.grad(make(jdrjax)), in_axes=(0, None))(xs, ys)
    with _form(form):
        got = torch.func.vmap(torch.func.grad(make(drjax)),
                              in_dims=(0, None))(_t(xs), _t(ys))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("form", FORMS)
def test_second_order(form):
    """``tests/test_ad.py:111``: f(x) = 3 x^3, f''(x) = 18 x."""
    @drjax.program(partition_size=3)
    def f(x):
        return drjax.reduce_sum(drjax.map_fn(lambda a: a ** 3,
                                             drjax.broadcast(x)))

    with _form(form):
        h = torch.func.grad(torch.func.grad(f))(_t(2.0))
        x = _t(2.0).requires_grad_(True)
        (g,) = torch.autograd.grad(f(x), x, create_graph=True)
        (h2,) = torch.autograd.grad(g, x)
    np.testing.assert_allclose(h.numpy(), 36.0, rtol=1e-5)
    np.testing.assert_allclose(h2.numpy(), 36.0, rtol=1e-5)


@pytest.mark.parametrize("form", FORMS)
def test_maml_gradient_matches_reference(form):
    """``tests/test_ad.py:102``'s neighbours: the gradient of parallel
    MAML (a gradient inside the map, and the outer one through it) within
    1e-6 of the reference's, in both model and learning rate."""
    jf = _maml(jdrjax, jax.grad)
    tf = _maml(drjax, torch.func.grad)
    jargs = tuple(jnp.asarray(a, jnp.float32) for a in MAML_ARGS)
    want = jax.grad(jf, argnums=(0, 1))(*jargs)
    with _form(form):
        m, lr = _t(0.1).requires_grad_(True), _t(0.05).requires_grad_(True)
        got = torch.autograd.grad(tf(m, lr, _t(MAML_ARGS[2])), (m, lr))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_recorded_ops_equal_direct_forms():
    """The registered ops compute the direct forms bitwise (values and
    gradients), nested placements and the int8-tagged mean included."""
    x = torch.randn((2, 3, 5, 256), generator=torch.Generator().manual_seed(3))

    @drjax.program(placements={"pods": 2, "clients": 3})
    def f(v):
        a = drjax.reduce_mean(v, placement="clients")
        b = prims.reduce_mean(v, placement="clients", compress="int8")
        c = drjax.reduce_sum(drjax.broadcast(a, placement="clients"),
                             placement="clients")
        return a, b, drjax.reduce_mean(c, placement="pods")

    outs, grads = [], []
    for form in FORMS:
        v = x.clone().requires_grad_(True)
        with _form(form):
            o = f(v)
            grads.append(torch.autograd.grad(sum(t.sum() for t in o), v)[0])
        outs.append(o)
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    assert torch.equal(grads[0], grads[1])
