"""``drjax.map_fn`` allocates each stacked output once and copies every
group's output into its slot. The result equals ``torch.stack`` of the
per-group outputs bitwise (flat, nested, and at an inner placement), for
trees of mixed dtypes and scalars, and its gradient equals the gradient
through that stack."""

import itertools

import pytest

torch = pytest.importorskip("torch")

from repro_torch import core as drjax  # noqa: E402


def _client(p, d):
    """A group's work: a tree of an f32 delta, a bf16 copy and a value
    reduced over the last axis (a scalar for a flat group's slice)."""
    delta = torch.tanh(p * d["x"]) - p
    return {"delta": delta, "half": (delta * 3).to(torch.bfloat16),
            "loss": (delta * delta).flatten(p.ndim - 2).mean(-1)}, \
        d["x"].flatten(p.ndim - 2).sum(-1)


def _stacked_by_hand(p, data, sizes, lead=0):
    outs = []
    for idx in itertools.product(*(range(n) for n in sizes)):
        sel = (slice(None),) * lead + idx
        outs.append(_client(p[sel], {"x": data["x"][sel]}))
    flat = [torch.utils._pytree.tree_flatten(o) for o in outs]

    def stack(*xs):
        out = torch.stack(xs, dim=lead)
        return out.reshape(out.shape[:lead] + sizes + out.shape[lead + 1:])

    leaves = [stack(*parts) for parts in zip(*(f[0] for f in flat))]
    return torch.utils._pytree.tree_unflatten(leaves, flat[0][1])


def _assert_same(got, want):
    got_l, got_spec = torch.utils._pytree.tree_flatten(got)
    want_l, want_spec = torch.utils._pytree.tree_flatten(want)
    assert got_spec == want_spec
    for g, w in zip(got_l, want_l):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("placements", [{"clients": 3},
                                        {"pods": 2, "clients": 3}])
def test_stacked_outputs_equal_torch_stack(placements):
    sizes = tuple(placements.values())
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(sizes + (5, 4), generator=gen)
    p0 = torch.randn((5, 4), generator=gen)

    @drjax.program(placements=placements)
    def run(p, data):
        return drjax.map_fn(_client, (drjax.broadcast(p), data))

    got = run(p0, {"x": x})
    want = _stacked_by_hand(p0.expand(sizes + (5, 4)), {"x": x}, sizes)
    _assert_same(got, want)


def test_inner_placement_and_gradient():
    """``placement="clients"`` under {pods: 2, clients: 3}: the clients
    axis stays at position 1; the gradient with respect to the mapped
    input equals the one through ``torch.stack``."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((2, 3, 5, 6), generator=gen)
    p = torch.randn((2, 3, 5, 6), generator=gen)

    @drjax.program(placements={"pods": 2, "clients": 3})
    def run(p_, x_):
        return drjax.map_fn(_client, (p_, {"x": x_}), placement="clients")

    pg = p.clone().requires_grad_()
    got = run(pg, x)
    want_pg = p.clone().requires_grad_()
    want = _stacked_by_hand(want_pg, {"x": x}, (3,), lead=1)
    _assert_same(tuple(t.detach() if t.requires_grad else t
                       for t in torch.utils._pytree.tree_leaves(got)),
                 tuple(t.detach() if t.requires_grad else t
                       for t in torch.utils._pytree.tree_leaves(want)))

    def objective(tree):
        out, _ = tree
        return (out["delta"] ** 2).sum() + out["loss"].sum() \
            + out["half"].float().sum()

    (g,) = torch.autograd.grad(objective(got), pg)
    (w,) = torch.autograd.grad(objective(want), want_pg)
    assert torch.equal(g, w)


def test_groups_must_agree_on_their_outputs():
    @drjax.program(partition_size=2)
    def run(x):
        return drjax.map_fn(lambda a: a[: int(a[0].item()) + 1], x)

    with pytest.raises(ValueError, match="group"):
        run(torch.tensor([[0.0, 0.0], [1.0, 0.0]]))
