"""The port's elastic two-leg hierarchical round
(``runtime/elastic.py``, ``runtime/executor.py:ElasticHierarchicalRound``)
against ``tests/test_executor.py::TestElasticSplit`` and
``tests/test_chaos.py::TestMaskedElasticRound``.

* A step is bitwise the port's hierarchical round (uncompressed) at the
  same pod count, and within the rounds' atol 1e-5 of the reference's
  hierarchical round on the same numpy data.
* A pod shrink 4 -> 3 never traces the per-client leg again and builds one
  more cross-pod leg; a regrow to 4 reuses both.
* The masked form (one pod fully masked, one partly) is within 1e-6
  relative (per leaf, max |a - b| <= 1e-6 max |b|) of the flat masked
  round over the same finishers; an all-masked cohort leaves the params
  bitwise as they were. Against the reference's masked elastic round on
  the same inputs (a dropped pod, partial pods, the whole cohort
  dropped): params and server state within atol 1e-5, the loss and the
  finishers within 1e-6 relative.
* Reduced lm_350m's step is bitwise the port's hierarchical round too.
* ``step(mesh=)`` on 6 gloo ranks (3 -> 2 -> 3 pods): one client trace, one
  cross leg per mesh, bitwise a same-mesh replay, within 1e-5 of the
  logical steps (``_torch_dist_checks.elastic_steps``).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

import _torch_dist  # noqa: E402
from _torch_programs import _round_data, load_model  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.algorithms import rounds as jrounds  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.algorithms import rounds  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.runtime.elastic import make_elastic_hierarchical_round  # noqa: E402


@pytest.fixture(scope="module")
def world6(tmp_path_factory):
    """The physical elastic steps in a world of 6 gloo ranks (3 pods of
    2), from ``_torch_dist_checks.elastic_steps``."""
    return _torch_dist.run_world(6, ["elastic_steps"],
                                 str(tmp_path_factory.mktemp("elastic6")))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so this file's tests do not crowd
    out the suite's other workers; the worker's count comes back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tloss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return torch.mean((pred - batch["y"]) ** 2)


def _jloss(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return jnp.mean((pred - batch["y"]) ** 2)


def _setup(num_pods=4, clients_per_pod=2, steps=2):
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal(3).astype(np.float32),
              "b": np.float32(0.0)}
    data = {"x": rng.standard_normal(
                (num_pods, clients_per_pod, steps, 8, 3)).astype(np.float32),
            "y": rng.standard_normal(
                (num_pods, clients_per_pod, steps, 8)).astype(np.float32)}
    cfg = rounds.LocalSGDConfig(partition_size=clients_per_pod,
                                num_local_steps=steps, num_pods=num_pods)
    return params, data, cfg


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _elastic(cfg, server, **kw):
    return make_elastic_hierarchical_round(_tloss, optim.sgd(0.05), server,
                                           cfg, device="cpu", **kw)


def _hier(cfg, server, pods):
    return rounds.make_hierarchical_local_sgd_round(
        _tloss, optim.sgd(0.05), server, dataclasses.replace(cfg,
                                                             num_pods=pods))


def _bitwise(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def _reference(params, data, cfg, pods):
    jcfg = jrounds.LocalSGDConfig(partition_size=cfg.partition_size,
                                  num_local_steps=cfg.num_local_steps,
                                  num_pods=pods)
    server = jopt.fedavg_momentum(1.0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jround = jrounds.make_hierarchical_local_sgd_round(
        _jloss, jopt.sgd(0.05), server, jcfg)
    return jround(jparams, server.init(jparams),
                  {k: jnp.asarray(v[:pods]) for k, v in data.items()})


class TestElasticSplit:
    def test_matches_hierarchical_round(self):
        params, data, cfg = _setup()
        server = optim.fedavg_momentum(1.0)
        tparams = _t(params)
        state = server.init(tparams)
        out = _elastic(cfg, server).step(tparams, state, _t(data))
        assert _bitwise(out, _hier(cfg, server, 4)(tparams, state, _t(data)))
        jnew, _, jm = _reference(params, data, cfg, 4)
        for k in ("w", "b"):
            np.testing.assert_allclose(out[0][k].numpy(), np.asarray(jnew[k]),
                                       rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(out[2]["loss"]), float(jm["loss"]),
                                   rtol=1e-5)

    def test_pod_shrink_never_retraces_client_leg(self):
        params, data, cfg = _setup(num_pods=4)
        server = optim.fedavg_momentum(1.0)
        elastic = _elastic(cfg, server)
        tparams = _t(params)
        state = server.init(tparams)
        elastic.step(tparams, state, _t(data))
        assert elastic.client_trace_count == 1
        assert elastic.cross_compile_count == 1
        data3 = {k: v[:3] for k, v in data.items()}
        out3 = elastic.step(tparams, state, _t(data3))
        assert elastic.client_trace_count == 1  # never traced again
        assert elastic.cross_compile_count == 2  # only the cross-pod leg
        assert _bitwise(out3, _hier(cfg, server, 3)(tparams, state,
                                                     _t(data3)))
        jnew, _, _ = _reference(params, data, cfg, 3)
        for k in ("w", "b"):
            np.testing.assert_allclose(out3[0][k].numpy(),
                                       np.asarray(jnew[k]), rtol=0, atol=1e-5)

    def test_pod_regrow_reuses_both_legs(self):
        params, data, cfg = _setup(num_pods=4)
        server = optim.fedavg_momentum(1.0)
        elastic = _elastic(cfg, server)
        tparams = _t(params)
        state = server.init(tparams)
        first = elastic.step(tparams, state, _t(data))
        elastic.step(tparams, state, _t({k: v[:3] for k, v in data.items()}))
        again = elastic.step(tparams, state, _t(data))  # the pod comes back
        assert elastic.client_trace_count == 1
        assert elastic.cross_compile_count == 2  # the P = 4 leg was cached
        assert _bitwise(first, again)

    def test_physical_steps_follow_the_mesh(self, world6):
        """step(mesh=) over 3 -> 2 -> 3 pods of 2 clients on 6 ranks (pod 1
        drops, then comes back): one client trace per run, one cross leg
        per mesh on the ranks that ran on both (cross_compile_count ==
        meshes_seen), a reshard per change, pod 1's ranks sitting out and
        then receiving the state, every rank ending on the same bits."""
        res = world6["elastic_steps"]
        for rank, r in enumerate(res):
            run = r["first"]
            assert run["client_traces"] == 1
            assert run["meshes"] == 2 and run["reshards"] == 2
            assert run["migrate_ms"] > 0
            if rank in (2, 3):  # pod 1
                assert run["cross"] == 1
                assert run["losses"][2:4] == [None, None]
            else:
                assert run["cross"] == run["meshes"]
            assert run["losses"][4] == res[0]["first"]["losses"][4]
            for k, v in res[0]["first"]["params"].items():
                np.testing.assert_array_equal(run["params"][k], v)

    def test_physical_steps_replay_bitwise_and_match_logical(self, world6):
        """A second run on the same meshes is bitwise the first, and within
        the rounds' atol 1e-5 (the losses 1e-6 relative) of the logical
        steps, which run every pod in one process."""
        for r in world6["elastic_steps"]:
            first, again, logical = r["first"], r["again"], r["logical"]
            assert first["losses"] == again["losses"]
            for k in first["params"]:
                np.testing.assert_array_equal(first["params"][k],
                                              again["params"][k])
                np.testing.assert_allclose(first["params"][k],
                                           logical["params"][k], rtol=0,
                                           atol=1e-5)
            for a, b in zip(first["losses"], logical["losses"]):
                if a is not None:
                    assert abs(a - b) <= 1e-6 * abs(b)
            assert logical["cross"] == 2 and logical["meshes"] == 0

    def test_default_device_is_the_card(self):
        params, data, cfg = _setup()
        if torch.cuda.is_available():
            assert make_elastic_hierarchical_round(
                _tloss, optim.sgd(0.05), optim.fedavg_momentum(1.0),
                cfg).device == "cuda"
            return
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make_elastic_hierarchical_round(
                _tloss, optim.sgd(0.05), optim.fedavg_momentum(1.0), cfg)


def _relative_worst(a, b):
    return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))


def _pairs(a, b):
    """Matching leaves of a port tree and a reference tree, dicts by key
    (the reference's flattening sorts keys, the port's keeps order)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            yield from _pairs(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            yield from _pairs(x, y)
    else:
        yield a, b


class TestMaskedElasticRound:
    def _build(self):
        server = optim.fedavg_momentum(1.0, momentum=0.9)
        cfg = rounds.LocalSGDConfig(partition_size=2, num_local_steps=2,
                                    straggler_mask=True)
        elastic = _elastic(cfg, server, straggler_mask=True)
        flat = rounds.make_local_sgd_round(
            _tloss, optim.sgd(0.05), server,
            dataclasses.replace(cfg, partition_size=6))
        params = {"w": torch.tensor([0.1, -0.2, 0.3]), "b": torch.tensor(0.0)}
        rng = np.random.default_rng(7)
        data = {"x": torch.tensor(rng.standard_normal(
                    (3, 2, 2, 8, 3)).astype(np.float32)),
                "y": torch.tensor(rng.standard_normal(
                    (3, 2, 2, 8)).astype(np.float32))}
        return elastic, flat, server, params, data

    def test_matches_flat_masked_with_dropped_pod(self):
        elastic, flat, server, params, data = self._build()
        state = server.init(params)
        mask = torch.tensor([[1.0, 1.0], [0.0, 0.0], [1.0, 0.0]])
        pe, _, me = elastic.step(params, state, {"data": data, "mask": mask})
        pf, _, mf = flat(params, state,
                         {k: v.reshape((6,) + v.shape[2:])
                          for k, v in data.items()}, mask.reshape(6))
        assert _relative_worst(pe, pf) <= 1e-6
        assert abs(float(me["loss"]) - float(mf["loss"])) <= 1e-6 * abs(
            float(mf["loss"]))
        assert float(me["finishers"]) == 3.0
        mask2 = torch.tensor([[0.0, 1.0], [1.0, 1.0], [0.0, 0.0]])
        elastic.step(params, state, {"data": data, "mask": mask2})
        assert elastic.client_trace_count == 1  # the mask is data

    @pytest.mark.parametrize("mask", [
        [[1.0, 1.0], [0.0, 0.0], [1.0, 0.0]],  # a dropped pod, a partial
        [[0.0, 1.0], [1.0, 1.0], [0.0, 0.0]],
        [[0.0, 0.0], [0.0, 0.0], [0.0, 0.0]],  # the whole cohort dropped
    ], ids=["dropped_pod", "partial_pods", "all_dropped"])
    def test_matches_reference(self, mask):
        """The reference's masked elastic round
        (``repro/runtime/elastic.py``, ``straggler_mask=True``, un-jitted)
        on the same params, data and mask: params and server state within
        atol 1e-5, the loss and the finishers within 1e-6 relative."""
        elastic, _, server, params, data = self._build()
        mask = torch.tensor(mask)
        pe, se, me = elastic.step(params, server.init(params),
                                  {"data": data, "mask": mask})
        jserver = jopt.fedavg_momentum(1.0, momentum=0.9)
        jcfg = jrounds.LocalSGDConfig(partition_size=2, num_local_steps=2,
                                      straggler_mask=True)
        jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
        jround = jelastic.make_elastic_hierarchical_round(
            _jloss, jopt.sgd(0.05), jserver, jcfg, straggler_mask=True)
        jp, js, jm = jround.step(
            jparams, jserver.init(jparams),
            {"data": {k: jnp.asarray(v.numpy()) for k, v in data.items()},
             "mask": jnp.asarray(mask.numpy())})
        pairs = list(_pairs((pe, se), (jp, js)))
        assert len(pairs) == len(jax.tree_util.tree_leaves((jp, js)))
        for a, b in pairs:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5)
        for k in ("loss", "finishers"):
            want = float(jm[k])
            assert abs(float(me[k]) - want) <= 1e-6 * abs(want), (k, me, jm)

    def test_all_dropped_cohort_is_a_no_op(self):
        elastic, _, server, params, data = self._build()
        pe, _, me = elastic.step(params, server.init(params),
                                 {"data": data, "mask": torch.zeros((3, 2))})
        assert _bitwise(pe, params)
        assert float(me["finishers"]) == 0.0


def test_reduced_lm_step_bitwise_to_hierarchical_round():
    """Reduced lm_350m, 2 pods x 2 clients then 1 pod: each step bitwise
    the port's uncompressed hierarchical round at that pod count."""
    _, tcfg, _, tparams = load_model()
    loss = functools.partial(registry.loss_fn, tcfg)
    server = optim.fedavg_momentum(1.0)
    cfg = rounds.LocalSGDConfig(partition_size=2, num_local_steps=1,
                                grad_clip=1.0)
    elastic = make_elastic_hierarchical_round(loss, optim.sgd(0.05), server,
                                              cfg, device="cpu")
    _, data = _round_data(4, (2, 2))
    state = server.init(tparams)
    for pods in (2, 1):
        d = {k: v[:pods] for k, v in data.items()}
        hier = rounds.make_hierarchical_local_sgd_round(
            loss, optim.sgd(0.05), server,
            dataclasses.replace(cfg, num_pods=pods))
        assert _bitwise(elastic.step(tparams, state, d),
                        hier(tparams, state, d))
    assert elastic.client_trace_count == 1
    assert elastic.cross_compile_count == 2
