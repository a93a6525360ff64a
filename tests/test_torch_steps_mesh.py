"""The step builders of the port (``repro_torch/launch/steps.py``) without
a mesh against the reference's mesh-free builders, and on a (data 2,
model 2) gloo world against the port's own mesh-free steps.

Mesh-free (``axis_rules(None)`` makes every reference constraint a no-op):
``make_sgd_train_step`` of stablelm_3b, phi35_moe and rwkv6_3b at the
reduced widths of the reference's ``tests/test_launch.py:35-37`` (f32:
XLA's CPU backend refuses some bf16 products with f32 results), weights
carried by ``convert.params_from_jax``: the loss within rtol 1e-5; SGD's
new parameters within atol 1e-6; AdamW's within atol 1e-6 but where a
gradient near zero turns Adam's normalised step (at most ``2 * lr`` apart,
in at most 0.1% of the elements). ``make_prefill_step`` and
``make_decode_step`` of stablelm_3b and recurrentgemma_2b: logits within
2e-5 (``tests/test_torch_serve_model.py``'s bound).

On the world (one module-scoped world of 4 ranks, ``_torch_dist``): two SGD
steps of each ``_torch_dist_checks.MESH_TRAIN`` case, from whole inputs
and then from the DTensors the first step returned, within rtol 2e-6 of
the mesh-free losses and atol 1e-5 of its parameters (f32 sums in other
orders); the round step of reduced lm_350m (dp: clients over "data", each
client's batch over "model") within the mesh rounds' tolerance of
``tests/test_torch_sharding.py`` (loss rtol 1e-6, parameters atol 1e-5) with all_reduces over both "data" groups; the
prefill of reduced qwen2_72b (the reference's launch test's widths) with
``tp_comm="int8"`` making an int8 gather per layer, each reduction within
its bound (one int8 step of each shard's row scale plus m f32 ulps of the
exact sum, ``tests/test_torch_tpcomm.py``), its logits at cosine > 0.9999
to the mesh-free ones, the bf16-wire prefill and a decode step within
1e-5; the vocabulary-parallel loss of a rank's logit columns within rtol
1e-6 of the whole logits' cross-entropy, its gradient within 1e-7.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist
import _torch_dist_checks as checks
from repro import optim as ref_optim
from repro.launch import steps as ref_steps
from repro.models import registry as ref_registry
from repro_torch import convert, optim
from repro_torch.launch import steps
from repro_torch.models import registry

WIDTHS = dict(d_model=64, num_heads=4, head_dim=16, vocab_size=512,
              dtype="float32", attn_impl="blocked", q_block=8, kv_block=8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return _torch_dist.run_world(
        4, ["steps_train", "steps_round", "steps_serve",
            "fsdp_layer_gathers", "vocab_loss"],
        str(tmp_path_factory.mktemp("steps4")))


def _configs(arch, **over):
    w = dict(WIDTHS, **over)
    return registry.get_config(arch).reduced(**w), \
        ref_registry.get_config(arch).reduced(**w)


def _ref_params(rcfg, cfg):
    tree = ref_registry.init_params(jax.random.PRNGKey(0), rcfg)
    return tree, convert.params_from_jax(cfg, jax.device_get(tree),
                                         device="cpu")


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# mesh-free against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
@pytest.mark.parametrize("arch", ["stablelm_3b", "phi35_moe", "rwkv6_3b"])
def test_train_step_without_mesh_matches_reference(arch, optimizer):
    cfg, rcfg = _configs(arch)
    tree, params = _ref_params(rcfg, cfg)
    # seq 16: the reference's chunked WKV is non-finite at longer ones
    # (ROADMAP.md R5)
    toks, labels = _tokens(cfg, 4, 16, 1), _tokens(cfg, 4, 16, 2)
    lr = 0.1 if optimizer == "sgd" else 3e-4
    ref_step, _ = ref_steps.make_sgd_train_step(rcfg, None,
                                                optimizer=optimizer, lr=lr)
    ropt = ref_optim.adamw(lr) if optimizer == "adamw" else ref_optim.sgd(lr)
    rp, _, rloss = jax.jit(ref_step)(
        tree, ropt.init(tree),
        {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    step, _ = steps.make_sgd_train_step(cfg, optimizer=optimizer, lr=lr)
    opt = optim.adamw(lr) if optimizer == "adamw" else optim.sgd(lr)
    p, _, loss = step(params, opt.init(params),
                      {"tokens": torch.from_numpy(toks),
                       "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
    want = convert.params_from_jax(cfg, jax.device_get(rp), device="cpu")
    for k, v in want.items():
        diff = (p[k] - v).abs()
        if optimizer == "sgd":
            assert float(diff.max()) <= 1e-6, k
        else:
            assert float(diff.max()) <= 2 * lr, k
            assert float((diff > 1e-6).float().mean()) <= 1e-3, k


@pytest.mark.parametrize("arch", ["stablelm_3b", "recurrentgemma_2b"])
def test_prefill_and_decode_without_mesh_match_reference(arch):
    over = dict(attn_impl="naive") if arch == "recurrentgemma_2b" else {}
    cfg, rcfg = _configs(arch, **over)
    tree, params = _ref_params(rcfg, cfg)
    toks = _tokens(cfg, 2, 12, 3)
    rpre, _ = ref_steps.make_prefill_step(rcfg, None, max_len=16)
    rlogits, rcaches = jax.jit(rpre)(tree, {"tokens": jnp.asarray(toks)})
    pre = steps.make_prefill_step(cfg, max_len=16)
    logits, caches = pre(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                               rtol=0, atol=2e-5)
    token = toks[:, -1:]
    rdec, _ = ref_steps.make_decode_step(rcfg, None)
    rl2, _ = jax.jit(rdec)(tree, jnp.asarray(token), rcaches)
    l2, _ = steps.make_decode_step(cfg)(params, torch.from_numpy(token),
                                        caches)
    np.testing.assert_allclose(l2.numpy(), np.asarray(rl2), rtol=0,
                               atol=2e-5)


def test_mesh_free_builders_are_todays_steps():
    """``mesh=None`` gives the mesh-free steps: no placements, no DTensor,
    the caches updated in place as before."""
    cfg, _ = _configs("stablelm_3b")
    params = registry.init_params(cfg, seed=0, device="cpu")
    pre = steps.make_prefill_step(cfg, max_len=8)
    assert not hasattr(pre, "shardings_for")
    toks = torch.from_numpy(_tokens(cfg, 2, 4, 0))
    _, caches = pre(params, {"tokens": toks})
    k0 = caches[0]["k"]
    _, caches2 = steps.make_decode_step(cfg)(params, toks[:, -1:], caches)
    assert caches2[0]["k"] is k0 and int(caches2[0]["pos"]) == 5
    for build in (steps.make_slot_decode_step, steps.make_slot_chunk_step,
                  steps.make_serve_step):
        assert not hasattr(build(cfg), "shardings_for")


def test_jit_donated_round_is_the_direct_round():
    # naive attention: a traced round of K2's plain CPU version replays a
    # view on a tensor of other strides (so on the parent tree too)
    cfg, _ = _configs("lm_350m", attn_impl="naive")
    params = registry.init_params(cfg, seed=0, device="cpu")
    data = registry.make_batch(cfg, 2, 16, seed=4, lead=(4, 2), device="cpu")
    direct, *_ = steps.make_drjax_round_step(cfg, partition_size=4,
                                             num_local_steps=2)
    compiled, *_ = steps.make_drjax_round_step(
        cfg, partition_size=4, num_local_steps=2, jit_donated=True)
    state = optim.fedavg_momentum(1.0).init(params)
    clone = lambda t: {k: v.clone() for k, v in t.items()}  # noqa: E731
    want = direct(clone(params), clone(state), data)
    got = compiled(clone(params), clone(state), data)
    for k in params:
        assert torch.equal(got[0][k], want[0][k]), k
    assert torch.equal(got[2]["loss"], want[2]["loss"])


def test_round_specs_and_placements_without_mesh():
    cfg, _ = _configs("lm_350m")
    params, state, data = steps.drjax_round_specs(
        cfg, partition_size=4, num_local_steps=2, local_batch=2, seq=16)
    assert data["tokens"].shape == (4, 2, 2, 16)
    assert all(t.device.type == "meta" for t in params.values())
    _, param_sh, server_sh, data_sh = steps.make_drjax_round_step(
        cfg, partition_size=4)
    assert data_sh(data["tokens"]) is None
    assert all(v is None for v in param_sh.values())


# ---------------------------------------------------------------------------
# on a (data 2, model 2) gloo world, against the port's mesh-free steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(checks.MESH_TRAIN))
def test_train_steps_on_mesh(world, case):
    for rank, res in enumerate(world["steps_train"]):
        r = res[case]
        np.testing.assert_allclose(r["mesh_loss"], r["loss"], rtol=2e-6)
        assert r["dtensor"]
        for k, v in r["params"].items():
            np.testing.assert_allclose(r["mesh_params"][k], v, rtol=0,
                                       atol=1e-5, err_msg=f"{rank} {k}")
        # the ranks of a step hold their blocks at the placements
        # shardings_for names
        for k, pl in r["placements"].items():
            n = pl.count("Shard")
            shape = r["params"][k].shape
            assert np.prod(r["local_shapes"][k]) * (2 ** n) == np.prod(shape) \
                or "Shard" not in pl, (k, pl)
    routes = world["steps_train"][0][case]["routes"]
    assert routes[("all_reduce", "gloo")] > 0


def test_tensor_parallel_heads_on_mesh(world):
    """16 heads split 8 a rank over "model"; 2 kv heads (qwen2_gqa) stay
    whole and the rank's query heads read theirs."""
    r = world["steps_train"][0]
    assert "Shard(dim=1)" in r["lm_1b_heads"]["placements"]["layers.0.attn.wq"]
    assert r["lm_1b_heads"]["local_shapes"]["layers.0.attn.wq"][1] == 8
    assert r["qwen2_gqa"]["local_shapes"]["layers.0.attn.wq"][1] == 8
    # kv heads whole, head_dim over "model" (the reference's layout)
    assert r["qwen2_gqa"]["local_shapes"]["layers.0.attn.wk"][1:] == (2, 4)
    # FSDP (tp strategy): the FFN's D rows over "data"
    assert r["lm_1b_heads"]["local_shapes"]["layers.0.mlp.wi"][0] == 32


def test_round_step_on_mesh(world):
    for res in world["steps_round"]:
        np.testing.assert_allclose(res["mesh_loss"], res["loss"], rtol=1e-6)
        for k, v in res["params"].items():
            np.testing.assert_allclose(res["mesh_params"][k], v, rtol=0,
                                       atol=1e-5, err_msg=k)
        assert res["data_group"] in res["groups"]   # the clients' mean
        assert res["model_group"] in res["groups"]  # a client's batch
        assert res["data_sharding"].startswith("[Shard(dim=0)")


@pytest.mark.parametrize("case", ["qwen2", "qwen2_heads"])
def test_int8_prefill_on_mesh(world, case):
    for res in world["steps_serve"]:
        r = res[case]
        rows = slice(4 * r["coord"][0], 4 * (r["coord"][0] + 1))
        want = r["logits"][rows]
        np.testing.assert_allclose(r["bf16"]["logits"], want, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(r["bf16"]["decode"], r["decode"][rows],
                                   rtol=0, atol=1e-5)
        got = r["int8"]["logits"]
        cos = float((got * want).sum() / np.linalg.norm(got) /
                    np.linalg.norm(want))
        assert cos > 0.9999
        assert r["int8"]["routes"]["int8 gathers"] >= 2  # one a layer
        assert len(r["int8_bound"]) >= 2 and max(r["int8_bound"]) <= 1.0
        assert r["bf16_bound"] == []
        assert "int8 gathers" not in r["bf16"]["routes"]
        # the caches' kv heads whole, head_dim over "model"
        assert r["int8"]["cache_placements"] == "(Shard(dim=0), Shard(dim=3))"


def test_fsdp_gathers_a_layer_inside_its_checkpoint(world):
    """A layer's FSDP leaves are gathered inside the layer: under remat
    "full" the backward's recomputation gathers each of them once more
    (the gathered weights live for one layer), under "none" it does not."""
    for res in world["fsdp_layer_gathers"]:
        assert res["layer_fsdp_leaves"] > 0
        assert res["full"] - res["none"] == res["layer_fsdp_leaves"]


@pytest.mark.parametrize("case", ["plain", "masked"])
def test_vocab_parallel_loss(world, case):
    """Each rank's loss from its vocabulary columns (the log-sum-exp of
    the ranks' column blocks, the gold logit summed) is the whole logits'
    cross-entropy within f32 rounding, and the gradient of its columns is
    theirs of the whole gradient: no rank gathers the logits."""
    for res in world["vocab_loss"]:
        r = res[case]
        np.testing.assert_allclose(r["loss"], r["want"], rtol=1e-6)
        np.testing.assert_allclose(r["grad"], r["want_grad"], rtol=0,
                                   atol=1e-7)
