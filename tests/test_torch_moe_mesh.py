"""MoE routing groups that span the ranks' rows (``repro_torch/models/
moe.py``), in gloo worlds of 2 and 4 CPU ranks (``_torch_dist``), against
the reference on the whole batch.

The parameters are the reference's ``registry.init_params`` carried over by
``convert.params_from_jax`` (reduced phi35_moe, 4 experts top 2, and
qwen3_moe with 16 experts top 8; f32 at ``_torch_dist_checks._f32``'s
widths), written to the world's directory for its ranks, which import no
JAX. Meshes: (data 2) in the world of 2; (data 4) and (data 2, model 2)
(the rank's experts) in the world of 4.

* ``moe.apply`` on B 4 x S 6 (one group of 24 tokens over every rank) and
  B 4 x S 384 (groups of 512 that a rank's rows cover in part): each
  rank's rows, put together, within 2e-5 (relative to the largest
  magnitude, as ``tests/test_torch_moe.py``) of the reference's
  ``moe.apply`` of the whole batch; each rank's tokens' expert choices,
  kept choices and slots bitwise those of the port's mesh-free run, their
  weights within 1e-6; the aux loss within 1e-6 relative of the
  reference's.
* The train step's gradient (``steps.dp_loss``) on spanning groups within
  1e-6 of each leaf's largest magnitude of the mesh-free gradient, and
  its loss within 1e-6 relative.
* ``make_prefill_step`` and ``make_decode_step`` on B 4 x S 6: the ranks'
  logits within 2e-5 of the reference's mesh-free steps.
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_dist  # noqa: E402
import _torch_dist_checks as checks  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro_torch import convert  # noqa: E402

CHECKS = ["moe_mesh_apply", "moe_mesh_grads", "moe_mesh_steps"]
WIDTHS = dict(d_model=64, num_heads=4, head_dim=16, vocab_size=512,
              dtype="float32", attn_impl="blocked", q_block=8, kv_block=8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref(arch):
    over = checks.MOE_MESH[arch]
    rcfg = ref_registry.get_config(arch).reduced(**WIDTHS, **over)
    tree = jax.device_get(ref_registry.init_params(jax.random.PRNGKey(0),
                                                   rcfg))
    return rcfg, tree


@pytest.fixture(scope="module")
def ref():
    """The reference's configs and parameters of every case."""
    return {arch: _ref(arch) for arch in checks.MOE_MESH}


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    specs = {}
    for w in (2, 4):
        wd = str(tmp_path_factory.mktemp(f"moe{w}"))
        for arch, (rcfg, tree) in ref.items():
            cfg = checks._f32(arch, **checks.MOE_MESH[arch])
            params = convert.params_from_jax(cfg, tree, device="cpu")
            np.savez(checks.moe_params_path(wd, arch),
                     **{k: v.numpy() for k, v in params.items()})
        specs[w] = (w, CHECKS, wd)
    return _torch_dist.run_worlds(specs)


def _close(got, want, rel, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rel,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def _ref_apply(rcfg, tree, x):
    p = jax.tree_util.tree_map(lambda v: v[0], tree["layers"]["moe"])
    out, aux = ref_moe.apply(rcfg, p, jnp.asarray(x))
    return np.asarray(out), float(aux)


def _cases():
    return [(w, arch, shape) for w in (2, 4) for arch in checks.MOE_MESH
            for shape in checks.MOE_SHAPES]


@pytest.mark.parametrize("world,arch,shape", _cases())
def test_apply_spanning_groups_match_the_whole_batch(world, arch, shape,
                                                     worlds, ref):
    rcfg, tree = ref[arch]
    b, s = checks.MOE_SHAPES[shape]
    x = checks.moe_input(rcfg, b, s)
    want, want_aux = _ref_apply(rcfg, tree, x)
    ranks = worlds[world]["moe_mesh_apply"]
    for mesh in ["data"] + (["data2_model2"] if world == 4 else []):
        got = np.zeros_like(want)
        for res in ranks:
            r = res[(arch, shape, mesh)]
            rows = r["rows"].shape[0]
            got[r["lo"]:r["lo"] + rows] = r["rows"]
            assert r["spans"]
            # the rank's tokens routed as the whole batch's run routes them
            for key in ("choices", "kept", "slot"):
                np.testing.assert_array_equal(
                    r["routing"][key], r["plain_routing"][key],
                    err_msg=f"{mesh} {key}")
            np.testing.assert_allclose(r["routing"]["weights"],
                                       r["plain_routing"]["weights"],
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(r["aux"], want_aux, rtol=1e-6)
            # the batch's tokens gathered over the chain, its sums summed
            assert r["routes"][("gather", "all_gather")] >= 1
            assert r["routes"][("all_reduce", "gloo")] >= 2
            if mesh == "data2_model2":
                assert r["local_experts"] == rcfg.num_experts // 2
        _close(got, want, 2e-5, f"{mesh} rows")
        # the port's mesh-free run agrees with the reference too
        _close(ranks[0][(arch, shape, mesh)]["want"], want, 2e-5)
        np.testing.assert_allclose(ranks[0][(arch, shape, mesh)]["want_aux"],
                                   want_aux, rtol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_train_step_gradient_through_spanning_groups(world, worlds):
    for res in worlds[world]["moe_mesh_grads"]:
        for mesh, r in res["mesh"].items():
            np.testing.assert_allclose(r["loss"], res["want_loss"], rtol=1e-6)
            for k, want in res["want"].items():
                _close(r["grads"][k], want, 1e-6, f"{mesh} {k}")
            # the gather's and the aux sums' backward: sums over the chain
            assert r["routes"][("all_reduce", "gloo")] > 0


@pytest.mark.parametrize("world", [2, 4])
def test_prefill_and_decode_steps_match_the_reference(world, worlds):
    rcfg, tree = _ref("phi35_moe")
    tokens = checks.moe_step_tokens(rcfg)
    pre, _ = ref_steps.make_prefill_step(rcfg, None,
                                         max_len=checks.MOE_STEPS["max_len"])
    dec, _ = ref_steps.make_decode_step(rcfg, None)
    logits, caches = jax.jit(pre)(tree, {"tokens": jnp.asarray(tokens)})
    dlogits, _ = jax.jit(dec)(tree, jnp.asarray(tokens[:, -1:]), caches)
    logits, dlogits = np.asarray(logits), np.asarray(dlogits)
    for res in worlds[world]["moe_mesh_steps"]:
        for mesh, r in res.items():
            rows = slice(r["lo"], r["lo"] + r["prefill"].shape[0])
            _close(r["prefill"], logits[rows], 2e-5, f"{mesh} prefill")
            _close(r["decode"], dlogits[rows], 2e-5, f"{mesh} decode")
