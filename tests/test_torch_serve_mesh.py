"""The serve schedulers on a data-parallel mesh (``mesh=``,
``repro_torch/launch/{serve,steps}.py``), in gloo worlds of 2 and 4 CPU
ranks (``_torch_dist``), against the reference's mesh-free schedulers.

Reduced stablelm_3b and reduced phi35_moe (f32), the reference's
parameters through ``convert.params_from_jax``, 4 slots split 2 a rank
over "data": a (data 2) mesh in the world of 2, (data 2, model 2) in the
world of 4 (the rank's heads and kv heads too). Six requests each, the
first two at once and the rest staggered, so slots are reused:

* the continuous and the static scheduler with ``mesh=`` emit every
  request's tokens equal, token for token, to the reference's mesh-free
  ``ContinuousBatchingScheduler`` and ``StaticWaveScheduler`` on the same
  requests, on every rank;
* a rank holds only its slots: every pool leaf a DTensor whose local
  block is half the slots; the steps run eagerly (``captured`` false,
  nothing replayed) and build one step per chunk bucket and one decode
  step, as without a mesh;
* a pool of 3 slots, which does not split over the 2 data ranks, raises
  ``ValueError`` when the scheduler is built.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import _torch_dist  # noqa: E402
import _torch_dist_checks as checks  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import registry as ref_registry  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import registry  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    out = {}
    for arch in checks.SERVE_MESH:
        rcfg = ref_registry.get_config(arch).reduced()
        out[arch] = (rcfg, jax.device_get(ref_registry.init_params(
            jax.random.PRNGKey(0), rcfg)))
    return out


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    specs = {}
    for w in (2, 4):
        wd = str(tmp_path_factory.mktemp(f"serve{w}"))
        for arch, (rcfg, tree) in ref.items():
            cfg = registry.get_config(arch).reduced()
            params = convert.params_from_jax(cfg, tree, device="cpu")
            np.savez(checks.moe_params_path(wd, arch + "_serve"),
                     **{k: v.numpy() for k, v in params.items()})
        specs[w] = (w, ["serve_mesh"], wd)
    return _torch_dist.run_worlds(specs)


@pytest.fixture(scope="module")
def want(ref):
    """Each case's tokens from the reference's mesh-free schedulers."""
    out = {}
    for arch, (rcfg, tree) in ref.items():
        _, _, max_len, chunk = checks.SERVE_MESH[arch]
        for kind, cls in (("continuous", ref_serve.ContinuousBatchingScheduler),
                          ("static", ref_serve.StaticWaveScheduler)):
            out[(arch, kind)] = cls(rcfg, tree, checks.SERVE_SLOTS, max_len,
                                    chunk).run(checks.serve_mesh_requests(
                                        rcfg, arch, ref_serve.Request))
    return out


CASES = [(w, arch, kind) for w in (2, 4) for arch in checks.SERVE_MESH
         for kind in ("continuous", "static")]


@pytest.mark.parametrize("world,arch,kind", CASES)
def test_schedulers_on_a_mesh_emit_the_reference_s_tokens(world, arch, kind,
                                                         worlds, want):
    for rank, res in enumerate(worlds[world]["serve_mesh"]):
        r = res[(arch, kind)]
        assert r["tokens"] == want[(arch, kind)], f"rank {rank}"


@pytest.mark.parametrize("world,arch,kind", CASES)
def test_a_rank_holds_only_its_slots(world, arch, kind, worlds):
    for res in worlds[world]["serve_mesh"]:
        r = res[(arch, kind)]
        assert r["dtensor"]
        assert r["shape"][0] == checks.SERVE_SLOTS
        assert r["local"][0] == checks.SERVE_SLOTS // 2
        assert r["local"][1:] == r["shape"][1:] or world == 4
        # eager by rule: each step ends in the tokens' gather
        assert r["captured"] is False and r["replayed"] == {}
        lens, _, _, chunk = checks.SERVE_MESH[arch]
        buckets = {c for n in lens for c in _chunks(n, chunk)}
        assert r["builds"] == (len(buckets), 1)


def _chunks(n, chunk_max):
    from repro_torch.launch.serve import chunk_schedule

    return chunk_schedule(n, chunk_max)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", list(checks.SERVE_MESH))
def test_a_pool_that_does_not_split_raises(world, arch, worlds):
    for res in worlds[world]["serve_mesh"]:
        msg = res[(arch, "three_slots")]
        assert msg is not None and "does not split" in msg
