"""The port's chaos soak (``repro_torch/runtime/chaos.py``, logical and
physical modes) and its mesh-free elastic helpers against the reference's
(``repro/runtime/chaos.py``, ``repro/runtime/elastic.py``), on the CPU.

* ``ChaosSchedule``: every draw bitwise the reference's at the CI shape
  (``tests/test_chaos.py::_smoke_cfg``), at ``num_elastic_events=3`` and at
  the full soak's defaults: pod counts, alive pods, failure rounds,
  checkpoint faults with their kill offsets, elastic events, serve rounds,
  audits, every round's data, mask and straggler times, and the serve
  bursts' requests; the streams stay independent.
* The soak at the CI shape, from the reference's initial state converted
  (``_init_state`` patched: the port draws ``w`` from a torch
  ``Generator``): every counter of ``to_json()`` equal to the reference's,
  the straggler percentiles exactly, the losses within 1e-6 relative, the
  audit's relative error <= 1e-6, the oracle bitwise and the invariants
  holding; again with serve bursts every 8 rounds (bursts, requests,
  completions, the injected fault and its recovery, builds flat).
* ``assert_invariants`` refuses a report broken in each invariant alone.
* ``launch.train --chaos``, the time budget, and ``ElasticSchedule`` /
  ``rescale_partition``.
* The physical mode on 8 gloo ranks at the reference's acceptance config
  (``tests/test_chaos.py:194-201``): every invariant, ``meshes_seen`` and
  ``reshards`` as the reference's schedule implies, the losses within 1e-6
  relative of the logical soak's.

The reference runs as its own tests run it (``run_chaos_soak``), the
torch side on one intra-op thread.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.optim import server as jserver  # noqa: E402
from repro.runtime import chaos as jchaos  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
import _torch_dist  # noqa: E402
import _torch_dist_checks  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.runtime import chaos, elastic  # noqa: E402

CI = dict(rounds=20, seed=1, num_device_failures=1, num_elastic_events=1,
          num_ckpt_faults=1, checkpoint_every=4, audit_every=8,
          serve_traffic=False)
SHAPES = {"ci": CI, "elastic3": dict(CI, num_elastic_events=3),
          "full": {}}

# the report's counters, compared as the reference reports them
COUNTERS = ("rounds", "seed", "restarts", "scratch_restarts",
            "completed_steps", "replayed_steps", "backoff_s",
            "device_failures", "failure_rounds", "restores",
            "fallback_restores", "ckpt_faults_injected", "elastic_events",
            "pods_seen", "client_leg_traces", "client_retraces",
            "cross_compiles", "oracle_extra_traces", "physical_mesh",
            "reshards", "mesh_migrate_ms", "meshes_seen",
            "mid_write_kills_injected", "mid_write_kills_survived",
            "oracle_bitwise_equal", "minutes_budget")
SERVE_COUNTERS = ("bursts", "requests", "completed", "faults_injected",
                  "recoveries", "prefill_traces", "decode_traces",
                  "flat_traces")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so this file's tests do not crowd
    out the suite's other workers; the worker's count comes back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _configs(**over):
    return (jchaos.ChaosConfig(**over),
            chaos.ChaosConfig(**dict(over, device="cpu")))


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_schedule_draws_match_reference(shape):
    jcfg, tcfg = _configs(**SHAPES[shape])
    js = jchaos.ChaosSchedule.from_config(jcfg)
    ts = chaos.ChaosSchedule.from_config(tcfg)
    for name in ("pod_counts", "alive_pods", "elastic_events",
                 "failure_rounds", "ckpt_faults", "serve_rounds",
                 "serve_fault_round", "audit_rounds"):
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.ckpt_faults and all(
        k in ("torn", "corrupt") or k.startswith("kill@")
        for k in ts.ckpt_faults.values())
    for r in range(tcfg.rounds):
        p = ts.pod_counts[r]
        for got, want in zip(ts.data_for_round(r, p),
                             js.data_for_round(r, p)):
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(_np(got), _np(want))
        tmask, tt, tsync = ts.round_mask_and_times(r, p)
        jmask, jt, jsync = js.round_mask_and_times(r, p)
        assert tmask.shape == (p, tcfg.clients_per_pod)
        np.testing.assert_array_equal(_np(tmask), _np(jmask))
        assert (tt, tsync) == (jt, jsync)
    for r in (0, 8, 16):
        treqs = ts.serve_requests_for(r, 512)
        jreqs = js.serve_requests_for(r, 512)
        assert len(treqs) == len(jreqs) == tcfg.serve_requests
        for a, b in zip(treqs, jreqs):
            assert (a.rid, a.max_new) == (b.rid, b.max_new)
            np.testing.assert_array_equal(a.prompt, b.prompt)
            assert a.prompt.dtype == np.int32


def test_stream_ids_are_the_reference_s():
    names = ("STREAM_FAILURES", "STREAM_ELASTIC", "STREAM_DATA",
             "STREAM_SERVE", "STREAM_CKPT")
    assert [getattr(chaos, n) for n in names] == [1, 2, 3, 4, 5]
    assert [getattr(chaos, n) for n in names] == [getattr(jchaos, n)
                                                  for n in names]


def test_streams_independent():
    """Changing one stream's config leaves the others' draws alone (the
    ``SeedSequence([seed, stream_id, ...])`` rule)."""
    a = chaos.ChaosSchedule.from_config(chaos.ChaosConfig(**CI, device="cpu"))
    b = chaos.ChaosSchedule.from_config(
        chaos.ChaosConfig(**dict(CI, num_elastic_events=3), device="cpu"))
    assert a.failure_rounds == b.failure_rounds
    assert a.ckpt_faults == b.ckpt_faults
    assert a.pod_counts[0] == b.pod_counts[0]
    for xa, xb in zip(a.data_for_round(0, a.pod_counts[0]),
                      b.data_for_round(0, b.pod_counts[0])):
        assert torch.equal(xa, xb)


def test_config_validation():
    with pytest.raises(ValueError, match="rounds"):
        chaos.ChaosSchedule.from_config(chaos.ChaosConfig(rounds=4,
                                                          device="cpu"))
    with pytest.raises(ValueError, match="max_restarts"):
        chaos.ChaosSchedule.from_config(chaos.ChaosConfig(
            num_device_failures=8, max_restarts=8, device="cpu"))
    with pytest.raises(ValueError, match="clients_per_pod"):
        chaos.ChaosSchedule.from_config(chaos.ChaosConfig(
            dim=2, clients_per_pod=2, device="cpu"))


def test_default_device_is_the_card():
    assert chaos.ChaosConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        chaos.ChaosSchedule.from_config(chaos.ChaosConfig(**CI))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        chaos.run_chaos_soak(chaos.ChaosConfig(**CI))


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    """The physical soak at the reference's acceptance config on 8 gloo
    ranks (4 pods x 2 clients), beside each rank's logical soak
    (``_torch_dist_checks.physical_soak``)."""
    return _torch_dist.run_world(8, ["physical_soak"],
                                 str(tmp_path_factory.mktemp("soak8")))


def test_physical_soak_passes_every_invariant(world8):
    for r in world8["physical_soak"]:
        rep = r["report"]
        assert rep["physical_mesh"] and rep["oracle_bitwise_equal"]
        assert rep["reshards"] >= len(rep["elastic_events"]) >= 2
        assert rep["cross_compiles"] == rep["meshes_seen"] >= 2
        assert rep["mesh_migrate_ms"] > 0
        assert rep["client_retraces"] == 0 and rep["oracle_extra_traces"] == 0
        assert rep["audit"]["max_rel_err"] <= 1e-6
        chaos.ChaosReport(**{**rep, "failure_rounds": tuple(
            rep["failure_rounds"]), "ckpt_faults_injected": {
            int(k): v for k, v in rep["ckpt_faults_injected"].items()}}
        ).assert_invariants()


def test_physical_soak_meshes_follow_the_reference_schedule(world8):
    """meshes_seen is the number of distinct alive sets of the reference's
    schedule, and reshards the number of changes of alive set along the
    rounds the soak ran (replays after a restore included)."""
    alive = jchaos.ChaosSchedule.from_config(jchaos.ChaosConfig(
        **_torch_dist_checks.SOAK)).alive_pods
    ran, start = [], 0
    rep = world8["physical_soak"][0]["report"]
    for fail, restored in zip(rep["failure_rounds"], rep["restores"]):
        ran += list(range(start, fail))
        start = restored or 0
    ran += list(range(start, rep["rounds"]))
    changes = sum(alive[a] != alive[b] for a, b in zip(ran, ran[1:]))
    for r in world8["physical_soak"]:
        assert r["report"]["meshes_seen"] == len(set(alive))
        assert r["report"]["reshards"] == changes


def test_physical_soak_matches_the_logical_soak(world8):
    """Every rank's report agrees with the others' and, counters aside,
    with the logical soak's: the losses within 1e-6 relative."""
    first = world8["physical_soak"][0]["report"]
    for r in world8["physical_soak"]:
        rep, log = r["report"], r["logical"]
        for key in ("restarts", "restores", "failure_rounds", "reshards",
                    "meshes_seen", "cross_compiles", "elastic_events",
                    "completed_steps", "replayed_steps", "loss_first",
                    "loss_final", "straggler", "audit"):
            assert rep[key] == first[key], key
        for key in ("restarts", "restores", "elastic_events",
                    "fallback_restores", "mid_write_kills_survived",
                    "straggler"):
            assert rep[key] == log[key], key
        for key in ("loss_first", "loss_final"):
            assert abs(rep[key] - log[key]) <= 1e-6 * abs(log[key])


def _converted_init(monkeypatch):
    """Patch the port's ``_init_state`` to the reference's initial state
    (its ``jax.random`` draw of ``w``), converted to CPU tensors; the
    server state is the port's ``init`` of those params (zeros, as the
    reference's)."""

    def init(cfg, server_opt):
        jstate = jax.device_get(jchaos._init_state(
            jchaos.ChaosConfig(seed=cfg.seed, dim=cfg.dim),
            jserver.fedavg_momentum(1.0, momentum=cfg.server_momentum)))
        params = {k: torch.from_numpy(np.array(v))
                  for k, v in jstate["params"].items()}
        return {"params": params, "server": server_opt.init(params)}

    monkeypatch.setattr(chaos, "_init_state", init)


def _soaks(tmp_path_factory, **over):
    jrep = jchaos.run_chaos_soak(jchaos.ChaosConfig(
        **dict(CI, **over), ckpt_dir=str(tmp_path_factory.mktemp("jax"))))
    with pytest.MonkeyPatch.context() as mp:
        _converted_init(mp)
        trep = chaos.run_chaos_soak(chaos.ChaosConfig(
            **dict(CI, **over), device="cpu",
            ckpt_dir=str(tmp_path_factory.mktemp("torch"))))
    return jrep, trep


@pytest.fixture(scope="module")
def soaks(tmp_path_factory):
    return _soaks(tmp_path_factory)


@pytest.fixture(scope="module")
def serve_soaks(tmp_path_factory):
    return _soaks(tmp_path_factory, serve_traffic=True, serve_every=8)


@pytest.mark.parametrize("name", COUNTERS)
def test_soak_counters_match_reference(soaks, name):
    jrep, trep = soaks
    assert trep.to_json()[name] == jrep.to_json()[name]


def test_soak_exercised_every_fault(soaks):
    _, trep = soaks
    assert trep.device_failures == 1 and trep.restarts == 1
    assert trep.fallback_restores == 1
    assert trep.mid_write_kills_injected == trep.mid_write_kills_survived == 1
    assert trep.client_leg_traces == 1 and trep.oracle_extra_traces == 0
    assert trep.cross_compiles == len(trep.pods_seen) == 2
    assert trep.oracle_bitwise_equal
    trep.assert_invariants()


def test_straggler_percentiles_equal(soaks):
    jrep, trep = soaks
    assert trep.straggler == jrep.straggler


def test_losses_and_audit_match_reference(soaks):
    jrep, trep = soaks
    for name in ("loss_first", "loss_final"):
        want = getattr(jrep, name)
        assert abs(getattr(trep, name) - want) <= 1e-6 * abs(want), name
    assert trep.loss_final < trep.loss_first
    assert trep.audit["rounds"] == jrep.audit["rounds"]
    assert trep.audit["max_rel_err"] <= 1e-6


def test_report_serializes_with_the_reference_keys(soaks):
    jrep, trep = soaks
    d = trep.to_json()
    assert json.loads(json.dumps(d)) == d
    assert set(d) == set(jrep.to_json())
    assert set(d) == {f.name for f in dataclasses.fields(trep)}


@pytest.mark.parametrize("name", SERVE_COUNTERS)
def test_serve_bursts_match_reference(serve_soaks, name):
    jrep, trep = serve_soaks
    assert trep.serve[name] == jrep.serve[name]


def test_serve_soak_recovers_and_stays_flat(serve_soaks):
    jrep, trep = serve_soaks
    s = trep.serve
    assert s["bursts"] == 3 and s["completed"] == s["requests"] == 6
    assert s["faults_injected"] == s["recoveries"] == 1
    assert s["flat_traces"] and s["p99_contended_s"] > 0
    assert trep.serve_p99_contended == s["p99_contended_s"]
    assert trep.oracle_bitwise_equal
    for name in COUNTERS:
        assert trep.to_json()[name] == jrep.to_json()[name], name


# ---------------------------------------------------------------------------
# assert_invariants: each invariant alone
# ---------------------------------------------------------------------------

BROKEN = {
    "oracle": (dict(oracle_bitwise_equal=False), "bitwise"),
    "retrace": (dict(client_retraces=1), "retraced"),
    "oracle_traces": (dict(oracle_extra_traces=1), "oracle replay added"),
    "restarts": (dict(restarts=0), "restarts for"),
    "p99": (dict(straggler=dict(p50_masked_s=1.0, p99_masked_s=9.0,
                                p50_sync_s=1.0, p99_sync_s=9.0,
                                tail_ratio_masked=1.0, tail_ratio_sync=9.0,
                                speedup=1.0)), "masked p99 round time"),
    "tail": (dict(straggler=dict(p50_masked_s=1.0, p99_masked_s=5.0,
                                 p50_sync_s=2.0, p99_sync_s=9.0,
                                 tail_ratio_masked=5.0, tail_ratio_sync=4.5,
                                 speedup=1.0)), "p99/p50"),
    "audit": (dict(audit=dict(rounds=[0], max_rel_err=2e-3)),
              "masked mean diverged"),
    "fallback": (dict(fallback_restores=0), "no restore fell back"),
    "kills": (dict(mid_write_kills_survived=0), "mid-write checkpoint kills"),
    "serve_flat": ("flat_traces", "serve traces grew"),
    "serve_completed": ("completed", "serve completed"),
    "serve_recovered": ("recoveries", "never recovered"),
}


def _good_report():
    return chaos.ChaosReport(
        rounds=20, seed=1, restarts=1, scratch_restarts=0,
        completed_steps=20, replayed_steps=6, backoff_s=0.0,
        device_failures=1, failure_rounds=(10,), restores=(4,),
        fallback_restores=1, ckpt_faults_injected={8: "kill@1701"},
        elastic_events=((12, 4, 3),), pods_seen=(3, 4),
        client_leg_traces=1, client_retraces=0, cross_compiles=2,
        oracle_extra_traces=0, physical_mesh=False, reshards=0,
        mesh_migrate_ms=0.0, meshes_seen=0, mid_write_kills_injected=1,
        mid_write_kills_survived=1,
        straggler=dict(p50_masked_s=17.0, p99_masked_s=41.0,
                       p50_sync_s=18.0, p99_sync_s=59.0,
                       tail_ratio_masked=2.4, tail_ratio_sync=3.3,
                       speedup=1.2),
        audit=dict(rounds=[0, 8], max_rel_err=1e-7), loss_first=1.0,
        loss_final=0.1, oracle_bitwise_equal=True,
        serve=dict(bursts=3, requests=6, completed=6, faults_injected=1,
                   recoveries=1, prefill_traces=4, decode_traces=1,
                   flat_traces=True, p50_contended_s=0.01,
                   p99_contended_s=0.02),
        serve_p99_contended=0.02, minutes_budget=None, wall_s=1.0)


def test_good_report_passes():
    _good_report().assert_invariants()


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_assert_invariants_catches(case):
    change, match = BROKEN[case]
    rep = _good_report()
    if isinstance(change, str):  # a serve field, broken
        rep.serve[change] = {"flat_traces": False, "completed": 5,
                             "recoveries": 0}[change]
    else:
        rep = dataclasses.replace(rep, **change)
    with pytest.raises(AssertionError, match=match):
        rep.assert_invariants()


# ---------------------------------------------------------------------------
# entry points and the time budget
# ---------------------------------------------------------------------------


def test_train_chaos_prints_a_report(capsys):
    train.main(["--chaos", "--device", "cpu", "--rounds", "8"])
    out = json.loads(capsys.readouterr().out)
    assert out["rounds"] == 8 and out["oracle_bitwise_equal"]
    assert out["client_leg_traces"] == 1 and out["serve"] is None


def test_scale_config_to_minutes_matches_reference():
    over = dict(rounds=48, num_device_failures=2, num_elastic_events=4,
                num_ckpt_faults=2)
    for minutes, round_s in ((2.0, 0.5), (0.001, 10.0), (None, 0.5),
                             (1.0, 0.07)):
        jcfg, tcfg = _configs(**over, minutes=minutes)
        got = chaos.scale_config_to_minutes(tcfg, round_s)
        want = jchaos.scale_config_to_minutes(jcfg, round_s)
        for f in dataclasses.fields(want):
            assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_minutes_budget_drives_soak_length(monkeypatch, tmp_path):
    monkeypatch.setattr(chaos, "_calibrate_round_s", lambda fn: 0.1)
    rep = chaos.run_chaos_soak(chaos.ChaosConfig(
        **CI, minutes=0.02, device="cpu", ckpt_dir=str(tmp_path)),
        check=False)
    assert rep.rounds == 12 and rep.minutes_budget == 0.02
    assert rep.completed_steps == 12 and rep.client_leg_traces == 1


def test_calibration_runs_the_probe_three_times():
    calls = []
    assert chaos._calibrate_round_s(lambda: calls.append(1)) > 0
    assert len(calls) == 3


# ---------------------------------------------------------------------------
# the mesh-free elastic helpers
# ---------------------------------------------------------------------------


def test_elastic_schedule_matches_reference():
    for g in (1, 2, 3):
        for n in (0, 1, 7, 128, 256):
            assert (elastic.ElasticSchedule(groups_per_device=g).cohort_size(n)
                    == jelastic.ElasticSchedule(groups_per_device=g)
                    .cohort_size(n))
    assert elastic.ElasticSchedule(2).cohort_size(128) == 256


@pytest.mark.parametrize("new_n", [3, 8, 12, 20])
def test_rescale_partition_matches_reference(new_n):
    rng = np.random.default_rng(0)
    data = {"tokens": rng.integers(0, 9, (8, 3)).astype(np.int32),
            "x": rng.standard_normal((8, 2, 4)).astype(np.float32),
            "other": rng.standard_normal((5, 2)).astype(np.float32),
            "scalar": np.float32(1.5)}
    want = jelastic.rescale_partition(data, 8, new_n)
    got_np = elastic.rescale_partition(data, 8, new_n)
    got_t = elastic.rescale_partition(
        {k: torch.from_numpy(np.array(v)) for k, v in data.items()}, 8, new_n)
    for k in data:
        np.testing.assert_array_equal(np.asarray(got_np[k]),
                                      np.asarray(want[k]))
        np.testing.assert_array_equal(got_t[k].numpy(), np.asarray(want[k]))
    assert got_t["tokens"].shape == (new_n, 3)
    assert got_t["other"].shape == (5, 2)
