"""The port's dry run (``repro_torch/launch/dryrun.py``) in fake worlds of 4
and 8 ranks, on (data 2, model 2) and (pod 2, data 2, model 2) meshes, at
reduced f32 widths (global batch 8, sequence 16; fake CPU tensors: a
CPU-only torch cannot index a fake CUDA tensor or take its gradient).

* The SGD train step, the DrJAX local-SGD round, prefill and decode end
  ``ok``, and their collective counts and operand bytes equal those of the
  same step on real tensors in a gloo world of the same size
  (``_torch_dist_checks.dryrun_counts``, rank 0), as do their counted
  FLOPs: the dry run's numbers are a real run's.
* A rank's parameter and optimizer bytes equal its storage blocks of the
  whole values that ``steps.shard_tree`` places by the train step's rules
  (the round holds its parameters whole).
* ``long_500k`` is ``skipped`` for a full-attention arch; MoE routing
  groups that span the ranks' rows (a known gap) end ``error`` with their
  message; the CLI writes only under ``--out``, and never imports JAX.
"""

import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import _torch_dist  # noqa: E402
import _torch_dist_checks as checks  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(name):
    arch, kind, alg, shape = checks.DRYRUN_CASES[name]
    return dryrun.run_cell(
        arch, CELL[kind], "multi" if len(shape) == 3 else "single", alg,
        device="cpu", cfg=checks._f32(arch),
        mesh_spec=(shape, checks.DRYRUN_AXES[len(shape)]),
        shape={"kind": kind, "seq_len": checks.DRYRUN_SEQ,
               "global_batch": checks.DRYRUN_BATCH})


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """Rank 0's counts of every case, from one gloo world of each size."""
    specs = {w: (w, ["dryrun_counts"], str(tmp_path_factory.mktemp(f"w{w}")))
             for w in (4, 8)}
    worlds = _torch_dist.run_worlds(specs)
    return {**worlds[4]["dryrun_counts"][0], **worlds[8]["dryrun_counts"][0]}


@pytest.fixture(scope="module")
def fake():
    return {name: _run(name) for name in checks.DRYRUN_CASES}


@pytest.mark.parametrize("name", list(checks.DRYRUN_CASES))
def test_counts_equal_a_gloo_world(name, fake, gloo):
    rec, real = fake[name], gloo[name]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["collectives"] == real["collectives"]
    assert rec["collectives"], "a step on a mesh runs collectives"
    assert rec["collective_bytes_per_device_trace"] == sum(
        v["operand_bytes"] for v in real["collectives"].values())
    assert rec["trace_cost"]["flops_per_device"] == real["flops"] > 0


@pytest.mark.parametrize("name", list(checks.DRYRUN_CASES))
def test_param_and_optimizer_bytes_exact(name, fake, gloo):
    arch, kind, alg, shape = checks.DRYRUN_CASES[name]
    mem, real = fake[name]["memory"], gloo[name]
    if alg == "local_sgd":
        # server values every rank holds whole; FedAvg keeps a step count
        assert mem["param_bytes"] == real["whole_param_bytes"]
        assert 0 < mem["optimizer_bytes"] <= 8
    elif kind == "train":
        assert mem["param_bytes"] == real["param_bytes"]
        assert mem["optimizer_bytes"] == real["optimizer_bytes"]
        assert mem["param_bytes"] < real["whole_param_bytes"]
    else:
        assert mem["param_bytes"] == real["param_bytes"]
        assert mem["optimizer_bytes"] == 0
    assert mem["argument_bytes"] == (mem["param_bytes"]
                                     + mem["optimizer_bytes"]
                                     + mem["input_bytes"])
    assert mem["peak_hbm_bytes"] >= mem["argument_bytes"]


@pytest.mark.parametrize("name", list(checks.DRYRUN_CASES))
def test_record_beside_the_analytic_model(name, fake):
    rec = fake[name]
    arch, kind, alg, shape = checks.DRYRUN_CASES[name]
    assert rec["chips"] == math.prod(shape)
    assert rec["roofline"]["flops_per_device"] > 0
    assert rec["flops_over_analytic"] == pytest.approx(
        rec["trace_cost"]["flops_per_device"]
        / rec["roofline"]["flops_per_device"])
    terms = rec["trace_cost"]
    assert terms["term_compute_s"] == round(
        terms["flops_per_device"] / 989e12, 6)
    assert terms["bytes_per_device"] is None


def test_long_500k_skipped_for_full_attention():
    rec = dryrun.run_cell("lm_350m", "long_500k", "single", device="cpu")
    assert rec["status"] == "skipped"
    assert "O(S^2)" in rec["reason"]


def test_moe_routing_gap_is_an_error():
    rec = dryrun.run_cell(
        "phi35_moe", "train_4k", "single", device="cpu",
        cfg=checks._f32("phi35_moe"),
        mesh_spec=((2, 2), checks.DRYRUN_AXES[2]),
        shape={"kind": "train", "seq_len": 16, "global_batch": 8})
    assert rec["status"] == "error"
    assert rec["error"].startswith("NotImplementedError: routing groups")
    assert "span the ranks' batch rows" in rec["error"]
    assert "moe.py" in rec["traceback"]


def test_cli_writes_only_under_out_and_imports_no_jax(tmp_path):
    out = tmp_path / "out"
    committed = os.path.join(REPO, "benchmarks", "dryrun_results")
    before = sorted(os.listdir(committed))
    code = (
        "import sys; from repro_torch.launch import dryrun; "
        f"dryrun.main(['--arch', 'lm_8b', '--cell', 'long_500k', "
        f"'--out', {str(out)!r}]); "
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "lm_8b long_500k single sgd: skipped" in run.stdout
    files = [p.relative_to(tmp_path) for p in tmp_path.rglob("*")
             if p.is_file()]
    assert [str(f) for f in files] == [
        os.path.join("out", "lm_8b__long_500k__single.json")]
    rec = json.loads((out / "lm_8b__long_500k__single.json").read_text())
    assert rec["status"] == "skipped"
    assert sorted(os.listdir(committed)) == before


def test_collective_counter_follows_the_reference_s_operands():
    """Each c10d op and functional collective by the reference's kind
    names and operand convention (``repro/launch/hlo_cost.py:64-70``):
    an all-gather's operand is the rank's block, a reduce-scatter's the
    whole input, an all-reduce's the tensor; the port's broadcast under
    its own kind."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    from repro_torch import compat
    from repro_torch.launch import hlo_cost

    with compat.fake_world(4):
        t = torch.zeros(6, 5)
        counter = hlo_cost.CollectiveCounter()
        with counter:
            dist.all_reduce(t)
            dist.all_gather([torch.empty_like(t) for _ in range(4)], t)
            dist.all_gather_into_tensor(torch.empty(24, 5), t)
            dist.reduce_scatter_tensor(torch.empty(6, 5), torch.zeros(24, 5))
            dist.broadcast(t, 0)
            funcol.all_reduce(t, "sum", dist.group.WORLD).wait()
        stats = counter.stats()
    one = 6 * 5 * 4
    assert stats == {
        "all-gather": {"count": 2, "operand_bytes": 2.0 * one},
        "all-reduce": {"count": 2, "operand_bytes": 2.0 * one},
        "reduce-scatter": {"count": 1, "operand_bytes": 4.0 * one},
        "broadcast": {"count": 1, "operand_bytes": 1.0 * one},
    }
    assert list(stats) == [k for k in hlo_cost.COLLECTIVES if k in stats]
