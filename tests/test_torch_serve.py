"""The port's serve runtime (``repro_torch/launch/{steps,serve}.py``) on
the CPU: the cases of ``tests/test_serve.py`` on the port, and the port's
schedulers against the reference's.

- chunk scheduling; the slot pool's layout; chunked prefill refused for
  models that are not token-only decoders;
- continuous batching token for token the static waves for the dense,
  ssm and hybrid families, with mixed lengths, slot reuse and staggered
  arrivals; the continuous scheduler and the wave API token for token the
  greedy oracle (``prefill`` + ``decode_step``, dense); a reused scheduler
  the same as a fresh one; EOS in both schedulers; build counts flat under
  arbitrary traffic after a bucket warm-up; uneven ``max_new``; a request
  too long refused; recovery from a fault through ``reset_slots``;
- the port's ``ContinuousBatchingScheduler`` emits the reference's tokens
  for the same requests (reduced stablelm_3b, f32, the reference's
  parameters through ``convert.params_from_jax``), and for reduced
  phi35_moe with the reference MoE test's power-of-two prompts (MoE
  capacity depends on the chunk, so chunked prefill equals full prefill
  only for a prompt that fits one chunk);
- MoE routing per slot: a slot decode step's logits for a slot are
  bitwise the same whatever token the other slot holds, which a decode
  routing both slots as one group fails;
- ``python -m repro_torch.launch.serve --device cpu`` prints the
  reference's JSON line.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    BatchScheduler, ContinuousBatchingScheduler, Request, StaticWaveScheduler,
    chunk_schedule)
from repro_torch.models import moe, registry  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one intra-op thread, so this file's tests do not crowd
    out the suite's other workers; the worker's count comes back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_PARAMS = {}


def _model(arch, seed=0):
    cfg = registry.get_config(arch).reduced()
    key = (arch, seed)
    if key not in _PARAMS:
        _PARAMS[key] = registry.init_params(cfg, seed=seed, device="cpu")
    return cfg, _PARAMS[key]


def _mkreqs(cfg, seed, lens, max_new, arrivals=None, cls=Request):
    rng = np.random.default_rng(seed)
    return [cls(rid=i,
                prompt=rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32),
                max_new=max_new,
                arrival=(arrivals[i] if arrivals else 0.0))
            for i, n in enumerate(lens)]


def _oracle(cfg, params, prompt, max_new, max_len):
    """Greedy reference: full prefill, then one decode step at a time
    (``steps.make_prefill_step``, ``make_decode_step``)."""
    prefill = steps.make_prefill_step(cfg, max_len=max_len)
    decode = steps.make_decode_step(cfg)
    last, caches = prefill(params, {"tokens": torch.from_numpy(prompt)[None]})
    out, tok = [], torch.argmax(last, -1)[:, None].to(torch.int32)
    for _ in range(max_new):
        out.append(int(tok[0, 0]))
        logits, caches = decode(params, tok, caches)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    return out


# ---------------------------------------------------------------------------
# chunk scheduling and the slot pool
# ---------------------------------------------------------------------------


def test_chunk_schedule_exact_binary_decomposition():
    for n in range(1, 100):
        for cmax in (1, 4, 8, 16, 31):
            chunks = chunk_schedule(n, cmax)
            assert sum(chunks) == n  # exact: no padding
            assert all(c & (c - 1) == 0 for c in chunks)  # powers of two
            assert all(c <= cmax for c in chunks)
            assert chunks == sorted(chunks, reverse=True)  # largest first
    buckets = {c for n in range(1, 1000) for c in chunk_schedule(n, 16)}
    assert buckets <= {1, 2, 4, 8, 16}


def test_chunk_schedule_rejects_degenerate():
    with pytest.raises(ValueError):
        chunk_schedule(0, 8)
    with pytest.raises(ValueError):
        chunk_schedule(5, 0)


@pytest.mark.parametrize("arch", ["stablelm_3b", "rwkv6_3b",
                                  "recurrentgemma_2b", "phi35_moe"])
def test_slot_pool_layout(arch):
    cfg = registry.get_config(arch).reduced()
    slots, max_len = 3, 16
    pool = registry.init_slot_pool(cfg, slots, max_len, device="cpu")
    dims = registry.cache_batch_dims(cfg)
    axes = registry.slot_vmap_axes(cfg)
    assert len(pool) == len(dims) == len(axes) == cfg.num_layers
    for layer, ld, la in zip(pool, dims, axes):
        assert set(layer) == set(ld) == set(la)
        for name, leaf in layer.items():
            if ld[name] == registry.POS_LEAF:
                assert leaf.shape == (slots,)  # one position a slot
            else:
                assert leaf.shape[ld[name]] == slots
            assert leaf.shape[la[name]] == slots
    assert registry.slot_pool_bytes(cfg, slots, max_len) == sum(
        t.numel() * t.element_size() for layer in pool for t in layer.values())


def test_chunk_prefill_fn_rejects_non_decoder():
    cfg = registry.get_config("stablelm_3b").reduced()
    for bad in (dataclasses.replace(cfg, is_encoder_decoder=True),
                dataclasses.replace(cfg, family="vlm"),
                registry.get_config("llava_next_34b").reduced()):
        with pytest.raises(ValueError):
            registry.make_chunk_prefill_fn(bad)


# ---------------------------------------------------------------------------
# token identity: continuous == static waves == greedy oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["stablelm_3b", "rwkv6_3b",
                                  "recurrentgemma_2b"])
def test_continuous_token_identical_to_static(arch):
    """Mixed prompt lengths, more requests than slots (slot reuse) and
    staggered arrivals (mid-stream admission) change no token."""
    cfg, params = _model(arch)
    lens = [6, 13, 8, 3, 9, 5]
    arrivals = [i * 2e-4 for i in range(len(lens))]
    cont = ContinuousBatchingScheduler(cfg, params, slots=2, max_len=32,
                                       chunk=8)
    stat = StaticWaveScheduler(cfg, params, batch=2, max_len=32, chunk=8)
    out_c = cont.run(_mkreqs(cfg, 0, lens, 6, arrivals))
    out_s = stat.run(_mkreqs(cfg, 0, lens, 6, arrivals))
    assert out_c == out_s
    assert all(len(v) == 6 for v in out_c.values())


def test_moe_single_chunk_token_identical():
    """MoE capacity is per forward, so chunked prefill matches full
    prefill only when a prompt fits one chunk: the reference's MoE case
    uses power-of-two prompts no longer than the chunk."""
    cfg, params = _model("phi35_moe")
    lens = [8, 4, 16, 8, 2]
    cont = ContinuousBatchingScheduler(cfg, params, slots=2, max_len=32,
                                       chunk=16)
    stat = StaticWaveScheduler(cfg, params, batch=2, max_len=32, chunk=16)
    out_c = cont.run(_mkreqs(cfg, 0, lens, 5))
    out_s = stat.run(_mkreqs(cfg, 0, lens, 5))
    assert out_c == out_s
    assert all(len(v) == 5 for v in out_c.values())


def _two_slot_pool(cfg, params):
    """A 2-slot pool with a prompt chunked into each slot, and the tokens
    that follow them."""
    pool = registry.init_slot_pool(cfg, 2, 24, device="cpu")
    step = steps.make_slot_chunk_step(cfg)
    rng = np.random.default_rng(4)
    nxt = []
    for slot, n in ((0, 8), (1, 4)):
        prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (n,))
                                  .astype(np.int32))
        tok, pool = step(params, pool, torch.tensor([slot]), prompt,
                         torch.tensor(0, dtype=torch.int32),
                         torch.tensor(True))
        nxt.append(int(tok))
    return pool, nxt


def _slot_logits(cfg, params, pool, tokens):
    """The slot decode's logits: per-row routing, as ``launch.steps``'s
    slot steps take it."""
    from torch.utils import _pytree as pytree

    decode = registry.make_decode_fn(cfg, route_rows=True)
    with torch.no_grad():
        logits, _ = decode(params, torch.tensor(tokens, dtype=torch.int32)[
            :, None], pytree.tree_map(torch.clone, pool))
    return logits


def test_moe_decode_routes_each_slot_alone(monkeypatch):
    """A decode step's logits for one slot do not depend on the token the
    other slot holds: the decode routes each row as its own group of one
    token, as the reference's batch-1 decode of each slot. Routed as one
    group (``moe.apply``'s own grouping; capacity 1 an expert for two
    tokens at top 2 of 4), the first row's choices take the slots and the
    second row's are dropped where they meet them, so some token in slot 0
    changes slot 1's logits."""
    cfg, params = _model("phi35_moe")
    pool, (a, b) = _two_slot_pool(cfg, params)
    base = _slot_logits(cfg, params, pool, [a, b])
    for other in range(16):
        got = _slot_logits(cfg, params, pool, [a, other])
        assert torch.equal(got[0], base[0])
        got = _slot_logits(cfg, params, pool, [other, b])
        assert torch.equal(got[1], base[1])
    # the steps decode per slot
    tokens = torch.tensor([[a], [b]], dtype=torch.int32)
    from torch.utils import _pytree as pytree
    steps.make_slot_decode_step(cfg)(params, tokens,
                                     pytree.tree_map(torch.clone, pool))
    assert torch.equal(tokens[:, 0], torch.argmax(base, -1).to(torch.int32))
    # the control: the same decode routing both rows as one group
    apply = moe.apply
    monkeypatch.setattr(moe, "apply", lambda cfg, p, x, group_size=None:
                        apply(cfg, p, x))
    joint = _slot_logits(cfg, params, pool, [a, b])
    assert any(not torch.equal(
        _slot_logits(cfg, params, pool, [other, b])[1], joint[1])
        for other in range(16))


def test_continuous_matches_greedy_oracle():
    cfg, params = _model("stablelm_3b")
    lens, max_new, max_len = [6, 11, 4], 5, 24
    reqs = _mkreqs(cfg, 0, lens, max_new)
    results = ContinuousBatchingScheduler(cfg, params, slots=2,
                                          max_len=max_len, chunk=8).run(reqs)
    for r in reqs:
        assert results[r.rid] == _oracle(cfg, params, r.prompt, max_new,
                                         max_len), f"request {r.rid}"


def test_slot_reuse_is_clean():
    """A scheduler reused for a second batch (slots zero-reset on
    admission, no reallocation) emits what a fresh one does."""
    cfg, params = _model("rwkv6_3b")
    lens = [7, 5, 12]
    sched = ContinuousBatchingScheduler(cfg, params, slots=2, max_len=24,
                                        chunk=8)
    sched.run(_mkreqs(cfg, 9, [10, 3], 6))  # dirty the pool
    reused = sched.run(_mkreqs(cfg, 0, lens, 6))
    fresh = ContinuousBatchingScheduler(cfg, params, slots=2, max_len=24,
                                        chunk=8).run(_mkreqs(cfg, 0, lens, 6))
    assert reused == fresh


def test_recovery_after_a_fault():
    """A fault mid-run (``fault_hook`` raising): ``reset_slots`` and the
    unfinished requests submitted again finish with the tokens of an
    undisturbed run, with no step built again after a bucket warm-up."""
    cfg, params = _model("recurrentgemma_2b")
    lens = [9, 4, 7]
    want = ContinuousBatchingScheduler(cfg, params, slots=2, max_len=24,
                                       chunk=8).run(_mkreqs(cfg, 0, lens, 5))

    fault_at = []

    def hook(step):
        if fault_at and step == fault_at[0]:
            raise RuntimeError("simulated fault")

    sched = ContinuousBatchingScheduler(cfg, params, slots=2, max_len=24,
                                        chunk=8, fault_hook=hook)
    sched.run(_mkreqs(cfg, 1, [15], 2))  # every bucket built: {8, 4, 2, 1}
    fault_at.append(sched.step_index + 6)
    reqs = _mkreqs(cfg, 0, lens, 5)
    with pytest.raises(RuntimeError, match="simulated"):
        sched.run(reqs)
    builds = (sched.prefill_traces, sched.decode_traces)
    sched.reset_slots()
    again = [dataclasses.replace(r, generated=[], done=False, t_first=None,
                                 t_done=None, token_times=[])
             for r in reqs if not r.done]
    got = {r.rid: r.generated for r in reqs if r.done}
    got.update(sched.run(again))
    assert got == want
    assert (sched.prefill_traces, sched.decode_traces) == builds


def test_cross_package_continuous_batching():
    """The port's continuous scheduler emits the reference's tokens for the
    same requests, from the reference's parameters (reduced stablelm_3b,
    f32)."""
    jax = pytest.importorskip("jax")
    from repro.launch import serve as jserve
    from repro.models import registry as jreg
    from repro_torch import convert

    jcfg = jreg.get_config("stablelm_3b").reduced()
    cfg = registry.get_config("stablelm_3b").reduced()
    jparams = jreg.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(cfg, jax.device_get(jparams),
                                     device="cpu")
    lens, arrivals = [6, 13, 3, 9], [0.0, 0.0, 1e-4, 2e-4]
    want = jserve.ContinuousBatchingScheduler(
        jcfg, jparams, slots=2, max_len=24, chunk=8).run(
            _mkreqs(jcfg, 0, lens, 6, arrivals, cls=jserve.Request))
    got = ContinuousBatchingScheduler(cfg, params, slots=2, max_len=24,
                                      chunk=8).run(
        _mkreqs(cfg, 0, lens, 6, arrivals))
    assert got == want


def test_cross_package_moe_continuous_batching():
    """The reference MoE test's requests (power-of-two prompts no longer
    than the chunk) through both packages' continuous schedulers, from the
    reference's parameters (reduced phi35_moe, f32): the same tokens."""
    jax = pytest.importorskip("jax")
    from repro.launch import serve as jserve
    from repro.models import registry as jreg
    from repro_torch import convert

    jcfg = jreg.get_config("phi35_moe").reduced()
    cfg = registry.get_config("phi35_moe").reduced()
    jparams = jreg.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(cfg, jax.device_get(jparams),
                                     device="cpu")
    lens = [8, 4, 16, 8, 2]
    want = jserve.ContinuousBatchingScheduler(
        jcfg, jparams, slots=2, max_len=32, chunk=16).run(
            _mkreqs(jcfg, 0, lens, 5, cls=jserve.Request))
    got = ContinuousBatchingScheduler(cfg, params, slots=2, max_len=32,
                                      chunk=16).run(_mkreqs(cfg, 0, lens, 5))
    assert got == want


# ---------------------------------------------------------------------------
# EOS termination
# ---------------------------------------------------------------------------


def test_eos_stops_slot_and_masks_further_tokens():
    cfg, params = _model("stablelm_3b")
    lens, max_new = [6, 9], 8
    out = ContinuousBatchingScheduler(cfg, params, slots=2, max_len=32,
                                      chunk=8).run(_mkreqs(cfg, 0, lens,
                                                           max_new))
    eos, cut = out[0][3], 3
    cfg_eos = dataclasses.replace(cfg, eos_id=eos)
    sched = ContinuousBatchingScheduler(cfg_eos, params, slots=2, max_len=32,
                                        chunk=8)
    reqs = _mkreqs(cfg_eos, 0, lens, max_new)
    out_eos = sched.run(reqs)
    assert out_eos[0] == out[0][:out[0].index(eos) + 1]
    assert len(out_eos[0]) <= cut + 1 and out_eos[0][-1] == eos
    assert reqs[0].done and reqs[0].t_done is not None
    expect_1 = out[1]
    if eos in expect_1:
        expect_1 = expect_1[:expect_1.index(eos) + 1]
    assert out_eos[1] == expect_1


def test_eos_in_static_scheduler():
    cfg, params = _model("stablelm_3b")
    out = StaticWaveScheduler(cfg, params, batch=2, max_len=24,
                              chunk=8).run(_mkreqs(cfg, 0, [6, 6], 6))
    eos = out[0][2]
    cfg_eos = dataclasses.replace(cfg, eos_id=eos)
    out_eos = StaticWaveScheduler(cfg_eos, params, batch=2, max_len=24,
                                  chunk=8).run(_mkreqs(cfg_eos, 0, [6, 6], 6))
    assert out_eos[0] == out[0][:out[0].index(eos) + 1]


# ---------------------------------------------------------------------------
# flat build counts (the steady-state invariant)
# ---------------------------------------------------------------------------


def test_trace_counts_flat_under_arbitrary_traffic():
    """After a bucket warm-up the step set is fixed: mixed lengths,
    mid-stream admission and slot reuse build no step again."""
    cfg, params = _model("stablelm_3b")
    sched = ContinuousBatchingScheduler(cfg, params, slots=2, max_len=32,
                                        chunk=8)
    sched.run(_mkreqs(cfg, 1, [15, 15, 15], 4))  # touches {8, 4, 2, 1}
    warm = (sched.prefill_traces, sched.decode_traces)
    assert warm[0] == len(chunk_schedule(15, 8))  # one build a bucket
    assert warm[1] == 1
    sched.run(_mkreqs(cfg, 2, [1, 9, 3, 14, 6, 2, 11], 5,
                      arrivals=[i * 1e-4 for i in range(7)]))
    assert (sched.prefill_traces, sched.decode_traces) == warm


def test_static_trace_counts_flat():
    cfg, params = _model("stablelm_3b")
    sched = StaticWaveScheduler(cfg, params, batch=2, max_len=32, chunk=8)
    sched.run(_mkreqs(cfg, 1, [15, 15], 4))
    warm = (sched.prefill_traces, sched.decode_traces)
    sched.run(_mkreqs(cfg, 2, [3, 9, 6, 13], 5))
    assert (sched.prefill_traces, sched.decode_traces) == warm


# ---------------------------------------------------------------------------
# the wave API (BatchScheduler, run_wave); limits; the CLI
# ---------------------------------------------------------------------------


def test_wave_greedy_matches_manual_decode():
    cfg, params = _model("stablelm_3b")
    max_new, max_len = 5, 11
    reqs = _mkreqs(cfg, 0, [6, 6], max_new)
    results = BatchScheduler(cfg, params, batch=2, max_len=max_len).run_wave(
        reqs)
    for r in reqs:
        assert results[r.rid] == _oracle(cfg, params, r.prompt, max_new,
                                         max_len), f"request {r.rid}"


def test_wave_handles_uneven_max_new():
    cfg, params = _model("rwkv6_3b", seed=1)
    rng = np.random.default_rng(1)
    reqs = [Request(rid=0, prompt=rng.integers(0, cfg.vocab_size, (4,))
                    .astype(np.int32), max_new=2),
            Request(rid=1, prompt=rng.integers(0, cfg.vocab_size, (4,))
                    .astype(np.int32), max_new=6)]
    results = BatchScheduler(cfg, params, batch=2, max_len=12).run_wave(reqs)
    assert len(results[0]) == 2
    assert len(results[1]) == 6


def test_request_too_long_rejected():
    cfg, params = _model("stablelm_3b")
    sched = ContinuousBatchingScheduler(cfg, params, slots=2, max_len=8)
    with pytest.raises(ValueError):
        sched.run(_mkreqs(cfg, 0, [7], 4))


def test_serve_cli_prints_the_reference_line(capsys):
    serve.main(["--arch", "recurrentgemma_2b", "--reduced", "--requests", "3",
                "--slots", "2", "--prompt-len", "5", "--max-new", "3",
                "--chunk", "4", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["generated_tokens"] == 9
    assert line["prefill_traces"] == len(chunk_schedule(5, 4))
    assert line["decode_traces"] == 1
    assert line["pool_mb"] > 0
    assert set(line) == {"arch", "scheduler", "requests", "generated_tokens",
                         "wall_s", "tokens_per_s", "ttft_p50_s",
                         "prefill_traces", "decode_traces", "pool_mb"}
