"""The CUDA kernels against their plain versions, on a card.

Marked ``cuda``: they skip without a compute-capability 9.x card (the
decision is made inside the fixture). The file imports no JAX, so it runs
on a card machine without one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import compat  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


@pytest.fixture
def card():
    if not compat.is_hopper():
        pytest.skip("needs a compute-capability 9.x CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(card, dtype):
    gen = torch.Generator(device=card).manual_seed(0)
    x = (torch.randn((1029, 256), generator=gen, device=card) * 1e-2).to(dtype)
    x[:5] = 0
    ops.reset_launches()
    q, s = ops.quantize(x)
    qr, sr = ref.quantize_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(ops.dequantize(q, s, dtype), ref.dequantize_ref(q, s, dtype))
    x4 = (torch.randn((2, 3, 515, 256), generator=gen, device=card)).to(dtype)
    back = ops.reduce_compress_roundtrip(x4, axis=1)
    assert torch.equal(back, ref.reduce_compress_roundtrip_ref(x4)[0])
    assert ops.launch_counts() == {
        "quantize": 1, "dequantize": 1, "reduce_compress_roundtrip": 1}


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x4 = torch.zeros((2, 3, 4, 256), device=card)
    with pytest.raises(NotImplementedError):
        ops.reduce_compress_roundtrip(x4, axis=1, qaxis=0)
    with pytest.raises(ValueError, match="256"):
        ops.quantize(torch.zeros((4, 128), device=card))
    with pytest.raises(ValueError, match="contiguous"):
        ops.quantize(torch.zeros((256, 8), device=card).t())
    with pytest.raises(TypeError):
        ops.quantize(torch.zeros((4, 256), device=card, dtype=torch.float16))


@pytest.mark.cuda
def test_round_on_card_matches_cpu(card):
    """A reduced flat int8 round: the card (kernels) and the CPU (plain
    versions) give the same loss."""
    import argparse

    from repro_torch.data.grouped import CohortSampler, GroupedCorpus
    from repro_torch.launch import train
    from repro_torch.models import registry

    args = argparse.Namespace(algorithm="local_sgd", cohort=2, local_steps=2,
                              client_lr=0.05, compression="int8")
    cfg = registry.get_config("lm_350m").reduced()
    base = registry.init_params(cfg, seed=0, device="cpu")
    sampler = CohortSampler(GroupedCorpus(vocab_size=cfg.vocab_size),
                            cohort_size=2)
    losses = {}
    for device in ("cuda", "cpu"):
        round_fn, server_opt = train.build_round_fn(cfg, args)
        params = {k: v.to(device) for k, v in base.items()}
        d = sampler.round_batch(0, 2, 2, 32, device=device)
        _, _, m = round_fn(params, server_opt.init(params),
                           {"tokens": d["tokens"], "labels": d["labels"]})
        losses[device] = float(m["loss"])
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"])
