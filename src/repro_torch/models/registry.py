"""Architecture registry (``repro/models/registry.py``): config lookup,
parameter init and the loss. The port registers lm_350m (dense),
recurrentgemma_2b (hybrid: RG-LRU and local attention) and rwkv6_3b (ssm:
RWKV-6); the other
architectures, input specs and serve-step builders wait."""

from __future__ import annotations

import importlib
from typing import Dict

import torch

from .. import compat
from . import transformer
from .config import ModelConfig

ARCH_IDS = ("lm_350m", "recurrentgemma_2b", "rwkv6_3b")


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise ValueError(f"arch {arch!r} is not ported; have {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}").CONFIG


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> Dict[str, torch.Tensor]:
    """Fresh parameters as a flat dict of tensors on ``device``, drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed`` (the same seed
    gives other numbers on the CPU than on the card)."""
    dev = compat.resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        model = transformer.TransformerLM(cfg, generator, device=dev)
    return {k: v.detach() for k, v in model.named_parameters()}


def loss_fn(cfg: ModelConfig, params, batch) -> torch.Tensor:
    return transformer.loss_fn(cfg, params, batch)
