"""PyTorch/CUDA port of the DrJAX reproduction (``repro``).

Laid out module for module beside the JAX package: ``repro_torch.core`` is
``repro.core``, ``repro_torch.kernels`` is ``repro.kernels`` and so on. The
port imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro``; the parity tests import both.

It ports the paper's §4 training path: DrJAX local-SGD rounds, flat and
pod-hierarchical, with int8 delta compression and straggler masks, for
the dense LM (lm_350m), the hybrid RG-LRU + local-attention LM
(recurrentgemma_2b) and the RWKV-6 LM (rwkv6_3b), on hand-written Hopper
kernels (``kernels/csrc/*.cu``). What it leaves out is listed in each
module's docstring and in ROADMAP.md.
"""

__all__ = ["compat"]


def __getattr__(name):
    # ``compat`` imports torch; loading it lazily keeps ``import
    # repro_torch.analysis.lints`` (the lint CLI) free of torch.
    if name == "compat":
        import importlib

        return importlib.import_module(".compat", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
