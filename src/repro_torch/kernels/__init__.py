"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``ops`` holds the public wrappers (CUDA tensor -> kernel, CPU tensor ->
``ref``); ``quantize``, ``reduce_compress``, ``flash_attention``,
``rglru_scan`` and ``wkv6`` launch the CUDA C++ kernels in
``csrc/`` that ``_build`` compiles with nvcc for ``sm_90a`` at first use.
Nothing is built or loaded at import time.
"""

from . import ops, ref

__all__ = ["ops", "ref"]
