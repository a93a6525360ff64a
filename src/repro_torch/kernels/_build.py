"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled at first use into its own shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so
         csrc/<name>.cu

into ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``). The file name carries a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is reused. All sources are
compiled together, one nvcc process each (from a thread pool), on the
first call to :func:`library`. No fast math: the kernels must divide and
round exactly as the reference does. No source links libcuda (``-lcuda``):
``rglru_scan.cu`` and ``flash_attention_sm90.cu`` encode their TMA tensor
maps with libcuda's ``cuTensorMapEncodeTiled``, which ``common.cuh`` looks
up at run time through the CUDA runtime's ``cudaGetDriverEntryPoint``.
``-Xptxas -v`` makes nvcc report each kernel's registers, spills and shared
memory; a build keeps that report per source in ``KernelBuild.logs``, and
each source's nvcc wall seconds in ``KernelBuild.source_seconds``.

No build failure is caught: a missing nvcc or a compile error raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

from .. import compat

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("quantize", "reduce_compress", "flash_attention",
           "flash_attention_sm90", "flash_decode", "rglru_scan", "wkv6")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_C = ctypes.c_int
_FLASH_TAIL = (_C,) * 8 + (ctypes.c_float, _P)
# C signatures of the extern "C" entry points (all return cudaError_t as int).
SIGNATURES = {
    "quantize": {
        "repro_quantize": (_P, ctypes.c_int, _P, _P, _I64, _P),
        "repro_dequantize": (_P, _P, _P, ctypes.c_int, _I64, _P),
    },
    "reduce_compress": {
        "repro_reduce_compress_roundtrip": (
            _P, ctypes.c_int, _P, _P, _P, _I64, _I64, _I64, ctypes.c_float,
            _P,
        ),
        "repro_reduce_compress": (
            _P, ctypes.c_int, _P, _P, _I64, _I64, _I64, ctypes.c_float, _P,
        ),
        "repro_dequant_accumulate": (
            _P, _P, _P, _I64, _I64, ctypes.c_float, _P,
        ),
    },
    # (q, k, v, dtype, ...buffers..., B, Sq, Skv, Hq, Hkv, hd, causal,
    #  window, scale, stream)
    "flash_attention": {
        "repro_flash_fwd": (_P, _P, _P, _C, _P, _P, _P, *_FLASH_TAIL),
        "repro_flash_bwd_dq": (_P, _P, _P, _C, _P, _P, _P, _P, _P,
                               *_FLASH_TAIL),
        "repro_flash_bwd_dkdv": (_P, _P, _P, _C, _P, _P, _P, _P, _P, _P,
                                 *_FLASH_TAIL),
        "repro_flash_tc_smem": (_C, _C),
    },
    # the same signatures as repro_flash_fwd, repro_flash_bwd_dq and
    # repro_flash_bwd_dkdv (bf16 only, and no scratch); (which, hd)
    "flash_attention_sm90": {
        "repro_flash_wg_fwd": (_P, _P, _P, _C, _P, _P, _P, *_FLASH_TAIL),
        "repro_flash_wg_bwd_dq": (_P, _P, _P, _C, _P, _P, _P, _P, _P,
                                  *_FLASH_TAIL),
        "repro_flash_wg_bwd_dkdv": (_P, _P, _P, _C, _P, _P, _P, _P, _P,
                                    *_FLASH_TAIL),
        "repro_flash_wg_smem": (_C, _C),
    },
    # repro_flash_fwd's signature with the per-split scratch after lse
    # (bf16 only); (hd)
    "flash_decode": {
        "repro_flash_decode": (_P, _P, _P, _C, _P, _P, _P, _P,
                               *_FLASH_TAIL),
        "repro_flash_decode_chunk": (_C,),
    },
    # (a, b, h0, dtype, h, B, S, W, tma, stream),
    # (a, h, g, h0, dtype, da, db, dh0, B, S, W, tma, stream): tma 0 is the
    # SIMT route, 1 the TMA route; and (dtype, backward)
    "rglru_scan": {
        "repro_lru_scan_fwd": (_P, _P, _P, _C, _P, _C, _C, _C, _C, _P),
        "repro_lru_scan_bwd": (_P, _P, _P, _P, _C, _P, _P, _P, _C, _C, _C,
                               _C, _P),
        "repro_lru_ring_smem": (_C, _C),
    },
    # (r, k, v, logw, u, s0, out, states, final, dvec, B, S, H, N, stream),
    # (r, k, v, logw, u, states, final, dout, dfinal, dr, dk, dv, dlogw,
    #  ds0, dstates, dvec, du_part, du, B, S, H, N, stream) and
    # (N, int blocks[4])
    "wkv6": {
        "repro_wkv6_fwd": (_P,) * 10 + (_C,) * 4 + (_P,),
        "repro_wkv6_bwd": (_P,) * 18 + (_C,) * 4 + (_P,),
        "repro_wkv6_occupancy": (_C, _P),
    },
}


class KernelBuild:
    """Builds and loads the kernel libraries of one checkout, once."""

    def __init__(self):
        self.build_dir = BUILD_DIR
        self.build_seconds: Optional[float] = None
        self.source_seconds: Dict[str, float] = {}
        self.logs: Dict[str, str] = {}
        self._libs: Dict[str, ctypes.CDLL] = {}
        self._lock = threading.Lock()

    def _target(self, name: str) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sorted(CSRC.iterdir()):
            if src.suffix in (".cu", ".cuh"):
                h.update(src.name.encode())
                h.update(src.read_bytes())
        return self.build_dir / f"{name}-{h.hexdigest()[:16]}.so"

    def path(self, name: str) -> Path:
        """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
        return self._target(name)

    def build_all(self) -> float:
        """Compile every source whose library is missing, in parallel.
        Returns the wall seconds spent (0 if everything was built)."""
        nvcc = compat.nvcc_path()
        todo = [n for n in SOURCES if not self._target(n).exists()]
        t0 = time.perf_counter()
        if todo:
            if nvcc is None:
                raise RuntimeError(
                    "repro_torch: nvcc not found (PATH or CUDA_HOME); the "
                    "CUDA kernels cannot be built"
                )
            self.build_dir.mkdir(parents=True, exist_ok=True)

            def compile_one(name: str):
                out = self._target(name)
                tmp = out.with_suffix(f".tmp{os.getpid()}.so")
                t = time.perf_counter()
                proc = subprocess.run(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                return name, out, tmp, proc, time.perf_counter() - t

            errors = []
            with ThreadPoolExecutor(len(todo)) as pool:
                for name, out, tmp, proc, secs in pool.map(compile_one, todo):
                    self.logs[name] = proc.stdout
                    self.source_seconds[name] = secs
                    if proc.returncode != 0:
                        errors.append(f"nvcc {name}.cu failed:\n{proc.stdout}")
                    else:
                        os.replace(tmp, out)
            if errors:
                raise RuntimeError("\n".join(errors))
        self.build_seconds = time.perf_counter() - t0
        return self.build_seconds

    def library(self, name: str) -> ctypes.CDLL:
        """The loaded library of ``csrc/<name>.cu``, built at first use."""
        with self._lock:
            if name not in self._libs:
                if not compat.is_hopper():
                    raise RuntimeError(
                        "repro_torch kernels are compiled for sm_90a and need "
                        f"a compute-capability 9.x card; found "
                        f"{compat.compute_capability()}"
                    )
                if self.build_seconds is None:
                    self.build_all()
                lib = ctypes.CDLL(str(self._target(name)))
                for fn, argtypes in SIGNATURES[name].items():
                    f = getattr(lib, fn)
                    f.argtypes = list(argtypes)
                    f.restype = ctypes.c_int
                self._libs[name] = lib
            return self._libs[name]


# The process's one build of this checkout's kernels (nothing runs at import).
KERNELS = KernelBuild()


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
