"""Build the package's CUDA sources with nvcc and bind them with ctypes.

``csrc/*.cu`` compiles on first use into one C-ABI shared library under
``build/zigflac_tpu_torch/`` at the repository root, named by a hash of the
sources and flags, so a process builds it at most once and a rebuilt source
never loads a stale library. Nothing here runs at import time: the CPU
tests import every module of the package on machines with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zigflac_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib = None
# this process's nvcc run, if it ran one: wall seconds and output (ptxas
# reports each kernel's registers and shared memory)
BUILD_SECONDS = None
BUILD_LOG = ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: set CUDA_HOME or put nvcc on PATH")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library() -> ctypes.CDLL:
    """The built kernel library, compiled now if this source set has no
    library yet. Raises with nvcc's output if the build fails."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        digest.update(p.name.encode() + p.read_bytes())
    out = BUILD_DIR / f"zf_kernels_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        BUILD_SECONDS = time.perf_counter() - t0
        BUILD_LOG = proc.stdout + proc.stderr
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.zf_deposit_words.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.zf_deposit_words.restype = ctypes.c_int
    lib.zf_shared_row_bytes.argtypes = []
    lib.zf_shared_row_bytes.restype = ctypes.c_int64
    lib.zf_error_string.argtypes = [ctypes.c_int]
    lib.zf_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib
