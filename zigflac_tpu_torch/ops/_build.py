"""Build the package's native code at first use: the CUDA kernels with nvcc,
bound with ctypes, and the C++ host runtime with g++, loaded as a module.

``csrc/*.cu`` compiles into one C-ABI shared library (``library()``), and
``native/zf_native.cpp`` (the frame bit parser and the all-C++ decode path)
into a CPython extension (``native_module()``), both under
``build/zigflac_tpu_torch/`` at the repository root and named by a hash of
their sources and flags, so a process builds each at most once and a
rebuilt source never loads a stale binary. Nothing here runs at import
time: the CPU tests import every module of the package on machines with no
nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zigflac_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "--threads", "0",  # one compile job per source, all started together
)
NATIVE_SOURCE = Path(__file__).resolve().parents[2] / "native" / "zf_native.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lib = None
# this process's nvcc run, if it ran one: wall seconds; and the output of
# the run that built the loaded library (ptxas reports each kernel's
# registers, shared memory and spills), kept beside it
BUILD_SECONDS = None
BUILD_LOG = ""
_native = None
# this process's g++ run, if it ran one: wall seconds
NATIVE_BUILD_SECONDS = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: set CUDA_HOME or put nvcc on PATH")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _compile(cmd, out: Path):
    """Run ``cmd -o <temporary name>`` and rename the result to ``out``, so a
    reader never sees a half-written binary. Returns (wall seconds, the
    compiler's output); raises with that output if the compiler fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [*cmd, "-o", str(tmp)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return time.perf_counter() - t0, proc.stdout + proc.stderr


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
    log = out.with_suffix(".log")
    if not out.exists():
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), *map(str, sources)]
        BUILD_SECONDS, BUILD_LOG = _compile(cmd, out)
        log.write_text(BUILD_LOG)
    elif log.exists():
        BUILD_LOG = log.read_text()
    lib = ctypes.CDLL(str(out))
    lib.zf_deposit_words.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.zf_deposit_words.restype = ctypes.c_int
    lib.zf_shared_row_bytes.argtypes = []
    lib.zf_shared_row_bytes.restype = ctypes.c_int64
    lib.zf_synthesize.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2 + [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.zf_synthesize.restype = ctypes.c_int
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.zf_analyze_fixed.argtypes = [ptr, i32, i64, i64, i32, i64, i64] + [ptr] * 9
    lib.zf_analyze_fixed.restype = ctypes.c_int
    lib.zf_rice_estimate.argtypes = [ptr, ptr, i64, i64, i64, i64] + [ptr] * 5
    lib.zf_rice_estimate.restype = ctypes.c_int
    lib.zf_crc16_frames.argtypes = [ptr, ptr, i64, i64, i32, ptr, ptr]
    lib.zf_crc16_frames.restype = ctypes.c_int
    lib.zf_frame_symbols.argtypes = [ptr] * 12 + [i32] + [i64] * 3 + [ptr] + [i64] * 13 + [
        ptr] * 5
    lib.zf_frame_symbols.restype = ctypes.c_int
    lib.zf_unpack_pcm.argtypes = [ptr, ptr, i32, i32, i32, i64, i64, i64, ptr]
    lib.zf_unpack_pcm.restype = ctypes.c_int
    lib.zf_lag_sums.argtypes = [ptr, i32, i32, ptr, i64, i64, i64, i64, ptr, ptr]
    lib.zf_lag_sums.restype = ctypes.c_int
    lib.zf_error_string.argtypes = [ctypes.c_int]
    lib.zf_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def native_module():
    """The C++ host runtime built from ``native/zf_native.cpp``, compiled
    now with g++ if this source has no binary yet: ``parse_frames``,
    ``synthesize``, ``decode_frames_pcm`` and ``decode_frames_pcm_mt``.
    Raises with g++'s output if the build fails. The module is loaded from
    its file under a name of this package, so it is never mistaken for an
    ``_zf_native`` that another package imported by name."""
    global _native, NATIVE_BUILD_SECONDS
    if _native is not None:
        return _native
    include = sysconfig.get_paths()["include"]
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + NATIVE_SOURCE.read_bytes())
    suffix = sysconfig.get_config_var("EXT_SUFFIX")
    out = BUILD_DIR / f"_zf_native_{digest.hexdigest()[:16]}{suffix}"
    if not out.exists():
        cmd = ["g++", *GXX_FLAGS, "-I", include, str(NATIVE_SOURCE)]
        NATIVE_BUILD_SECONDS, _ = _compile(cmd, out)
    # the extension's init function is PyInit_<last component of the name>
    spec = importlib.util.spec_from_file_location(f"{__package__}._zf_native", out)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _native = mod
    return mod
