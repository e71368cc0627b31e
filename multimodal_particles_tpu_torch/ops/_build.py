"""Builds the hand-written CUDA kernels at first use and loads them with ctypes.

`nvcc` compiles every `ops/csrc/*.cu` for Hopper (`sm_90a`), one process per
source in parallel, and links the objects into one shared library with a
plain C interface, in `ops/build/` (git-ignored). The library
is rebuilt when a source or header is newer than it. No fast-math: the
telegraph update divides by 1 − exp(−Sγ(1−t)), which is about 1e-4 at the
last step, and its jump decisions must follow the accurate `expf`.
"""

import concurrent.futures
import ctypes
import dataclasses
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
LIB_NAME = "libmmp_kernels.so"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points (ops/csrc/*.cu) and their argument types; every pointer and
# the stream are c_void_p so that 64-bit addresses are not truncated.
_SIGNATURES = {
    # weights, t, x, k, mask, out, B, N, dims[8], stream
    "mmp_epic_forward": [_P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    # weights, x, k, mask, u, x_out, k_out, t, dt, gamma, B, N, dims[8], stream
    "mmp_sampler_step": [_P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _I, _I, _P, _P],
}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when an up-to-date library was found
    log: str  # nvcc's output (ptxas register and shared-memory report)


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA kernels of "
        "multimodal_particles_tpu_torch.ops are built at first use with the CUDA toolkit"
    )


def build_library() -> BuildResult:
    sources = sorted(CSRC_DIR.glob("*.cu"))
    newest = max(p.stat().st_mtime for p in sources + sorted(CSRC_DIR.glob("*.cuh")))
    out = BUILD_DIR / LIB_NAME
    if out.exists() and out.stat().st_mtime >= newest:
        return BuildResult(out, 0.0, "")
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    tmp = out.with_name(f"{LIB_NAME}.{tag}")
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        logs = list(pool.map(
            lambda so: _run([nvcc, *COMPILE_FLAGS, "-c", str(so[0]), "-o", str(so[1])]),
            zip(sources, objects),
        ))
    logs.append(_run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]))
    seconds = time.perf_counter() - start
    os.replace(tmp, out)
    for obj in objects:
        obj.unlink()
    log = "".join(logs)
    (BUILD_DIR / "nvcc.log").write_text(log)
    return BuildResult(out, seconds, log)


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    return proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    lib.mmp_error_string.argtypes = [_I]
    lib.mmp_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if rc != 0:
        msg = lib.mmp_error_string(rc).decode()
        raise RuntimeError(f"{what} failed: CUDA error {rc} ({msg})")
