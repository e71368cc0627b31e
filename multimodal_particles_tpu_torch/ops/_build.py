"""Builds the hand-written CUDA kernels at first use and loads them with ctypes.

`nvcc` compiles every `ops/csrc/*.cu` for Hopper (`sm_90a`), one process per
source in parallel, and links the objects into one shared library with a
plain C interface, in `ops/build/` (git-ignored). The library
is rebuilt when a source or header is newer than it. Sources that share
device code include a header: epic_forward.cuh (the narrow EPiC layout),
narrow_tc.cuh (the per-warp tensor-core products and the buffer of the narrow
forward, the sampler step and the narrow backward; epic_forward_kernel.cuh the
forward kernel, its two instantiations and the backward's rerun),
epic_wide.cuh (the wide ones and the tiled products; epic_wide_any.cuh the
clusters, instantiated a source a width and, past 128 slots, a source a width
with two row blocks: epic_wide_{forward,backward}_h*{,_r2}.cu), gsdm_blocks.cuh (the
(ResnetBlock, AttnBlock) stack of the survival head and the gsdm stack, whose
kernels survival_head.cuh and gsdm_stack.cuh instantiate, a source a
transformer width) and
tf32x3.cuh (tensor-core products at fp32 accuracy, for every kernel that
runs its products on the tensor cores). No fast-math: the
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
    # dims[10]: EpicDims.c_array (ops/epic_cuda.py)
    # the buffer of K1 and K2 (ops/epic_cuda.py::narrow_buffer), t, x, k (int tokens; the
    # _fold entry: float channel values, for a layout that folds the discrete input), mask,
    # out, hidden out (or null), B, N, dims[10], stream
    "mmp_epic_forward": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    "mmp_epic_forward_fold": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    # the buffer of K1 and K2 (ops/epic_cuda.py::narrow_buffer), x, k, mask, u,
    # x_out, k_out, t, dt, gamma, B, N, dims[10], stream
    "mmp_sampler_step": [_P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _I, _I, _P, _P],
    # B, N, dims[10], &grid (int), &scratch floats (long long)
    "mmp_epic_backward_workspace": [_I, _I, _P, _P, _P],
    # the buffer (ops/epic_cuda.py::narrow_buffer), weights, t, x, k, mask,
    # g, d_weights, the rerun's out (or null), scratch, grid, B, N, dims[10], stream
    "mmp_epic_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    # the wide pair (hidden, global and embedding widths 128 to 512, N ≤ 256) takes the
    # narrow one's arguments; the forward also the tensor-core stages and
    # local_0's tables after the weights, the backward those and the
    # transposed stages
    "mmp_epic_wide_forward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    "mmp_epic_wide_backward_workspace": [_I, _I, _P, _P, _P],
    "mmp_epic_wide_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
    # weights, tensor-core stream, temb_proj (n_blocks, B, C), last (B, N, Dh),
    # mask (B, N), out (B, N), scratch (grid, 2, 128, 132), grid, B, N, Dh,
    # n_blocks, n_heads, C, stream
    "mmp_survival_head": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # weights, tensor-core stream, temb_proj (n_blocks, B, C), x (B, N, Din),
    # out (B, N, C), scratch (grid, 2, 128, 132), grid, B, N, Din, n_blocks,
    # n_heads, C, stream
    "mmp_gsdm_stack": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, mask (B, N) or null, out (B, N, C), grid, B, N, C, n_heads, stream
    "mmp_attention_core": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float  # 0.0 when an up-to-date library was found
    log: str  # nvcc's output (ptxas register and shared-memory report)
    source_seconds: dict  # nvcc seconds per source file (empty when up to date)


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
        return BuildResult(out, 0.0, "", {})
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    tmp = out.with_name(f"{LIB_NAME}.{tag}")
    start = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        runs = list(pool.map(
            lambda so: _run([nvcc, *COMPILE_FLAGS, "-c", str(so[0]), "-o", str(so[1])]),
            zip(sources, objects),
        ))
    runs.append(_run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]))
    seconds = time.perf_counter() - start
    os.replace(tmp, out)
    for obj in objects:
        obj.unlink()
    log = "".join(text for text, _ in runs)
    (BUILD_DIR / "nvcc.log").write_text(log)
    per_source = {src.name: sec for src, (_, sec) in zip(sources, runs)}
    return BuildResult(out, seconds, log, per_source)


def _run(cmd):
    """Run nvcc; (its output, seconds)."""
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    return proc.stdout + proc.stderr, time.perf_counter() - start


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
