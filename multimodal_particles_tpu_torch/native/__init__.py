"""The C++ substructure library, loaded through ctypes: the counterpart of
multimodal_particles_tpu/native/__init__.py:1-112.

`substructure.cpp` is built with g++ at first use into `native/build/`
(git-ignored; rebuilt when the source is newer than the library), never into
the source tree. Without a C++ toolchain `load_substructure_lib` returns None
and `substructure_batch_native` returns None, and the caller takes the numpy
version (`data/particle_clouds/substructure.py`), as in the JAX package.
"""

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "substructure.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
LIB_NAME = "libsubstructure.so"
COMPILE_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_D = ctypes.POINTER(ctypes.c_double)
_U8 = ctypes.POINTER(ctypes.c_uint8)
# pt, eta, phi, mask, B, N, R, beta, min_constituents, tau1, tau2, tau3, d2, valid
_ARGTYPES = [_D, _D, _D, _U8, ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
             ctypes.c_int, _D, _D, _D, _D, _U8]


def build_library() -> Path:
    """g++ the source into BUILD_DIR unless an up-to-date library is there; the
    library's path. Raises when g++ is missing or fails."""
    out = BUILD_DIR / LIB_NAME
    if out.exists() and out.stat().st_mtime >= SRC.stat().st_mtime:
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise FileNotFoundError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")  # concurrent builders each rename whole
    subprocess.run([gxx, *COMPILE_FLAGS, str(SRC), "-o", str(tmp)], check=True,
                   capture_output=True)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_substructure_lib():
    """The ctypes handle, building the library on first use; None when no C++
    toolchain builds it."""
    try:
        lib = ctypes.CDLL(str(build_library()))
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.substructure_batch.argtypes = _ARGTYPES
    lib.substructure_batch.restype = None
    return lib


def substructure_batch_native(pt, eta, phi, mask, R=0.8, beta=1.0, min_constituents=3):
    """τ1, τ2, τ3, D2 and `valid` (at least `min_constituents` particles with
    mask > 0 and pt > 0) for every jet of a (B, N) batch, as float64 / bool
    arrays of (B,); None when the library is missing. Jets that are not valid
    hold NaN."""
    lib = load_substructure_lib()
    if lib is None:
        return None
    pt = np.ascontiguousarray(pt, dtype=np.float64)
    eta = np.ascontiguousarray(eta, dtype=np.float64)
    phi = np.ascontiguousarray(phi, dtype=np.float64)
    mask = np.ascontiguousarray(np.asarray(mask) > 0, dtype=np.uint8)
    if pt.ndim != 2 or not (pt.shape == eta.shape == phi.shape == mask.shape):
        raise ValueError(f"pt, eta, phi and mask must be (B, N) alike: {pt.shape}, "
                         f"{eta.shape}, {phi.shape}, {mask.shape}")
    B, N = pt.shape
    tau1, tau2, tau3, d2 = (np.empty(B) for _ in range(4))
    valid = np.empty(B, dtype=np.uint8)
    lib.substructure_batch(
        pt.ctypes.data_as(_D), eta.ctypes.data_as(_D), phi.ctypes.data_as(_D),
        mask.ctypes.data_as(_U8), B, N, R, beta, min_constituents,
        tau1.ctypes.data_as(_D), tau2.ctypes.data_as(_D), tau3.ctypes.data_as(_D),
        d2.ctypes.data_as(_D), valid.ctypes.data_as(_U8),
    )
    return {"tau1": tau1, "tau2": tau2, "tau3": tau3, "d2": d2, "valid": valid.astype(bool)}
