"""Shared machinery of the variants scripts (k2_variants.py, k4_variants.py,
k5_variants.py, gsdm_variants.py): copy a kernel's sources and the headers
into a temporary directory, apply text edits to them, build with nvcc and
bind the entry points with ctypes; time the builds in turns.

A variant's edits are (file, old text, new text) triples; each must match
exactly once or more, or the build raises, so that a variant whose text has
moved away fails instead of timing the unedited kernel.
"""

import concurrent.futures
import ctypes
import json
import shutil
from pathlib import Path

import torch

from multimodal_particles_tpu_torch.ops import _build
from port_kernel_bits import ERROR_STRING_STUB

CSRC = Path(__file__).resolve().parents[1] / "multimodal_particles_tpu_torch" / "ops" / "csrc"


def build(name, csrc, sources, edits, bind, workdir):
    """`sources` (.cu files) of `csrc` with the headers, `edits` applied,
    built into workdir/name; `bind(lib, src)` sets the entry points'
    argument types (and whatever the scripts read of the build) from the
    edited sources in `src`: (name, lib). lib.text holds the first source's
    text (the scripts read which design a build is from it), lib.ptxas the
    register and spill lines of ptxas -v."""
    here = workdir / name.replace(":", "_")
    src = here / "csrc"
    src.mkdir(parents=True)
    for path in [*(csrc / s for s in sources), *csrc.glob("*.cuh")]:
        shutil.copy(path, src / path.name)
    for file, old, new in edits:
        text = (src / file).read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: its edit no longer matches {file}:\n{old}")
        (src / file).write_text(text.replace(old, new))
    (src / "error_string.cu").write_text(ERROR_STRING_STUB)
    objects, log = [], ""
    for cu in (*sources, "error_string.cu"):
        obj = here / f"{cu}.o"
        log += _build._run([_build.find_nvcc(), *_build.COMPILE_FLAGS, "-c", str(src / cu), "-o",
                            str(obj)])[0]
        objects.append(str(obj))
    library = here / "libvariant.so"
    _build._run([_build.find_nvcc(), *_build.ARCH_FLAGS, "-shared", "-o", str(library), *objects])
    lib = ctypes.CDLL(str(library))
    lib.text = (src / sources[0]).read_text()
    bind(lib, src)
    lib.mmp_error_string.argtypes, lib.mmp_error_string.restype = [ctypes.c_int], ctypes.c_char_p
    lib.ptxas = [line.split("info    : ")[-1].strip() for line in log.splitlines()
                 if "registers" in line or "spill" in line]
    return name, lib


def build_all(builds, sources, bind, workdir):
    """Every build of `builds` (name → (csrc, edits)) at once, one thread
    each: name → lib."""
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        return dict(pool.map(lambda item: build(item[0], item[1][0], sources, item[1][1], bind,
                                                workdir), builds.items()))


def bind_entries(lib, entries):
    """Set each entry point's argument types: entry → argtypes."""
    for entry, argtypes in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int


def time_in_turns(libs, run, cuda_ms, iters):
    """Each library's CUDA-event mean of `run(lib)` in two turns, forward then
    backward order: name → [ms, ms]."""
    order = list(libs) + list(libs)[::-1]
    times = {name: [] for name in libs}
    for name in order:
        _build.load_library = lambda lib=libs[name]: lib
        times[name].append(cuda_ms(lambda: run(libs[name]), iters=iters))
    return times


def emit(obj):
    print(json.dumps(obj), flush=True)


def finite(t):
    return bool(torch.isfinite(t).all().item())
