"""Shared machinery of the variants scripts (k1_variants.py, k2_variants.py,
k4_variants.py, k5_variants.py, gsdm_variants.py): copy a kernel's sources
and the headers into a temporary directory, apply text edits to them, build
with nvcc and bind the entry points with ctypes; time the builds in turns.
The edits of the per-warp tensor-core machinery that K1 and K2 share
(ops/csrc/narrow_tc.cuh) are here, for both scripts.

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

NARROW_TC = "narrow_tc.cuh"
# variant → edits of narrow_tc.cuh, the same for K1 and K2:
#   no_products  the per-particle products' mma skipped
#   no_jet_mlp   the per-jet vector-matrix products skipped (`dense*`)
#   one_product  a_hi·w_hi alone, the 3×TF32 split's two small products left out
#   three_blocks, five_blocks  registers bounded for three or five blocks an SM
#                at hidden 16, in place of four
NARROW_TC_EDITS = {
    "no_products": [(NARROW_TC, "      mma(small[j], al, bh);\n      mma(acc[j], ah, bh);\n"
                                "      mma(small[j], ah, bl);\n", "")],
    "no_jet_mlp": [(NARROW_TC,
                    "  ((dense_seg(a, segs.v, segs.n, w, n_out, cols), w += (size_t)segs.n * n_out), ...);",
                    "  ((void)segs, ...);\n  (void)w;")],
    "one_product": [(NARROW_TC, "      mma(small[j], al, bh);\n", ""),
                    (NARROW_TC, "      mma(small[j], ah, bl);\n", "")],
    "three_blocks": [(NARROW_TC, "H == 16 ? 4 : H == 32 ? 2 : 1", "H == 16 ? 3 : H == 32 ? 2 : 1")],
    "five_blocks": [(NARROW_TC, "H == 16 ? 4 : H == 32 ? 2 : 1", "H == 16 ? 5 : H == 32 ? 2 : 1")],
}


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
    sources = tuple(s for s in sources if (csrc / s).exists())  # another revision may lack some
    for path in [*(csrc / s for s in sources), *csrc.glob("*.cuh")]:
        shutil.copy(path, src / path.name)
    for file, old, new in edits:
        text = (src / file).read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: its edit no longer matches {file}:\n{old}")
        (src / file).write_text(text.replace(old, new))
    # the error strings' entry point lives in K1's source; without it, a stub
    if not any("mmp_error_string" in (src / cu).read_text() for cu in sources):
        (src / "error_string.cu").write_text(ERROR_STRING_STUB)
        sources = (*sources, "error_string.cu")
    objects = [str(here / f"{cu}.o") for cu in sources]
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        log = "".join(text for text, _ in pool.map(
            lambda so: _build._run([_build.find_nvcc(), *_build.COMPILE_FLAGS, "-c",
                                    str(src / so[0]), "-o", so[1]]), zip(sources, objects)))
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
