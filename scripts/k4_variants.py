#!/usr/bin/env python3
"""Where K4's time goes: the wide EPiC forward kernel timed beside copies of
its source with one part taken out, on one GPU, in one process.

    python3 scripts/k4_variants.py [--other DIR]

Each variant is `ops/csrc/epic_wide_forward.cu` with `epic_wide.cuh` edited
as text (EDITS below) and built with nvcc into a temporary directory, the
builds in parallel. The variants compute wrong outputs on purpose; each
line gives its worst per-particle error as a share of K4's gate, so that a
variant that leaves its part in place shows as one that agrees:

  here         the working tree's kernel
  no_products  fc_local1's and fc_local2's tensor-core products skipped
               (the weight ring still drained): the time of everything else
  no_jet_mlp   the per-jet vector-matrix products (the time third of
               local_0, the global MLP, fc_local1's broadcast thirds)
               skipped: their weights stream from L2 for every jet
  one_product  a_hi·w_hi alone, the 3×TF32 split's two small products left
               out: what the split's accuracy costs

DIR (for example the parent's `ops/csrc`, unpacked with `git archive`) adds
that revision's kernel as "other", called through its own entry point. The
times are CUDA-event means over 5 launches, each variant in two turns
(forward, then backward order), at the main path's shapes: MBM at the scaled
backbone (B=8192, N=128) and the scaled absorbing trunk (56-wide head, the
hidden output, B=4096, N=109), seeded weights.
"""

import argparse
import concurrent.futures
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
import port_kernel_bits as pkb  # noqa: E402
from multimodal_particles_tpu_torch.ops import _build  # noqa: E402
from multimodal_particles_tpu_torch.ops.epic_cuda import epic_forward_reference  # noqa: E402

CSRC = ROOT / "multimodal_particles_tpu_torch" / "ops" / "csrc"
HEADER = "epic_wide.cuh"
# variant → [(old text, new text)] in epic_wide.cuh
EDITS = {
    "no_products": [(
        "  uint32_t ah[2][4], al[2][4];\n  fence_operands(acc.v);\n",
        "  uint32_t ah[2][4], al[2][4];\n  fence_operands(acc.v);\n"
        "  if (npad > 0) { cp_async_wait<0>(); __syncthreads(); return; }\n",
    )],
    "no_jet_mlp": [(
        "  const int tid = threadIdx.x, cg = tid & 31, ks = tid >> 5;\n"
        "  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);",
        "  const int tid = threadIdx.x, cg = tid & 31, ks = tid >> 5;\n"
        "  if (n_in > 0) { __syncthreads(); if (tid < WD) post(tid, 0.f); __syncthreads(); return; }\n"
        "  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);",
    )],
    "one_product": [(
        "      wgmma_m64n128k8(acc.v, al[s], w_hi);\n      wgmma_m64n128k8(acc.v, ah[s], w_lo);\n",
        "",
    )],
}
ERROR_STRING = """#include <cuda_runtime.h>
extern "C" const char* mmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
"""


def build(name, csrc, workdir):
    """K4's source of `csrc` with the variant's edits, built and bound."""
    src = workdir / name / "csrc"
    src.mkdir(parents=True)
    for path in [csrc / "epic_wide_forward.cu", *csrc.glob("*.cuh")]:
        shutil.copy(path, src / path.name)
    header = (src / HEADER).read_text()
    for old, new in EDITS.get(name, []):
        if old not in header:
            raise RuntimeError(f"variant {name}: its edit no longer matches {HEADER}")
        header = header.replace(old, new)
    (src / HEADER).write_text(header)
    (src / "error_string.cu").write_text(ERROR_STRING)
    objects = []
    for cu in ("epic_wide_forward.cu", "error_string.cu"):
        obj = workdir / name / f"{cu}.o"
        _build._run([_build.find_nvcc(), *_build.COMPILE_FLAGS, "-c", str(src / cu), "-o", str(obj)])
        objects.append(str(obj))
    library = workdir / name / "libk4.so"
    _build._run([_build.find_nvcc(), *_build.ARCH_FLAGS, "-shared", "-o", str(library), *objects])
    lib = ctypes.CDLL(str(library))
    lib.k4_tensor_core = "tcw" in (src / "epic_wide_forward.cu").read_text()
    argtypes = list(_build._SIGNATURES["mmp_epic_wide_forward"])
    if not lib.k4_tensor_core:
        del argtypes[1:3]
    lib.mmp_epic_wide_forward.argtypes, lib.mmp_epic_wide_forward.restype = argtypes, ctypes.c_int
    lib.mmp_error_string.argtypes, lib.mmp_error_string.restype = [ctypes.c_int], ctypes.c_char_p
    return name, lib


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", type=Path, help="another revision's csrc files")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k4_variants: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    sources = {"here": CSRC, **{name: CSRC for name in EDITS}}
    if args.other is not None:
        sources["other"] = args.other
    with tempfile.TemporaryDirectory() as tmp:
        with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
            libs = dict(pool.map(lambda item: build(*item, Path(tmp)), sources.items()))
        gen = torch.Generator(device=device).manual_seed(cs.SEED + 40)
        mbm = cs.scaled_packed(device)
        t, x, k, mask = cs.random_inputs(cs.TRAIN_B, device, gen)
        trunk, _ = cs.make_absorbing(device, scaled=True).pack_for_kernel()
        shapes = {
            "mbm": (lambda lib: pkb.wide_forward(lib, mbm, t, x, k, mask, False),
                    epic_forward_reference(mbm, t, x, k, mask), {"B": cs.TRAIN_B, "N": cs.N}),
        }
        absorbing = (trunk, *cs.scattered_inputs(cs.ABS_B, cs.ABS_N, device, gen))
        shapes["absorbing_scaled"] = (
            lambda lib: pkb.wide_forward(lib, *absorbing, True),
            epic_forward_reference(*absorbing, output_hidden_local=True)[0],
            {"B": cs.ABS_B, "N": cs.ABS_N})
        order = list(libs) + list(libs)[::-1]
        for shape, (run, ref, where) in shapes.items():
            times = {name: [] for name in libs}
            for name in order:
                _build.load_library = lambda lib=libs[name]: lib
                times[name].append(cs.cuda_ms(lambda: run(libs[name]), iters=5))
            for name, lib in libs.items():
                _build.load_library = lambda lib=lib: lib
                out = run(lib)[0]
                torch.cuda.synchronize()
                share = cs.compare(out, ref)["worst_particle_err_over_bound"]
                print(json.dumps({"shape": shape, **where, "variant": name, "ms": times[name],
                                  "share_of_gate": share, "card": card}), flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
