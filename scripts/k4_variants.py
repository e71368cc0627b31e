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
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
import kernel_variants as kv  # noqa: E402
import port_kernel_bits as pkb  # noqa: E402
from multimodal_particles_tpu_torch.ops.epic_cuda import epic_forward_reference  # noqa: E402

SOURCE = "epic_wide_forward.cu"
HEADER = "epic_wide.cuh"
# variant → [(file, old text, new text)]
EDITS = {
    "no_products": [(
        HEADER,
        "  uint32_t ah[2][4], al[2][4];\n  fence_operands(acc.v);\n",
        "  uint32_t ah[2][4], al[2][4];\n  fence_operands(acc.v);\n"
        "  if (npad > 0) { cp_async_wait<0>(); __syncthreads(); return; }\n",
    )],
    "no_jet_mlp": [(
        HEADER,
        "  const int tid = threadIdx.x, cg = tid & 31, ks = tid >> 5;\n"
        "  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);",
        "  const int tid = threadIdx.x, cg = tid & 31, ks = tid >> 5;\n"
        "  if (n_in > 0) { __syncthreads(); if (tid < WD) post(tid, 0.f); __syncthreads(); return; }\n"
        "  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);",
    )],
    "one_product": [(
        HEADER,
        "      wgmma_m64n128k8(acc.v, al[s], w_hi);\n      wgmma_m64n128k8(acc.v, ah[s], w_lo);\n",
        "",
    )],
}
def bind(lib, src):
    """K4's entry point: before its tensor-core products it takes no prepared
    weights (port_kernel_bits.wide_forward reads `k4_tensor_core`)."""
    lib.k4_tensor_core = "tcw" in lib.text
    argtypes = list(kv._build._SIGNATURES["mmp_epic_wide_forward"])
    if not lib.k4_tensor_core:
        del argtypes[1:3]
    kv.bind_entries(lib, {"mmp_epic_wide_forward": argtypes})


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
    builds = {"here": (kv.CSRC, []), **{name: (kv.CSRC, edits) for name, edits in EDITS.items()}}
    if args.other is not None:
        builds["other"] = (args.other, [])
    with tempfile.TemporaryDirectory() as tmp:
        libs = kv.build_all(builds, (SOURCE,), bind, Path(tmp))
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
        for shape, (run, ref, where) in shapes.items():
            times = kv.time_in_turns(libs, run, cs.cuda_ms, 5)
            for name, lib in libs.items():
                kv._build.load_library = lambda lib=lib: lib
                out = run(lib)[0]
                torch.cuda.synchronize()
                share = cs.compare(out, ref)["worst_particle_err_over_bound"]
                kv.emit({"shape": shape, **where, "variant": name, "ms": times[name],
                         "share_of_gate": share, "card": card})
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
