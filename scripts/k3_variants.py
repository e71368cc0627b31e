#!/usr/bin/env python3
"""Where K3's time goes: the narrow EPiC backward timed beside copies of its
source with one part taken out, on one GPU, in one process.

    python3 scripts/k3_variants.py [--other DIR]

Each variant is `ops/csrc/epic_backward.cu` (with the headers it includes,
K1's forward among them) edited as text (EDITS below, and the edits of
`narrow_tc.cuh` that kernel_variants.py holds), built with nvcc into a
temporary directory, the builds in parallel. The variants compute wrong
gradients on purpose; each line gives its error against the plain autograd
backward as a share of K3's per-leaf gate (|err| ≤ 1e-4·max|ref leaf| +
1e-3·|ref|, off `near_kink_jets`), so that a variant that leaves its part in
place shows as one that agrees:

  here           the source as it is
  no_outer       the aᵀ·dz products (the per-particle weight gradients,
                 local_0's Q included) skipped
  no_dzwt        the dz·Wᵀ products of the walk back skipped (the rerun's
                 products stay)
  no_jet_mlp     warp 0's per-jet MLP backward skipped (the rerun's per-jet
                 MLP stays)
  one_product    a_hi·w_hi alone in every product, the rerun's and the walk
                 back's: what the 3×TF32 split's accuracy costs
  part_global    the warps' partial sums in global memory (the buffer's
                 per-jet entries and the MLP's weights in shared memory)
  prefix_global  the per-jet entries of the buffer (warp 0's forward MLP)
                 read from global memory, not staged
  records_smem   every thread's per-particle records (h_in, z_fl1 and the
                 signs, a float4 a slot) in shared memory, not in the global
                 scratch; they take their room first, and the warps'
                 partial sums, the per-jet entries and the MLP's weights
                 then go to shared memory where they still fit beside them
                 within two blocks an SM
  records_smem_one_block  the records in shared memory and every other
                 part that `make_plan` places there too, one block an SM
  jet_weights_global  the per-jet MLP backward's weights read from global
                 memory, not copied to shared memory
  noinline_mlp   the per-jet MLP backward as called functions, with
                 registers of their own

DIR (for example the parent's `ops/csrc`, unpacked with `git archive`) adds
that revision's K3 as "other" (the FFMA kernel before the tensor cores takes
the packed weights alone, through its own signature). The times are
CUDA-event means over 10 launches of the backward, each build in two turns
(forward, then backward order), at the main path's shape: config-berlin
(hidden 16, 2 blocks), B=8192, N=128, a random cotangent, seeded weights;
and forward + backward as the training step runs them: the buffer made
from the weights (DIR's K1 reads its first part), K1's forward, K3.
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
from multimodal_particles_tpu_torch.ops import epic_cuda  # noqa: E402
from multimodal_particles_tpu_torch.ops.epic_vjp_cuda import (  # noqa: E402
    epic_backward_reference,
    near_kink_jets,
)

SOURCES = ("epic_forward.cu", "epic_backward.cu")
K3 = "epic_backward.cu"
SMALL_MMA = ("      mma(small, A[ks].lo, b.hi);\n      mma(acc, A[ks].hi, b.hi);\n"
             "      mma(small, A[ks].hi, b.lo);\n")
# the records at the start of the planned shared memory, counted first
RECORDS_IN_SMEM = [
    (K3, "  size_t floats = p.base_floats;",
     "  size_t floats = p.base_floats + (size_t)record_slots(d) * p.threads * 4;"),
    (K3, "  float* after = smem + base_floats;",
     "  float* after = smem + base_floats + (size_t)record_slots(d) * T * 4;"),
    (K3, "  float4* rec_base = records + (size_t)blockIdx.x * record_slots(d) * T + threadIdx.x;",
     "  float4* rec_base = reinterpret_cast<float4*>(smem + base_floats) + threadIdx.x;"),
]
EDITS = {
    "no_outer": [
        (K3, "  using namespace tf32x3;\n  constexpr int MT = (NA + 1) / 2;",
         "  return;\n  using namespace tf32x3;\n  constexpr int MT = (NA + 1) / 2;"),
        (K3, SMALL_MMA, ""),
    ],
    "no_dzwt": [
        (K3, "    product<1, 1>(dz, gd,", "    if (false) product<1, 1>(dz, gd,"),
        (K3, "    product<1, 1>(dd, dz,", "    if (false) product<1, 1>(dd, dz,"),
        (K3, "  product<2, NT>(dh, dzo,", "  if (false) product<2, NT>(dh, dzo,"),
        (K3, "      product<NT, NT>(dl1, dz2,", "      if (false) product<NT, NT>(dl1, dz2,"),
        (K3, "    product<NT, NT>(dh, dz1,", "    if (false) product<NT, NT>(dh, dz1,"),
    ],
    "no_jet_mlp": [
        (K3, "      jet_layer_backward(J, d, blk, jr, R, sdz1, K);\n"
             "      if (blk == 0) jet_projection_backward(J, d, jr, R, K);",
         ""),
    ],
    "one_product": [
        *kv.NARROW_TC_EDITS["one_product"],
        (K3, SMALL_MMA, "      mma(acc, A[ks].hi, b.hi);\n"),
    ],
    "prefix_global": [
        (K3, "  p.prefix_in_smem = sizeof(float) * (floats + prefix) <= SMEM_BUDGET;",
             "  p.prefix_in_smem = 0;"),
    ],
    "records_smem": RECORDS_IN_SMEM,
    "records_smem_one_block": [*RECORDS_IN_SMEM,
                               (K3, "constexpr size_t SMEM_BUDGET = 112 * 1024;",
                                "constexpr size_t SMEM_BUDGET = 227 * 1024;")],
    "jet_weights_global": [
        (K3, "  p.jet_weights_in_smem = sizeof(float) * (floats + jet_weights) <= SMEM_BUDGET;",
         "  p.jet_weights_in_smem = 0;"),
    ],
    "noinline_mlp": [
        (K3, "__device__ __forceinline__ void jet_layer_backward(",
         "__device__ __noinline__ void jet_layer_backward("),
        (K3, "__device__ __forceinline__ void jet_projection_backward(",
         "__device__ __noinline__ void jet_projection_backward("),
    ],
    "part_global": [
        (K3, "  p.part_in_smem = sizeof(float) * (floats + part) <= SMEM_BUDGET;",
         "  p.part_in_smem = 0;"),
    ],
}


def bind(lib, src):
    lib.k1_tensor_core = "narrow_tc.cuh" in (src / "epic_forward.cu").read_text()
    kv.bind_entries(lib, {
        "mmp_epic_forward": kv._build._SIGNATURES["mmp_epic_forward"],
        "mmp_epic_backward_workspace": kv._build._SIGNATURES["mmp_epic_backward_workspace"],
        "mmp_epic_backward": pkb.narrow_backward_signature((src / K3).read_text()),
    })


def forward_backward(lib, packed, t, x, k, mask, g):
    """What a training step runs of K1 and K3: the buffer(s) made from the
    weights, K1's forward, K3."""
    with_buffer = epic_cuda.with_narrow_buffer(packed)
    pkb.epic_forward(lib, with_buffer, t, x, k, mask, False)
    return pkb.narrow_backward(lib, with_buffer, t, x, k, mask, g)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", type=Path, help="another revision's csrc files")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k3_variants: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    builds = {"here": (kv.CSRC, [])}
    builds.update({name: (kv.CSRC, edits) for name, edits in EDITS.items()})
    if args.other is not None:
        builds["other"] = (args.other, [])
    with tempfile.TemporaryDirectory() as tmp:
        libs = kv.build_all(builds, SOURCES, bind, Path(tmp))
        for name, lib in libs.items():
            kv.emit({"variant": name, "ptxas": lib.ptxas})
        gen = torch.Generator(device=device).manual_seed(cs.SEED + 43)
        model = cs.make_model(device)
        packed = epic_cuda.with_narrow_buffer(
            epic_cuda.pack_mbm_encoder_params(model.encoder, model.config))
        t, x, k, mask = cs.random_inputs(cs.TRAIN_B, device, gen)
        near = near_kink_jets(packed, t, x, k, mask)
        g = torch.randn((cs.TRAIN_B, cs.N, 11), generator=gen, device=device) * (~near)[:, None, None]
        ref = epic_backward_reference(packed, t, x, k, mask, g)
        times = kv.time_in_turns(
            libs, lambda lib: pkb.narrow_backward(lib, packed, t, x, k, mask, g), cs.cuda_ms, 10)
        fb_times = kv.time_in_turns(
            libs, lambda lib: forward_backward(lib, packed, t, x, k, mask, g), cs.cuda_ms, 10)
        for name, lib in libs.items():
            got = pkb.narrow_backward(lib, packed, t, x, k, mask, g)
            torch.cuda.synchronize()
            share = pkb.leaf_share(packed, got, ref)
            kv.emit({"kernel": "K3", "B": cs.TRAIN_B, "N": cs.N, "hidden": 16, "variant": name,
                     "backward_ms": times[name], "forward_backward_ms": fb_times[name],
                     "share_of_gate": share, "finite": kv.finite(got), "card": card})
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
