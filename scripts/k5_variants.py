#!/usr/bin/env python3
"""Where K5's time goes: the wide EPiC backward timed beside copies of its
source with one part taken out, on one GPU, in one process.

    python3 scripts/k5_variants.py [--other DIR]

Each variant is `ops/csrc/epic_wide_backward.cu` with it or `epic_wide.cuh`
edited as text (EDITS below, one set for each of the two designs: the FFMA
kernel before the tensor cores and the tensor-core kernel after them; the
set is taken by which design the source is) and built with nvcc into a
temporary directory, the builds in parallel. The variants compute wrong
gradients on purpose; each line gives its worst leaf error against plain
autograd as a share of K5's per-leaf gate (|err| ≤ 1e-4·max|ref leaf| +
1e-3·|ref|, jets near a kink given no cotangent, as chip_smoke.py's phase
K5), so that a variant that leaves its part in place shows as one that
agrees:

  here          the source as it is
  no_products   every (128, 128, 128) product skipped: the recording rerun's,
                dz·Wᵀ and aᵀ·dz (their weight streams stay)
  no_records    the records neither written nor read: the walk back uses
                whatever the tiles they would fill hold
  no_add_outer  the per-jet aᵀ·dz results not added into the block's
                gradient row (their products stay)
  no_jet_mlp    the tensor-core kernel: the per-jet vector-matrix products
                skipped, the rerun's (jet_matvec) and the walk back's
                (jet_matvec_t): the global MLP, the broadcast thirds
  no_contract   the tensor-core kernel: the pair log's contraction skipped
  outer_wgmma   the tensor-core kernel's other plan for aᵀ·dz (computes what
                "here" does): wgmma with aᵀ from registers, loaded by hand,
                and dz transposed by the block into K-major TF32 hi/lo stages,
                a k-step at a time, in place of mma.sync with both fragments
                loaded by hand
  one_product   the tensor-core kernel: a_hi·w_hi alone in every product,
                the 3×TF32 split's two small products left out

DIR (for example the parent's `ops/csrc`, unpacked with `git archive`) adds
that revision's kernel as "other" and, where it is the other design, its
variants as "other:…". The times
are CUDA-event means over 3 launches, each variant in two turns (forward,
then backward order), at the main path's shape: the scaled MBM backbone
(every width 128, 6 blocks), B=8192, N=128, seeded weights.
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
from multimodal_particles_tpu_torch.ops.epic_vjp_cuda import (  # noqa: E402
    epic_backward_reference,
    near_kink_jets,
)

SOURCE = "epic_wide_backward.cu"
HEADER = "epic_wide.cuh"
# the per-jet sums of a thread's aᵀ·dz piece, stored where no run looks, so
# that the products stay when add_outer no longer adds them
KEEP_ACC = ("{ float s = 0.f;\n#pragma unroll\n    for (int i = 0; i < 8; ++i)\n#pragma unroll\n"
            "      for (int j = 0; j < 8; ++j) s += acc[i][j];\n"
            "    if (s == 1234.5f) gm[threadIdx.x] = s;\n    return; }\n")
# The other plan for aᵀ·dz: wgmma with A (aᵀ) from registers, loaded by hand
# from the a tile, and B (dz) transposed by the block into K-major TF32 hi/lo
# core matrices a k-step at a time, two stages in the staging area.
OUTER_WGMMA = """// gm (128, 128) += aᵀ·dz by wgmma: A (a-columns × rows) from registers,
// B (rows × dz-columns) each k-step's 8 rows of dz transposed into a stage of
// K-major hi/lo core matrices (two stages at `stage`). Barriers inside.
__device__ void outer_wgmma(float* gm, const float* A, const float* D, int ksteps, float* stage) {
  using namespace tf32x3;
  const int tid = threadIdx.x, warp = tid >> 5, g = (tid >> 2) & 7, t = tid & 3;
  const float* ar = A + t * LDA_TC + 64 * (warp >> 2) + 16 * (warp & 3) + g;
  WgAcc acc;
  acc.zero();
  fence_operands(acc.v);
  for (int ks = 0; ks < ksteps; ++ks) {
    float* st = stage + (ks & 1) * TC_STAGE;
    for (int e = tid; e < TC_KT * WD; e += THREADS) {
      const int k = e >> 7, n = e & (WD - 1);
      uint32_t hi, lo;
      split_fast(D[(TC_KT * ks + k) * LDA_TC + n], hi, lo);
      const int at = (n >> 3) * 64 + (k >> 2) * 32 + (n & 7) * 4 + (k & 3);
      st[at] = __uint_as_float(hi);
      st[TC_KT * WD + at] = __uint_as_float(lo);
    }
    fence_proxy_async();
    __syncthreads();
    const float* a = ar + TC_KT * ks * LDA_TC;
    uint32_t ah[4], al[4];
    split_fast(a[0], ah[0], al[0]);
    split_fast(a[8], ah[1], al[1]);
    split_fast(a[4 * LDA_TC], ah[2], al[2]);
    split_fast(a[4 * LDA_TC + 8], ah[3], al[3]);
    const uint64_t b_hi = smem_desc(st, 128, 256), b_lo = smem_desc(st + TC_KT * WD, 128, 256);
    wgmma_fence();
    wgmma_m64n128k8(acc.v, al, b_hi);
    wgmma_m64n128k8(acc.v, ah, b_lo);
    wgmma_m64n128k8(acc.v, ah, b_hi);
    wgmma_commit();
    wgmma_wait<0>();
  }
  fence_operands(acc.v);
  float2 old[32];
  acc.each([&](int i, int r, int c, float) {
    if (!(i & 1)) old[i >> 1] = *reinterpret_cast<const float2*>(gm + r * WD + c);
  });
  acc.each([&](int i, int r, int c, float v) {
    if (i & 1) {
      float2 o = old[i >> 1];
      o.y += v;
      o.x += acc.v[i - 1];
      *reinterpret_cast<float2*>(gm + r * WD + c - 1) = o;
    }
  });
  __syncthreads();
}

"""

# design → variant → [(file, old text, new text)]
EDITS = {
    "ffma": {
        "no_products": [
            (HEADER, "  for (int k4 = 0; k4 < KT; k4 += 4) {", "  for (int k4 = 0; k4 < 0; k4 += 4) {"),
            (SOURCE, "  for (int r = 0; r < ROWS; ++r) {\n    const float4 a0",
             "  for (int r = 0; r < 0; ++r) {\n    const float4 a0"),
        ],
        "no_records": [
            (SOURCE, "void z_l0(int r, int c, float v) const { mat(0)[r * WD + c] = v; }",
             "void z_l0(int, int, float) const {}"),
            (SOURCE, "    z_fl1_mat(b)[r * WD + c] = v;\n", ""),
            (SOURCE, "    z_fl2_mat(b)[r * WD + c] = v;\n", ""),
            (SOURCE, "    for (int i = threadIdx.x; i < MAT / 4; i += THREADS) dst[i] = src[i];\n", ""),
            (SOURCE, "        const float4 z = z2[i];", "        const float4 z = v;"),
            (SOURCE, "        S1v[i] = z1[i];", "        S1v[i] = v;"),
            (SOURCE, "      for (int i = tid; i < MAT / 4; i += THREADS) S2v[i] = hin[i];",
             "      for (int i = tid; i < MAT / 4; i += THREADS) S2v[i] = S0v[i];"),
            (SOURCE, "      const float4 z = zl0[i];\n      float4 v = S0v[i];",
             "      float4 v = S0v[i];\n      const float4 z = v;"),
        ],
        "no_add_outer": [
            (SOURCE, "__device__ __forceinline__ void add_outer(float* gm, const float (&acc)[8][8]) {\n",
             "__device__ __forceinline__ void add_outer(float* gm, const float (&acc)[8][8]) {\n"
             + KEEP_ACC),
        ],
    },
    "tensor_cores": {
        "no_products": [
            (HEADER, "  uint32_t ah[2][4], al[2][4];\n  fence_operands(acc.v);\n",
             "  uint32_t ah[2][4], al[2][4];\n  fence_operands(acc.v);\n"
             "  if (npad > 0) { cp_async_wait<0>(); __syncthreads(); return; }\n"),
            (SOURCE, "  for (int ks = 0; ks < ksteps; ++ks) {", "  for (int ks = 0; ks < 0; ++ks) {"),
        ],
        "no_records": [
            (SOURCE, "    const unsigned bits = __ballot_sync(0xffffffffu, z >= 0.f);\n"
                     "    if ((threadIdx.x & 31) == 0) words[64 * (threadIdx.x >> 5) + i] = bits;\n", ""),
            (SOURCE, "    z_fl1_mat(b)[r * WD + c] = v;\n", ""),
            (SOURCE, "    for (int i = threadIdx.x; i < MAT / 4; i += THREADS)\n"
                     "      dst[i] = *reinterpret_cast<const float4*>(S + (i >> 5) * ld + 4 * (i & 31));\n",
             ""),
            (SOURCE, "    tile_to_smem_async(S1, rec.z_fl1_mat(blk));\n"
                     "    signs_to_smem_async(reinterpret_cast<unsigned*>(tiles), rec.z_fl2_signs(blk));\n",
             ""),
            (SOURCE, "    tile_to_smem_async(S2, rec.h_in_mat(blk));\n", ""),
            (SOURCE, "  signs_to_smem_async(reinterpret_cast<unsigned*>(tiles), rec.z_l0_signs());\n", ""),
        ],
        "no_add_outer": [
            (SOURCE, "        v[mi][j][h] = *p[mi][j][h];", "        v[mi][j][h] = make_float2(0.f, 0.f);"),
            (SOURCE, "        *p[mi][j][h] = v[mi][j][h];",
             "        if (v[mi][j][h].x + v[mi][j][h].y == 1234.5f) *p[mi][j][h] = v[mi][j][h];"),
        ],
        "no_jet_mlp": [
            (HEADER, "  const int tid = threadIdx.x, cg = tid & 31, ks = tid >> 5;\n"
                     "  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);",
             "  const int tid = threadIdx.x, cg = tid & 31, ks = tid >> 5;\n"
             "  if (n_in > 0) { __syncthreads(); if (tid < WD) post(tid, 0.f); __syncthreads(); return; }\n"
             "  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);"),
            (SOURCE, "  const float4 vv = *reinterpret_cast<const float4*>(v + lane * 4);\n",
             "  const float4 vv = *reinterpret_cast<const float4*>(v + lane * 4);\n"
             "  if (n_out > 0) {\n    if (lane == 0)\n      for (int j = warp; j < n_out; j += WARPS) post(j, 0.f);\n"
             "    __syncthreads();\n    return;\n  }\n"),
        ],
        "no_contract": [
            (SOURCE, "  const int o4 = (threadIdx.x & 31) * 4, ig = (threadIdx.x >> 5) * 4;\n",
             "  const int o4 = (threadIdx.x & 31) * 4, ig = (threadIdx.x >> 5) * 4;\n  if (n_groups > 0) return;\n"),
        ],
        "outer_wgmma": [
            (SOURCE, "// cp.async of a record's (128, 128) tile", OUTER_WGMMA + "// cp.async of a record's (128, 128) tile"),
            (SOURCE, "    outer_mma(gb + L.fl2, S2, S0, ksteps);", "    outer_wgmma(gb + L.fl2, S2, S0, ksteps, tiles);"),
            (SOURCE, "    outer_mma(gb + L.fl1, S2, S1, ksteps);", "    outer_wgmma(gb + L.fl1, S2, S1, ksteps, tiles);"),
        ],
        "one_product": [
            (HEADER, "      wgmma_m64n128k8(acc.v, al[s], w_hi);\n      wgmma_m64n128k8(acc.v, ah[s], w_lo);\n",
             ""),
            ("tf32x3.cuh", "  mma(d, a.lo, b.hi);\n  mma(d, a.hi, b.lo);\n", ""),
        ],
    },
}


def design(csrc):
    return "tensor_cores" if "tcw_t" in (csrc / SOURCE).read_text() else "ffma"


def bind(lib, src):
    kv.bind_entries(lib, {"mmp_epic_wide_backward": pkb.wide_backward_signature(lib.text),
                          "mmp_epic_wide_backward_workspace": kv._build._SIGNATURES[
                              "mmp_epic_wide_backward_workspace"]})


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", type=Path, help="another revision's csrc files")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k5_variants: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    device = torch.device("cuda", 0)
    builds = {"here": (kv.CSRC, [])}
    builds.update({name: (kv.CSRC, edits) for name, edits in EDITS[design(kv.CSRC)].items()})
    if args.other is not None:
        builds["other"] = (args.other, [])
        if design(args.other) != design(kv.CSRC):  # the other design's own parts
            builds.update({f"other:{name}": (args.other, edits)
                           for name, edits in EDITS[design(args.other)].items()})
    with tempfile.TemporaryDirectory() as tmp:
        libs = kv.build_all(builds, (SOURCE,), bind, Path(tmp))
        for name, lib in libs.items():
            kv.emit({"variant": name, "ptxas": lib.ptxas})
        gen = torch.Generator(device=device).manual_seed(cs.SEED + 43)
        packed = cs.scaled_packed(device)
        B = cs.TRAIN_B
        t, x, k, mask = cs.random_inputs(B, device, gen)
        near = torch.cat([near_kink_jets(packed, *c) for c in cs.jet_chunks(B, t, x, k, mask)])
        g = torch.randn((B, cs.N, 11), generator=gen, device=device) * (~near)[:, None, None]
        ref = sum(epic_backward_reference(packed, *c) for c in cs.jet_chunks(B, t, x, k, mask, g))

        def run(lib):
            return pkb.wide_backward(lib, packed, t, x, k, mask, g)

        times = kv.time_in_turns(libs, run, cs.cuda_ms, 3)
        for name, lib in libs.items():
            out = run(lib)
            torch.cuda.synchronize()
            cmp = cs.leaf_compare(out, ref, packed)
            kv.emit({"kernel": "K5", "B": B, "N": cs.N, "variant": name, "ms": times[name],
                     "share_of_gate": cmp["worst_leaf_err_over_bound"],
                     "leaves_out_of_bound": len(cmp["leaves_out_of_bound"]),
                     "finite": kv.finite(out), "card": card})
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
