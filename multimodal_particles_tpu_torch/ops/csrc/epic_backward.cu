// K3 backward: d(packed weights) of the fused narrow EPiC forward for a
// cotangent g (B, N, 3 + 8), in one persistent launch plus a deterministic
// reduction, every per-particle product on the tensor cores under the 3×TF32
// split (tf32x3.cuh).
//
// Replaces the TPU kernel multimodal_particles_tpu/ops/epic_pallas_vjp.py
// (`make_epic_train_forward`, body `_bwd_kernel`, :91-240). The forward of
// the same custom op is the K1 kernel (epic_forward.cu): the JAX `_fwd_kernel`
// runs the same `_forward_acts`.
//
// Design. A persistent grid; a block of one warp per 16 particle slots walks
// over jets, as K1's does.
//   * The rerun is K1's forward (epic_forward_kernel.cuh `forward_jet`) on
//     the buffer K1 read, with a recorder: so the gradient is taken at the
//     activations whose loss K1 gave, to the bit. A thread records its own
//     C fragments (per layer h_in and z_fl1, the signs of z_fl2 and of
//     local_0's z) to this block's slice of a global scratch, a float4 a
//     slot, threads side by side, and reads them back within the jet;
//     warp 0 records the jet's pooled sums and the per-jet MLP's
//     pre-activations in shared memory. In shared memory the records (45 KB
//     a block at config-berlin) leave no room for the warps' partial sums
//     at two blocks an SM, which costs more than they save (PERF.md §5).
//   * dz·Wᵀ runs as K1's products do (`product`, mma.sync.m16n8k8): each
//     cotangent's C fragments are the next product's A fragments, the
//     transposed weights come as hi/lo fragments after K1's in the buffer
//     (`make_tc_layout_t`, ops/epic_cuda.py::narrow_buffer).
//   * aᵀ·dz, the weight gradients, contract the warp's 16 slots as the mma's
//     k: a C fragment holds a row a slot, so both operands are transposed in
//     registers, 8 × 8 at a time (`transpose8`: movmatrix on the two 16-bit
//     halves of each float), and split by truncation. Each warp adds its
//     products into its own partial sums, held in the mma's C layout, across
//     all the jets the block walks (shared memory when they fit, else this
//     block's global scratch); the block folds its warps' partials into its
//     gradient row once, after its last jet. local_0's input side needs no
//     H-row product: with R = [x·m, m, 1, 0, 0, 0, onehot(k)·m] (16 columns)
//     Q = Rᵀ·dz_l0 gives b_l0, w_l0's x and token columns, w_x, b_x and the
//     table from the weights, once a block.
//   * What is the same for every particle of a jet (the global MLP, the
//     broadcast thirds of fc_local1 and local_0's time columns) gives rank-1
//     gradients of the jet's vectors: warp 0 runs the per-jet MLP backward
//     after each pool of the cotangents and logs each (a, dz) pair to the
//     block's pair log; the block contracts the pairs over its jets after its
//     last jet, as K5 does.
//   * Masking follows `_bwd_kernel`: the heads' cotangents are masked, pooled
//     cotangents come back times the mask, the mean's denominator is
//     max(Σmask, 1), so an all-masked jet contributes only through the
//     discrete head; leaky'(0) = 1 and selu'(0) = scale (`_dleaky`,
//     `_dselu`, epic_pallas_vjp.py:68-75).
//   * Shared memory holds, as they fit in two blocks' share of an SM, the
//     warps' partial sums, the buffer's per-jet entries (warp 0's forward
//     MLP) and a compact copy of the (out, in) weights its MLP backward
//     reads; the per-particle fragments are read through L1.
//   * Each block writes its own row of a (grid, n_weights) buffer (a thread
//     always owns the same elements, so no atomics); a second kernel sums the
//     rows in a fixed order. The result does not depend on the schedule.
//
// What bounds it. The per-particle products are the rerun's (K1's, 1,384
// multiply-adds a particle at config-berlin) and about as many again for
// each of dz·Wᵀ and aᵀ·dz, three TF32 products each; what the kernel spends
// is each jet's chain of dependent steps: warp 0's per-jet MLP, forward and
// back, while the other warps wait at the pools, and the products' short
// mma chains. On an H100 at config-berlin, B=8192 (PERF.md §5,
// scripts/k3_variants.py): 1.35–1.41 ms, of which the MLP backward ≈ 22–25%,
// aᵀ·dz ≈ 9–13%, dz·Wᵀ ≈ 1–5%, the split's two small products ≈ 6%; the
// rerun is ≈ 40% of warp 0's time.
//
// C interface (bound with ctypes by ops/epic_vjp_cuda.py): each entry point
// returns the cudaError_t of its calls, 0 on success.

#include "epic_forward_kernel.cuh"

namespace mmp {
namespace k3 {

using namespace narrow;
using k1::Scratch;

constexpr int MAX_K3_THREADS = 512;  // ⌈256 / 16⌉ warps
// Shared memory a block may take so that two share an SM (`make_plan`): the
// warps' partial sums go there when they fit, then the buffer's per-jet
// entries, then the compact per-jet MLP weights, each as it fits (else read
// from global memory).
constexpr size_t SMEM_BUDGET = 112 * 1024;

__device__ __forceinline__ float dleaky(float z) { return z >= 0.f ? 1.f : 0.01f; }

// selu'(z) with the right-hand derivative at 0, as `_dselu`
// (epic_pallas_vjp.py:72-75).
__device__ __forceinline__ float dselu(float z) {
  const float alpha = 1.6732632423543772f, scale = 1.0507009873554805f;
  return scale * (z >= 0.f ? 1.f : alpha * expf(z));
}

// ---- the per-jet records in shared memory (floats, each entry padded to 4)

struct JetRecLayout {
  int denom, s0, zg0, zg1, zg2, blocks, block_stride, s, gin, zfg1, zfg2, total;
};

__host__ __device__ inline JetRecLayout make_jet_rec(const Dims& d) {
  JetRecLayout R;
  const int H = pad4(d.hidden), Hg = pad4(d.hidden_glob);
  int o = 0;
  R.denom = o; o += 4;
  R.s0 = o;    o += H;
  R.zg0 = o;   o += H;
  R.zg1 = o;   o += H;
  R.zg2 = o;   o += Hg;
  R.blocks = o;
  int b = 0;
  R.s = b;    b += H;
  R.gin = b;  b += Hg;
  R.zfg1 = b; b += H;
  R.zfg2 = b; b += Hg;
  R.block_stride = b;
  R.total = o + d.num_blocks * b;
  return R;
}

// ---- the pair log: per jet the vectors of its rank-1 gradients, in global
// memory; the groups (gradient offset, its row stride, rows, columns, where
// a and dz sit in a jet's record) follow from the layout, in the same order
// for every jet.

struct Group {
  int goff, ld, n_out, n_a, a, dz;
};

struct PairLayout {
  int one, blocks, block_stride, gt, sdz1, fa, dzfg2, p, dzfg1;
  int ag1, dzg2, ag0, dzg1, p0, dzg0, temb, q3, total;
};

__host__ __device__ inline PairLayout make_pair_layout(const Dims& d) {
  PairLayout P;
  const int H = d.hidden, Hg = d.hidden_glob, Et = d.emb_t;
  int o = 0;
  P.one = o;  o += 4;
  P.blocks = o;
  int b = 0;
  P.gt = b;    b += pad4(Hg + Et);  // [g_new ‖ temb]: fc_local1's broadcast inputs
  P.sdz1 = b;  b += pad4(H);        // Σ_particles dz_fl1
  P.fa = b;    b += pad4(H);        // leaky(z_fg1)
  P.dzfg2 = b; b += pad4(Hg);
  P.p = b;     b += pad4(2 * H + Hg + Et);  // [mean ‖ sum ‖ g_in ‖ temb]
  P.dzfg1 = b; b += pad4(H);
  P.block_stride = b;
  o += d.num_blocks * b;
  P.ag1 = o;  o += pad4(H);
  P.dzg2 = o; o += pad4(Hg);
  P.ag0 = o;  o += pad4(H);
  P.dzg1 = o; o += pad4(H);
  P.p0 = o;   o += pad4(2 * H + Et);
  P.dzg0 = o; o += pad4(H);
  P.temb = o; o += pad4(Et);
  P.q3 = o;   o += pad4(H);  // Σ_particles dz_l0·m
  P.total = o;
  return P;
}

__host__ __device__ inline int n_groups(const Dims& d) { return 6 * d.num_blocks + 7; }

// Group i of the pair log.
__host__ __device__ inline Group group(const Dims& d, const Layout& L, const PairLayout& P, int i) {
  const int H = d.hidden, Hg = d.hidden_glob, Et = d.emb_t;
  const int n_g1 = 2 * H + Hg + Et, n_l1 = H + Hg + Et, n_g0 = 2 * H + Et;
  const int n_l0 = Et + d.emb_x + d.emb_k;
  if (i < 6 * d.num_blocks) {
    const int blk = i / 6, wb = L.blocks + blk * L.block_stride, pb = P.blocks + blk * P.block_stride;
    switch (i % 6) {
      case 0: return {wb + L.fl1 + H, n_l1, H, Hg + Et, pb + P.gt, pb + P.sdz1};
      case 1: return {wb + L.bfl1, 1, H, 1, P.one, pb + P.sdz1};
      case 2: return {wb + L.fg2, H, Hg, H, pb + P.fa, pb + P.dzfg2};
      case 3: return {wb + L.bfg2, 1, Hg, 1, P.one, pb + P.dzfg2};
      case 4: return {wb + L.fg1, n_g1, H, n_g1, pb + P.p, pb + P.dzfg1};
      default: return {wb + L.bfg1, 1, H, 1, P.one, pb + P.dzfg1};
    }
  }
  switch (i - 6 * d.num_blocks) {
    case 0: return {L.w_g2, H, Hg, H, P.ag1, P.dzg2};
    case 1: return {L.b_g2, 1, Hg, 1, P.one, P.dzg2};
    case 2: return {L.w_g1, H, H, H, P.ag0, P.dzg1};
    case 3: return {L.b_g1, 1, H, 1, P.one, P.dzg1};
    case 4: return {L.w_g0, n_g0, H, n_g0, P.p0, P.dzg0};
    case 5: return {L.b_g0, 1, H, 1, P.one, P.dzg0};
    default: return {L.w_l0, n_l0, H, Et, P.temb, P.q3};
  }
}

// ---- the warps' partial sums of the per-particle weight gradients: per
// warp float4 slots, a slot an mma C fragment (or the column sums of up to
// two n-tiles), lanes side by side. MT = H / 16 m-tiles of an H-wide a.

struct PartLayout {
  int out, bout, h1, h0, q, blocks, block_stride, fl2, bfl2, fl1, total;
};

__host__ __device__ inline PartLayout make_part_layout(const Dims& d) {
  PartLayout P;
  const int NT = d.hidden / 8, MT = d.hidden / 16;
  int o = 0;
  P.out = o;  o += 2 * MT;  // h_finalᵀ·[dd·m ‖ gc·m]
  P.bout = o; o += 1;
  P.h1 = o;   o += 1;       // [selu(z_h0) ‖ 1]ᵀ·gd: row 8 the bias's
  P.h0 = o;   o += 1;       // [pre-logits ‖ 1]ᵀ·dz_h0
  P.q = o;    o += NT;      // Rᵀ·dz_l0
  P.blocks = o;
  int b = 0;
  P.fl2 = b;  b += MT * NT;  // l1ᵀ·dz_fl2
  P.bfl2 = b; b += NT / 2;
  P.fl1 = b;  b += MT * NT;  // h_inᵀ·dz_fl1
  P.block_stride = b;
  P.total = o + d.num_blocks * b;
  return P;
}

// Slots of a thread's per-particle records: per layer h_in, z_fl1 (NT each)
// and the signs of z_fl2, then the signs of z_l0.
__host__ __device__ inline int record_slots(const Dims& d) {
  return d.num_blocks * (2 * (d.hidden / 8) + 1) + 1;
}

// ---- transposes and the weight-gradient products

__device__ __forceinline__ uint32_t movtrans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

// An 8 × 8 fp32 block M held as a C fragment's half (lane 4g + t: x0 =
// M[g][2t], x1 = M[g][2t + 1]) → y0 = M[2t][g], y1 = M[2t + 1][g]: movmatrix
// transposes the low and the high 16 bits of every element apart.
__device__ __forceinline__ void transpose8(float x0, float x1, float& y0, float& y1) {
  const uint32_t a = __float_as_uint(x0), b = __float_as_uint(x1);
  const uint32_t lo = movtrans(__byte_perm(a, b, 0x5410));
  const uint32_t hi = movtrans(__byte_perm(a, b, 0x7632));
  y0 = __uint_as_float(__byte_perm(lo, hi, 0x5410));
  y1 = __uint_as_float(__byte_perm(lo, hi, 0x7632));
}

// dz's B fragments for aᵀ·dz over the warp's 16 slots: the mma's k
// positions t and t + 4 of k-step ks are the slots 8·ks + 2t and
// 8·ks + 2t + 1, where `transpose8` puts them.
template <int ND>
__device__ __forceinline__ void dz_fragments(float (&bt)[ND][2][2], const float (&dz)[ND][4]) {
#pragma unroll
  for (int jn = 0; jn < ND; ++jn)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      transpose8(dz[jn][2 * ks], dz[jn][2 * ks + 1], bt[jn][ks][0], bt[jn][ks][1]);
}

// P (this lane's slots of one m-tile, n-tile jn at P + 32·jn) += A·dz, the
// m-tile's A fragments of both k-steps given (split), dz's B fragments
// split by truncation here: three TF32 products each.
template <int ND>
__device__ __forceinline__ void accumulate(float4* P, const tf32x3::Frag<4> (&A)[2],
                                           const float (&bt)[ND][2][2]) {
  using namespace tf32x3;
#pragma unroll
  for (int jn = 0; jn < ND; ++jn) {
    float4* slot = P + jn * 32;
    const float4 c = *slot;
    float acc[4] = {c.x, c.y, c.z, c.w}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      Frag<2> b;
      split_fast(bt[jn][ks][0], b.hi[0], b.lo[0]);
      split_fast(bt[jn][ks][1], b.hi[1], b.lo[1]);
      mma(small, A[ks].lo, b.hi);
      mma(acc, A[ks].hi, b.hi);
      mma(small, A[ks].hi, b.lo);
    }
    *slot = make_float4(acc[0] + small[0], acc[1] + small[1], acc[2] + small[2],
                        acc[3] + small[3]);
  }
}

// P (this lane's slot 0, slots 32 float4 apart) += aᵀ·dz over the warp's 16
// slots: a's NA and dz's ND n-tiles as C fragments, both transposed in
// registers and split by truncation; an odd NA leaves an m-tile's upper half
// zero. Slot mi·ND + jn holds m-tile mi (a's columns 16·mi …) × n-tile jn.
template <int NA, int ND>
__device__ __forceinline__ void outer_acc(float4* P, const float (&a)[NA][4],
                                          const float (&dz)[ND][4]) {
  using namespace tf32x3;
  constexpr int MT = (NA + 1) / 2;
  float bt[ND][2][2];
  dz_fragments(bt, dz);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    Frag<4> A[2];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      // an odd NA's last m-tile: its upper half transposes a's last n-tile
      // again, and is then zero
      const int upper = 2 * mi + 1 < NA ? 2 * mi + 1 : 2 * mi;
      float v[4];
      transpose8(a[2 * mi][2 * ks], a[2 * mi][2 * ks + 1], v[0], v[2]);
      transpose8(a[upper][2 * ks], a[upper][2 * ks + 1], v[1], v[3]);
      if (upper == 2 * mi) v[1] = v[3] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) split_fast(v[e], A[ks].hi[e], A[ks].lo[e]);
    }
    accumulate(P + mi * ND * 32, A, bt);
  }
}

// P (slots 32 float4 apart) += the column sums of dz over the warp's 16
// slots: slot jp holds n-tiles 2·jp (x, y) and 2·jp + 1 (z, w), at the
// lane's columns 2t, 2t + 1, every lane of a column the same sum.
template <int ND>
__device__ __forceinline__ void colsum_acc(float4* P, const float (&dz)[ND][4]) {
#pragma unroll
  for (int jp = 0; jp < (ND + 1) / 2; ++jp) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = 2 * jp + q < ND ? 2 * jp + q : ND - 1;
      if (2 * jp + q >= ND) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = dz[j][e] + dz[j][e + 2];
        s += __shfl_xor_sync(FULL, s, 4);
        s += __shfl_xor_sync(FULL, s, 8);
        s += __shfl_xor_sync(FULL, s, 16);
        v[2 * q + e] = s;
      }
    }
    float4* slot = P + jp * 32;
    const float4 c = *slot;
    *slot = make_float4(c.x + v[0], c.y + v[1], c.z + v[2], c.w + v[3]);
  }
}

// The lane's two outputs (columns c0 + lane and c0 + 32 + lane, 0 past
// n_out) of Σ_r v[r]·W[r·stride + c] over r < n: the product of v with the
// (n, stride) row-major W read from its column 0, which for a packed (out,
// in) matrix is v·W, the transpose's product. Every lane takes part.
template <class Vv>
__device__ __forceinline__ void tcols(float (&z)[2], const float* __restrict__ W, int stride,
                                      int n_out, int c0, const Vv& v, int n) {
  const int cols = min(n_out - c0, 64);
  float a[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  dense_seg(a, v, n, W + c0, stride, cols);
  const int lane = threadIdx.x & 31;
  float sum[2] = {(a[0][0] + a[0][1]) + (a[0][2] + a[0][3]), (a[1][0] + a[1][1]) + (a[1][2] + a[1][3])};
  if (cols <= 16) sum[0] += __shfl_xor_sync(FULL, sum[0], 16);
#pragma unroll
  for (int q = 0; q < 2; ++q) z[q] = lane + 32 * q < cols ? sum[q] : 0.f;
}

// dst[0, n) = src[0, n), by the calling warp's lanes.
__device__ __forceinline__ void warp_copy(float* dst, const float* src, int n) {
  for (int i = threadIdx.x & 31; i < n; i += 32) dst[i] = src[i];
}

// ---- the recorder

template <int H>
struct Recorder {
  static constexpr bool ON = true;
  static constexpr int NT = H / 8;
  float4* rec;  // this thread's record slot 0, slots T float4 apart
  int T;
  float* jr;    // the jet's per-jet records (JetRecLayout), shared memory
  JetRecLayout R;
  uint32_t zl0 = 0u;  // local_0's z ≥ 0, bit 4j + e
  float zh0[4];       // the head's pre-activations (its one tile)

  __device__ __forceinline__ void put(int slot, float4 v) const { rec[(size_t)slot * T] = v; }
  __device__ __forceinline__ float4 get(int slot) const { return rec[(size_t)slot * T]; }
  __device__ __forceinline__ int layer(int blk) const { return blk * (2 * NT + 1); }

  __device__ __forceinline__ void z_l0(int j, int e, float z) {
    if (z >= 0.f) zl0 |= 1u << (4 * j + e);
  }
  __device__ __forceinline__ void h_in(int blk, const float (&h)[NT][4]) {
#pragma unroll
    for (int j = 0; j < NT; ++j) put(layer(blk) + j, make_float4(h[j][0], h[j][1], h[j][2], h[j][3]));
  }
  __device__ __forceinline__ void z_fl1(int blk, const float (&z)[NT][4]) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
      put(layer(blk) + NT + j, make_float4(z[j][0], z[j][1], z[j][2], z[j][3]));
  }
  __device__ __forceinline__ void z_fl2(int blk, const float (&z)[NT][4]) {
    uint32_t bits = 0u;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (z[j][e] >= 0.f) bits |= 1u << (4 * j + e);
    put(layer(blk) + 2 * NT, make_float4(__uint_as_float(bits), 0.f, 0.f, 0.f));
  }
  __device__ __forceinline__ void z_h0(int jt, const float (&z)[1][4]) {
    if (jt == 0)
#pragma unroll
      for (int e = 0; e < 4; ++e) zh0[e] = z[0][e];
  }
  // warp 0: the pooled sums (blk −1: the projection's) and the denominator
  __device__ __forceinline__ void pooled(int blk, const LaneVec& s, float denom) {
    lane_store(jr + (blk < 0 ? R.s0 : R.blocks + blk * R.block_stride + R.s), s, H);
    if (blk < 0 && (threadIdx.x & 31) == 0) jr[R.denom] = denom;
  }
  __device__ __forceinline__ void g_in(int blk, const float* gv) {
    warp_copy(jr + R.blocks + blk * R.block_stride + R.gin, gv, R.zfg1 - R.gin);
  }
  __device__ __forceinline__ float* z_g0_at() const { return jr + R.zg0; }
  __device__ __forceinline__ float* z_g1_at() const { return jr + R.zg1; }
  __device__ __forceinline__ float* z_g2_at() const { return jr + R.zg2; }
  __device__ __forceinline__ float* z_fg1_at(int blk) const {
    return jr + R.blocks + blk * R.block_stride + R.zfg1;
  }
  __device__ __forceinline__ float* z_fg2_at(int blk) const {
    return jr + R.blocks + blk * R.block_stride + R.zfg2;
  }
};

// ---- the per-jet MLP backward, on warp 0

// The packed (out, in) weights that the per-jet MLP backward reads, each as
// (pointer, row stride): those of the packed buffer, or a compact copy in
// shared memory of the columns it reads (`copy_jet_weights`).
struct JetWeights {
  const float *g0, *g1, *g2, *blocks;
  int g0_stride, block_stride, fg1, fg1_stride, fg2, fl1, fl1_stride;
};

// In the packed buffer w: w_g0 over [mean ‖ sum ‖ temb], fc_global1 over
// [mean ‖ sum ‖ g ‖ temb], fc_local1's broadcast g columns.
__device__ __forceinline__ JetWeights packed_jet_weights(const float* w, const Layout& L,
                                                         const Dims& d) {
  const int H = d.hidden, Hg = d.hidden_glob, Et = d.emb_t;
  return {w + L.w_g0, w + L.w_g1, w + L.w_g2, w + L.blocks, 2 * H + Et, L.block_stride,
          L.fg1, 2 * H + Hg + Et, L.fg2, L.fl1 + H, H + Hg + Et};
}

// Floats of the compact copy: w_g0's first 2H columns, w_g1, w_g2, per layer
// fc_global1's first 2H + Hg columns, fc_global2, fc_local1's g columns.
__host__ __device__ inline int jet_weight_floats(const Dims& d) {
  const int H = d.hidden, Hg = d.hidden_glob;
  return pad4(3 * H * H + Hg * H + d.num_blocks * (H * (2 * H + Hg) + 2 * Hg * H));
}

// The compact copy at dst, made by the block's threads from the packed buffer.
__device__ __forceinline__ JetWeights copy_jet_weights(float* dst, const float* __restrict__ w,
                                                       const Layout& L, const Dims& d) {
  const int H = d.hidden, Hg = d.hidden_glob, T = blockDim.x;
  const JetWeights P = packed_jet_weights(w, L, d);
  JetWeights C;
  C.g0 = dst;
  C.g0_stride = 2 * H;
  C.g1 = C.g0 + 2 * H * H;
  C.g2 = C.g1 + H * H;
  C.blocks = C.g2 + Hg * H;
  C.fg1 = 0;
  C.fg1_stride = 2 * H + Hg;
  C.fg2 = H * (2 * H + Hg);
  C.fl1 = C.fg2 + Hg * H;
  C.fl1_stride = Hg;
  C.block_stride = C.fl1 + H * Hg;
  // (destination, source, rows, columns, source row stride)
  auto copy = [&](const float* to, const float* from, int rows, int cols, int stride) {
    float* o = const_cast<float*>(to);
    for (int i = threadIdx.x; i < rows * cols; i += T) o[i] = __ldg(from + (i / cols) * stride + i % cols);
  };
  copy(C.g0, P.g0, H, 2 * H, P.g0_stride);
  copy(C.g1, P.g1, H, H, H);
  copy(C.g2, P.g2, Hg, H, H);
  for (int b = 0; b < d.num_blocks; ++b) {
    const float* from = P.blocks + b * P.block_stride;
    const float* to = C.blocks + b * C.block_stride;
    copy(to + C.fg1, from + P.fg1, H, 2 * H + Hg, P.fg1_stride);
    copy(to + C.fg2, from + P.fg2, Hg, H, H);
    copy(to + C.fl1, from + P.fl1, H, Hg, P.fl1_stride);
  }
  return C;
}

// Shared vectors of the walk back: warp 0's per-jet MLP backward writes
// them; the whole block reads them after the next barrier.
struct Back {
  float* dg;     // cotangent of the global vector out of the current layer (Hg)
  float* dsg;    // its skip-connection sum (Hg)
  float* dzfg2;  // the current layer's dz_fg2 (Hg)
  float* dzg2;   // the projection's dz_g2 (Hg)
  float* dp;     // the pooled input's cotangent (2H + Hg)
  float* dsum;   // the current layer's pooled-sum cotangent (H)
  float* dsum0;  // the projection's (H)
  float* sdz1;   // the current layer's Σ_particles dz_fl1 (H)
  float* dzfg1;  // its dz_fg1 (H)
  float* dzg1;   // the projection's dz_g1 (H)
  float* dzg0;   // and dz_g0 (H)
};

// Shared floats of `Back`.
__host__ __device__ inline int back_floats(const Dims& d) {
  return 4 * pad4(d.hidden_glob) + pad4(2 * d.hidden + d.hidden_glob) + 6 * pad4(d.hidden);
}

__device__ __forceinline__ Back make_back(float* p, const Dims& d) {
  const int H = pad4(d.hidden), Hg = pad4(d.hidden_glob);
  Back K;
  K.dg = p;
  K.dsg = K.dg + Hg;
  K.dzfg2 = K.dsg + Hg;
  K.dzg2 = K.dzfg2 + Hg;
  K.dp = K.dzg2 + Hg;
  K.dsum = K.dp + pad4(2 * d.hidden + d.hidden_glob);
  K.dsum0 = K.dsum + H;
  K.sdz1 = K.dsum0 + H;
  K.dzfg1 = K.sdz1 + H;
  K.dzg1 = K.dzfg1 + H;
  K.dzg0 = K.dzg1 + H;
  return K;
}

// Warp 0, after the pool of layer blk's Σ dz_fl1 (sdz1, lane-held): the
// layer's per-jet backward (epic_pallas_vjp.py:170-190). Writes dsum, the
// new dg and the vectors of the layer's pairs.
__device__ __forceinline__ void jet_layer_backward(const JetWeights& J, const Dims& d, int blk,
                                                   const float* jr, const JetRecLayout& R,
                                                   const LaneVec& sdz1, const Back& K) {
  const int lane = threadIdx.x & 31;
  const int H = d.hidden, Hg = d.hidden_glob;
  const float* wb = J.blocks + blk * J.block_stride;
  const float* rb = jr + R.blocks + blk * R.block_stride;
  const float denom = jr[R.denom];
  // dz_fg2 = (dg + W_fl1[:, H:H+Hg]ᵀ·Σdz_fl1)·leaky'(z_fg2)
  for (int c0 = 0; c0 < Hg; c0 += 64) {
    float z[2];
    tcols(z, wb + J.fl1, J.fl1_stride, Hg, c0, sdz1, H);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = c0 + lane + 32 * q;
      if (c < Hg) {
        const float dg = K.dg[c];
        if (d.use_skip) K.dsg[c] += dg;
        K.dzfg2[c] = (dg + z[q]) * dleaky(rb[R.zfg2 + c]);
      }
    }
  }
  lane_store(K.sdz1, sdz1, H);
  __syncwarp();
  // dz_fg1 = W_fg2ᵀ·dz_fg2 · leaky'(z_fg1)
  LaneVec dzfg1;
  {
    float z[2];
    tcols(z, wb + J.fg2, H, H, 0, SmemVec{K.dzfg2}, Hg);
    const LaneVec zf = lane_load(rb + R.zfg1, H);
#pragma unroll
    for (int q = 0; q < 2; ++q) dzfg1.v[q] = z[q] * dleaky(zf.v[q]);
  }
  lane_store(K.dzfg1, dzfg1, H);
  // dp = W_fg1ᵀ·dz_fg1 over [mean ‖ sum ‖ g_in] (temb's cotangent is dropped)
  for (int c0 = 0; c0 < 2 * H + Hg; c0 += 64) {
    float z[2];
    tcols(z, wb + J.fg1, J.fg1_stride, 2 * H + Hg, c0, dzfg1, H);
    if (c0 + lane < 2 * H + Hg) K.dp[c0 + lane] = z[0];
    if (c0 + 32 + lane < 2 * H + Hg) K.dp[c0 + 32 + lane] = z[1];
  }
  __syncwarp();
  for (int c = lane; c < H; c += 32) K.dsum[c] = K.dp[H + c] + K.dp[c] / denom;
  for (int c = lane; c < Hg; c += 32) K.dg[c] = K.dzfg2[c] + K.dp[2 * H + c];
  __syncwarp();
}

// Warp 0, after the last layer's backward: the projection's global MLP
// backward (epic_pallas_vjp.py:192-212). Writes dsum0 and the vectors of
// the projection's pairs.
__device__ __forceinline__ void jet_projection_backward(const JetWeights& J, const Dims& d,
                                                        const float* jr, const JetRecLayout& R,
                                                        const Back& K) {
  const int lane = threadIdx.x & 31;
  const int H = d.hidden, Hg = d.hidden_glob;
  const float denom = jr[R.denom];
  for (int c = lane; c < Hg; c += 32) {
    const float dg = d.use_skip ? K.dg[c] + K.dsg[c] : K.dg[c];
    K.dzg2[c] = dg * dleaky(jr[R.zg2 + c]);
  }
  __syncwarp();
  const LaneVec zg1 = lane_load(jr + R.zg1, H), zg0 = lane_load(jr + R.zg0, H);
  LaneVec dzg1, dzg0;
  {
    float z[2];
    tcols(z, J.g2, H, H, 0, SmemVec{K.dzg2}, Hg);
#pragma unroll
    for (int q = 0; q < 2; ++q) dzg1.v[q] = z[q] * dleaky(zg1.v[q]);
    tcols(z, J.g1, H, H, 0, dzg1, H);
#pragma unroll
    for (int q = 0; q < 2; ++q) dzg0.v[q] = z[q] * dleaky(zg0.v[q]);
  }
  lane_store(K.dzg1, dzg1, H);
  lane_store(K.dzg0, dzg0, H);
  for (int c0 = 0; c0 < 2 * H; c0 += 64) {
    float z[2];
    tcols(z, J.g0, J.g0_stride, 2 * H, c0, dzg0, H);
    if (c0 + lane < 2 * H) K.dp[c0 + lane] = z[0];
    if (c0 + 32 + lane < 2 * H) K.dp[c0 + 32 + lane] = z[1];
  }
  __syncwarp();
  for (int c = lane; c < H; c += 32) K.dsum0[c] = K.dp[H + c] + K.dp[c] / denom;
  __syncwarp();
}

// Every thread: layer blk's pairs into the jet's record, the block's
// threads sharing the elements.
__device__ __forceinline__ void write_layer_pairs(const Dims& d, int blk, const float* jr,
                                                  const JetRecLayout& R, const float* temb,
                                                  const Back& K, float* pairs,
                                                  const PairLayout& P) {
  const int H = d.hidden, Hg = d.hidden_glob, Et = d.emb_t, T = blockDim.x;
  const float* rb = jr + R.blocks + blk * R.block_stride;
  float* pb = pairs + P.blocks + blk * P.block_stride;
  const float denom = jr[R.denom];
  for (int c = threadIdx.x; c < Hg; c += T) {
    pb[P.gt + c] = leaky(rb[R.zfg2 + c]);
    pb[P.dzfg2 + c] = K.dzfg2[c];
    pb[P.p + 2 * H + c] = rb[R.gin + c];
  }
  for (int c = threadIdx.x; c < Et; c += T) {
    pb[P.gt + Hg + c] = temb[c];
    pb[P.p + 2 * H + Hg + c] = temb[c];
  }
  for (int c = threadIdx.x; c < H; c += T) {
    const float s = rb[R.s + c];
    pb[P.p + c] = s / denom;
    pb[P.p + H + c] = s;
    pb[P.fa + c] = leaky(rb[R.zfg1 + c]);
    pb[P.sdz1 + c] = K.sdz1[c];
    pb[P.dzfg1 + c] = K.dzfg1[c];
  }
}

// Every thread, after the barrier that follows layer blk's per-jet backward
// (blk −1: none): the layer's pairs and, with `projection`, the
// projection's, into the jet's record.
__device__ __forceinline__ void write_pairs(const Dims& d, int blk, bool projection,
                                            const float* jr, const JetRecLayout& R,
                                            const float* temb, const Back& K, float* pairs,
                                            const PairLayout& P) {
  const int H = d.hidden, Hg = d.hidden_glob, Et = d.emb_t, T = blockDim.x;
  const float denom = jr[R.denom];
  if (blk >= 0) write_layer_pairs(d, blk, jr, R, temb, K, pairs, P);
  if (!projection) return;
  for (int c = threadIdx.x; c < Hg; c += T) pairs[P.dzg2 + c] = K.dzg2[c];
  for (int c = threadIdx.x; c < H; c += T) {
    const float s = jr[R.s0 + c];
    pairs[P.p0 + c] = s / denom;
    pairs[P.p0 + H + c] = s;
    pairs[P.ag1 + c] = leaky(jr[R.zg1 + c]);
    pairs[P.ag0 + c] = leaky(jr[R.zg0 + c]);
    pairs[P.dzg1 + c] = K.dzg1[c];
    pairs[P.dzg0 + c] = K.dzg0[c];
  }
  for (int c = threadIdx.x; c < Et; c += T) pairs[P.p0 + 2 * H + c] = temb[c];
}

// ---- the kernel

// Where a launch puts things: threads, shared memory, the warps' partial
// sums, the buffer's per-jet entries and the MLP's weights (each shared or
// global; the rest of the buffer is read through L1).
struct Plan {
  int threads, part_in_smem, prefix_in_smem, jet_weights_in_smem;
  size_t smem;
  int base_floats;  // shared floats before the partial sums
};

inline Plan make_plan(const Dims& d, int N) {
  Plan p;
  p.threads = 32 * ((N + 15) / 16);
  const int nwarps = p.threads / 32, H = d.hidden;
  p.base_floats = k1::staged_offset(nwarps, d) + make_jet_rec(d).total + back_floats(d) + 16 * H;
  const size_t part = (size_t)nwarps * make_part_layout(d).total * 128;
  const size_t jet_weights = jet_weight_floats(d);
  const size_t prefix = make_tc_layout(d).l0f;
  size_t floats = p.base_floats;
  p.part_in_smem = sizeof(float) * (floats + part) <= SMEM_BUDGET;
  if (p.part_in_smem) floats += part;
  // the buffer's per-jet entries, which warp 0's forward MLP reads
  p.prefix_in_smem = sizeof(float) * (floats + prefix) <= SMEM_BUDGET;
  if (p.prefix_in_smem) floats += prefix;
  p.jet_weights_in_smem = sizeof(float) * (floats + jet_weights) <= SMEM_BUDGET;
  if (p.jet_weights_in_smem) floats += jet_weights;
  p.smem = sizeof(float) * floats;
  return p;
}

// The backward of one jet after its recording rerun, on the calling warp's
// 16 slots: h the final local state, o the masked output layer, m the rows'
// masks, rec the recorder. Every thread of the block calls it.
template <int H>
__device__ __forceinline__ void backward_jet(const float* sw, const JetWeights& J,
                                             const TcLayoutT& LT, const Layout& L, const Dims& d,
                                             const Scratch& S, int jet, int N,
                                             const float* __restrict__ x,
                                             const int* __restrict__ k,
                                             const float* __restrict__ mask,
                                             const float* __restrict__ gout, Recorder<H>& rec,
                                             const float (&h)[H / 8][4], const float (&o)[2][4],
                                             const float (&m)[2], float4* part,
                                             const PartLayout& PL, const Back& K, float* pairs,
                                             const PairLayout& P) {
  constexpr int NT = H / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int rows[2] = {16 * warp + g, 16 * warp + g + 8};
  const float mcol[4] = {m[0], m[0], m[1], m[1]};
  const size_t p0 = (size_t)jet * N;
  const float* jr = rec.jr;
  const JetRecLayout& R = rec.R;
  const float* temb = S.temb - warp * pad4(d.emb_t);  // warp 0's copy

  // ---- the cotangents of the thread's rows: the discrete logits' (n-tile
  // of 8) and the continuous outputs' (columns 0-2 of an n-tile)
  float gd[1][4], gc[1][4];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const bool real = rows[hr] < N;
    const float* gp = gout + (p0 + rows[hr]) * (DC + V);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = 2 * tq + c;
      gd[0][2 * hr + c] = real ? gp[DC + i] : 0.f;
      gc[0][2 * hr + c] = real && i < DC ? gp[i] : 0.f;
    }
  }

  // ---- heads (epic_pallas_vjp.py:117-141): the head's cotangents unmasked,
  // the output layer's masked
  float dzo[2][4];
  if (d.add_discrete_head) {
    // each a with a column of ones after it: the m-tile's row 8 sums dz,
    // the bias's gradient
    const float one = tq == 0 ? 1.f : 0.f;
    float a[2][4] = {{0.f, 0.f, 0.f, 0.f}, {one, 0.f, one, 0.f}};
    float dz[1][4] = {{0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int e = 0; e < 4; ++e) a[0][e] = selu(rec.zh0[e]);
    outer_acc<2, 1>(part + PL.h1 * 32, a, gd);
    product<1, 1>(dz, gd, reinterpret_cast<const float4*>(sw + LT.h1T));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dz[0][e] *= dselu(rec.zh0[e]);
      a[0][e] = o[0][e];  // the pre-logits
    }
    outer_acc<2, 1>(part + PL.h0 * 32, a, dz);
    float dd[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    product<1, 1>(dd, dz, reinterpret_cast<const float4*>(sw + LT.h0T));
#pragma unroll
    for (int e = 0; e < 4; ++e) dzo[0][e] = dd[0][e] * mcol[e];
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) dzo[0][e] = gd[0][e] * mcol[e];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) dzo[1][e] = gc[0][e] * mcol[e];
  outer_acc<NT, 2>(part + PL.out * 32, h, dzo);
  colsum_acc<2>(part + PL.bout * 32, dzo);
  float dh[NT][4], dsl[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dh[j][e] = 0.f;
      dsl[j][e] = 0.f;
    }
  product<2, NT>(dh, dzo, reinterpret_cast<const float4*>(sw + LT.outT));

  // ---- EPiC layers, reversed (epic_pallas_vjp.py:148-190)
  if (warp == 0)
    for (int c = lane; c < d.hidden_glob; c += 32) {
      K.dg[c] = 0.f;
      K.dsg[c] = 0.f;
    }
  for (int blk = d.num_blocks - 1; blk >= 0; --blk) {
    float4* pb = part + (PL.blocks + blk * PL.block_stride) * 32;
    float hin[NT][4], l1[NT][4], dz2[NT][4], dz1[NT][4];
    const uint32_t s2 = __float_as_uint(rec.get(rec.layer(blk) + 2 * NT).x);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 a = rec.get(rec.layer(blk) + j), z = rec.get(rec.layer(blk) + NT + j);
      const float av[4] = {a.x, a.y, a.z, a.w}, zv[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        hin[j][e] = av[e];
        dz1[j][e] = dleaky(zv[e]);  // leaky'(z_fl1) until dz_fl1
        l1[j][e] = leaky(zv[e]);
        if (d.use_skip) dsl[j][e] += dh[j][e];
        // h_out = leaky(z_fl2)·m + skip
        dz2[j][e] = dh[j][e] * mcol[e] * ((s2 >> (4 * j + e)) & 1u ? 1.f : 0.01f);
      }
    }
    outer_acc<NT, NT>(pb + PL.fl2 * 32, l1, dz2);
    colsum_acc<NT>(pb + PL.bfl2 * 32, dz2);
    {
      float dl1[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dl1[j][e] = 0.f;
      product<NT, NT>(dl1, dz2, reinterpret_cast<const float4*>(sw + LT.blocks + blk * LT.block_stride + LT.fl2T));
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dz1[j][e] *= dl1[j][e];
    }
    // Σ_particles dz_fl1 reaches the per-jet MLP; warp 0 runs its backward
    // while every other warp adds its particles' products
    const LaneVec sdz1 = pool<H, false>(dz1, 0.f, S.red).s;
    if (warp == 0) {
      jet_layer_backward(J, d, blk, jr, R, sdz1, K);
      if (blk == 0) jet_projection_backward(J, d, jr, R, K);
    }
    outer_acc<NT, NT>(pb + PL.fl1 * 32, hin, dz1);
    // dh_in = dz_fl2 (the residual) + dz_fl1·W_fl1[:, :H]
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dh[j][e] = dz2[j][e];
    product<NT, NT>(dh, dz1, reinterpret_cast<const float4*>(sw + LT.blocks + blk * LT.block_stride + LT.fl1T));
    __syncthreads();  // dsum (and at layer 0 dsum0) and the pairs' vectors written
    write_pairs(d, blk, blk == 0, jr, R, temb, K, pairs, P);
    // s = pool(h_in·mask) → dh_in += dsum·mask
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 ds = *reinterpret_cast<const float2*>(K.dsum + 8 * j + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) dh[j][e] = fmaf(e & 1 ? ds.y : ds.x, mcol[e], dh[j][e]);
    }
  }
  if (d.num_blocks == 0) {
    if (warp == 0) jet_projection_backward(J, d, jr, R, K);
    __syncthreads();
    write_pairs(d, -1, true, jr, R, temb, K, pairs, P);
  }

  // ---- local_0 (epic_pallas_vjp.py:214-224): h = leaky(z_l0)·m, s0 =
  // pool(h); Q += Rᵀ·dz_l0 with R's rows built at the transposed places
  float dzl0[NT][4], dzm[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 ds = *reinterpret_cast<const float2*>(K.dsum0 + 8 * j + 2 * tq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float dhv = d.use_skip ? dh[j][e] + dsl[j][e] : dh[j][e];
      const float sl = (rec.zl0 >> (4 * j + e)) & 1u ? 1.f : 0.01f;
      dzl0[j][e] = (dhv * mcol[e] + (e & 1 ? ds.y : ds.x) * mcol[e]) * sl;
      dzm[j][e] = dzl0[j][e] * mcol[e];
    }
  }
  {
    // R (16 slots × 16 columns) at the mma's A places: lane (g, t) takes
    // columns g (a0, a2) and g + 8 (a1, a3) of the slots 8·ks + 2t (+1)
    using namespace tf32x3;
    Frag<4> A[2];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int row = 16 * warp + 8 * ks + 2 * tq + u;
        const bool real = row < N;
        const size_t p = p0 + row;
        const float mv = real ? mask[p] : 0.f;
        const float xv = real && g < DC ? x[p * DC + g] : 0.f;
        const int kv = real ? k[p] : -1;
        const float lo = g < DC ? xv * mv : g == DC ? mv : g == DC + 1 ? 1.f : 0.f;
        const float up = kv == g ? mv : 0.f;
        split_fast(lo, A[ks].hi[2 * u], A[ks].lo[2 * u]);
        split_fast(up, A[ks].hi[2 * u + 1], A[ks].lo[2 * u + 1]);
      }
    float bt[NT][2][2];
    dz_fragments(bt, dzl0);
    accumulate(part + PL.q * 32, A, bt);
  }
  // local_0's time columns: temb·m is the same for every particle
  const LaneVec q3 = pool<H, false>(dzm, 0.f, S.red).s;
  if (warp == 0) {
    for (int c = lane; c < d.emb_t; c += 32) pairs[P.temb + c] = temb[c];
    lane_store(pairs + P.q3, q3, H);
    if (lane == 0) pairs[P.one] = 1.f;
  }
}

// ---- after a block's last jet: its warps' partial sums and its pairs into
// its gradient row

// Σ over the warps, in order, of component `comp` of a lane's slot.
__device__ __forceinline__ float warp_sum(const float4* part, int per_warp, int nwarps, int slot,
                                          int lane, int comp) {
  const float* p = reinterpret_cast<const float*>(part) + ((size_t)slot * 32 + lane) * 4 + comp;
  float s = 0.f;
  for (int w = 0; w < nwarps; ++w) s += p[(size_t)w * per_warp * 128];
  return s;
}

// An outer_acc product's n_i × n_o elements (a's column i, dz's column o),
// summed over the warps: put(i, o, value). Its slots from `slot` on, ND
// n-tiles of dz.
template <class Put>
__device__ __forceinline__ void fold_product(const float4* part, int per_warp, int nwarps,
                                             int slot, int ND, int n_i, int n_o, Put put) {
  for (int e = threadIdx.x; e < n_i * n_o; e += blockDim.x) {
    const int i = e / n_o, o = e - i * n_o;
    const int gi = i & 15, oc = o & 7;
    const int s = slot + (i >> 4) * ND + (o >> 3);
    const int lane = 4 * (gi & 7) + (oc >> 1), comp = 2 * (gi >> 3) + (oc & 1);
    put(i, o, warp_sum(part, per_warp, nwarps, s, lane, comp));
  }
}

// A colsum_acc's n_o column sums, summed over the warps: put(o, value).
template <class Put>
__device__ __forceinline__ void fold_colsum(const float4* part, int per_warp, int nwarps, int slot,
                                            int n_o, Put put) {
  for (int o = threadIdx.x; o < n_o; o += blockDim.x) {
    const int oc = o & 7;
    put(o, warp_sum(part, per_warp, nwarps, slot + (o >> 4), oc >> 1, 2 * ((o >> 3) & 1) + (oc & 1)));
  }
}

__device__ void fold_partials(const float4* part, int nwarps, const Dims& d, const Layout& L,
                              const PartLayout& PL, const float* __restrict__ w, float* Qs,
                              float* grad) {
  const int H = d.hidden, Hg = d.hidden_glob, Et = d.emb_t, Ex = d.emb_x, Ek = d.emb_k;
  const int n_l0 = Et + Ex + Ek, n_l1 = H + Hg + Et, NT = H / 8, PS = PL.total;
  float* gh = grad + L.heads;
  fold_product(part, PS, nwarps, PL.out, 2, H, DC + V, [&](int i, int o, float v) {
    gh[o < V ? L.out_d + o * H + i : L.out_c + (o - V) * H + i] += v;
  });
  fold_colsum(part, PS, nwarps, PL.bout, DC + V, [&](int o, float v) {
    gh[o < V ? L.b_out_d + o : L.b_out_c + o - V] += v;
  });
  if (d.add_discrete_head) {
    fold_product(part, PS, nwarps, PL.h1, 1, V + 1, V, [&](int i, int o, float v) {
      gh[i < V ? L.h1 + o * V + i : L.b_h1 + o] += v;
    });
    fold_product(part, PS, nwarps, PL.h0, 1, V + 1, V, [&](int i, int o, float v) {
      gh[i < V ? L.h0 + o * V + i : L.b_h0 + o] += v;
    });
  }
  for (int blk = 0; blk < d.num_blocks; ++blk) {
    float* gb = grad + L.blocks + blk * L.block_stride;
    const int pb = PL.blocks + blk * PL.block_stride;
    fold_product(part, PS, nwarps, pb + PL.fl2, NT, H, H, [&](int i, int o, float v) {
      gb[L.fl2 + o * H + i] += v;
    });
    fold_colsum(part, PS, nwarps, pb + PL.bfl2, H, [&](int o, float v) { gb[L.bfl2 + o] += v; });
    fold_product(part, PS, nwarps, pb + PL.fl1, NT, H, H, [&](int i, int o, float v) {
      gb[L.fl1 + o * n_l1 + i] += v;
    });
  }
  // Q = Rᵀ·dz_l0 (16 × H), R = [x·m, m, 1, 0, 0, 0, onehot(k)·m]
  fold_product(part, PS, nwarps, PL.q, NT, 16, H, [&](int r, int o, float v) { Qs[r * H + o] = v; });
  __syncthreads();
  for (int o = threadIdx.x; o < H; o += blockDim.x) grad[L.b_l0 + o] += Qs[4 * H + o];
  // w_l0's x and token columns: the embedded features are x·w_xᵀ + b_x and a
  // token's table row, so Σ_p dz_l0·feature·m is a product of Q with them
  for (int e = threadIdx.x; e < H * (Ex + Ek); e += blockDim.x) {
    const int o = e / (Ex + Ek), c = e - o * (Ex + Ek);
    float v = 0.f;
    if (c < Ex) {
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) v = fmaf(w[L.w_x + c * DC + cc], Qs[cc * H + o], v);
      v = fmaf(w[L.b_x + c], Qs[DC * H + o], v);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) v = fmaf(w[L.table + u * Ek + c - Ex], Qs[(8 + u) * H + o], v);
    }
    grad[L.w_l0 + o * n_l0 + Et + c] += v;
  }
  // dfeats = W_l0ᵀ·dz_l0·m reaches w_x, b_x and the table through Q
  for (int e = threadIdx.x; e < Ex * (DC + 1) + V * Ek; e += blockDim.x) {
    float v = 0.f;
    if (e < Ex * (DC + 1)) {
      const int i = e / (DC + 1), c = e - i * (DC + 1);
      for (int o = 0; o < H; ++o) v = fmaf(w[L.w_l0 + o * n_l0 + Et + i], Qs[c * H + o], v);
      grad[c < DC ? L.w_x + i * DC + c : L.b_x + i] += v;
    } else {
      const int u = (e - Ex * (DC + 1)) / Ek, c = e - Ex * (DC + 1) - u * Ek;
      for (int o = 0; o < H; ++o) v = fmaf(w[L.w_l0 + o * n_l0 + Et + Ex + c], Qs[(8 + u) * H + o], v);
      grad[L.table + u * Ek + c] += v;
    }
  }
}

// grad[g.goff + o·g.ld + i] += Σ_jets dz_jet[o]·a_jet[i] for every group,
// jets in the order the block walked them. A thread takes four columns i of
// a row o at a time (a's entries are padded to 4 floats and 16-byte
// aligned), the loads of four jets in flight together.
__device__ void contract_pairs(const float* pairs, int n_jets, const Dims& d, const Layout& L,
                               const PairLayout& P, float* grad) {
  for (int gi = 0; gi < n_groups(d); ++gi) {
    const Group G = group(d, L, P, gi);
    const int n_a4 = (G.n_a + 3) / 4;
    for (int e = threadIdx.x; e < G.n_out * n_a4; e += blockDim.x) {
      const int o = e / n_a4, i = 4 * (e - o * n_a4);
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int j = 0; j < n_jets; ++j) {
        const float* rec = pairs + (size_t)j * P.total;
        const float dz = rec[G.dz + o];
        const float4 a = *reinterpret_cast<const float4*>(rec + G.a + i);
        acc[0] = fmaf(dz, a.x, acc[0]);
        acc[1] = fmaf(dz, a.y, acc[1]);
        acc[2] = fmaf(dz, a.z, acc[2]);
        acc[3] = fmaf(dz, a.w, acc[3]);
      }
      for (int c = 0; c < 4 && i + c < G.n_a; ++c) grad[G.goff + o * G.ld + i + c] += acc[c];
    }
  }
}

// ---- the kernel and its launch

template <int H>
__global__ void __launch_bounds__(MAX_K3_THREADS, 1)
epic_backward_kernel(const float* __restrict__ buf, const float* __restrict__ w, Dims d,
                     const float* __restrict__ t, const float* __restrict__ x,
                     const int* __restrict__ k, const float* __restrict__ mask,
                     const float* __restrict__ gout, float* __restrict__ fwd_out,
                     float4* __restrict__ records, float4* __restrict__ gpart,
                     float* __restrict__ rows, float* __restrict__ pair_log, int jets_per_block,
                     int B, int N, int base_floats, int part_in_smem, int prefix_in_smem,
                     int jet_weights_in_smem) {
  constexpr int NT = H / 8;
  extern __shared__ __align__(16) float smem[];
  const TcLayout L1 = make_tc_layout(d);
  const TcLayoutT LT = make_tc_layout_t(d);
  const Layout L = make_layout(d);
  const JetRecLayout R = make_jet_rec(d);
  const PartLayout PL = make_part_layout(d);
  const PairLayout P = make_pair_layout(d);
  const int T = blockDim.x, nwarps = T >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Scratch S = k1::scratch(smem, d);
  float* jr = smem + k1::staged_offset(nwarps, d);
  const Back K = make_back(jr + R.total, d);
  float* Qs = jr + R.total + back_floats(d);
  float* after = smem + base_floats;
  float4* part_all = gpart + (size_t)blockIdx.x * nwarps * PL.total * 32;
  if (part_in_smem) {
    part_all = reinterpret_cast<float4*>(after);
    after += (size_t)nwarps * PL.total * 128;
  }
  const float* sw = buf;  // the buffer, and its per-jet entries
  const float* swj = buf;
  if (prefix_in_smem) {
    for (int i = threadIdx.x; i < L1.l0f / 4; i += T)
      reinterpret_cast<float4*>(after)[i] = __ldg(reinterpret_cast<const float4*>(buf) + i);
    swj = after;
    after += L1.l0f;
  }
  const JetWeights J = jet_weights_in_smem ? copy_jet_weights(after, w, L, d)
                                           : packed_jet_weights(w, L, d);
  float4* part = part_all + (size_t)warp * PL.total * 32 + lane;
  for (int s = 0; s < PL.total; ++s) part[s * 32] = make_float4(0.f, 0.f, 0.f, 0.f);
  float* grad = rows + (size_t)blockIdx.x * L.total;
  for (int i = threadIdx.x; i < L.total; i += T) grad[i] = 0.f;
  float4* rec_base = records + (size_t)blockIdx.x * record_slots(d) * T + threadIdx.x;
  float* pairs = pair_log + (size_t)blockIdx.x * jets_per_block * P.total;
  __syncthreads();

  int n_jets = 0;
  for (int jet = blockIdx.x; jet < B; jet += gridDim.x, ++n_jets) {
    Recorder<H> rec;
    rec.rec = rec_base;
    rec.T = T;
    rec.jr = jr;
    rec.R = R;
    float h[NT][4], o[2][4], m[2];
    k1::forward_jet<H, false>(sw, swj, L1, d, S, jet, N, t, x, k, mask, fwd_out, nullptr, rec, h, o, m);
    backward_jet<H>(sw, J, LT, L, d, S, jet, N, x, k, mask, gout, rec, h, o, m, part, PL, K,
                    pairs + (size_t)n_jets * P.total, P);
    __syncthreads();  // the jet's scratch is free for the next jet
  }
  fold_partials(part_all, nwarps, d, L, PL, w, Qs, grad);
  contract_pairs(pairs, n_jets, d, L, P, grad);
}

// out[e] = Σ_rows rows[row, e], rows in order.
__global__ void reduce_partials(const float* __restrict__ rows, int n_rows, int n,
                                float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int r = 0; r < n_rows; ++r) s += rows[(size_t)r * n + e];
  out[e] = s;
}

inline bool backward_dims_supported(const Dims& d) {
  return token_layout(d) && k1::forward_dims_supported(d);
}

// Floats of the scratch at `grid` blocks, in its order: the records
// (float4), the warps' partial sums when they live in global memory
// (float4), the pair logs (16-byte aligned records), the blocks' gradient
// rows.
inline long long scratch_floats(const Dims& d, const Plan& p, int grid, int jets_per_block) {
  const int nwarps = p.threads / 32;
  const long long part = p.part_in_smem ? 0 : (long long)nwarps * make_part_layout(d).total * 128;
  return (long long)grid * ((long long)record_slots(d) * p.threads * 4 + part +
                            make_layout(d).total +
                            (long long)jets_per_block * make_pair_layout(d).total);
}

template <int H>
cudaError_t workspace(const Dims& d, int B, int N, int* grid, long long* floats) {
  const Plan p = make_plan(d, N);
  auto kernel = epic_backward_kernel<H>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  int blocks;
  if ((err = resident_blocks((const void*)kernel, p.threads, p.smem, &blocks)) != cudaSuccess)
    return err;
  *grid = B < blocks ? (B < 1 ? 1 : B) : blocks;
  *floats = scratch_floats(d, p, *grid, (B + *grid - 1) / *grid);
  return cudaSuccess;
}

template <int H>
cudaError_t launch(const float* buf, const float* w, const Dims& d, const float* t, const float* x,
                   const int* k, const float* mask, const float* g, float* out, float* fwd_out,
                   float* scratch, int grid, int B, int N, cudaStream_t stream) {
  const Plan p = make_plan(d, N);
  auto kernel = epic_backward_kernel<H>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  const int jets_per_block = (B + grid - 1) / grid;
  const int nwarps = p.threads / 32;
  auto* records = reinterpret_cast<float4*>(scratch);
  float4* gpart = records + (size_t)grid * record_slots(d) * p.threads;
  float* pair_log = reinterpret_cast<float*>(
      gpart + (p.part_in_smem ? 0 : (size_t)grid * nwarps * make_part_layout(d).total * 32));
  float* rows = pair_log + (size_t)grid * jets_per_block * make_pair_layout(d).total;
  const int n = make_layout(d).total;
  kernel<<<grid, p.threads, p.smem, stream>>>(buf, w, d, t, x, k, mask, g, fwd_out, records, gpart,
                                              rows, pair_log, jets_per_block, B, N, p.base_floats,
                                              p.part_in_smem, p.prefix_in_smem,
                                              p.jet_weights_in_smem);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_partials<<<(n + 255) / 256, 256, 0, stream>>>(rows, grid, n, out);
  return cudaGetLastError();
}

}  // namespace k3
}  // namespace mmp

extern "C" int mmp_epic_backward_workspace(int B, int N, const int* dims, int* grid,
                                           long long* floats) {
  using namespace mmp;
  const Dims d = dims_from(dims);
  if (!k3::backward_dims_supported(d) || N < 1 || N > MAX_THREADS || B < 0)
    return cudaErrorInvalidValue;
  switch (d.hidden) {
    case 16: return k3::workspace<16>(d, B, N, grid, floats);
    case 32: return k3::workspace<32>(d, B, N, grid, floats);
    case 64: return k3::workspace<64>(d, B, N, grid, floats);
    default: return cudaErrorInvalidValue;
  }
}

// buf: the buffer K1 read (ops/epic_cuda.py::narrow_buffer: K1's entries,
// then the transposed fragments); w: the packed weights (the per-jet MLP's
// transposed products and local_0's input side read them); fwd_out: null,
// or (B, N, 3 + V) for the rerun's outputs.
extern "C" int mmp_epic_backward(const void* buf, const void* w, const void* t, const void* x,
                                 const void* k, const void* mask, const void* g, void* out,
                                 void* fwd_out, void* scratch, int grid, int B, int N,
                                 const int* dims, void* stream) {
  using namespace mmp;
  const Dims d = dims_from(dims);
  if (!k3::backward_dims_supported(d) || N < 1 || N > MAX_THREADS || B < 0 || grid < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const auto* bf = static_cast<const float*>(buf);
  const auto* wf = static_cast<const float*>(w);
  const auto* tf = static_cast<const float*>(t);
  const auto* xf = static_cast<const float*>(x);
  const auto* ki = static_cast<const int*>(k);
  const auto* mf = static_cast<const float*>(mask);
  const auto* gf = static_cast<const float*>(g);
  auto* of = static_cast<float*>(out);
  auto* ff = static_cast<float*>(fwd_out);
  auto* sf = static_cast<float*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d.hidden) {
    case 16: return k3::launch<16>(bf, wf, d, tf, xf, ki, mf, gf, of, ff, sf, grid, B, N, s);
    case 32: return k3::launch<32>(bf, wf, d, tf, xf, ki, mf, gf, of, ff, sf, grid, B, N, s);
    case 64: return k3::launch<64>(bf, wf, d, tf, xf, ki, mf, gf, of, ff, sf, grid, B, N, s);
    default: return cudaErrorInvalidValue;
  }
}
