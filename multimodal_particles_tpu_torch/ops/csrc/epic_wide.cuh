// Shared EPiC forward for the wide hand-written Hopper kernels
// (epic_wide_forward.cu, epic_wide_backward.cu), as the JAX wide kernels share
// `_forward_acts_wide` (multimodal_particles_tpu/ops/epic_pallas_wide.py:97-191).
//
// The narrow kernels (narrow_tc.cuh) keep a warp's 16 particles' hidden
// vectors in its mma fragments and their whole buffer in shared memory. At
// hidden 128 neither fits: one fc_local1 weight is 192 KB. The wide kernels
// are a chain of matrix products through shared memory instead.
//
// Design: one thread block of 256 threads per jet, every width 128 (the other
// widths up to 512 and heads past 64: a cluster of blocks, epic_wide_any.cuh).
//   * A jet's activations are (128 rows, 128 features) float32 tiles in
//     shared memory, rows padded to LDA_TC floats: h and the local hidden
//     l1; the skip copy h0 lives in registers. Rows past the jet's N carry
//     mask 0.
//   * The per-particle products (fc_local1's particle third, fc_local2) run
//     on the tensor cores (gemm_wg: wgmma under the 3×TF32 split of
//     tf32x3.cuh) on weight stages the wrapper lays out, streamed through a
//     ring of cp.async stages in the third tile's place. local_0's particle
//     two thirds are folded with the embeddings into small tables.
//   * The concatenated inputs of fc_local1 and local_0 are never built: the
//     broadcast thirds (g_new ‖ temb, and temb) are the same for every
//     particle of a jet, so they enter as one per-jet vector-matrix product
//     added like a bias; only h·W_fl1[0:128] is per particle.
//   * Masked per-jet sums are column sums over the tile in shared memory;
//     the per-jet global MLP is vector-matrix products by the whole block.
//   * A recorder (template parameter Rec) receives the activations that the
//     backward kernel reads back (its recording rerun is this forward);
//     NoRecord compiles to nothing.
//   * The forward kernel alone also takes the two trunks of the absorbing and
//     transdimensional families (`wide_forward_jet_ext`): the folded
//     Linear-discrete input (FOLD: the discrete embedding is a Dense over the
//     particle's V channel values, so k_emb = values·table + b_k fills the
//     tile the token lookup fills; the concatenated features stay 384 wide),
//     a discrete head of any hidden width up to MAX_WIDE_HEAD (WIDE_HEAD: a
//     warp a row, a lane two hidden units), and the trunk's last local
//     hidden state as a third output. Each is a template flag or a null
//     pointer, so that the token, 8-wide-head instantiation is the MBM one.
#pragma once

#include <cuda_runtime.h>
#include <math.h>


#include "tf32x3.cuh"

namespace mmpw {

constexpr int DC = 3;         // continuous features per particle
constexpr int V = 8;          // token vocabulary
constexpr int NOUT = DC + V;  // head outputs per particle
constexpr int WD = 128;       // every hidden and embedding width
constexpr int ROWS = 128;     // particle slots per jet
constexpr int THREADS = 256;
constexpr int MAT = ROWS * WD;

// head_hidden: hidden width of the discrete head's MLP; fold_discrete: the
// Linear-discrete input (a Dense over the V channel values in place of the
// token table). The backward kernel is written for a head of width V and a
// token input and refuses anything else (dims_supported); the forward kernel
// takes both (forward_dims_supported).
struct Dims {
  int hidden, hidden_glob, emb_t, emb_x, emb_k, num_blocks, use_skip, add_discrete_head;
  int head_hidden, fold_discrete;
};

inline Dims dims_from(const int* a) {
  return Dims{a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9]};
}

inline bool dims_supported(const Dims& d) {
  return d.hidden == WD && d.hidden_glob == WD && d.emb_t == WD && d.emb_x == WD &&
         d.emb_k == WD && d.num_blocks >= 0 && d.head_hidden == V && d.fold_discrete == 0;
}

// the widest discrete head of this header's forward kernel (its weights staged
// in shared memory); a wider one takes the general kernel (epic_wide_any.cuh)
constexpr int MAX_WIDE_HEAD = 64;

inline bool forward_dims_supported(const Dims& d) {
  return d.hidden == WD && d.hidden_glob == WD && d.emb_t == WD && d.emb_x == WD &&
         d.emb_k == WD && d.num_blocks >= 0 && d.head_hidden >= 1 &&
         d.head_hidden <= MAX_WIDE_HEAD && (d.fold_discrete == 0 || d.fold_discrete == 1);
}

// Offsets in floats into the packed buffer; matrices are (in, out) row-major.
// Block offsets are from the start of a block, head offsets absolute.
struct Layout {
  int w_x, b_x, table, b_k, w_l0, b_l0, w_g0, b_g0, w_g1, b_g1, w_g2, b_g2;
  int blocks, block_stride;
  int fg1, bfg1, fg2, bfg2, fl1, bfl1, fl2, bfl2;
  int out_c, b_out_c, out_d, b_out_d, h0, b_h0, h1, b_h1;
  int total, row_stride;  // row_stride: total rounded up to a float4
};

// head_hidden and fold as in Dims; the defaults are the backward kernel's
// layout.
__host__ __device__ inline Layout make_layout(int num_blocks, int head_hidden = V,
                                              bool fold = false) {
  Layout L;
  int o = 0;
  L.w_x = o;   o += DC * WD;
  L.b_x = o;   o += WD;
  L.table = o; o += V * WD;     // with fold: the folded Dense, (V, 128)
  L.b_k = o;   o += fold ? WD : 0;  // and its bias
  L.w_l0 = o;  o += 3 * WD * WD;
  L.b_l0 = o;  o += WD;
  L.w_g0 = o;  o += 3 * WD * WD;
  L.b_g0 = o;  o += WD;
  L.w_g1 = o;  o += WD * WD;
  L.b_g1 = o;  o += WD;
  L.w_g2 = o;  o += WD * WD;
  L.b_g2 = o;  o += WD;
  L.blocks = o;
  int b = 0;
  L.fg1 = b;  b += 4 * WD * WD;
  L.bfg1 = b; b += WD;
  L.fg2 = b;  b += WD * WD;
  L.bfg2 = b; b += WD;
  L.fl1 = b;  b += 3 * WD * WD;
  L.bfl1 = b; b += WD;
  L.fl2 = b;  b += WD * WD;
  L.bfl2 = b; b += WD;
  L.block_stride = b;
  o += num_blocks * b;
  L.out_c = o;   o += WD * DC;
  L.b_out_c = o; o += DC;
  L.out_d = o;   o += WD * V;
  L.b_out_d = o; o += V;
  L.h0 = o;      o += V * head_hidden;
  L.b_h0 = o;    o += head_hidden;
  L.h1 = o;      o += head_hidden * V;
  L.b_h1 = o;    o += V;
  L.total = o;
  L.row_stride = (o + 3) & ~3;
  return L;
}

// Offsets of the per-jet vectors in shared memory, in floats. g_new and temb
// are adjacent: together they are the broadcast input of fc_local1.
constexpr int V_MASK = 0, V_X = 128, V_K = 512, V_GNEW = 640, V_TEMB = 768, V_P = 896,
              V_VA = 1408, V_VB = 1536, V_G = 1664, V_GSKIP = 1792, V_CL1 = 1920, V_CT = 2048;

// Head weights staged in the (idle) staging area, [output][input].
constexpr int T_HW = 0, T_BO = NOUT * WD, T_WH0 = T_BO + 16, T_BH0 = T_WH0 + 64,
              T_WH1 = T_BH0 + 8, T_BH1 = T_WH1 + 64, T_DZ = 2048;
// A wide head's weights in the same buffer, [input][output] as packed:
// W_h0 (V, head_hidden), W_h1 (head_hidden, V).
constexpr int TW_WH0 = T_BO + 16, TW_BH0 = TW_WH0 + V * MAX_WIDE_HEAD,
              TW_WH1 = TW_BH0 + MAX_WIDE_HEAD, TW_BH1 = TW_WH1 + MAX_WIDE_HEAD * V,
              TW_END = TW_BH1 + V;

// Shared memory of the forward: the activation tiles h (S0) and l1 (S1) with
// rows padded to LDA_TC floats, so that the A-fragment reads hit 32 banks; in
// the third tile's place the ring of TC_STAGES prepared weight stages (the
// skip copy h0 lives in registers, and local_0 needs no embedding tiles: its
// per-particle products are folded into per-jet tables by the wrapper); a
// small staging area (the heads' weights, local_0's tables); the per-jet
// vectors (V_MASK … V_CT) and the reduction buffer. The backward kernel
// takes this plan and its own vectors after them.
constexpr int LDA_TC = WD + 4;
constexpr int TC_KT = 8;                   // input rows a stage: one k-step of wgmma
constexpr int TC_STAGE = 2 * TC_KT * WD;   // floats a stage: its TF32 hi and lo halves
constexpr int TC_STAGES = 8;               // stages in the ring; 6 are fetched ahead
constexpr int TC_STAGING = 4096;           // floats of the staging area
constexpr int S_TILE_TC = 3 * ROWS * LDA_TC;
constexpr int S_VEC_TC = S_TILE_TC + TC_STAGING;
constexpr int V_RED_TC = V_CT + WD, V_END_TC = V_RED_TC + 8 * WD;
constexpr size_t SMEM_BYTES_TC = sizeof(float) * (size_t)(S_VEC_TC + V_END_TC);
static_assert(SMEM_BYTES_TC <= 232448, "over a block's 227 KB of shared memory");
static_assert(TC_STAGES * TC_STAGE <= ROWS * LDA_TC, "the ring overruns the third tile");
static_assert(TW_END <= TC_STAGING, "a wide head's weights overrun the staging area");
// local_0's tables in the staging area, as the wrapper packs them: x's
// (3, 128), the discrete input's (V, 128), the constant row (128)
constexpr int L0_X = 0, L0_K = DC * WD, L0_C = L0_K + V * WD, L0_END = L0_C + WD;
static_assert(L0_END <= TC_STAGING, "local_0's tables overrun the staging area");
// prepared weights of one EPiC layer: fc_local1's particle third, then fc_local2
constexpr int TC_FL2 = (WD / TC_KT) * TC_STAGE, TC_LAYER = 2 * TC_FL2;

__device__ __forceinline__ float leaky(float x) { return x >= 0.f ? x : 0.01f * x; }

__device__ __forceinline__ float selu(float x) {
  const float alpha = 1.6732632423543772f, scale = 1.0507009873554805f;
  return scale * (x > 0.f ? x : alpha * expm1f(x));
}

// A (128, 128) product result in registers as the tensor cores hold it:
// warpgroup q (warps 4q … 4q + 3) owns rows 64q … 64q + 63, warp w of it 16 of
// them, in the wgmma.m64n128k8 accumulator layout (tf32x3.cuh). A thread's
// elements sit at the same (row, column) in every product.
struct WgAcc {
  float v[64];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 64; ++i) v[i] = 0.f;
  }
  template <class F>
  __device__ __forceinline__ void each(F f) const {
    const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
    const int r0 = 64 * (warp >> 2) + 16 * (warp & 3) + g;
#pragma unroll
    for (int i = 0; i < 64; ++i) f(i, r0 + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * t + (i & 1), v[i]);
  }
};

// Stage `stage` (TC_STAGE floats) of a product's prepared weights into its
// slot of a ring of RING stages by cp.async, two float4 a thread, committed
// as a group; a null Wt commits an empty group. The wrapper lays each stage
// out as the tensor cores read it (ops/epic_cuda.py::tensor_core_weights):
// the TF32 hi and lo halves of 8 input rows, each K-major in 8 × 4 core
// matrices.
template <int RING = TC_STAGES>
__device__ __forceinline__ void ring_fetch(const float* __restrict__ Wt, int stage, float* ring) {
  if (Wt != nullptr) {
    const float* src = Wt + (size_t)stage * TC_STAGE;
    float* dst = ring + (stage % RING) * TC_STAGE;
#pragma unroll
    for (int q = 0; q < TC_STAGE / (4 * THREADS); ++q) {
      const int idx = 4 * (threadIdx.x + THREADS * q);
      tf32x3::cp_async16(dst + idx, src + idx);
    }
  }
  tf32x3::cp_async_commit();
}

// The first RING − 2 stages of Wt, before the product that reads it.
template <int RING = TC_STAGES>
__device__ __forceinline__ void ring_prefetch(const float* __restrict__ Wt, float* ring) {
#pragma unroll
  for (int kt = 0; kt < RING - 2; ++kt) ring_fetch<RING>(Wt, kt, ring);
}

// acc += A·W on the tensor cores at fp32 accuracy (the 3×TF32 split): A
// (128, 128) in shared memory with rows of LDA_TC floats, W (128, 128) given
// as its 16 prepared stages Wt, streamed through the ring. Each warpgroup
// multiplies its 64 rows by wgmma, A from registers (split here, truncated:
// `split_fast`), the stage's hi and lo halves from shared memory (rounded by
// the wrapper): a_lo·w_hi + a_hi·w_lo + a_hi·w_hi a k-step, one k-step in
// flight while the next A is split. The
// caller has fetched Wt's first TC_STAGES − 2 stages (ring_prefetch, or the
// `next` of the gemm_wg before); this one fetches `next`'s (null: none) as
// its own last stages are read, so that the following product starts on a
// full ring. A stage's slot is refilled two k-steps after its product was
// issued, when both warpgroups have waited for it. A warpgroup whose rows
// all lie at or past npad skips its products and keeps its accumulators.
// Every thread of the block calls it; it ends with a barrier, after which A
// and the ring slots read are free.
__device__ __forceinline__ void gemm_wg(WgAcc& acc, const float* A, const float* __restrict__ Wt,
                                        float* ring, const float* __restrict__ next, int npad) {
  using namespace tf32x3;
  constexpr int NKT = WD / TC_KT;
  static_assert(NKT % TC_STAGES == 0, "the next product's stages must land in their own slots");
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
  const bool live = 64 * (warp >> 2) < npad;
  const float* ar = A + (64 * (warp >> 2) + 16 * (warp & 3) + g) * LDA_TC + t;
  uint32_t ah[2][4], al[2][4];
  fence_operands(acc.v);
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt) {
    const int s = kt & 1;  // the A registers of group kt − 2, which has completed
    if (live) {
      const float* a = ar + kt * TC_KT;
      split_fast(a[0], ah[s][0], al[s][0]);
      split_fast(a[8 * LDA_TC], ah[s][1], al[s][1]);
      split_fast(a[4], ah[s][2], al[s][2]);
      split_fast(a[8 * LDA_TC + 4], ah[s][3], al[s][3]);
    }
    cp_async_wait<TC_STAGES - 3>();  // stage kt has landed, for this thread
    fence_proxy_async();
    __syncthreads();  // for every thread; both warpgroups have waited for group kt − 2
    const int ahead = kt + TC_STAGES - 2;  // into the slot of stage kt − 2
    ring_fetch(ahead < NKT ? Wt : next, ahead < NKT ? ahead : ahead - NKT, ring);
    if (live) {
      const float* slot = ring + (kt % TC_STAGES) * TC_STAGE;
      // core matrices: 128 bytes apart along K, 256 along N
      const uint64_t w_hi = smem_desc(slot, 128, 256), w_lo = smem_desc(slot + TC_KT * WD, 128, 256);
      wgmma_fence();
      wgmma_m64n128k8(acc.v, al[s], w_hi);
      wgmma_m64n128k8(acc.v, ah[s], w_lo);
      wgmma_m64n128k8(acc.v, ah[s], w_hi);
      wgmma_commit();
      wgmma_wait<1>();
    }
  }
  if (live) wgmma_wait<0>();
  fence_operands(acc.v);
  __syncthreads();
}

// z[j] = Σ_k v[k]·W[k·ld + c0 + j] for a per-jet vector v (n_in, shared
// memory) and the 128 columns from c0 of W, rows of ld floats in global
// memory (at every width 128: ld = 128, c0 = 0); thread j < 128 then calls
// post(j, z[j]). Every thread calls it; it ends with a barrier.
// UNROLL: the weight rows a thread has in flight (the sums' order is the same).
template <int UNROLL = 4, class Post>
__device__ __forceinline__ void jet_matvec(const float* v, const float* __restrict__ Wg, int n_in,
                                           int ld, int c0, float* red, Post post) {
  const int tid = threadIdx.x, cg = tid & 31, ks = tid >> 5;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll (UNROLL)
  for (int k = ks; k < n_in; k += 8) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(Wg + (size_t)k * ld + c0) + cg);
    const float vk = v[k];
    acc.x = fmaf(vk, w.x, acc.x);
    acc.y = fmaf(vk, w.y, acc.y);
    acc.z = fmaf(vk, w.z, acc.z);
    acc.w = fmaf(vk, w.w, acc.w);
  }
  *reinterpret_cast<float4*>(red + ks * WD + cg * 4) = acc;
  __syncthreads();
  if (tid < WD) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 8; ++q) s += red[q * WD + tid];
    post(tid, s);
  }
  __syncthreads();
}

// s[c] = Σ_r f(r, S[r, c]) over the tile's rows (row stride LD); thread
// c < 128 then calls post(c, s[c]). Every thread calls it; it ends with a
// barrier.
template <int LD = WD, class F, class Post>
__device__ __forceinline__ void column_sums(const float* S, float* red, F f, Post post) {
  const int tid = threadIdx.x, c = tid & (WD - 1), half = tid >> 7;
  float s = 0.f;
  for (int r = half * 64; r < half * 64 + 64; ++r) s += f(r, S[r * LD + c]);
  red[half * WD + c] = s;
  __syncthreads();
  if (tid < WD) post(tid, red[tid] + red[WD + tid]);
  __syncthreads();
}

// Receives nothing: the forward kernel keeps no activations.
struct NoRecord {
  static constexpr bool HEADS = true;
  __device__ __forceinline__ void z_l0(int, int, int, float) const {}
  __device__ __forceinline__ void z_fl1(int, int, int, float) const {}
  __device__ __forceinline__ void z_fl2(int, int, int, int, float) const {}
  __device__ __forceinline__ void h_in(int, const float*, int) const {}
  __device__ __forceinline__ void proj(int, float) const {}
  __device__ __forceinline__ void glob(int, int, float) const {}
};

// Offsets of the per-jet vectors a recorder receives.
constexpr int R_P0 = 0, R_ZG0 = 384, R_ZG1 = 512, R_ZG2 = 640, R_PROJ = 768;  // proj(i, v)
constexpr int R_P = 0, R_ZFG1 = 512, R_ZFG2 = 640, R_GLOB = 768;              // glob(blk, i, v)

// Stages the output layer's weights [output][input] and biases into the
// weight buffer.
__device__ __forceinline__ void stage_outputs(const float* __restrict__ w, const Layout& L,
                                              float* tiles) {
  const int tid = threadIdx.x;
  for (int e = tid; e < WD * DC; e += THREADS) tiles[T_HW + (e % DC) * WD + e / DC] = w[L.out_c + e];
  for (int e = tid; e < WD * V; e += THREADS)
    tiles[T_HW + (DC + e % V) * WD + e / V] = w[L.out_d + e];
  if (tid < DC) tiles[T_BO + tid] = w[L.b_out_c + tid];
  if (tid < V) tiles[T_BO + DC + tid] = w[L.b_out_d + tid];
}

// Stages the output layer and the V-wide head's weights and biases.
__device__ __forceinline__ void stage_heads(const float* __restrict__ w, const Layout& L,
                                            float* tiles) {
  const int tid = threadIdx.x;
  stage_outputs(w, L, tiles);
  if (tid < V) {
    tiles[T_BH0 + tid] = w[L.b_h0 + tid];
    tiles[T_BH1 + tid] = w[L.b_h1 + tid];
  }
  if (tid < V * V) {
    tiles[T_WH0 + tid] = w[L.h0 + tid];
    tiles[T_WH1 + tid] = w[L.h1 + tid];
  }
}

// Stages the output layer and a head of hidden width hh ≤ MAX_WIDE_HEAD.
__device__ __forceinline__ void stage_wide_head(const float* __restrict__ w, const Layout& L,
                                                int hh, float* tiles) {
  const int tid = threadIdx.x;
  stage_outputs(w, L, tiles);
  for (int e = tid; e < V * hh; e += THREADS) {
    tiles[TW_WH0 + e] = w[L.h0 + e];
    tiles[TW_WH1 + e] = w[L.h1 + e];
  }
  if (tid < hh) tiles[TW_BH0 + tid] = w[L.b_h0 + tid];
  if (tid < V) tiles[TW_BH1 + tid] = w[L.b_h1 + tid];
}

// The discrete head Dense(V → hh) → SELU → Dense(hh → V) on one row's
// disc_pre p[DC..DC+V) by the calling warp: lane j takes the hidden units j
// and j + 32, the output products are warp sums. Every lane gets all V.
__device__ __forceinline__ void wide_head(float (&p)[NOUT], const float* tiles, int hh) {
  const int lane = threadIdx.x & 31;
  float a[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int j = lane + 32 * q;
    a[q] = 0.f;
    if (j < hh) {
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < V; ++u) s = fmaf(p[DC + u], tiles[TW_WH0 + u * hh + j], s);
      a[q] = selu(s + tiles[TW_BH0 + j]);
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = lane + 32 * q;
      if (j < hh) s = fmaf(a[q], tiles[TW_WH1 + j * V + v], s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    p[DC + v] = s + tiles[TW_BH1 + v];
  }
}

// One row's output-layer products by the calling warp: p[o] = h[r, :]·W_out[:, o]
// + b[o], masked (cont ‖ disc_pre); every lane gets all 11.
__device__ __forceinline__ void row_outputs(const float* h_row, const float* tiles, float m,
                                            float (&p)[NOUT]) {
  const int lane = threadIdx.x & 31;
  float hv[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) hv[c] = h_row[lane + 32 * c];
#pragma unroll
  for (int o = 0; o < NOUT; ++o) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) s = fmaf(hv[c], tiles[T_HW + o * WD + lane + 32 * c], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    p[o] = (s + tiles[T_BO + o]) * m;
  }
}

// z_h0[v] = disc_pre·W_h0[:, v] + b_h0[v]; every lane computes all 8.
__device__ __forceinline__ void head_hidden(const float (&p)[NOUT], const float* tiles,
                                            float (&z)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float s = 0.f;
#pragma unroll
    for (int u = 0; u < V; ++u) s = fmaf(p[DC + u], tiles[T_WH0 + u * V + v], s);
    z[v] = s + tiles[T_BH0 + v];
  }
}

// The whole encoder for this block's jet. Every thread of the block calls it.
// On return the tile S0 holds h_final; with Rec::HEADS the head outputs of
// rows < N are written to out (N, 11). FOLD: the discrete input is `kv`
// (N, V) channel values through the folded Dense (k unused); else the tokens
// `k` (N,). WIDE_HEAD: the discrete head has d.head_hidden hidden units (else
// V). A non-null `hid` receives h_final's rows < N, (N, 128).
// The per-particle products run on the tensor cores (gemm_wg, the plan
// SMEM_BYTES_TC) over the 64-row halves that hold rows below ⌈N/16⌉·16, on
// the weights the wrapper prepared: `tcw` the fc_local1/fc_local2 stages of
// each layer (TC_LAYER floats a layer), `l0t` local_0's tables (L0_END
// floats): the x and discrete embeddings are Dense layers, so their product
// with local_0's weights is the embedding's input times a (3, 128) or
// (V, 128) table plus a constant row (a token's row of the table without the
// fold).
template <class Rec, bool FOLD, bool WIDE_HEAD>
__device__ void wide_forward_jet_ext(const float* __restrict__ w, const float* __restrict__ tcw,
                                     const float* __restrict__ l0t, const Dims& d, const Layout& L,
                                     float* smem, float t, const float* __restrict__ x,
                                     const int* __restrict__ k, const float* __restrict__ kv,
                                     const float* __restrict__ mask, int N,
                                     float* __restrict__ out, float* __restrict__ hid,
                                     const Rec& rec) {
  constexpr int LDA = LDA_TC;
  constexpr int MATVEC_UNROLL = 8;
  const int tid = threadIdx.x;
  const int npad = (N + 15) & ~15;
  float* S0 = smem;
  float* S1 = smem + ROWS * LDA;
  float* S2 = smem + 2 * ROWS * LDA;  // the weight ring
  float* tiles = smem + S_TILE_TC;
  float* vec = smem + S_VEC_TC;
  float* m = vec + V_MASK;
  float* xs = vec + V_X;
  int* ks = reinterpret_cast<int*>(vec + V_K);
  float* gnew = vec + V_GNEW;
  float* temb = vec + V_TEMB;
  float* pv = vec + V_P;
  float* va = vec + V_VA;
  float* vb = vec + V_VB;
  float* g = vec + V_G;
  float* gskip = vec + V_GSKIP;
  float* cl1 = vec + V_CL1;
  float* ct = vec + V_CT;
  float* red = vec + V_RED_TC;
  // the skip copy h0 of the thread's elements (WgAcc's places)
  float h0[64];
  ring_prefetch(d.num_blocks > 0 ? tcw : nullptr, S2);  // fc_local1's first stages

  // ---- inputs and the sinusoidal time embedding [cos | sin]
  // (architectures/utils.py:15-34)
  if (tid < ROWS) {
    const bool real = tid < N;
    m[tid] = real ? mask[tid] : 0.f;
    if constexpr (!FOLD) ks[tid] = real ? k[tid] : 0;
#pragma unroll
    for (int c = 0; c < DC; ++c) xs[tid * DC + c] = real ? x[tid * DC + c] : 0.f;
    const int half = WD / 2;
    const int f = tid < half ? tid : tid - half;
    const float freq = expf(-9.210340371976184f * (float)f / (float)half);
    const float arg = t * freq;
    temb[tid] = tid < half ? cosf(arg) : sinf(arg);
  }
  for (int e = tid; e < L0_END / 4; e += THREADS)
    reinterpret_cast<float4*>(tiles)[e] = __ldg(reinterpret_cast<const float4*>(l0t) + e);
  __syncthreads();
  float denom = 0.f;
  for (int r = 0; r < ROWS; ++r) denom += m[r];
  denom = fmaxf(denom, 1.f);

  // the time third of local_0 is the same for every particle of the jet
  jet_matvec<MATVEC_UNROLL>(temb, w + L.w_l0, WD, WD, 0, red, [&](int j, float s) { ct[j] = s; });

  // ---- projection (epic.py:164-191): local_0 sees the masked features,
  // W·(f·m) + b = (W·f)·m + b
  WgAcc acc;
  acc.zero();
  {
    // the particle two thirds from the tables (the embeddings are Dense
    // layers, utils.py:112-172): x·T_x + (values·T_k or a token's row of
    // T_k) + the constant row
    const int r0 = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + ((tid >> 2) & 7);
    float kin[2][V];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if constexpr (FOLD) {
          kin[h][v] = r < N ? __ldg(kv + r * V + v) : 0.f;
        } else {
          kin[h][v] = ks[r] == v ? 1.f : 0.f;
        }
      }
    }
    acc.each([&](int i, int r, int c, float) {
      const int h = (i >> 1) & 1;
      float e = tiles[L0_C + c];
#pragma unroll
      for (int q = 0; q < DC; ++q) e = fmaf(xs[r * DC + q], tiles[L0_X + q * WD + c], e);
#pragma unroll
      for (int v = 0; v < V; ++v) e = fmaf(kin[h][v], tiles[L0_K + v * WD + c], e);
      const float z = (e + ct[c]) * m[r] + w[L.b_l0 + c];
      rec.z_l0(i, r, c, z);
      const float a = leaky(z);
      S0[r * LDA + c] = a;
      h0[i] = d.use_skip ? a * m[r] : 0.f;
    });
  }
  __syncthreads();
  column_sums<LDA>(S0, red, [&](int r, float v) { return v * m[r]; }, [&](int c, float s) {
    pv[c] = s / denom;
    pv[WD + c] = s;
    pv[2 * WD + c] = temb[c];
  });
  // h = h_act·mask (the skip copy is in registers)
  for (int idx = tid; idx < MAT; idx += THREADS) {
    const int at = (idx >> 7) * LDA + (idx & (WD - 1));
    const float v = S0[at] * m[idx >> 7];
    S0[at] = v;
  }
  for (int i = tid; i < 3 * WD; i += THREADS) rec.proj(R_P0 + i, pv[i]);
  jet_matvec<MATVEC_UNROLL>(pv, w + L.w_g0, 3 * WD, WD, 0, red, [&](int j, float s) {
    const float z = s + w[L.b_g0 + j];
    rec.proj(R_ZG0 + j, z);
    va[j] = leaky(z);
  });
  jet_matvec<MATVEC_UNROLL>(va, w + L.w_g1, WD, WD, 0, red, [&](int j, float s) {
    const float z = s + w[L.b_g1 + j];
    rec.proj(R_ZG1 + j, z);
    vb[j] = leaky(z);
  });
  jet_matvec<MATVEC_UNROLL>(vb, w + L.w_g2, WD, WD, 0, red, [&](int j, float s) {
    const float z = s + w[L.b_g2 + j];
    rec.proj(R_ZG2 + j, z);
    g[j] = leaky(z);
    gskip[j] = d.use_skip ? g[j] : 0.f;
  });

  // ---- EPiC layers (epic.py:193-241)
  for (int blk = 0; blk < d.num_blocks; ++blk) {
    const float* wb = w + L.blocks + (size_t)blk * L.block_stride;
    const float* tb = tcw + (size_t)blk * TC_LAYER;
    rec.h_in(blk, S0, LDA);
    column_sums<LDA>(S0, red, [&](int r, float v) { return v * m[r]; }, [&](int c, float s) {
      pv[c] = s / denom;
      pv[WD + c] = s;
      pv[2 * WD + c] = g[c];
      pv[3 * WD + c] = temb[c];
    });
    for (int i = tid; i < 4 * WD; i += THREADS) rec.glob(blk, R_P + i, pv[i]);
    jet_matvec<MATVEC_UNROLL>(pv, wb + L.fg1, 4 * WD, WD, 0, red, [&](int j, float s) {
      const float z = s + wb[L.bfg1 + j];
      rec.glob(blk, R_ZFG1 + j, z);
      va[j] = leaky(z);
    });
    jet_matvec<MATVEC_UNROLL>(va, wb + L.fg2, WD, WD, 0, red, [&](int j, float s) {
      const float z = s + wb[L.bfg2 + j] + g[j];
      rec.glob(blk, R_ZFG2 + j, z);
      gnew[j] = leaky(z);
    });
    // fc_local1's broadcast inputs [g_new ‖ temb], once per jet
    jet_matvec<MATVEC_UNROLL>(gnew, wb + L.fl1 + WD * WD, 2 * WD, WD, 0, red, [&](int j, float s) {
      cl1[j] = s + wb[L.bfl1 + j];
      g[j] = gnew[j] + gskip[j];
    });

    acc.zero();
    gemm_wg(acc, S0, tb, S2, tb + TC_FL2, npad);
    acc.each([&](int, int r, int c, float a) {
      const float z = a + cl1[c];
      rec.z_fl1(blk, r, c, z);
      S1[r * LDA + c] = leaky(z);
    });
    __syncthreads();
    acc.zero();
    gemm_wg(acc, S1, tb + TC_FL2, S2, blk + 1 < d.num_blocks ? tb + TC_LAYER : nullptr, npad);
    acc.each([&](int i, int r, int c, float a) {
      const float z = a + wb[L.bfl2 + c] + S0[r * LDA + c];
      rec.z_fl2(blk, i, r, c, z);
      S0[r * LDA + c] = leaky(z) * m[r] + h0[i];
    });
    __syncthreads();
  }

  // ---- the trunk's last local hidden state (output_hidden_local): rows of
  // 128 floats, contiguous
  if (hid != nullptr)
    for (int idx = tid; idx < N * (WD / 4); idx += THREADS)
      reinterpret_cast<float4*>(hid)[idx] =
          *reinterpret_cast<const float4*>(S0 + (idx >> 5) * LDA + (idx & 31) * 4);

  // ---- weight-normed output + heads (epic.py:145-162, mbm :102-113):
  // one warp per row; cont and disc_pre are masked, the SELU head's output
  // is not
  if (!Rec::HEADS) return;
  if constexpr (WIDE_HEAD) {
    stage_wide_head(w, L, d.head_hidden, tiles);
  } else {
    stage_heads(w, L, tiles);
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < N; r += THREADS / 32) {
    float p[NOUT];
    row_outputs(S0 + r * LDA, tiles, m[r], p);
    if (WIDE_HEAD && d.add_discrete_head) {
      wide_head(p, tiles, d.head_hidden);
    } else if (d.add_discrete_head) {
      float z[V];
      head_hidden(p, tiles, z);
#pragma unroll
      for (int v = 0; v < V; ++v) z[v] = selu(z[v]);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float s = 0.f;
#pragma unroll
        for (int u = 0; u < V; ++u) s = fmaf(z[u], tiles[T_WH1 + u * V + v], s);
        p[DC + v] = s + tiles[T_BH1 + v];
      }
    }
    float val = 0.f;
#pragma unroll
    for (int o = 0; o < NOUT; ++o)
      if (lane == o) val = p[o];
    if (lane < NOUT) out[r * NOUT + lane] = val;
  }
  __syncthreads();
}

}  // namespace mmpw
