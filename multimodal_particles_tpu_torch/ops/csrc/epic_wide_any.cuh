// The wide EPiC forward at every width the JAX wide gate takes up to 512
// (multimodal_particles_tpu/ops/epic_pallas_wide.py:335-369): the local
// hidden width H, the global width G and the time embedding T each 128, 256,
// 384 or 512, mixed, and a discrete head of any hidden width up to 512. The
// width-128 kernels with a head of at most 64 keep epic_wide.cuh's code, so
// their bits and time stay; every other shape comes here.
//
// Design: a jet is a thread-block cluster of CL = H / 128 blocks of 256
// threads (CL = 1 when only G, T or the head differ from 128), block `rank`
// owning columns 128·rank … + 127 of every (128 rows, H) activation tile.
// A block's plan is epic_wide.cuh's: the tiles h and l1 with rows of LDA_TC
// floats, a ring of weight stages (four here, two fetched ahead: the per-jet
// vectors of widths up to 512 take the room of the other four), the staging
// area, the per-jet vectors.
//   * The per-particle products (fc_local1's particle third, fc_local2) are
//     the same wgmma.m64n128k8 tiles under the 3×TF32 split, CL times as
//     deep: each k-step reads its A from the block that owns those 128
//     columns, through the cluster's distributed shared memory, and each
//     block streams the stages of its own 128 output columns (the wrapper
//     lays the CL column blocks one after the other,
//     ops/epic_cuda.py::tensor_core_weights).
//   * local_0's particle two thirds and the time third, and fc_local1's
//     broadcast thirds, enter only the block's own columns.
//   * The masked pooling sums each block's own columns and writes them into
//     every block's pooled vector; the per-jet global MLP (widths up to 512)
//     then runs in every block on its own copy, in the same order, so that
//     every block holds the same bits of every per-jet vector.
//   * The heads: each block sums its own columns' part of the output layer
//     for every row; the rows are shared out over the cluster, which adds the
//     blocks' parts in block order and runs the discrete head, its weights
//     read from L2 (any hidden width up to 512: a lane takes hidden units
//     lane + 32q).
//   * The cluster synchronises (barrier.cluster) once every block has
//     started, after each product's epilogue (the next product reads what
//     the peers wrote, and the tile it overwrites is no longer read), after
//     the pooled vector is complete, and before a block leaves.
// Jets of 129 … 256 slots (RB = 2 row blocks): a block's tiles hold 128 rows,
// so the cluster grows to CL × RB blocks, cluster rank rb·CL + rank, row
// block rb owning slots 128·rb … + 127 of every tile and running the plan
// above on them (its live rows min(128, N − 128·rb), the products' 64-row
// halves and 16-row edge as at N ≤ 128). Only what sums over rows crosses a
// row block: the pooled sums, whose row peers' partials meet in the
// reduction buffer behind a cluster barrier and are added row block 0
// first, so that every block of the cluster holds the same bits of every
// per-jet vector; and the mean's denominator, which every block sums from
// the jet's mask in device memory in the same order. A jet of at most 128
// slots keeps RB = 1, the code above unchanged (every row-block step is
// `if constexpr (RB > 1)` or folds to the single row block's).
// What bounds it: the products grow as H² (CL blocks, each product CL
// times as deep), the per-jet global MLP as H·(2H + G + T) per block and
// jet, streamed from L2 by every block of the cluster; a block reads
// (CL − 1)/CL of its products' A from its peers.
#pragma once

#include <cooperative_groups.h>

#include "epic_wide.cuh"

namespace mmpw {

namespace cg = cooperative_groups;

constexpr int MAX_CL = 4;              // blocks a jet: widths up to 512
constexpr int MAX_RB = 2;              // row blocks a jet: up to 256 slots
constexpr int MAX_WIDTH = MAX_CL * WD;
constexpr int MAX_HEAD = 512;          // the widest discrete head

__host__ __device__ inline bool is_wide_width(int w) {
  return w == 128 || w == 256 || w == 384 || w == 512;
}

// The widths of the general kernels: H, G and T each 128 … 512; the token
// embeddings too, or with the folded Linear-discrete input two widths up to
// 512 whose sum is a multiple of 128 (the second a multiple of 4, so that the
// matrices after them stay 16-byte aligned). The backward kernel takes the
// token input and a head as wide as the vocabulary (MBM's), the forward
// kernel any head up to MAX_HEAD.
inline bool any_dims_supported(const Dims& d, bool forward) {
  const bool emb = d.fold_discrete
                       ? d.emb_x >= 1 && d.emb_k >= 1 && d.emb_x <= MAX_WIDTH &&
                             d.emb_k <= MAX_WIDTH && (d.emb_x + d.emb_k) % WD == 0 &&
                             d.emb_k % 4 == 0
                       : is_wide_width(d.emb_x) && is_wide_width(d.emb_k);
  const bool base = is_wide_width(d.hidden) && is_wide_width(d.hidden_glob) &&
                    is_wide_width(d.emb_t) && emb && d.num_blocks >= 0 &&
                    (d.fold_discrete == 0 || d.fold_discrete == 1);
  if (!forward) return base && d.head_hidden == V && d.fold_discrete == 0;
  return base && d.head_hidden >= 1 && d.head_hidden <= MAX_HEAD;
}

// Offsets in floats into the packed buffer at any widths, matrices (in, out)
// row-major (ops/epic_cuda.py::wide_weight_layout); at every width 128 the
// offsets of make_layout(num_blocks, head_hidden, fold).
__host__ __device__ inline Layout make_layout(const Dims& d) {
  const int H = d.hidden, G = d.hidden_glob, T = d.emb_t, X = d.emb_x, K = d.emb_k;
  const int hh = d.head_hidden;
  Layout L;
  int o = 0;
  L.w_x = o;   o += DC * X;
  L.b_x = o;   o += X;
  L.table = o; o += V * K;
  L.b_k = o;   o += d.fold_discrete ? K : 0;
  L.w_l0 = o;  o += (T + X + K) * H;
  L.b_l0 = o;  o += H;
  L.w_g0 = o;  o += (2 * H + T) * H;
  L.b_g0 = o;  o += H;
  L.w_g1 = o;  o += H * H;
  L.b_g1 = o;  o += H;
  L.w_g2 = o;  o += H * G;
  L.b_g2 = o;  o += G;
  L.blocks = o;
  int b = 0;
  L.fg1 = b;  b += (2 * H + G + T) * H;
  L.bfg1 = b; b += H;
  L.fg2 = b;  b += H * G;
  L.bfg2 = b; b += G;
  L.fl1 = b;  b += (H + G + T) * H;
  L.bfl1 = b; b += H;
  L.fl2 = b;  b += H * H;
  L.bfl2 = b; b += H;
  L.block_stride = b;
  o += d.num_blocks * b;
  L.out_c = o;   o += H * DC;
  L.b_out_c = o; o += DC;
  L.out_d = o;   o += H * V;
  L.b_out_d = o; o += V;
  L.h0 = o;      o += V * hh;
  L.b_h0 = o;    o += hh;
  L.h1 = o;      o += hh * V;
  L.b_h1 = o;    o += V;
  L.total = o;
  L.row_stride = (o + 3) & ~3;
  return L;
}

// Offsets in floats of the per-jet vectors a recorder receives: the
// projection's pooled input and pre-activations (proj(i, v)), then each EPiC
// layer's (glob(blk, i, v)); `proj` and `glob` are the sizes, rounded up to a
// float4.
struct JetRec {
  int p0, zg0, zg1, zg2, proj;
  int p, zfg1, zfg2, glob;
};

__host__ __device__ inline JetRec make_jet_rec(const Dims& d) {
  const int H = d.hidden, G = d.hidden_glob, T = d.emb_t;
  JetRec R;
  int o = 0;
  R.p0 = o;  o += 2 * H + T;
  R.zg0 = o; o += H;
  R.zg1 = o; o += H;
  R.zg2 = o; o += G;
  R.proj = (o + 3) & ~3;
  o = 0;
  R.p = o;    o += 2 * H + G + T;
  R.zfg1 = o; o += H;
  R.zfg2 = o; o += G;
  R.glob = (o + 3) & ~3;
  return R;
}

// Shared memory of the general kernels: the tiles h (S0) and l1 (S1), the
// ring of RING_ANY weight stages, the staging area (local_0's tables of the
// block's columns; the output layer's rows of the block's columns), the
// per-jet vectors. g_new sits right before temb, so that fc_local1's
// broadcast input [g_new ‖ temb] is one vector.
constexpr int RING_ANY = 4;
constexpr int MATVEC_ANY_UNROLL = 8;  // the weight rows a thread of jet_matvec has in flight
constexpr int SA_RING = 2 * ROWS * LDA_TC;
constexpr int SA_STAGING = SA_RING + RING_ANY * TC_STAGE;
constexpr int SA_VEC = SA_STAGING + TC_STAGING;
constexpr int A_MASK = 0, A_X = 128, A_K = 512, A_TEMB = 1152 /* g_new: the 512 before */,
              A_P = 1664, A_VA = 3712, A_VB = 4224, A_G = 4736, A_GSKIP = 5248, A_CL1 = 5760,
              A_CT = 5888, A_RED = 6016, A_END = 7040;
constexpr size_t SMEM_BYTES_ANY = sizeof(float) * (size_t)(SA_VEC + A_END);
static_assert(SMEM_BYTES_ANY <= 232448, "over a block's 227 KB of shared memory");
static_assert(A_TEMB - A_K - WD >= MAX_WIDTH, "g_new overruns");
static_assert(A_VA - A_P >= 4 * MAX_WIDTH, "the pooled vector overruns");
static_assert(A_P + ROWS * 12 <= A_VA, "the heads' partial sums overrun the pooled vector");
static_assert(L0_END <= TC_STAGING && T_BO + 16 <= TC_STAGING, "the staging area overruns");
// the head's partial sums: 12 floats a row, in the pooled vector's place
constexpr int PART_STRIDE = 12;
// at RB > 1 a block's partial column sums for its row peers, in the reduction
// buffer past what column_sums uses
constexpr int RED_ROWS = 2 * WD;
static_assert(A_END - A_RED >= RED_ROWS + WD, "the row peers' partial sums overrun");

// Every thread of the jet's blocks; a block barrier at CL = 1. The cluster
// barrier releases and acquires: shared-memory writes before it, the peers'
// included, are seen after it.
template <int CL>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (CL == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// `p` in this block's shared memory → the same place in block r's (cluster
// ranks; `rank`: this block's).
template <int CL>
__device__ __forceinline__ float* peer_ptr(float* p, int r, int rank) {
  if constexpr (CL == 1) {
    return p;
  } else {
    return r == rank ? p : cg::this_cluster().map_shared_rank(p, r);
  }
}
template <int CL>
__device__ __forceinline__ const float* peer_ptr(const float* p, int r, int rank) {
  return peer_ptr<CL>(const_cast<float*>(p), r, rank);
}

// acc += A·W, gemm_wg at CL > 1 (and at the RING_ANY ring): A (128, 128·CL),
// its column block q in block q's tile A (rows of LDA_TC floats), read
// through the cluster's shared memory; W (128·CL, 128) the block's output
// columns as its 16·CL prepared stages Wt; `next`'s first stages fetched as
// Wt's last are read. Every thread of the block calls it; it ends with a
// block barrier (the peers' tiles are read until the caller's next cluster
// barrier). CS, base: the cluster's size and the cluster rank of the row
// block's column block 0 (CL and 0 at one row block).
template <int CL, int CS = CL>
__device__ __forceinline__ void gemm_cl(WgAcc& acc, const float* A, const float* __restrict__ Wt,
                                        float* ring, const float* __restrict__ next, int npad,
                                        int rank, int base = 0) {
  using namespace tf32x3;
  constexpr int KPB = WD / TC_KT;  // k-steps a column block
  constexpr int NKT = CL * KPB;
  static_assert(NKT % RING_ANY == 0, "the next product's stages must land in their own slots");
  const int warp = threadIdx.x >> 5, g = (threadIdx.x >> 2) & 7, t = threadIdx.x & 3;
  const bool live = 64 * (warp >> 2) < npad;
  const int roff = (64 * (warp >> 2) + 16 * (warp & 3) + g) * LDA_TC + t;
  uint32_t ah[2][4], al[2][4];
  fence_operands(acc.v);
  auto step = [&](int kt, uint32_t (&h)[4], uint32_t (&l)[4]) {
    if (live) {  // registers of k-step kt − 2, which has completed
      // (at one row block the column peers' ranks are the cluster's: in that
      // form ptxas spills less in K5's recording rerun)
      const float* a = (CS == CL ? peer_ptr<CL>(A, kt / KPB, rank)
                                 : peer_ptr<CS>(A, base + kt / KPB, base + rank)) +
                       roff + (kt % KPB) * TC_KT;
      split_fast(a[0], h[0], l[0]);
      split_fast(a[8 * LDA_TC], h[1], l[1]);
      split_fast(a[4], h[2], l[2]);
      split_fast(a[8 * LDA_TC + 4], h[3], l[3]);
    }
    cp_async_wait<RING_ANY - 3>();  // stage kt has landed, for this thread
    fence_proxy_async();
    __syncthreads();  // for every thread; both warpgroups have waited for k-step kt − 2
    const int ahead = kt + RING_ANY - 2;  // into the slot of stage kt − 2
    ring_fetch<RING_ANY>(ahead < NKT ? Wt : next, ahead < NKT ? ahead : ahead - NKT, ring);
    if (live) {
      const float* slot = ring + (kt % RING_ANY) * TC_STAGE;
      const uint64_t w_hi = smem_desc(slot, 128, 256), w_lo = smem_desc(slot + TC_KT * WD, 128, 256);
      wgmma_fence();
      wgmma_m64n128k8(acc.v, l, w_hi);
      wgmma_m64n128k8(acc.v, h, w_lo);
      wgmma_m64n128k8(acc.v, h, w_hi);
      wgmma_commit();
      wgmma_wait<1>();
    }
  };
#pragma unroll 1
  for (int kt = 0; kt < NKT; kt += 2) {
    step(kt, ah[0], al[0]);
    step(kt + 1, ah[1], al[1]);
  }
  if (live) wgmma_wait<0>();
  fence_operands(acc.v);
  __syncthreads();
}

// post(j, Σ_k v[k]·W[k·n_out + j]) for every j < n_out (a multiple of 128),
// 128 columns at a time. Every thread calls it; it ends with a barrier.
template <class Post>
__device__ __forceinline__ void matvec_all(const float* v, const float* __restrict__ Wg, int n_in,
                                           int n_out, float* red, Post post) {
  for (int c0 = 0; c0 < n_out; c0 += WD)
    jet_matvec<MATVEC_ANY_UNROLL>(v, Wg, n_in, n_out, c0, red,
                                  [&](int j, float s) { post(c0 + j, s); });
}

// The discrete head Dense(V → hh) → SELU → Dense(hh → V) on one row's
// disc_pre p[DC..DC+V) by the calling warp, weights read from L2: lane j
// takes the hidden units j + 32q. Every lane gets all V.
__device__ __forceinline__ void head_any(float (&p)[NOUT], const float* __restrict__ w,
                                         const Layout& L, int hh) {
  const int lane = threadIdx.x & 31;
  constexpr int NQ = MAX_HEAD / 32;
  float a[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int j = lane + 32 * q;
    a[q] = 0.f;
    if (j < hh) {
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < V; ++u) s = fmaf(p[DC + u], __ldg(w + L.h0 + u * hh + j), s);
      a[q] = selu(s + __ldg(w + L.b_h0 + j));
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int j = lane + 32 * q;
      if (j < hh) s = fmaf(a[q], __ldg(w + L.h1 + j * V + v), s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    p[DC + v] = s + __ldg(w + L.b_h1 + v);
  }
}

// The output layer's rows of this block's columns, [output][column], and its
// biases, into the staging area.
__device__ __forceinline__ void stage_outputs_own(const float* __restrict__ w, const Layout& L,
                                                  int col0, float* tiles) {
  for (int e = threadIdx.x; e < WD * NOUT; e += THREADS) {
    const int o = e / WD, c = e - o * WD;
    tiles[T_HW + e] = o < DC ? w[L.out_c + (col0 + c) * DC + o] : w[L.out_d + (col0 + c) * V + o - DC];
  }
  if (threadIdx.x < DC) tiles[T_BO + threadIdx.x] = w[L.b_out_c + threadIdx.x];
  if (threadIdx.x < V) tiles[T_BO + DC + threadIdx.x] = w[L.b_out_d + threadIdx.x];
}

// part[r·12 + o] = h[r, own columns]·W_out[own columns, o] for rows r < n,
// one warp a row (no bias, no mask). Every thread calls it; it ends with a
// barrier.
__device__ __forceinline__ void output_parts(const float* S0, const float* tiles, int n, float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < n; r += THREADS / 32) {
    float hv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) hv[c] = S0[r * LDA_TC + lane + 32 * c];
    float val = 0.f;
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) s = fmaf(hv[c], tiles[T_HW + o * WD + lane + 32 * c], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == o) val = s;
    }
    if (lane < NOUT) part[r * PART_STRIDE + lane] = val;
  }
  __syncthreads();
}

// Row r's (cont ‖ disc_pre), masked: the row block's partial sums added in
// block order, plus the bias; every lane gets all 11. CS, base as gemm_cl's.
template <int CL, int CS = CL>
__device__ __forceinline__ void row_from_parts(const float* part, const float* tiles, float m, int r,
                                               int rank, float (&p)[NOUT], int base = 0) {
#pragma unroll
  for (int o = 0; o < NOUT; ++o) p[o] = 0.f;
  for (int q = 0; q < CL; ++q) {
    const float* pq = peer_ptr<CS>(part, base + q, base + rank) + r * PART_STRIDE;
#pragma unroll
    for (int o = 0; o < NOUT; ++o) p[o] += pq[o];
  }
#pragma unroll
  for (int o = 0; o < NOUT; ++o) p[o] = (p[o] + tiles[T_BO + o]) * m;
}

// max(Σ mask, 1) of the jet: at one row block over the block's rows in
// shared memory; at RB > 1 over the jet's mask in device memory (N slots),
// the two row blocks' halves summed apart and then added, the same bits in
// every block of the cluster.
template <int RB>
__device__ __forceinline__ float jet_denominator(const float* m, const float* __restrict__ mask,
                                                 int N) {
  float denom = 0.f;
  if constexpr (RB == 1) {
    for (int r = 0; r < ROWS; ++r) denom += m[r];
  } else {
    float d1 = 0.f;
    for (int r = 0; r < ROWS; ++r) denom += __ldg(mask + r);
    for (int r = ROWS; r < N; ++r) d1 += __ldg(mask + r);
    denom += d1;
  }
  return fmaxf(denom, 1.f);
}

// The masked pooling of the block's columns of S0 into the pooled vector of
// every block of its row block: [mean ‖ sum] at col0 + c and H + col0 + c.
// At RB > 1 each block first leaves its rows' sums in red[RED_ROWS …]; after
// a cluster barrier the row blocks' sums are added, row block 0 first. The
// caller's next cluster barrier completes the pooled vector; the row peers
// read red until then. Every thread calls it.
template <int CL, int RB>
__device__ __forceinline__ void pool_columns(const float* S0, const float* m, float* red, float* pv,
                                             int H, float denom, int rank, int base) {
  constexpr int CS = CL * RB;
  const int col0 = WD * rank;
  auto put = [&](int c, float s) {
    const float mean = s / denom;
    for (int q = 0; q < CL; ++q) {
      float* p = peer_ptr<CS>(pv, base + q, base + rank);
      p[col0 + c] = mean;
      p[H + col0 + c] = s;
    }
  };
  if constexpr (RB == 1) {
    column_sums<LDA_TC>(S0, red, [&](int r, float v) { return v * m[r]; }, put);
  } else {
    column_sums<LDA_TC>(S0, red, [&](int r, float v) { return v * m[r]; },
                        [&](int c, float s) { red[RED_ROWS + c] = s; });
    cluster_sync<CS>();  // every row block's sums
    if (threadIdx.x < WD) {
      float s = 0.f;
      for (int r = 0; r < RB; ++r)
        s += peer_ptr<CS>(red, r * CL + rank, base + rank)[RED_ROWS + threadIdx.x];
      put(threadIdx.x, s);
    }
  }
}

// Receives nothing.
struct NoRecordAny {
  static constexpr bool HEADS = true;
  __device__ __forceinline__ void z_l0(int, int, int, float) const {}
  __device__ __forceinline__ void z_fl1(int, int, int, float) const {}
  __device__ __forceinline__ void z_fl2(int, int, int, int, float) const {}
  __device__ __forceinline__ void h_in(int, const float*, int) const {}
  __device__ __forceinline__ void proj(int, float) const {}
  __device__ __forceinline__ void glob(int, int, float) const {}
};

// The whole encoder for this cluster's jet at any widths: wide_forward_jet_ext
// with the cluster's column blocks. Every thread of the jet's blocks calls
// it, after a cluster barrier that follows every block's start. On return
// S0 holds the block's columns of h_final and the peers may still read them
// until the caller's next cluster barrier (with Rec::HEADS it has passed
// one). Tile elements go to the recorder in the block's own columns (c <
// 128) and rows, per-jet vectors at the offsets R gives. FOLD: the discrete
// input is `kv` (N, V) channel values through the folded Dense; else the
// tokens `k`. A non-null `hid` (N, H) receives the block's columns of
// h_final. `tcw`: each layer's stages, fc_local1's particle third and then
// fc_local2, each as CL column blocks of 16·CL stages; `l0t`: local_0's
// tables, L0_END floats a column block. The jet's arrays (x, k, kv, mask,
// out, hid) from its slot 0, N slots; `rank`: the block's column block,
// `rb`: its row block (RB > 1: N > 128).
template <class Rec, bool FOLD, int CL, int RB = 1>
__device__ void wide_forward_jet_any(const float* __restrict__ w, const float* __restrict__ tcw,
                                     const float* __restrict__ l0t, const Dims& d, const Layout& L,
                                     const JetRec& R, float* smem, float t,
                                     const float* __restrict__ x, const int* __restrict__ k,
                                     const float* __restrict__ kv, const float* __restrict__ mask,
                                     int N, float* __restrict__ out, float* __restrict__ hid,
                                     const Rec& rec, int rank, int rb = 0) {
  constexpr int LDA = LDA_TC;
  constexpr int NKT = CL * WD / TC_KT;
  constexpr int CS = CL * RB;
  constexpr size_t PROD = (size_t)NKT * TC_STAGE;  // one product's stages of a column block
  constexpr size_t LAYER = 2 * CL * PROD;
  const int tid = threadIdx.x, H = d.hidden, G = d.hidden_glob, T = d.emb_t, col0 = WD * rank;
  // the row block's slots: row0 … row0 + n − 1 of the jet; `base` the cluster
  // rank of its column block 0
  const int row0 = RB > 1 ? ROWS * rb : 0, base = RB > 1 ? CL * rb : 0;
  const int n = RB > 1 ? min(ROWS, N - row0) : N;
  const float* jet_mask = mask;
  x += row0 * DC;
  mask += row0;
  if constexpr (FOLD) {
    kv += row0 * V;
  } else {
    k += row0;
  }
  if (Rec::HEADS) out += (size_t)row0 * NOUT;
  if (hid != nullptr) hid += (size_t)row0 * H;
  const int npad = (n + 15) & ~15;
  float* S0 = smem;
  float* S1 = smem + ROWS * LDA;
  float* ring = smem + SA_RING;
  float* tiles = smem + SA_STAGING;
  float* vec = smem + SA_VEC;
  float* m = vec + A_MASK;
  float* xs = vec + A_X;
  int* ks = reinterpret_cast<int*>(vec + A_K);
  float* temb = vec + A_TEMB;
  float* gnew = temb - G;
  float* pv = vec + A_P;
  float* va = vec + A_VA;
  float* vb = vec + A_VB;
  float* g = vec + A_G;
  float* gskip = vec + A_GSKIP;
  float* cl1 = vec + A_CL1;
  float* ct = vec + A_CT;
  float* red = vec + A_RED;
  float h0[64];
  ring_prefetch<RING_ANY>(d.num_blocks > 0 ? tcw + rank * PROD : nullptr, ring);

  // ---- inputs and the sinusoidal time embedding [cos | sin] of width T
  if (tid < ROWS) {
    const bool real = tid < n;
    m[tid] = real ? mask[tid] : 0.f;
    if constexpr (!FOLD) ks[tid] = real ? k[tid] : 0;
#pragma unroll
    for (int c = 0; c < DC; ++c) xs[tid * DC + c] = real ? x[tid * DC + c] : 0.f;
  }
  for (int i = tid; i < T; i += THREADS) {
    const int half = T / 2;
    const int f = i < half ? i : i - half;
    const float freq = expf(-9.210340371976184f * (float)f / (float)half);
    const float arg = t * freq;
    temb[i] = i < half ? cosf(arg) : sinf(arg);
  }
  const float* l0 = l0t + (size_t)rank * L0_END;
  for (int e = tid; e < L0_END / 4; e += THREADS)
    reinterpret_cast<float4*>(tiles)[e] = __ldg(reinterpret_cast<const float4*>(l0) + e);
  __syncthreads();
  const float denom = jet_denominator<RB>(m, jet_mask, N);

  // the time third of local_0, the block's columns
  jet_matvec<MATVEC_ANY_UNROLL>(temb, w + L.w_l0, T, H, col0, red,
                                [&](int j, float s) { ct[j] = s; });

  // ---- projection (epic.py:164-191), the block's columns
  WgAcc acc;
  acc.zero();
  {
    const int r0 = 64 * (tid >> 7) + 16 * ((tid >> 5) & 3) + ((tid >> 2) & 7);
    float kin[2][V];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if constexpr (FOLD) {
          kin[h][v] = r < n ? __ldg(kv + r * V + v) : 0.f;
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
      const float z = (e + ct[c]) * m[r] + w[L.b_l0 + col0 + c];
      rec.z_l0(i, r, c, z);
      const float a = leaky(z);
      S0[r * LDA + c] = a;
      h0[i] = d.use_skip ? a * m[r] : 0.f;
    });
  }
  __syncthreads();
  // the pooled sums of the block's columns, into every block's pv
  pool_columns<CL, RB>(S0, m, red, pv, H, denom, rank, base);
  for (int i = tid; i < T; i += THREADS) pv[2 * H + i] = temb[i];
  // h = h_act·mask (the skip copy is in registers)
  for (int idx = tid; idx < MAT; idx += THREADS) {
    const int at = (idx >> 7) * LDA + (idx & (WD - 1));
    S0[at] *= m[idx >> 7];
  }
  cluster_sync<CS>();  // every block's pooled sums
  for (int i = tid; i < 2 * H + T; i += THREADS) rec.proj(R.p0 + i, pv[i]);
  matvec_all(pv, w + L.w_g0, 2 * H + T, H, red, [&](int j, float s) {
    const float z = s + w[L.b_g0 + j];
    rec.proj(R.zg0 + j, z);
    va[j] = leaky(z);
  });
  matvec_all(va, w + L.w_g1, H, H, red, [&](int j, float s) {
    const float z = s + w[L.b_g1 + j];
    rec.proj(R.zg1 + j, z);
    vb[j] = leaky(z);
  });
  matvec_all(vb, w + L.w_g2, H, G, red, [&](int j, float s) {
    const float z = s + w[L.b_g2 + j];
    rec.proj(R.zg2 + j, z);
    g[j] = leaky(z);
    gskip[j] = d.use_skip ? g[j] : 0.f;
  });
  cluster_sync<CS>();  // every block has read its pv: the first layer's sums may overwrite it

  // ---- EPiC layers (epic.py:193-241)
  for (int blk = 0; blk < d.num_blocks; ++blk) {
    const float* wb = w + L.blocks + (size_t)blk * L.block_stride;
    const float* tb = tcw + (size_t)blk * LAYER;
    rec.h_in(blk, S0, LDA);
    pool_columns<CL, RB>(S0, m, red, pv, H, denom, rank, base);
    for (int i = tid; i < G; i += THREADS) pv[2 * H + i] = g[i];
    for (int i = tid; i < T; i += THREADS) pv[2 * H + G + i] = temb[i];
    cluster_sync<CS>();  // every block's pooled sums
    for (int i = tid; i < 2 * H + G + T; i += THREADS) rec.glob(blk, R.p + i, pv[i]);
    matvec_all(pv, wb + L.fg1, 2 * H + G + T, H, red, [&](int j, float s) {
      const float z = s + wb[L.bfg1 + j];
      rec.glob(blk, R.zfg1 + j, z);
      va[j] = leaky(z);
    });
    matvec_all(va, wb + L.fg2, H, G, red, [&](int j, float s) {
      const float z = s + wb[L.bfg2 + j] + g[j];
      rec.glob(blk, R.zfg2 + j, z);
      gnew[j] = leaky(z);
    });
    // fc_local1's broadcast inputs [g_new ‖ temb], the block's columns
    jet_matvec<MATVEC_ANY_UNROLL>(gnew, wb + L.fl1 + (size_t)H * H, G + T, H, col0, red,
                                  [&](int j, float s) { cl1[j] = s + wb[L.bfl1 + col0 + j]; });
    for (int j = tid; j < G; j += THREADS) g[j] = gnew[j] + gskip[j];

    acc.zero();
    gemm_cl<CL, CS>(acc, S0, tb + rank * PROD, ring, tb + (CL + rank) * PROD, npad, rank, base);
    acc.each([&](int, int r, int c, float a) {
      const float z = a + cl1[c];
      rec.z_fl1(blk, r, c, z);
      S1[r * LDA + c] = leaky(z);
    });
    cluster_sync<CS>();  // every block's l1; every read of h is done
    acc.zero();
    gemm_cl<CL, CS>(acc, S1, tb + (CL + rank) * PROD, ring,
                    blk + 1 < d.num_blocks ? tb + LAYER + rank * PROD : nullptr, npad, rank, base);
    acc.each([&](int i, int r, int c, float a) {
      const float z = a + wb[L.bfl2 + col0 + c] + S0[r * LDA + c];
      rec.z_fl2(blk, i, r, c, z);
      S0[r * LDA + c] = leaky(z) * m[r] + h0[i];
    });
    cluster_sync<CS>();  // every block's h; every read of l1 is done
  }

  // ---- the trunk's last local hidden state, the block's columns of rows of H
  if (hid != nullptr)
    for (int idx = tid; idx < n * (WD / 4); idx += THREADS)
      *reinterpret_cast<float4*>(hid + (size_t)(idx >> 5) * H + col0 + (idx & 31) * 4) =
          *reinterpret_cast<const float4*>(S0 + (idx >> 5) * LDA + (idx & 31) * 4);

  // ---- weight-normed output + heads (epic.py:145-162, mbm :102-113): each
  // block's columns' part of every row, then rows rank, rank + CL, … of the
  // row block, one warp a row
  if (!Rec::HEADS) return;
  stage_outputs_own(w, L, col0, tiles);
  __syncthreads();
  output_parts(S0, tiles, n, pv);
  cluster_sync<CS>();  // every block's parts
  const int lane = tid & 31, warp = tid >> 5;
  for (int r = rank + CL * warp; r < n; r += CL * (THREADS / 32)) {
    float p[NOUT];
    row_from_parts<CL, CS>(pv, tiles, m[r], r, rank, p, base);
    if (d.add_discrete_head) head_any(p, w, L, d.head_hidden);
    float val = 0.f;
#pragma unroll
    for (int o = 0; o < NOUT; ++o)
      if (lane == o) val = p[o];
    if (lane < NOUT) out[r * NOUT + lane] = val;
  }
  cluster_sync<CS>();  // no block leaves while a peer reads its parts
}

// The launch of a kernel over B jets as clusters of CL blocks (a plain
// launch at CL = 1), grid = clusters · CL. (CL: every block of a jet's
// cluster, row blocks included.)
template <int CL, class... Params, class... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int clusters, size_t smem, cudaStream_t s,
                            Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if constexpr (CL == 1) {
    kernel<<<clusters, THREADS, smem, s>>>(args...);
    return cudaGetLastError();
  } else {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(clusters * CL);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
}

// How many clusters of CL blocks of `kernel` at `smem` bytes the card holds
// at once (cudaOccupancyMaxActiveClusters: a cluster lies in one GPC), for a
// persistent grid.
template <int CL, class... Params>
cudaError_t resident_clusters(void (*kernel)(Params...), size_t smem, int* clusters) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(kernel), &cfg);
  if (err == cudaSuccess && *clusters < 1) err = cudaErrorInvalidConfiguration;
  return err;
}

}  // namespace mmpw
