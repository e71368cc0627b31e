// The (ResnetBlock, AttnBlock) stack that the survival head (survival_head.cu)
// and the gsdm stack (gsdm_stack.cu) share, as the JAX kernels share
// `_group_norm`, `_attention` and `_mm`
// (multimodal_particles_tpu/ops/gsdm_stack_pallas.py:31-38 imports them from
// ops/survival_pallas.py).
//
// A block is ResnetBlock: GroupNorm → swish → Dense → + time row → GroupNorm →
// swish → Dense → + x; AttnBlock: GroupNorm → q, k, v → per-head
// softmax(q·kᵀ/√d)·v over all N slots → proj_out → + x. Channel width C = 128,
// N ≤ 128 slots, float32 values. GroupNorm (32 groups of 4 channels, biased
// variance, eps 1e-6) and the attention run over all N slots of a jet, dead
// ones included, and over no slot past N: the TPU kernels' rounding of N up
// to 128 with their row masks and −1e9 key bias is TPU layout and has no
// counterpart.
//
// Design: one block of 256 threads works through jets (a persistent grid,
// one block an SM); every product and both attention products run on the
// tensor cores at fp32 accuracy by the 3×TF32 split (tf32x3.cuh).
//   * The products, (N, 128)·(128, 128) each, are wgmma.m64n128k8: each
//     warpgroup multiplies 64 rows, A from shared memory split in registers
//     with both halves rounded to nearest (`split`), W as TF32 hi and lo
//     halves rounded to nearest, laid out once by the wrapper in the tensor
//     cores' core-matrix order (ops/gsdm_stack_cuda.py::tensor_core_stream).
//     A warpgroup whose rows all lie at or past N skips its products.
//     Truncating A (`split_fast`) and the attention's P left K7 at 1.04 of
//     its gate against a float64 evaluation on a state that the seeded
//     48-step transdimensional flow reaches; rounding both costs ≈ 6% of
//     K7's time (PERF.md §6).
//   * The weights are one stream of 8-row stages a jet, in the order the
//     products read them; a ring of RING stages in shared memory takes it
//     by cp.async, RING − 2 stages ahead, through products, GroupNorm,
//     attention and epilogues alike, and on into the next jet's first
//     product.
//   * GroupNorm is applied to A as it is split: a pass computes the per-group
//     mean and rstd (two passes over the tile: the mean, then the centred sum
//     of squares), and the product's A fragment reads (x − mean)·rstd·scale +
//     bias, swished in the ResnetBlock. No normalised tile is written.
//   * The attention, as attention_core.cu (K8) does it: a warp for 16 query
//     rows and every head, q·kᵀ and P·v on mma.sync.m16n8k8 under the split
//     (q, k and v truncated, P rounded to nearest), k's rows read as the B
//     operand as they are stored, the softmax
//     online over chunks of 64 keys in registers, P from the score
//     accumulator straight into the A fragment with v's rows read in the
//     accumulator's order. Each head's output overwrites the warp's own q
//     rows, which are the warp's own A rows of proj_out: no barrier between.
//   * Shared memory holds three (128, 128) tiles, rows padded to 132 floats:
//     the residual h, a work tile (the ResnetBlock's hidden, or k) and v;
//     the ring of three 8 KB stages; GroupNorm's vectors. While the block
//     attends, q takes h's tile and h waits in the block's scratch tile in
//     device memory (64 KB, L2-resident), parked after the AttnBlock's
//     GroupNorm statistics and added back in proj_out's epilogue.
// Rows from N on of h, the work tile and v are kept at 0.
#pragma once

#include <math.h>

#include "tf32x3.cuh"

namespace mmps {

using namespace tf32x3;

constexpr int C = 128;        // transformer width
constexpr int ROWS = 128;     // particle slots per jet
constexpr int THREADS = 256;  // two warpgroups
constexpr int GROUPS = 32;    // GroupNorm groups
constexpr int GSIZE = C / GROUPS;
constexpr float GN_EPS = 1e-6f;
constexpr int STAGE_ROWS = 8;   // weight rows a stage: one k-step of wgmma
constexpr int STAGE = 2 * STAGE_ROWS * C;  // floats a stage: its TF32 hi and lo halves
constexpr int KSTEPS = C / STAGE_ROWS;     // stages of a (128, 128) weight

// An activation tile: rows of LDT floats, column c of row r at c ^ swz(r).
// Rows of 132 floats put the A fragment's reads (rows g, columns t) and v's
// (rows 2t, columns g) on 32 banks, and every offset from a thread's row is
// a constant; swz is 0. (scripts/gsdm_variants.py `swizzled` times the plan
// of unpadded rows with the column bits 2–4 XORed by the row, conflict-free
// for the float2 accesses too, which leaves room for a fourth ring stage.)
constexpr int LDT = 132;
__device__ __forceinline__ int swz(int r) {
  return 0 * r;
}
__device__ __forceinline__ int tix(int r, int c) { return r * LDT + (c ^ swz(r)); }

// Shared memory, in floats: the tiles h, work, v; the ring; GroupNorm's
// vectors (V_RED: the first pass's partial sums, then each channel's
// rstd·scale and bias; V_RED2: the second pass's; V_MU: each channel's
// group mean).
constexpr int RING = 3;  // ring stages; RING − 2 are fetched ahead
constexpr int TILE = ROWS * LDT;
constexpr int S_RING = 3 * TILE;
constexpr int S_VEC = S_RING + RING * STAGE;
constexpr int V_RED = 0, V_RED2 = 2 * C, V_MU = 4 * C, V_END = 5 * C;
constexpr size_t HEAD_SMEM_BYTES = sizeof(float) * (size_t)(S_VEC + V_END);
static_assert(HEAD_SMEM_BYTES <= 232448, "over a block's 227 KB of shared memory");
static_assert(RING >= 3, "the ring refills the slot read two k-steps before");

// Offsets in floats of one block's weights from the block's start (the
// per-block entries of ops/gsdm_stack_cuda.py::block_layout); vectors only
// are read from here, the matrices from the tensor-core stream.
struct BlockLayout {
  int gn1_s, gn1_b, w_c1, b_c1, gn2_s, gn2_b, w_c2, b_c2;
  int gna_s, gna_b, wq, bq, wk, bk, wv, bv, wp, bp;
  int stride;
};

__host__ __device__ inline BlockLayout make_block_layout() {
  BlockLayout L;
  int b = 0;
  L.gn1_s = b; b += C;
  L.gn1_b = b; b += C;
  L.w_c1 = b;  b += C * C;
  L.b_c1 = b;  b += C;
  L.gn2_s = b; b += C;
  L.gn2_b = b; b += C;
  L.w_c2 = b;  b += C * C;
  L.b_c2 = b;  b += C;
  L.gna_s = b; b += C;
  L.gna_b = b; b += C;
  L.wq = b;    b += C * C;
  L.bq = b;    b += C;
  L.wk = b;    b += C * C;
  L.bk = b;    b += C;
  L.wv = b;    b += C * C;
  L.bv = b;    b += C;
  L.wp = b;    b += C * C;
  L.bp = b;    b += C;
  L.stride = b;
  return L;
}

// Stages of a block in the stream: conv1, conv2, k, v, q, proj_out.
constexpr int BLOCK_STAGES = 6 * KSTEPS;

// No IEEE division in the kernels: its slow path is a called subroutine,
// which makes ptxas spill registers and wait for wgmma results in flight.
__device__ __forceinline__ float swish(float x) { return __fdividef(x, 1.f + expf(-x)); }

// The weight stream through the ring. `seq` counts the stages this block has
// consumed over all its jets; stage `seq` of the block is stage seq % total
// of the stream and lies in slot seq % RING.
struct Ring {
  const float* __restrict__ stream;
  int total;
  float* slots;
  int seq;

  // Stage `s` of the block's sequence into its slot, two float4 a thread,
  // committed as a group.
  __device__ __forceinline__ void fetch(int s) const {
    const float* src = stream + (size_t)(s % total) * STAGE;
    float* dst = slots + (s % RING) * STAGE;
#pragma unroll
    for (int q = 0; q < STAGE / (4 * THREADS); ++q) {
      const int idx = 4 * (threadIdx.x + THREADS * q);
      cp_async16(dst + idx, src + idx);
    }
    cp_async_commit();
  }
  // The first RING − 2 stages, before the block's first product.
  __device__ __forceinline__ void start() const {
    for (int s = 0; s < RING - 2; ++s) fetch(s);
  }
};

// The thread's rows of a product: warpgroup w >> 2 owns rows 64·(w >> 2) …
// + 63, warp w 16 of them; the thread rows r0 and r0 + 8.
__device__ __forceinline__ int frag_row0() {
  const int warp = threadIdx.x >> 5;
  return 64 * (warp >> 2) + 16 * (warp & 3) + ((threadIdx.x >> 2) & 7);
}

__device__ __forceinline__ void zero(float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
}

// f(row, column, at, v0, v1) for the thread's accumulator elements in pairs
// of neighbouring columns (the wgmma accumulator layout: d[4j … 4j + 3] is
// rows r0, r0, r0 + 8, r0 + 8 at columns 8j + 2t, 8j + 2t + 1); `at` is the
// pair's offset in a tile. Both rows are g mod 8: one swizzle.
template <class F>
__device__ __forceinline__ void each_pair(const float (&acc)[64], F f) {
  const int r0 = frag_row0(), c0 = 2 * (threadIdx.x & 3), sg = swz(r0);
#pragma unroll
  for (int j = 0; j < KSTEPS; ++j) {
    const int col = (8 * j + c0) ^ sg;
    f(r0, 8 * j + c0, r0 * LDT + col, acc[4 * j], acc[4 * j + 1]);
    f(r0 + 8, 8 * j + c0, (r0 + 8) * LDT + col, acc[4 * j + 2], acc[4 * j + 3]);
  }
}

__device__ __forceinline__ void store2(float* T, int at, float v0, float v1) {
  *reinterpret_cast<float2*>(T + at) = make_float2(v0, v1);
}

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// A operands. `operator()(kt, x)` gives the thread's A fragment of k-step kt
// (mma.m16n8k8's: rows r0, r0 + 8, r0, r0 + 8 at fragment columns t, t, t + 4,
// t + 4).
//
// From a tile, column 8kt + t and 8kt + t + 4, through f(column, value).
template <class F>
struct TileA {
  const float* T;
  F f;
  __device__ __forceinline__ void operator()(int kt, float (&x)[4]) const {
    const int r0 = frag_row0(), sg = swz(r0), c = 8 * kt + (threadIdx.x & 3);
    const float* row = T + r0 * LDT;
    x[0] = f(c, row[c ^ sg]);
    x[1] = f(c, row[8 * LDT + (c ^ sg)]);
    x[2] = f(c + 4, row[(c + 4) ^ sg]);
    x[3] = f(c + 4, row[8 * LDT + ((c + 4) ^ sg)]);
  }
};
struct Plain {
  __device__ __forceinline__ float operator()(int, float x) const { return x; }
};
// GroupNorm by gn_stats' vectors, then swish if SWISH.
template <bool SWISH>
struct Norm {
  const float* vec;
  __device__ __forceinline__ float operator()(int c, float x) const {
    const float y = fmaf(x - vec[V_MU + c], vec[V_RED + c], vec[V_RED + C + c]);
    return SWISH ? swish(y) : y;
  }
};

// GroupNorm's statistics of tile T over its rows < N: each channel's group
// mean into V_MU, rstd·scale into V_RED, bias into V_RED + C. Every thread
// calls it; it ends with a barrier.
__device__ __forceinline__ void gn_stats(const float* T, const float* __restrict__ scale,
                                         const float* __restrict__ bias, int N, float* vec) {
  const int tid = threadIdx.x, c = tid & (C - 1), half = tid >> 7;
  const int g0 = c / GSIZE * GSIZE;
  float* red = vec + V_RED;
  float* red2 = vec + V_RED2;
  const float inv_count = __fdividef(1.f, (float)(N * GSIZE));
  float s = 0.f;
  for (int r = half; r < N; r += 2) s += T[tix(r, c)];
  red[half * C + c] = s;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int q = 0; q < GSIZE; ++q) total += red[g0 + q] + red[C + g0 + q];
  const float mu = total * inv_count;
  s = 0.f;
  for (int r = half; r < N; r += 2) {
    const float dv = T[tix(r, c)] - mu;
    s = fmaf(dv, dv, s);
  }
  red2[half * C + c] = s;
  __syncthreads();  // every thread has read `red`
  if (tid < C) {
    total = 0.f;
#pragma unroll
    for (int q = 0; q < GSIZE; ++q) total += red2[g0 + q] + red2[C + g0 + q];
    vec[V_MU + c] = mu;
    red[c] = rsqrtf(total * inv_count + GN_EPS) * scale[c];
    red[C + c] = bias[c];
  }
  __syncthreads();
}

// One k-step: acc += a·w on the tensor cores, a_lo·w_hi + a_hi·w_lo +
// a_hi·w_hi, the stage's hi and lo halves K-major in 8 × 4 core matrices
// (core matrices 128 bytes apart along K, 256 along N).
__device__ __forceinline__ void wgmma3(float (&acc)[64], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const float* slot) {
  const uint64_t w_hi = smem_desc(slot, 128, 256), w_lo = smem_desc(slot + STAGE_ROWS * C, 128, 256);
  wgmma_fence();
  wgmma_m64n128k8(acc, al, w_hi);
  wgmma_m64n128k8(acc, ah, w_lo);
  wgmma_m64n128k8(acc, ah, w_hi);
  wgmma_commit();
}

// acc += A·W for the ring's next nkt stages (a (128, 128) weight at nkt =
// KSTEPS), A given by `afrag`, split here; one k-step in flight while the
// next A is split. Each k-step waits for its stage, then fetches the stage
// RING − 2 ahead into the slot read two k-steps before, which both
// warpgroups have finished with. Every thread of the block calls it; it
// ends with a barrier.
template <class AF>
__device__ __forceinline__ void gemm_tc(float (&acc)[64], const AF& afrag, int nkt, Ring& ring,
                                        bool live) {
  uint32_t ah[2][4], al[2][4];  // k-steps of even and odd index
  fence_operands(acc);
  auto step = [&](int kt, uint32_t (&h)[4], uint32_t (&l)[4]) {
    if (live) {
      float x[4];
      afrag(kt, x);
#pragma unroll
      for (int i = 0; i < 4; ++i) split(x[i], h[i], l[i]);  // k-step kt − 2's, completed
    }
    cp_async_wait<RING - 3>();  // stage kt has landed, for this thread
    fence_proxy_async();
    __syncthreads();  // for every thread; both warpgroups have waited for k-step kt − 2
    ring.fetch(ring.seq + kt + RING - 2);
    if (live) {
      wgmma3(acc, h, l, ring.slots + ((ring.seq + kt) % RING) * STAGE);
      wgmma_wait<1>();
    }
  };
#pragma unroll 1
  for (int kt = 0; kt < nkt; kt += 2) {
    step(kt, ah[0], al[0]);
    if (kt + 1 < nkt) step(kt + 1, ah[1], al[1]);
  }
  if (live) wgmma_wait<0>();
  fence_operands(acc);
  __syncthreads();
  ring.seq += nkt;
}

// d += a·b at fp32 accuracy on mma.sync: a_lo·b_hi + a_hi·b_lo + a_hi·b_hi.
__device__ __forceinline__ void mma3_split(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma(d, al, bh);
  mma(d, ah, bl);
  mma(d, ah, bh);
}

// The warp's 16 rows of Q (q, scaled) attend over the keys < N, head by head
// (HD channels each): each head's channels of the rows become softmax(q·kᵀ)·v.
// Q, K, V: tiles, K's and V's rows from N on 0. Only the warp's own rows are
// read and written. Warps whose rows all lie at or past N return at once.
template <int HD>
__device__ __forceinline__ void attend(float* Q, const float* K, const float* V, int N) {
  constexpr int NB = HD / 8;               // channel blocks of a head
  constexpr int KC = HD == 128 ? 32 : 64;  // keys a softmax chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 64 * (warp >> 2) + 16 * (warp & 3);
  if (row0 >= N) return;
  const int kpad = (N + 7) & ~7;  // keys the products run over, in tiles of 8
  // the swizzles of the thread's rows: g (q, k) and 2t, 2t + 1 (v) modulo 8
  const int sg = swz(g), sv0 = swz(2 * t), sv1 = swz(2 * t + 1);
  float* qa = Q + (row0 + g) * LDT;
  for (int head = 0; head < C / HD; ++head) {
    const int hc = head * HD;
    float o[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.f, 0.f};
    for (int kc = 0; kc < kpad; kc += KC) {
      const int nt = min(KC, kpad - kc) / 8;  // key tiles of 8 in this chunk
      float s[KC / 8][4];
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      // S = q·kᵀ over the chunk's keys; k's rows are the B operand as stored
#pragma unroll 2
      for (int kk = 0; kk < HD; kk += 8) {
        const int c0 = (hc + kk + t) ^ sg, c1 = (hc + kk + t + 4) ^ sg;
        uint32_t ah[4], al[4];
        split_fast(qa[c0], ah[0], al[0]);
        split_fast(qa[8 * LDT + c0], ah[1], al[1]);
        split_fast(qa[c1], ah[2], al[2]);
        split_fast(qa[8 * LDT + c1], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) {
          if (j < nt) {
            const float* kb = K + (kc + 8 * j + g) * LDT;
            uint32_t bh[2], bl[2];
            split_fast(kb[c0], bh[0], bl[0]);
            split_fast(kb[c1], bh[1], bl[1]);
            mma3_split(s[j], ah, al, bh, bl);
          }
        }
      }
      // the softmax's running maximum and sum; rows g (s[.][0..1]) and g + 8
      float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) {
        if (j < nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kc + 8 * j + 2 * t + (e & 1);
            const float x = key < N ? s[j][e] : -INFINITY;
            s[j][e] = x;
            cmax[e >> 1] = fmaxf(cmax[e >> 1], x);
          }
        }
      }
      float factor[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cmax[h] = fmaxf(cmax[h], __shfl_xor_sync(0xffffffffu, cmax[h], 1));
        cmax[h] = fmaxf(cmax[h], __shfl_xor_sync(0xffffffffu, cmax[h], 2));
        const float m = fmaxf(row_max[h], cmax[h]);  // finite: a chunk holds a key < N
        factor[h] = expf(row_max[h] - m);
        row_max[h] = m;
        row_sum[h] *= factor[h];
      }
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        o[n][0] *= factor[0];
        o[n][1] *= factor[0];
        o[n][2] *= factor[1];
        o[n][3] *= factor[1];
      }
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) {
        if (j < nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = expf(s[j][e] - row_max[e >> 1]);
            row_sum[e >> 1] += s[j][e];
          }
        }
      }
      // O += P·v, fragment column t ↔ key 2t, t + 4 ↔ key 2t + 1
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) {
        if (j < nt) {
          uint32_t ah[4], al[4];
          split(s[j][0], ah[0], al[0]);
          split(s[j][2], ah[1], al[1]);
          split(s[j][1], ah[2], al[2]);
          split(s[j][3], ah[3], al[3]);
          const float* v0 = V + (kc + 8 * j + 2 * t) * LDT;
#pragma unroll
          for (int n = 0; n < NB; ++n) {
            const int c = hc + 8 * n + g;
            uint32_t bh[2], bl[2];
            split_fast(v0[c ^ sv0], bh[0], bl[0]);
            split_fast(v0[LDT + (c ^ sv1)], bh[1], bl[1]);
            mma3_split(o[n], ah, al, bh, bl);
          }
        }
      }
    }
    float inv[2];  // row sums lie in [1, N]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 1);
      row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 2);
      inv[h] = __fdividef(1.f, row_sum[h]);
    }
    __syncwarp();  // every lane has read the head's q
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int c = (hc + 8 * n + 2 * t) ^ sg;
      *reinterpret_cast<float2*>(qa + c) = make_float2(o[n][0] * inv[0], o[n][1] * inv[0]);
      *reinterpret_cast<float2*>(qa + 8 * LDT + c) = make_float2(o[n][2] * inv[1], o[n][3] * inv[1]);
    }
  }
  __syncwarp();  // the rows are the warp's A operand of proj_out
}

// n_blocks × (ResnetBlock, AttnBlock) on the residual stream h, the first
// tile of `smem` (rows from N on 0); the other two tiles are work space.
// `wblocks` points at the first block's weights (vectors read from there),
// `tp` at the jet's time row of the first block, the next block's
// tp_block_stride floats on; the ring's next stages are the blocks'; `park`
// is the block's scratch tile in device memory. Every thread of the block
// calls it. HD: channels a head.
template <int HD>
__device__ __forceinline__ void gsdm_blocks(const float* __restrict__ wblocks,
                                            const BlockLayout& L, float* smem,
                                            const float* __restrict__ tp, size_t tp_block_stride,
                                            Ring& ring, float* park, int N, int n_blocks) {
  float* h = smem;             // the residual stream
  float* a = smem + TILE;      // the ResnetBlock's hidden, then k
  float* v = smem + 2 * TILE;  // v
  float* vec = smem + S_VEC;
  const bool live = 64 * (threadIdx.x >> 7) < N;  // the warpgroup's rows reach below N
  const float q_scale = 1.f / sqrtf((float)HD);
  float acc[64];

  for (int blk = 0; blk < n_blocks; ++blk) {
    const float* wb = wblocks + (size_t)blk * L.stride;
    const float* tpb = tp + blk * tp_block_stride;

    // ---- ResnetBlock
    gn_stats(h, wb + L.gn1_s, wb + L.gn1_b, N, vec);
    zero(acc);
    gemm_tc(acc, TileA<Norm<true>>{h, {vec}}, KSTEPS, ring, live);
    each_pair(acc, [&](int r, int c, int at, float v0, float v1) {
      const float2 b = ldg2(wb + L.b_c1 + c), tr = ldg2(tpb + c);
      const bool real = r < N;
      store2(a, at, real ? (v0 + b.x) + tr.x : 0.f, real ? (v1 + b.y) + tr.y : 0.f);
    });
    __syncthreads();
    gn_stats(a, wb + L.gn2_s, wb + L.gn2_b, N, vec);
    zero(acc);
    gemm_tc(acc, TileA<Norm<true>>{a, {vec}}, KSTEPS, ring, live);
    each_pair(acc, [&](int r, int c, int at, float v0, float v1) {
      if (r < N) {
        const float2 b = ldg2(wb + L.b_c2 + c);
        float2* p = reinterpret_cast<float2*>(h + at);
        const float2 x = *p;
        *p = make_float2(x.x + (v0 + b.x), x.y + (v1 + b.y));
      }
    });
    __syncthreads();

    // ---- AttnBlock: h parked, k into `a`, v into `v`, q into h's tile
    gn_stats(h, wb + L.gna_s, wb + L.gna_b, N, vec);
    for (int idx = threadIdx.x; idx < TILE / 4; idx += THREADS)
      reinterpret_cast<float4*>(park)[idx] = reinterpret_cast<const float4*>(h)[idx];
    zero(acc);
    gemm_tc(acc, TileA<Norm<false>>{h, {vec}}, KSTEPS, ring, live);
    each_pair(acc, [&](int r, int c, int at, float v0, float v1) {
      const float2 b = ldg2(wb + L.bk + c);
      const bool real = r < N;
      store2(a, at, real ? v0 + b.x : 0.f, real ? v1 + b.y : 0.f);
    });
    zero(acc);
    gemm_tc(acc, TileA<Norm<false>>{h, {vec}}, KSTEPS, ring, live);
    each_pair(acc, [&](int r, int c, int at, float v0, float v1) {
      const float2 b = ldg2(wb + L.bv + c);
      const bool real = r < N;
      store2(v, at, real ? v0 + b.x : 0.f, real ? v1 + b.y : 0.f);
    });
    zero(acc);
    gemm_tc(acc, TileA<Norm<false>>{h, {vec}}, KSTEPS, ring, live);  // its barriers end h's reads
    each_pair(acc, [&](int r, int c, int at, float v0, float v1) {
      const float2 b = ldg2(wb + L.bq + c);
      store2(h, at, (v0 + b.x) * q_scale, (v1 + b.y) * q_scale);
    });
    __syncthreads();  // k, v and q stored
    attend<HD>(h, a, v, N);
    zero(acc);
    // the warps' A fragments are the rows they attended for: no barrier before
    gemm_tc(acc, TileA<Plain>{h, {}}, KSTEPS, ring, live);
    each_pair(acc, [&](int r, int c, int at, float v0, float v1) {
      float2 y = make_float2(0.f, 0.f);
      if (r < N) {
        const float2 b = ldg2(wb + L.bp + c), x = *reinterpret_cast<const float2*>(park + at);
        y = make_float2(x.x + (v0 + b.x), x.y + (v1 + b.y));
      }
      store2(h, at, y.x, y.y);
    });
    __syncthreads();
  }
}

}  // namespace mmps
