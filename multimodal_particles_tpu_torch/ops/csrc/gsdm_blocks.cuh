// The (ResnetBlock, AttnBlock) stack that the survival head (survival_head.cu)
// and the gsdm stack (gsdm_stack.cu) share, as the JAX kernels share
// `_group_norm`, `_attention` and `_mm`
// (multimodal_particles_tpu/ops/gsdm_stack_pallas.py:31-38 imports them from
// ops/survival_pallas.py).
//
// A block is ResnetBlock: GroupNorm → swish → Dense → + time row → GroupNorm →
// swish → Dense → + x; AttnBlock: GroupNorm → q, k, v → per-head
// softmax(q·kᵀ/√d)·v over all N slots → proj_out → + x. Channel width C = 128,
// N ≤ 128 slots, float32 throughout. GroupNorm (32 groups of 4 channels,
// biased variance, eps 1e-6) and the attention run over all N slots of a jet,
// dead ones included, and over no slot past N: the TPU kernels' rounding of N
// up to 128 with their row masks and −1e9 key bias is TPU layout and has no
// counterpart.
//
// Design: one block of 256 threads works through jets (a persistent grid,
// one block an SM); a jet's activations are (128 rows, 128 channels) tiles in
// shared memory and the products are the wide EPiC kernels' (epic_wide.cuh):
// weights streamed from L2 in tiles of 16 input rows through a cp.async
// double buffer, an 8 × 8 register tile a thread; at N ≤ 112 a product leaves
// out the tile's last 16 rows.
//   * Three tiles fit beside the weight buffer (208 KB; with the per-warp
//     probability rows the block takes 226 KB of the 227 KB it may have).
//     The ResnetBlock needs two (h and a work tile). Attention needs q, kᵀ, v
//     and the normalized input, so the residual h is parked in a per-block
//     scratch row in device memory (64 KB a block, L2-resident) while the
//     block attends, and read back when proj_out's result is added.
//   * GroupNorm is two passes over the tile (mean, then the centred sum of
//     squares), a thread a channel and half of the rows.
//   * Attention is a warp for four query rows at a time: the lanes hold each
//     row's N scores (4 keys a lane), so the softmax is two warp reductions a
//     row, and a key or value read feeds four multiply-adds; k is kept
//     transposed (channel-major) so that the lanes read neighbouring keys, in
//     a layout XOR-swizzled so that the transposing store is conflict-free
//     too; the probabilities go through per-warp rows in shared memory into
//     the values' product, whose result overwrites the rows' own q. Heads are
//     contiguous channel ranges of 128 / n_heads; the (head, row group) pairs
//     are dealt round the warps.
#pragma once

#include "epic_wide.cuh"

namespace mmps {

using namespace mmpw;  // WD, ROWS, THREADS, KT, MAT, zero_acc, gemm_acc, tile_row, tile_col

constexpr int C = WD;          // transformer width
constexpr int GROUPS = 32;     // GroupNorm groups
constexpr int GSIZE = C / GROUPS;
constexpr float GN_EPS = 1e-6f;
constexpr int WARPS = THREADS / 32;
constexpr int RG = 4;  // query rows a warp attends for at a time
static_assert(RG == 4, "attention_rows reads a group's probabilities as one float4");

// Offsets in floats of one block's weights from the block's start (the
// per-block entries of ops/gsdm_stack_cuda.py::block_layout); matrices are
// (in, out) row-major.
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

// Shared memory, in floats: three activation tiles, the weight double buffer,
// then per-jet vectors.
constexpr int H_TILES = 3 * MAT;
constexpr int H_VEC = H_TILES + 2 * KT * WD;
constexpr int HV_MASK = 0, HV_TP = 128, HV_RED = 256, HV_MEAN = 512, HV_RSTD = 544,
              HV_PROB = 576, HV_END = HV_PROB + WARPS * ROWS * RG;
constexpr size_t HEAD_SMEM_BYTES = sizeof(float) * (size_t)(H_VEC + HV_END);
static_assert(HEAD_SMEM_BYTES <= 232448, "over a block's 227 KB of shared memory");

__device__ __forceinline__ float swish(float x) { return x / (1.f + expf(-x)); }

// Where key `row` of channel `c` lies in the transposed k tile: channel-major,
// the key index XORed with an even number that differs between the 16
// channels a warp stores at once, so that both the transposing store (lanes
// over channels 4 apart and two neighbouring rows) and the score loop's loads
// (lanes over neighbouring keys) touch 32 different banks.
__device__ __forceinline__ int kt_index(int c, int row) {
  return c * ROWS + (row ^ (((c >> 2) & 15) << 1));
}

// dst = GroupNorm(src)·scale + bias over rows < N, then swish if SWISH; rows
// from N on become 0. src may be dst. Every thread calls it; it ends with a
// barrier.
template <bool SWISH>
__device__ __forceinline__ void group_norm(const float* src, float* dst,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias, int N, float* vec) {
  const int tid = threadIdx.x, c = tid & (C - 1), half = tid >> 7;
  float* red = vec + HV_RED;
  float* mean = vec + HV_MEAN;
  float* rstd = vec + HV_RSTD;
  const float count = (float)(N * GSIZE);

  float s = 0.f;
  for (int r = half; r < N; r += 2) s += src[r * WD + c];
  red[half * C + c] = s;
  __syncthreads();
  if (tid < GROUPS) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < GSIZE; ++q) t += red[tid * GSIZE + q] + red[C + tid * GSIZE + q];
    mean[tid] = t / count;
  }
  __syncthreads();
  const float mu = mean[c / GSIZE];
  s = 0.f;
  for (int r = half; r < N; r += 2) {
    const float dv = src[r * WD + c] - mu;
    s = fmaf(dv, dv, s);
  }
  red[half * C + c] = s;
  __syncthreads();
  if (tid < GROUPS) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < GSIZE; ++q) t += red[tid * GSIZE + q] + red[C + tid * GSIZE + q];
    rstd[tid] = rsqrtf(t / count + GN_EPS);
  }
  __syncthreads();
  const float rs = rstd[c / GSIZE], sc = scale[c], bi = bias[c];
  for (int r = half; r < ROWS; r += 2) {
    float y = 0.f;
    if (r < N) {
      y = (src[r * WD + c] - mu) * rs * sc + bi;
      if (SWISH) y = swish(y);
    }
    dst[r * WD + c] = y;
  }
  __syncthreads();
}

// Q[r, head's channels] ← softmax_j(q_r·k_j)·v_j over the keys j < N, for the
// rows r < N and every head; q comes scaled. A warp takes RG neighbouring
// query rows at a time, so that a key or value read from shared memory feeds
// RG multiply-adds. The caller synchronises before and after.
__device__ __forceinline__ void attention_rows(float* Q, const float* KT, const float* Vt, int N,
                                               int n_heads, float* prob) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hd = C / n_heads, nq = hd / 32;
  float* pw = prob + warp * ROWS * RG;  // [key][row of the group]
  // the (head, row group) pairs go round the warps: at N = 109 and two heads
  // that is 56 pairs, 7 a warp
  const int groups = (N + RG - 1) / RG;
  for (int item = warp; item < n_heads * groups; item += WARPS) {
    const int hc = (item / groups) * hd, r0 = (item % groups) * RG;
    // rows past N read row r0 again and are not written back
    int row[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) row[i] = r0 + i < N ? r0 + i : r0;
    float s[RG][4];
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
    for (int c = 0; c < hd; c += 4) {
      float qv[RG][4];
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(Q + row[i] * WD + hc + c);
        qv[i][0] = v.x; qv[i][1] = v.y; qv[i][2] = v.z; qv[i][3] = v.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        // the four channels c..c+3 share kt_index's XOR term
        const float* kt = KT + (hc + c + cc) * ROWS + (lane ^ ((((hc + c) >> 2) & 15) << 1));
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float kv = kt[32 * jj];
#pragma unroll
          for (int i = 0; i < RG; ++i) s[i][jj] = fmaf(qv[i][cc], kv, s[i][jj]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (lane + 32 * jj < N) mx = fmaxf(mx, s[i][jj]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[i][jj] = lane + 32 * jj < N ? expf(s[i][jj] - mx) : 0.f;
        sum += s[i][jj];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) pw[(lane + 32 * jj) * RG + i] = s[i][jj] / sum;
    }
    __syncwarp();
    float o[RG][4];
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) o[i][q] = 0.f;
    for (int j = 0; j < N; ++j) {
      const float4 p4 = *reinterpret_cast<const float4*>(pw + j * RG);
      const float p[RG] = {p4.x, p4.y, p4.z, p4.w};
      const float* vrow = Vt + j * WD + hc + lane;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < nq) {
          const float vv = vrow[32 * q];
#pragma unroll
          for (int i = 0; i < RG; ++i) o[i][q] = fmaf(p[i], vv, o[i][q]);
        }
    }
    __syncwarp();  // every lane has read these rows' q and probabilities
#pragma unroll
    for (int i = 0; i < RG; ++i)
      if (r0 + i < N) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < nq) Q[(r0 + i) * WD + hc + lane + 32 * q] = o[i][q];
      }
  }
}

// n_blocks × (ResnetBlock, AttnBlock) on the residual stream in the first tile
// of `smem`; the other two tiles are work space. `wblocks` points at the first
// block's weights, `tp` at the jet's time row of the first block, the next
// block's tp_block_stride floats on; `park` is the block's scratch row in
// device memory. Every thread of the block calls it. Returns the tile that
// holds the residual afterwards (the first or the third); the second tile is
// free. NI: the products cover the tile's first 16·NI rows (N ≤ 16·NI).
template <int NI>
__device__ __forceinline__ float* gsdm_blocks(const float* __restrict__ wblocks,
                                              const BlockLayout& L, float* smem,
                                              const float* __restrict__ tp,
                                              size_t tp_block_stride, float* park, int N,
                                              int n_blocks, int n_heads) {
  const int tid = threadIdx.x;
  float* h = smem;             // the residual stream
  float* a = smem + MAT;       // work tile
  float* b = smem + 2 * MAT;   // work tile
  float* tiles = smem + H_TILES;
  float* vec = smem + H_VEC;
  float* tpv = vec + HV_TP;
  float acc[8][8];

  const float q_scale = rsqrtf((float)(C / n_heads));
  for (int blk = 0; blk < n_blocks; ++blk) {
    const float* wb = wblocks + (size_t)blk * L.stride;
    if (tid < C) tpv[tid] = tp[blk * tp_block_stride + tid];  // read after group_norm's barriers

    // ---- ResnetBlock
    group_norm<true>(h, a, wb + L.gn1_s, wb + L.gn1_b, N, vec);
    zero_acc(acc);
    gemm_acc<NI>(acc, a, wb + L.w_c1, C, tiles);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tile_row(i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(j);
        a[r * WD + c] = acc[i][j] + wb[L.b_c1 + c] + tpv[c];
      }
    }
    __syncthreads();
    group_norm<true>(a, a, wb + L.gn2_s, wb + L.gn2_b, N, vec);
    zero_acc(acc);
    gemm_acc<NI>(acc, a, wb + L.w_c2, C, tiles);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tile_row(i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(j);
        h[r * WD + c] += acc[i][j] + wb[L.b_c2 + c];
      }
    }
    __syncthreads();

    // ---- AttnBlock: the normalized input in `a`; h parked, its tile takes q
    group_norm<false>(h, a, wb + L.gna_s, wb + L.gna_b, N, vec);
    for (int idx = tid; idx < MAT / 4; idx += THREADS)
      reinterpret_cast<float4*>(park)[idx] = reinterpret_cast<const float4*>(h)[idx];
    float* Q = h;
    float* KT = b;
    zero_acc(acc);
    gemm_acc<NI>(acc, a, wb + L.wq, C, tiles);  // its barriers order the parking before the stores to Q
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tile_row(i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(j);
        Q[r * WD + c] = (acc[i][j] + wb[L.bq + c]) * q_scale;
      }
    }
    zero_acc(acc);
    gemm_acc<NI>(acc, a, wb + L.wk, C, tiles);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tile_row(i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(j);
        KT[kt_index(c, r)] = acc[i][j] + wb[L.bk + c];
      }
    }
    zero_acc(acc);
    gemm_acc<NI>(acc, a, wb + L.wv, C, tiles);  // ends with a barrier: `a` is free for v
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tile_row(i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(j);
        a[r * WD + c] = acc[i][j] + wb[L.bv + c];
      }
    }
    __syncthreads();
    attention_rows(Q, KT, a, N, n_heads, vec + HV_PROB);
    __syncthreads();
    // rows from N on of Q still hold q: finite, and no row reads another's
    zero_acc(acc);
    gemm_acc<NI>(acc, Q, wb + L.wp, C, tiles);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tile_row(i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(j);
        b[r * WD + c] = park[r * WD + c] + (acc[i][j] + wb[L.bp + c]);
      }
    }
    __syncthreads();
    float* freed = h;  // the new residual lies in `b`
    h = b;
    b = freed;
  }
  return h;
}

}  // namespace mmps
