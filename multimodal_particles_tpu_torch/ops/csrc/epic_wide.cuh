// Shared EPiC forward for the wide hand-written Hopper kernels
// (epic_wide_forward.cu, epic_wide_backward.cu), as the JAX wide kernels share
// `_forward_acts_wide` (multimodal_particles_tpu/ops/epic_pallas_wide.py:97-191).
//
// The narrow kernels (epic_forward.cuh) keep a particle's hidden vectors in
// one thread's registers and a whole stage's weights in shared memory. At
// hidden 128 neither fits: one fc_local1 weight is 192 KB. The wide kernels
// are a chain of matrix products through shared memory instead.
//
// Design: one thread block of 256 threads per jet, every width 128.
//   * A jet's activations are (128 rows, 128 features) float32 tiles in
//     shared memory: h, the local hidden l1, and the skip copy h0 (64 KB
//     each). Rows past the jet's N carry mask 0.
//   * A product C = A·W streams W from L2 in tiles of 16 input rows through
//     a double buffer filled with cp.async; each thread owns an 8 × 8
//     register tile of C (rows ty + 16·i, columns 4·tx + j and 64 + 4·tx + j)
//     and reads A as float4 along the contraction axis. Packed matrices are
//     (in, out) row-major (ops/epic_cuda.py::wide_weight_layout), so a
//     tile is 16 contiguous rows of 512 bytes.
//   * The concatenated inputs of fc_local1 and local_0 are never built: the
//     broadcast thirds (g_new ‖ temb, and temb) are the same for every
//     particle of a jet, so they enter as one per-jet vector-matrix product
//     added like a bias; only h·W_fl1[0:128] is per particle.
//   * Masked per-jet sums are column sums over the tile in shared memory;
//     the per-jet global MLP is vector-matrix products by the whole block.
//   * A recorder (template parameter Rec) receives the activations that the
//     backward kernel reads back; NoRecord compiles to nothing.
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

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace mmpw {

constexpr int DC = 3;         // continuous features per particle
constexpr int V = 8;          // token vocabulary
constexpr int NOUT = DC + V;  // head outputs per particle
constexpr int WD = 128;       // every hidden and embedding width
constexpr int ROWS = 128;     // particle slots per jet
constexpr int THREADS = 256;
constexpr int KT = 16;        // input rows of a weight tile
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

constexpr int MAX_WIDE_HEAD = 64;  // the forward kernel's widest discrete head

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

// Shared memory, in floats: three activation tiles, the weight double
// buffer, then per-jet vectors. g_new and temb are adjacent: together they
// are the broadcast input of fc_local1.
constexpr int S_TILE = 3 * MAT;
constexpr int S_VEC = S_TILE + 2 * KT * WD;
constexpr int V_MASK = 0, V_X = 128, V_K = 512, V_GNEW = 640, V_TEMB = 768, V_P = 896,
              V_VA = 1408, V_VB = 1536, V_G = 1664, V_GSKIP = 1792, V_CL1 = 1920, V_CT = 2048,
              V_DG = 2176, V_DSG = 2304, V_DZA = 2432, V_DZB = 2560, V_DZC = 2688, V_DP = 2816,
              V_DSUM = 3328, V_SDZ = 3456, V_RED = 3584, V_END = 4608;
constexpr size_t SMEM_BYTES = sizeof(float) * (size_t)(S_VEC + V_END);
static_assert(SMEM_BYTES <= 232448, "over a block's 227 KB of shared memory");

// Head weights staged in the (idle) weight buffer, [output][input].
constexpr int T_HW = 0, T_BO = NOUT * WD, T_WH0 = T_BO + 16, T_BH0 = T_WH0 + 64,
              T_WH1 = T_BH0 + 8, T_BH1 = T_WH1 + 64, T_DZ = 2048;
// A wide head's weights in the same buffer, [input][output] as packed:
// W_h0 (V, head_hidden), W_h1 (head_hidden, V).
constexpr int TW_WH0 = T_BO + 16, TW_BH0 = TW_WH0 + V * MAX_WIDE_HEAD,
              TW_WH1 = TW_BH0 + MAX_WIDE_HEAD, TW_BH1 = TW_WH1 + MAX_WIDE_HEAD * V,
              TW_END = TW_BH1 + V;
static_assert(TW_END <= 2 * KT * WD, "a wide head's weights overrun the weight buffer");

__device__ __forceinline__ float leaky(float x) { return x >= 0.f ? x : 0.01f * x; }

__device__ __forceinline__ float selu(float x) {
  const float alpha = 1.6732632423543772f, scale = 1.0507009873554805f;
  return scale * (x > 0.f ? x : alpha * expm1f(x));
}

struct Identity {
  __device__ __forceinline__ float operator()(float v) const { return v; }
};
struct Leaky {
  __device__ __forceinline__ float operator()(float v) const { return leaky(v); }
};

// The thread's register tile of a (128, 128) result.
__device__ __forceinline__ int tile_row(int i) { return (threadIdx.x >> 4) + 16 * i; }
__device__ __forceinline__ int tile_col(int j) {
  return ((threadIdx.x & 15) << 2) + (j & 3) + ((j >> 2) << 6);
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// acc += A[:, k0:k0+KT] · tile, tile (KT, 128) in shared memory. NI < 8 leaves
// out the thread's last 8 − NI rows, the tile's rows from 16·NI on (a caller
// whose jets hold fewer rows).
template <int NI = 8>
__device__ __forceinline__ void tile_fma(float (&acc)[8][8], const float* A, int k0,
                                         const float* tile) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int k4 = 0; k4 < KT; k4 += 4) {
    float a[NI][4];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * WD + k0 + k4);
      a[i][0] = v.x; a[i][1] = v.y; a[i][2] = v.z; a[i][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 lo = *reinterpret_cast<const float4*>(tile + (k4 + kk) * WD + tx * 4);
      const float4 hi = *reinterpret_cast<const float4*>(tile + (k4 + kk) * WD + 64 + tx * 4);
      const float w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][kk], w[j], acc[i][j]);
    }
  }
}

// acc += A · W for A (128, K) in shared memory (row stride 128) and W (K, 128)
// row-major in global memory; K a multiple of KT. Every thread of the block
// calls it; it ends with a barrier, after which A and the buffer are free.
// NI as in tile_fma.
template <int NI = 8>
__device__ __forceinline__ void gemm_acc(float (&acc)[8][8], const float* A,
                                         const float* __restrict__ Wg, int K, float* tiles) {
  const int tid = threadIdx.x;
  const int nkt = K / KT;
  auto fetch = [&](int kt) {
    float* dst = tiles + (kt & 1) * KT * WD;
    const float* src = Wg + (size_t)kt * KT * WD;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int idx = tid + THREADS * q;  // float4 index in the tile
      __pipeline_memcpy_async(dst + idx * 4, src + idx * 4, 16);
    }
    __pipeline_commit();
  };
  fetch(0);
  for (int kt = 0; kt < nkt; ++kt) {
    if (kt + 1 < nkt) {
      fetch(kt + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    tile_fma<NI>(acc, A, kt * KT, tiles + (kt & 1) * KT * WD);
    __syncthreads();
  }
}

// z[j] = Σ_k v[k]·W[k, j] for a per-jet vector v (n_in, shared memory) and W
// (n_in, 128) row-major in global memory; thread j < 128 then calls
// post(j, z[j]). Every thread calls it; it ends with a barrier.
template <class Post>
__device__ __forceinline__ void jet_matvec(const float* v, const float* __restrict__ Wg, int n_in,
                                           float* red, Post post) {
  const int tid = threadIdx.x, cg = tid & 31, ks = tid >> 5;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int k = ks; k < n_in; k += 8) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(Wg + (size_t)k * WD) + cg);
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

// s[c] = Σ_r f(r, S[r, c]) over the tile's rows; thread c < 128 then calls
// post(c, s[c]). Every thread calls it; it ends with a barrier.
template <class F, class Post>
__device__ __forceinline__ void column_sums(const float* S, float* red, F f, Post post) {
  const int tid = threadIdx.x, c = tid & (WD - 1), half = tid >> 7;
  float s = 0.f;
  for (int r = half * 64; r < half * 64 + 64; ++r) s += f(r, S[r * WD + c]);
  red[half * WD + c] = s;
  __syncthreads();
  if (tid < WD) post(tid, red[tid] + red[WD + tid]);
  __syncthreads();
}

// Receives nothing: the forward kernel keeps no activations.
struct NoRecord {
  static constexpr bool HEADS = true;
  __device__ __forceinline__ void z_l0(int, int, float) const {}
  __device__ __forceinline__ void z_fl1(int, int, int, float) const {}
  __device__ __forceinline__ void z_fl2(int, int, int, float) const {}
  __device__ __forceinline__ void h_in(int, const float*) const {}
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
template <class Rec, bool FOLD, bool WIDE_HEAD>
__device__ void wide_forward_jet_ext(const float* __restrict__ w, const Dims& d, const Layout& L,
                                     float* smem, float t, const float* __restrict__ x,
                                     const int* __restrict__ k, const float* __restrict__ kv,
                                     const float* __restrict__ mask, int N,
                                     float* __restrict__ out, float* __restrict__ hid,
                                     const Rec& rec) {
  const int tid = threadIdx.x;
  float* S0 = smem;
  float* S1 = smem + MAT;
  float* S2 = smem + 2 * MAT;
  float* tiles = smem + S_TILE;
  float* vec = smem + S_VEC;
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
  float* red = vec + V_RED;

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
  __syncthreads();
  float denom = 0.f;
  for (int r = 0; r < ROWS; ++r) denom += m[r];
  denom = fmaxf(denom, 1.f);

  // ---- input embeddings: S1 = x_emb, S2 = k_emb (utils.py:112-172)
  if constexpr (FOLD) {
    // the Linear-discrete input: k_emb = values·W_k + b_k
    const int e4 = (tid & 31) * 4;
    const float4 bk = *reinterpret_cast<const float4*>(w + L.b_k + e4);
    float4 wk[V];
#pragma unroll
    for (int v = 0; v < V; ++v) wk[v] = *reinterpret_cast<const float4*>(w + L.table + v * WD + e4);
    for (int r = tid >> 5; r < ROWS; r += 8) {
      float4 ke = bk;
      if (r < N) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float kc = __ldg(kv + r * V + v);
          ke.x = fmaf(kc, wk[v].x, ke.x);
          ke.y = fmaf(kc, wk[v].y, ke.y);
          ke.z = fmaf(kc, wk[v].z, ke.z);
          ke.w = fmaf(kc, wk[v].w, ke.w);
        }
      }
      *reinterpret_cast<float4*>(S2 + r * WD + e4) = ke;
    }
  }
  {
    const int e4 = (tid & 31) * 4;
    const float4 bx = *reinterpret_cast<const float4*>(w + L.b_x + e4);
    float4 wx[DC];
#pragma unroll
    for (int c = 0; c < DC; ++c) wx[c] = *reinterpret_cast<const float4*>(w + L.w_x + c * WD + e4);
    for (int r = tid >> 5; r < ROWS; r += 8) {
      float4 xe = bx;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float xc = xs[r * DC + c];
        xe.x = fmaf(xc, wx[c].x, xe.x);
        xe.y = fmaf(xc, wx[c].y, xe.y);
        xe.z = fmaf(xc, wx[c].z, xe.z);
        xe.w = fmaf(xc, wx[c].w, xe.w);
      }
      *reinterpret_cast<float4*>(S1 + r * WD + e4) = xe;
      if constexpr (!FOLD) {
        const int kr = ks[r];
        float4 ke = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kr >= 0 && kr < V) ke = *reinterpret_cast<const float4*>(w + L.table + kr * WD + e4);
        *reinterpret_cast<float4*>(S2 + r * WD + e4) = ke;
      }
    }
  }
  // the time third of local_0 is the same for every particle of the jet
  jet_matvec(temb, w + L.w_l0, WD, red, [&](int j, float s) { ct[j] = s; });

  // ---- projection (epic.py:164-191): local_0 sees the masked features,
  // W·(f·m) + b = (W·f)·m + b
  float acc[8][8];
  zero_acc(acc);
  gemm_acc(acc, S1, w + L.w_l0 + WD * WD, WD, tiles);
  gemm_acc(acc, S2, w + L.w_l0 + 2 * WD * WD, WD, tiles);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_row(i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(j);
      const float z = (acc[i][j] + ct[c]) * m[r] + w[L.b_l0 + c];
      rec.z_l0(r, c, z);
      S0[r * WD + c] = leaky(z);
    }
  }
  __syncthreads();
  column_sums(S0, red, [&](int r, float v) { return v * m[r]; }, [&](int c, float s) {
    pv[c] = s / denom;
    pv[WD + c] = s;
    pv[2 * WD + c] = temb[c];
  });
  // h = h_act·mask, and the skip copy
  for (int idx = tid; idx < MAT; idx += THREADS) {
    const float v = S0[idx] * m[idx >> 7];
    S0[idx] = v;
    if (d.use_skip) S2[idx] = v;
  }
  for (int i = tid; i < 3 * WD; i += THREADS) rec.proj(R_P0 + i, pv[i]);
  jet_matvec(pv, w + L.w_g0, 3 * WD, red, [&](int j, float s) {
    const float z = s + w[L.b_g0 + j];
    rec.proj(R_ZG0 + j, z);
    va[j] = leaky(z);
  });
  jet_matvec(va, w + L.w_g1, WD, red, [&](int j, float s) {
    const float z = s + w[L.b_g1 + j];
    rec.proj(R_ZG1 + j, z);
    vb[j] = leaky(z);
  });
  jet_matvec(vb, w + L.w_g2, WD, red, [&](int j, float s) {
    const float z = s + w[L.b_g2 + j];
    rec.proj(R_ZG2 + j, z);
    g[j] = leaky(z);
    gskip[j] = d.use_skip ? g[j] : 0.f;
  });

  // ---- EPiC layers (epic.py:193-241)
  for (int blk = 0; blk < d.num_blocks; ++blk) {
    const float* wb = w + L.blocks + (size_t)blk * L.block_stride;
    rec.h_in(blk, S0);
    column_sums(S0, red, [&](int r, float v) { return v * m[r]; }, [&](int c, float s) {
      pv[c] = s / denom;
      pv[WD + c] = s;
      pv[2 * WD + c] = g[c];
      pv[3 * WD + c] = temb[c];
    });
    for (int i = tid; i < 4 * WD; i += THREADS) rec.glob(blk, R_P + i, pv[i]);
    jet_matvec(pv, wb + L.fg1, 4 * WD, red, [&](int j, float s) {
      const float z = s + wb[L.bfg1 + j];
      rec.glob(blk, R_ZFG1 + j, z);
      va[j] = leaky(z);
    });
    jet_matvec(va, wb + L.fg2, WD, red, [&](int j, float s) {
      const float z = s + wb[L.bfg2 + j] + g[j];
      rec.glob(blk, R_ZFG2 + j, z);
      gnew[j] = leaky(z);
    });
    // fc_local1's broadcast inputs [g_new ‖ temb], once per jet
    jet_matvec(gnew, wb + L.fl1 + WD * WD, 2 * WD, red, [&](int j, float s) {
      cl1[j] = s + wb[L.bfl1 + j];
      g[j] = gnew[j] + gskip[j];
    });

    zero_acc(acc);
    gemm_acc(acc, S0, wb + L.fl1, WD, tiles);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tile_row(i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(j);
        const float z = acc[i][j] + cl1[c];
        rec.z_fl1(blk, r, c, z);
        S1[r * WD + c] = leaky(z);
      }
    }
    __syncthreads();
    zero_acc(acc);
    gemm_acc(acc, S1, wb + L.fl2, WD, tiles);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = tile_row(i);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tile_col(j);
        const float z = acc[i][j] + wb[L.bfl2 + c] + S0[r * WD + c];
        rec.z_fl2(blk, r, c, z);
        S0[r * WD + c] = leaky(z) * m[r] + (d.use_skip ? S2[r * WD + c] : 0.f);
      }
    }
    __syncthreads();
  }

  // ---- the trunk's last local hidden state (output_hidden_local): rows of
  // 128 floats, contiguous
  if (hid != nullptr)
    for (int idx = tid; idx < N * (WD / 4); idx += THREADS)
      reinterpret_cast<float4*>(hid)[idx] = reinterpret_cast<const float4*>(S0)[idx];

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
    row_outputs(S0 + r * WD, tiles, m[r], p);
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

// The MBM encoder (tokens, a V-wide head, no hidden output), as the backward
// kernel's recording forward runs it.
template <class Rec>
__device__ __forceinline__ void wide_forward_jet(const float* __restrict__ w, const Dims& d,
                                                 const Layout& L, float* smem, float t,
                                                 const float* __restrict__ x,
                                                 const int* __restrict__ k,
                                                 const float* __restrict__ mask, int N,
                                                 float* __restrict__ out, const Rec& rec) {
  wide_forward_jet_ext<Rec, false, false>(w, d, L, smem, t, x, k, nullptr, mask, N, out, nullptr,
                                          rec);
}

}  // namespace mmpw
