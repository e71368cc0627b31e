// The per-warp tensor-core machinery of the narrow kernels K1 (the fused EPiC
// forward, epic_forward_kernel.cuh), K2 (the fused sampler step,
// sampler_step.cu) and K3 (the backward, epic_backward.cu, whose rerun is
// K1's forward), and the buffer they read.
//
// A block gives each warp 16 particle slots, at most 256 slots (16 warps) a
// block. A jet of 257 to 512 slots is a thread-block cluster of two row
// blocks (`RowBlocks`), each the same plan on its half of the slots; only
// the pools cross them (below). A warp's rows go through every
// per-particle product as mma.sync.m16n8k8 TF32 products under the 3×TF32
// split (tf32x3.cuh, `product`), each product's accumulator passed on as the
// next one's A fragment: a thread holds columns 2t and 2t + 1 of each 8-column
// n-tile, and the buffer lays each weight's k-step out so that the mma's k
// positions t and t + 4 read the inputs 2t and 2t + 1. A masked pool is each
// warp's column partial sums in shared memory and one barrier (`pool`); in a
// cluster of row blocks every block adds both blocks' partials, row block 0
// first, through distributed shared memory, so that both hold the same bits
// and run the jet's per-jet MLP alike. The
// per-jet vector-matrix products run on one warp (`dense*`): H-wide vectors
// lane-held (`LaneVec`), vectors of any width in shared memory (`SmemVec`),
// 64 output columns at a time.
//
// The buffer (ops/epic_cuda.py::narrow_buffer_layout, `make_tc_layout` here):
// the per-jet weights (in, out) row-major, then the per-particle products'
// fragments (2·K·N floats a (K, N) product: per k-step and n-tile, a lane's
// hi b0, hi b1, lo b0, lo b1) and biases, each entry padded to 4 floats.
// local_0's particle two thirds are folded with the embeddings into one
// 16-deep product of [x, 1, 0…, onehot(k) or the 8 channel values] with
// [T_x; c; 0; T_k]; the output layer's 16 columns are the 8 discrete
// pre-logits, the 3 continuous outputs and 5 zero columns; the discrete head
// is Dense(8 → head width) → SELU → Dense(head width → 8), its width padded
// to 8-column tiles. The fragments of K3's transposed weights follow
// (`make_tc_layout_t`); K1 and K2 do not read them.
#pragma once

#include <cooperative_groups.h>

#include "epic_forward.cuh"
#include "tf32x3.cuh"

namespace mmp {
namespace narrow {

__host__ __device__ inline int pad4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int pad8(int n) { return (n + 7) & ~7; }

// Offsets in floats into the buffer. Block offsets are from `blocks` /
// `pblocks`.
struct TcLayout {
  int t0, g0, bg0, g1, bg1, g2, bg2, blocks, block_stride;
  int fg1, bfg1, fg2, bfg2, fl1b, bfl1;
  int l0f, bl0, pblocks, pblock_stride, fl1f, fl2f, bfl2;
  int outf, bout, h0f, bh0, h1f, bh1, total;
};

__host__ __device__ inline TcLayout make_tc_layout(const Dims& d) {
  TcLayout L;
  const int H = d.hidden, Hg = d.hidden_glob, Et = d.emb_t, Hd = pad8(d.head_hidden);
  int o = 0;
  L.t0 = o;  o += pad4(Et * H);
  L.g0 = o;  o += pad4((2 * H + Et) * H);
  L.bg0 = o; o += pad4(H);
  L.g1 = o;  o += pad4(H * H);
  L.bg1 = o; o += pad4(H);
  L.g2 = o;  o += pad4(H * Hg);
  L.bg2 = o; o += pad4(Hg);
  L.blocks = o;
  int b = 0;
  L.fg1 = b;  b += pad4((2 * H + Hg + Et) * H);
  L.bfg1 = b; b += pad4(H);
  L.fg2 = b;  b += pad4(H * Hg);
  L.bfg2 = b; b += pad4(Hg);
  L.fl1b = b; b += pad4((Hg + Et) * H);
  L.bfl1 = b; b += pad4(H);
  L.block_stride = b;
  o += d.num_blocks * b;
  L.l0f = o; o += 2 * 16 * H;
  L.bl0 = o; o += pad4(H);
  L.pblocks = o;
  b = 0;
  L.fl1f = b; b += 2 * H * H;
  L.fl2f = b; b += 2 * H * H;
  L.bfl2 = b; b += pad4(H);
  L.pblock_stride = b;
  o += d.num_blocks * b;
  L.outf = o; o += 2 * H * 16;
  L.bout = o; o += 16;
  L.h0f = o;  o += 2 * V * Hd;
  L.bh0 = o;  o += Hd;
  L.h1f = o;  o += 2 * Hd * V;
  L.bh1 = o;  o += V;
  L.total = o;
  return L;
}

// K3's part of the buffer, after K1's and K2's (`make_tc_layout(d).total`): the
// fragments of the transposed per-particle weights of its dz·Wᵀ products,
// each a (K, N) product's fragments laid out as K1's: the output layer's (16,
// H), per layer fc_local2's and fc_local1's particle third (H, H), the
// head's second layer (V, head width) and first (head width, V).
struct TcLayoutT {
  int outT, blocks, block_stride, fl2T, fl1T, h1T, h0T, total;
};

__host__ __device__ inline TcLayoutT make_tc_layout_t(const Dims& d) {
  TcLayoutT L;
  const int H = d.hidden, Hd = pad8(d.head_hidden);
  int o = make_tc_layout(d).total;
  L.outT = o; o += 2 * 16 * H;
  L.blocks = o;
  L.fl2T = 0;
  L.fl1T = 2 * H * H;
  L.block_stride = 4 * H * H;
  o += d.num_blocks * L.block_stride;
  L.h1T = o; o += 2 * V * Hd;
  L.h0T = o; o += 2 * Hd * V;
  L.total = o;
  return L;
}

constexpr unsigned FULL = 0xffffffffu;

// A lane-held vector of at most 64 (the H-wide ones): lane l holds elements
// l and 32 + l.
struct LaneVec {
  float v[2];
  __device__ __forceinline__ float at(int i) const {  // every lane gets element i
    return __shfl_sync(FULL, i < 32 ? v[0] : v[1], i & 31);
  }
  // each lane gets its own element i; every lane's i lies in the 32 of base
  __device__ __forceinline__ float get(int base, int i) const {
    return __shfl_sync(FULL, base < 32 ? v[0] : v[1], i & 31);
  }
};

// A vector of any length in shared memory (the time embedding, the global
// vectors of width hidden_glob), read by the calling warp.
struct SmemVec {
  const float* p;
  __device__ __forceinline__ float at(int i) const { return p[i]; }
  __device__ __forceinline__ float get(int, int i) const { return p[i]; }
};

// The calling warp's partial sums of `cols` ≤ 64 columns of a dense layer
// over one segment of its input (n values), W the segment's rows of the
// layer's (n, stride) row-major matrix from its first column on (in shared
// or global memory), eight inputs a step with their loads issued together.
// For cols ≤ 16 lanes l and l + 16 both take column l, the first inputs 0–3
// of each eight, the second 4–7; otherwise lane l takes the columns l and
// l + 32 (a[q]), all eight inputs. a[q][p]: four partial sums, by the
// input's place p in its group of four.
template <class V>
__device__ __forceinline__ void dense_seg(float (&a)[2][4], const V& in, int n,
                                          const float* __restrict__ W, int stride, int cols) {
  const int lane = threadIdx.x & 31;
  if (cols <= 16) {
    const int j = lane & 15, first = 4 * (lane >> 4);
    const bool live = j < cols;
    for (int i = 0; i < n; i += 8) {
      // i is a multiple of 8: inputs i … i + 7 lie in one 32, so a lane-held
      // vector's one register holds them all and each lane fetches its own four
      float x[4], w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = i + first + c;
        x[c] = in.get(i, min(r, n - 1));
        w[c] = live && r < n ? W[(size_t)r * stride + j] : 0.f;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) a[0][c] = fmaf(w[c], x[c], a[0][c]);
    }
    return;
  }
  const bool o0 = lane < cols, o1 = lane + 32 < cols;
  for (int i = 0; i < n; i += 4) {
    float x[4], w0[4], w1[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = i + c;
      x[c] = in.at(min(r, n - 1));
      w0[c] = o0 && r < n ? W[(size_t)r * stride + lane] : 0.f;
      w1[c] = o1 && r < n ? W[(size_t)r * stride + lane + 32] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      a[0][c] = fmaf(w0[c], x[c], a[0][c]);
      a[1][c] = fmaf(w1[c], x[c], a[1][c]);
    }
  }
}

// One segment of a dense layer's concatenated input: a vector and its length.
template <class V>
struct Seg {
  V v;
  int n;
};
__device__ __forceinline__ Seg<LaneVec> seg(const LaneVec& v, int n) { return {v, n}; }
__device__ __forceinline__ Seg<SmemVec> seg(const float* p, int n) { return {SmemVec{p}, n}; }

// The lane's two outputs (columns c0 + lane and c0 + 32 + lane, 0 past
// n_out) of act(W·[segments] + b (+ res)), the segments' weights stacked in
// W's (·, n_out) rows in order, b may be null; every lane of the warp takes
// part.
template <bool LEAKY, bool RES, class... S>
__device__ __forceinline__ void dense_cols(float (&z)[2], const float* __restrict__ W,
                                           const float* __restrict__ b, int n_out, int c0,
                                           const float (&res)[2], S... segs) {
  const int cols = min(n_out - c0, 64);
  float a[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  const float* w = W + c0;
  ((dense_seg(a, segs.v, segs.n, w, n_out, cols), w += (size_t)segs.n * n_out), ...);
  const int lane = threadIdx.x & 31;
  float sum[2] = {(a[0][0] + a[0][1]) + (a[0][2] + a[0][3]), (a[1][0] + a[1][1]) + (a[1][2] + a[1][3])};
  if (cols <= 16) sum[0] += __shfl_xor_sync(FULL, sum[0], 16);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int j = lane + 32 * q;
    float v = 0.f;
    if (j < cols) {
      v = sum[q] + (b != nullptr ? b[c0 + j] : 0.f);
      if (RES) v += res[q];
      if (LEAKY) v = leaky(v);
    }
    z[q] = v;
  }
}

// out = act(W·[segments] + b (+ res)) lane-held, n_out ≤ 64.
template <bool LEAKY, bool RES = false, class... S>
__device__ __forceinline__ LaneVec dense(const float* __restrict__ W, const float* __restrict__ b,
                                         int n_out, LaneVec res, S... segs) {
  LaneVec out;
  dense_cols<LEAKY, RES>(out.v, W, b, n_out, 0, res.v, segs...);
  return out;
}

// out[0, n_out) = act(W·[segments] + b (+ res)) into shared memory, 64
// columns at a time; res (shared, may be out itself) may be null. No
// segment may read out. Ends with the warp's writes visible to its lanes.
template <bool LEAKY, bool RES = false, class... S>
__device__ __forceinline__ void dense_to(float* out, const float* __restrict__ W,
                                         const float* __restrict__ b, int n_out, const float* res,
                                         S... segs) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < n_out; c0 += 64) {
    float r[2] = {0.f, 0.f}, z[2];
    if (RES) {
      r[0] = c0 + lane < n_out ? res[c0 + lane] : 0.f;
      r[1] = c0 + 32 + lane < n_out ? res[c0 + 32 + lane] : 0.f;
    }
    dense_cols<LEAKY, RES>(z, W, b, n_out, c0, r, segs...);
    if (c0 + lane < n_out) out[c0 + lane] = z[0];
    if (c0 + 32 + lane < n_out) out[c0 + 32 + lane] = z[1];
  }
  __syncwarp();
}

// acc += A·W on the tensor cores at fp32 accuracy: A given as KS C fragments
// (k-step kk is the n-tile kk of the product before; its inputs 2t, 2t + 1
// sit at the mma's k positions t, t + 4), W as the wrapper's fragments F:
// per k-step and n-tile, a lane's (hi b0, hi b1, lo b0, lo b1). The next
// k-step's fragments are loaded while this one's products run; the two
// small products of the split go to their own sums, added at the end, so
// that 2·NTO chains of dependent mma are in flight and not NTO.
template <int KS, int NTO>
__device__ __forceinline__ void product(float (&acc)[NTO][4], const float (&a)[KS][4],
                                        const float4* __restrict__ F) {
  using namespace tf32x3;
  const int lane = threadIdx.x & 31;
  float small[NTO][4];
  float4 f[NTO];
#pragma unroll
  for (int j = 0; j < NTO; ++j) {
    f[j] = F[j * 32 + lane];
#pragma unroll
    for (int e = 0; e < 4; ++e) small[j][e] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t ah[4], al[4];
    split_fast(a[kk][0], ah[0], al[0]);
    split_fast(a[kk][2], ah[1], al[1]);
    split_fast(a[kk][1], ah[2], al[2]);
    split_fast(a[kk][3], ah[3], al[3]);
    float4 next[NTO];
#pragma unroll
    for (int j = 0; j < NTO; ++j)
      if (kk + 1 < KS) next[j] = F[((kk + 1) * NTO + j) * 32 + lane];
#pragma unroll
    for (int j = 0; j < NTO; ++j) {
      const uint32_t bh[2] = {__float_as_uint(f[j].x), __float_as_uint(f[j].y)};
      const uint32_t bl[2] = {__float_as_uint(f[j].z), __float_as_uint(f[j].w)};
      mma(small[j], al, bh);
      mma(acc[j], ah, bh);
      mma(small[j], ah, bl);
    }
#pragma unroll
    for (int j = 0; j < NTO; ++j)
      if (kk + 1 < KS) f[j] = next[j];
  }
#pragma unroll
  for (int j = 0; j < NTO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += small[j][e];
}

// acc[j][e] = the bias (global, by column) for every element.
template <int NT>
__device__ __forceinline__ void set_bias(float (&acc)[NT][4], const float* __restrict__ b) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 v = *reinterpret_cast<const float2*>(b + 8 * j + 2 * tq);
    acc[j][0] = acc[j][2] = v.x;
    acc[j][1] = acc[j][3] = v.y;
  }
}

// The lane-held vector's element at each of the thread's columns.
template <int NT>
__device__ __forceinline__ void at_columns(float (&out)[NT][2], const LaneVec& v) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      out[j][e] = __shfl_sync(FULL, 8 * j < 32 ? v.v[0] : v.v[1], (8 * j + 2 * tq + e) & 31);
}

// ---- jets past 256 slots: a cluster of row blocks

namespace cg = cooperative_groups;

constexpr int MAX_BLOCK_SLOTS = 256;  // a block's slots, at most: 16 warps

// The row blocks of a jet: RB = 1 (a plain launch, the jet's every slot in
// one block: the kernels' code at N ≤ 256) or 2 (a cluster of two blocks, N =
// 257 … 512), this block's cluster rank, and the jet's first slot that it
// takes. Both blocks have the same warps; block r takes the slots
// r·16·nwarps … + 16·nwarps − 1.
template <int RB>
struct RowBlocks {
  int rank, row0;
};

__host__ __device__ inline int row_blocks_for(int N) { return N > MAX_BLOCK_SLOTS ? 2 : 1; }

// Threads a block: one warp per 16 of the block's slots.
__host__ __device__ inline int block_threads(int N) {
  const int per_block = 16 * row_blocks_for(N);
  return 32 * ((N + per_block - 1) / per_block);
}

template <int RB>
__device__ __forceinline__ RowBlocks<RB> row_blocks() {
  RowBlocks<RB> r{0, 0};
  if constexpr (RB > 1) {
    r.rank = (int)cg::this_cluster().block_rank();
    r.row0 = r.rank * 16 * (int)(blockDim.x >> 5);
  }
  return r;
}

// The cluster barrier in its two halves: `arrive` releases this thread's
// writes (shared memory included), `wait` returns once every thread of the
// cluster has arrived, and acquires theirs. Every thread alternates them.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// A cluster's pools keep one barrier phase open between them: each block
// arrives when it has read its peer's partial sums, and waits before it
// writes the next pool's, so that no pool overwrites what a peer still
// reads. The kernel opens the first phase (`rows_begin`) and closes the last
// before it exits (`rows_end`), when no peer reads its shared memory any
// more. No-ops at one row block.
template <int RB>
__device__ __forceinline__ void rows_begin(const RowBlocks<RB>&) {
  if constexpr (RB > 1) cluster_arrive();
}
template <int RB>
__device__ __forceinline__ void rows_end(const RowBlocks<RB>&) {
  if constexpr (RB > 1) cluster_wait();
}

// Column sums over the jet's rows of h (C fragments: an 8-column n-tile of a
// 16-row product, e = 0, 1 row g at columns 2t, 2t + 1, e = 2, 3 row g + 8;
// already times the mask): every warp gets them lane-held, in warp order, and
// with MASK also Σ mask from mrows (the thread's rows' mask, given by one lane
// of each quad). One barrier; `red` is this pool's buffer of nwarps × (H + 1).
// In a cluster of row blocks (`rb`) the barrier is the cluster's and the sums
// run over both blocks' warps, row block 0's first.
struct Pooled {
  LaneVec s;
  float msum;
};

template <int H, bool MASK, int RB>
__device__ __forceinline__ Pooled pool(const float (&h)[H / 8][4], float mrows, float* red,
                                       const RowBlocks<RB>& rb) {
  constexpr int NT = H / 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  float* mine = red + warp * (H + 1);
  if constexpr (RB > 1) cluster_wait();  // the peer has read what this pool overwrites
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = h[j][e] + h[j][e + 2];
      s += __shfl_xor_sync(FULL, s, 4);
      s += __shfl_xor_sync(FULL, s, 8);
      s += __shfl_xor_sync(FULL, s, 16);
      if (g == 0) mine[8 * j + 2 * tq + e] = s;
    }
  if (MASK) {
    float s = mrows;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
    if (lane == 0) mine[H] = s;
  }
  Pooled out;
  if constexpr (RB == 1) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = lane + 32 * q;
      float s = 0.f;
      if (c < H)
        for (int w = 0; w < nwarps; ++w) s += red[w * (H + 1) + c];
      out.s.v[q] = s;
    }
    out.msum = 0.f;
    if (MASK)
      for (int w = 0; w < nwarps; ++w) out.msum += red[w * (H + 1) + H];
    return out;
  } else {
    cluster_arrive();
    cluster_wait();  // every block's partial sums
    const float* part[2];
    for (int r = 0; r < 2; ++r)
      part[r] = r == rb.rank ? red : cg::this_cluster().map_shared_rank(red, r);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int c = lane + 32 * q;
      float s = 0.f;
      if (c < H)
        for (int r = 0; r < 2; ++r)
          for (int w = 0; w < nwarps; ++w) s += part[r][w * (H + 1) + c];
      out.s.v[q] = s;
    }
    out.msum = 0.f;
    if (MASK)
      for (int r = 0; r < 2; ++r)
        for (int w = 0; w < nwarps; ++w) out.msum += part[r][w * (H + 1) + H];
    cluster_arrive();  // this block has read its peer's partial sums
    return out;
  }
}

__device__ __forceinline__ LaneVec lane_load(const float* p, int n) {
  const int lane = threadIdx.x & 31;
  LaneVec v;
  v.v[0] = lane < n ? p[lane] : 0.f;
  v.v[1] = lane + 32 < n ? p[32 + lane] : 0.f;
  return v;
}

__device__ __forceinline__ void lane_store(float* p, const LaneVec& v, int n) {
  const int lane = threadIdx.x & 31;
  if (lane < n) p[lane] = v.v[0];
  if (lane + 32 < n) p[32 + lane] = v.v[1];
}

// The buffer is staged into shared memory, once a block, when it takes at most
// this many bytes (config-berlin's, hidden 16, takes ≈ 35 KB); a larger one is
// read through L1.
constexpr size_t MAX_STAGED_BYTES = 64 * 1024;

// Registers a thread may take so that several jets' blocks share an SM: the
// kernel is a chain of dependent steps a jet (products, pools, the MLP's
// sums), and other blocks hide it. Jets of up to 128 slots take 256 threads.
template <int H, int THREADS_MAX>
constexpr int min_blocks() { return THREADS_MAX > 256 ? 1 : H == 16 ? 4 : H == 32 ? 2 : 1; }

// The cluster launch attribute of `rb` row blocks.
inline cudaLaunchAttribute cluster_of(int rb) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = rb;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

// Blocks of `kernel` resident on the card at once (SMs × blocks an SM at
// `threads` and `smem`; at two row blocks a jet, twice the clusters of two
// that the card holds, cudaOccupancyMaxActiveClusters), the size of a
// persistent grid. Asked of the runtime once a (device, kernel, threads,
// shared memory, row blocks), not at each launch: a request of 1024 jets is
// bound by the host.
inline cudaError_t resident_blocks(const void* kernel, int threads, size_t smem, int* blocks,
                                   int rb = 1) {
  struct Config {
    int dev = -1, threads = 0;
    const void* kernel = nullptr;
    size_t smem = 0;
    int rb = 0, blocks = 0;
  };
  static thread_local Config cache[8];
  static thread_local int next = 0;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (const Config& c : cache)
    if (c.dev == dev && c.threads == threads && c.kernel == kernel && c.smem == smem && c.rb == rb) {
      *blocks = c.blocks;
      return cudaSuccess;
    }
  int count;
  if (rb == 1) {
    int sms, per_sm;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    count = sms * per_sm;
  } else {
    cudaLaunchAttribute attr = cluster_of(rb);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(rb);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    count = clusters * rb;
  }
  cache[next] = Config{dev, threads, kernel, smem, rb, count};
  next = (next + 1) % 8;
  *blocks = count;
  return cudaSuccess;
}

// kernel<<<grid, threads, smem, stream>>>(args…), as clusters of `rb` row
// blocks when rb > 1 (grid a multiple of rb).
template <class... Params, class... Args>
cudaError_t launch_rows(void (*kernel)(Params...), int grid, int threads, size_t smem, int rb,
                        cudaStream_t stream, Args... args) {
  if (rb == 1) {
    kernel<<<grid, threads, smem, stream>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr = cluster_of(rb);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace narrow
}  // namespace mmp
