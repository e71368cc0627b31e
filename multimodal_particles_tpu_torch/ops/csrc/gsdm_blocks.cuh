// The (ResnetBlock, AttnBlock) stack that the survival head (survival_head.cu)
// and the gsdm stack (gsdm_stack.cu) share, as the JAX kernels share
// `_group_norm`, `_attention` and `_mm`
// (multimodal_particles_tpu/ops/gsdm_stack_pallas.py:31-38 imports them from
// ops/survival_pallas.py).
//
// A block is ResnetBlock: GroupNorm → swish → Dense → + time row → GroupNorm →
// swish → Dense → + x; AttnBlock: GroupNorm → q, k, v → per-head
// softmax(q·kᵀ/√d)·v over all N slots → proj_out → + x. Channel width C = 128,
// N ≤ 128 slots (a jet of up to 256 takes two row blocks, below), float32
// values. GroupNorm (32 groups of 4 channels, biased
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
//
// Wider stacks (transformer width 256, 384, 512: CL = width / 128 = 2 … 4).
// A jet no longer fits one block: at width 128 the three tiles, the ring and
// the vectors already take 224.5 of the 227 KB a block may have. So a jet
// becomes a thread-block cluster of CL blocks on CL SMs of one GPC, block
// `rank` owning channels 128·rank … + 127 of all N rows of every tile: each
// block's plan is the one above, byte for byte, and its products are the
// same m64n128k8 tiles, CL times as deep.
//   * A product's A operand (all 128·CL input channels) is read from the
//     peer blocks' shared memory (distributed shared memory, through the
//     cluster's generic addresses); each block streams its own 128 output
//     columns of every weight (the wrapper lays the CL column slices one
//     after the other) and writes its own 128 columns.
//   * GroupNorm's 32 groups (4·CL channels each; at 384 group 10 is
//     channels 120–131, across two blocks): each block sums its own
//     channels, and each group's sums are reduced across the cluster; every
//     block keeps the per-channel rstd·scale and per-group means of all
//     channels, and reads the biases from device memory.
//   * Attention: each block computes the heads that hold any of its
//     channels, and P·v only for its own channels. A head that lies across
//     two blocks (a width that does not divide 128: 96, or 3, whose head 42
//     is channels 126–128 at width 384) reads its other channels of q and k
//     from the peer; its output goes to the block's second scratch tile and
//     back into its own columns once every block has attended.
//   * The cluster synchronises (barrier.cluster) wherever a block is about
//     to overwrite a tile that its peers may still read, and wherever it
//     reads what its peers wrote; a cluster is resident as a whole, so the
//     barrier cannot deadlock.
//   What bounds it: a jet's products grow as CL² (CL blocks, each product
//   CL times as deep), its attention as CL, its bytes hardly at all, so the
//   operations bound it as at width 128; besides, a block reads (CL − 1)/CL
//   of its products' A operands from its peers' shared memory, at several
//   times a local read's latency, and waits at the cluster's barriers (two
//   a GroupNorm, three to five an AttnBlock).
// Heads of a width that is not a multiple of 8 (1, 2, 3, 4, …) take the
// general attention with their channels zero-padded to 8: the padded q·k
// columns add 0, the padded output columns are not stored. At width 128
// with heads of a multiple of 8 the code is the one above: every cluster
// step is `if constexpr (CL > 1)`.
//
// Jets of 129 … 256 slots (RT = 2 row blocks). The three tiles hold 128 rows,
// so such a jet's rows are cut in two: the cluster grows to CL × RT blocks
// (at most 8, the portable limit, at width 512), block (row block rb, channel
// block cb) at cluster rank rb·CL + cb owning rows 128·rb … + 127 of its 128
// channels, each running the plan above on its rows.
//   * The products are row-local: a block's A operand is its own rows, read
//     from its channel peers as before; its weight stream is its channel
//     block's, the same for both row blocks.
//   * GroupNorm's sums are reduced over the row peers as well as the channel
//     peers, in double (gn_stats_rows, through the cluster's vectors also at
//     CL = 1).
//   * Attention (attend_any for every head width): each warp's online softmax
//     runs over the keys of its own row block and on into the row peer's k
//     and v, read from the peer's shared memory, chunk by chunk as before;
//     the keys of a row block past N never enter it. v is centred on the last
//     key's value (P·v's terms of a jet's equal dead slots are then 0).
//   * Every barrier that the jet needs is the cluster's (Jet::sync), which
//     now also holds a block from overwriting k or v while a row peer may
//     still attend over them; each block parks its own residual tile.
//   * K7's products (proj_in and the six of each block) run on the CUDA
//     cores in fp32 fused multiply-adds rounded to nearest (gemm_fma: the
//     weights' fp32 rows through the ring's slots by cp.async, 16 at a time);
//     its tensor-core stream is not read. The tensor cores add each product
//     into the accumulator rounding toward zero, and on a jet of one live
//     particle among 256 that one-signed error in the live row's hidden
//     state (whose normalised values reach √N, its attention logits ~250
//     while its weights stay between 0 and 1) took K7 past its gate on the
//     scaled transdimensional flows at N = 256 on an H100: 1.51 of it
//     against a float64 evaluation at stack inputs of 139 columns (the plain
//     version 0.13), where a float64 model of the kernel's products with
//     each accumulation rounded toward zero gives 1.57, the same model with
//     every product a fused multiply-add 0.17
//     (scripts/k7_accumulation_model.py). On the CUDA cores K7 takes 45.8 ms
//     against 31.5 at B = 4096, N = 256, Din 27 (H100). K6 keeps its products
//     on the tensor cores (its checks pass).
// A jet of at most 128 slots keeps RT = 1: the code above, unchanged (every
// row-block step is `if constexpr (RT > 1)`).
#pragma once

#include <math.h>

#include <cooperative_groups.h>

#include "tf32x3.cuh"

namespace mmps {

using namespace tf32x3;
namespace cg = cooperative_groups;

constexpr int C = 128;        // channels a block owns: the transformer width at CL = 1
constexpr int MAX_CL = 4;     // blocks a jet: transformer width up to 512
constexpr int ROWS = 128;     // particle slots a block: a row block of a jet
constexpr int MAX_RT = 2;     // row blocks a jet: up to 256 slots
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
static_assert(RING >= 3, "the ring refills the slot read two k-steps before");
// A cluster's vectors (CL > 1): the block's partial sums of both passes, the
// 32 group means and rstds, the survival head's per-row partials of
// post_rate, and every channel's rstd·scale.
constexpr int VC_RED = 0, VC_RED2 = 2 * C, VC_MU = 4 * C, VC_RSTD = VC_MU + GROUPS,
              VC_POST = VC_RSTD + GROUPS, VC_RS = VC_POST + ROWS;
template <int CL, int RT = 1>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(S_VEC + (CL * RT == 1 ? V_END : VC_RS + C * CL));
}
static_assert(smem_bytes<1>() <= 232448 && smem_bytes<MAX_CL, MAX_RT>() <= 232448,
              "over a block's 227 KB of shared memory");
// A block's scratch in device memory: the parked residual tile, then the
// tile of the heads that lie across two blocks.
constexpr int SCRATCH_FLOATS = 2 * TILE;

// The jet's blocks: the cluster of CL × RT blocks, this one owning channels
// col0() … + 127 (channel block `rank`) of rows row0() … + 127 (row block
// `rrow`). At CL = RT = 1 every call is the single block's.
template <int CL, int RT = 1>
struct Jet {
  int rank;
  int rrow;
  __device__ __forceinline__ int col0() const { return CL == 1 ? 0 : C * rank; }
  __device__ __forceinline__ int row0() const { return RT == 1 ? 0 : ROWS * rrow; }
  // Every thread of the jet's blocks; a block barrier at CL = RT = 1.
  __device__ __forceinline__ void sync() const {
    if constexpr (CL * RT == 1) {
      __syncthreads();
    } else {
      cg::this_cluster().sync();
    }
  }
  // `p` in this block's shared memory → the same place in block (rb, cb)'s.
  __device__ __forceinline__ const float* at(const float* p, int rb, int cb) const {
    if constexpr (CL * RT == 1) {
      return p;
    } else {
      const int r = rb * CL + cb;
      return r == rrow * CL + rank ? p
                                   : cg::this_cluster().map_shared_rank(const_cast<float*>(p), r);
    }
  }
  // `p` in this block's shared memory → the same place in channel block r's
  // of this row block.
  __device__ __forceinline__ const float* peer(const float* p, int r) const {
    if constexpr (CL == 1 && RT == 1) {
      return p;
    } else if constexpr (RT == 1) {
      return r == rank ? p : cg::this_cluster().map_shared_rank(const_cast<float*>(p), r);
    } else {
      return at(p, rrow, r);
    }
  }
  // Row 0 of channel gc (0 … 128·CL − 1) of tile T.
  __device__ __forceinline__ const float* channel(const float* T, int gc) const {
    return peer(T, gc / C) + (gc % C);
  }
  // The same in row block rb's tile.
  __device__ __forceinline__ const float* channel_at(const float* T, int gc, int rb) const {
    if constexpr (RT == 1) {
      return channel(T, gc);
    } else {
      return at(T, rb, gc / C) + (gc % C);
    }
  }
};

// Slots of a jet of N in this block's row block: N at RT = 1.
template <int CL, int RT>
__device__ __forceinline__ int block_rows(int N, const Jet<CL, RT>& jet) {
  if constexpr (RT == 1) {
    return N;
  } else {
    return min(ROWS, N - jet.row0());
  }
}

// Offsets in floats of one block's weights from the block's start (the
// per-block entries of ops/gsdm_stack_cuda.py::block_layout); vectors only
// are read from here, the matrices from the tensor-core stream.
struct BlockLayout {
  int gn1_s, gn1_b, w_c1, b_c1, gn2_s, gn2_b, w_c2, b_c2;
  int gna_s, gna_b, wq, bq, wk, bk, wv, bv, wp, bp;
  int stride;
};

// W: the transformer width, 128·CL.
__host__ __device__ inline BlockLayout make_block_layout(int W) {
  BlockLayout L;
  int b = 0;
  L.gn1_s = b; b += W;
  L.gn1_b = b; b += W;
  L.w_c1 = b;  b += W * W;
  L.b_c1 = b;  b += W;
  L.gn2_s = b; b += W;
  L.gn2_b = b; b += W;
  L.w_c2 = b;  b += W * W;
  L.b_c2 = b;  b += W;
  L.gna_s = b; b += W;
  L.gna_b = b; b += W;
  L.wq = b;    b += W * W;
  L.bq = b;    b += W;
  L.wk = b;    b += W * W;
  L.bk = b;    b += W;
  L.wv = b;    b += W * W;
  L.bv = b;    b += W;
  L.wp = b;    b += W * W;
  L.bp = b;    b += W;
  L.stride = b;
  return L;
}

// Stages of a block in a block's stream: conv1, conv2, k, v, q, proj_out.
constexpr int BLOCK_STAGES = 6 * KSTEPS;  // × CL

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
// From a tile, column 8kt + t and 8kt + t + 4, through f(column, value). At
// CL > 1 the columns are the cluster's, k-step kt in block kt / KSTEPS's tile.
template <class F, int CL = 1, int RT = 1>
struct TileA {
  const float* T;
  F f;
  Jet<CL, RT> jet;
  __device__ __forceinline__ void operator()(int kt, float (&x)[4]) const {
    const int r0 = frag_row0(), sg = swz(r0), c = 8 * kt + (threadIdx.x & 3);
    if constexpr (CL == 1) {
      const float* row = T + r0 * LDT;
      x[0] = f(c, row[c ^ sg]);
      x[1] = f(c, row[8 * LDT + (c ^ sg)]);
      x[2] = f(c + 4, row[(c + 4) ^ sg]);
      x[3] = f(c + 4, row[8 * LDT + ((c + 4) ^ sg)]);
    } else {
      const int owner = kt / KSTEPS, lc = c - C * owner;
      const float* row = jet.peer(T, owner) + r0 * LDT;
      x[0] = f(c, row[lc ^ sg]);
      x[1] = f(c, row[8 * LDT + (lc ^ sg)]);
      x[2] = f(c + 4, row[(lc + 4) ^ sg]);
      x[3] = f(c + 4, row[8 * LDT + ((lc + 4) ^ sg)]);
    }
  }
};
struct Plain {
  __device__ __forceinline__ float operator()(int, float x) const { return x; }
};
// GroupNorm by gn_stats' vectors, then swish if SWISH. In a cluster (CL or
// RT > 1) by gn_stats_cluster's or gn_stats_rows', with the biases `bias`
// (all channels) from device memory.
template <bool SWISH, int CL = 1, int RT = 1>
struct Norm {
  const float* vec;
  const float* __restrict__ bias;
  __device__ __forceinline__ float operator()(int c, float x) const {
    float y;
    if constexpr (CL * RT == 1) {
      y = fmaf(x - vec[V_MU + c], vec[V_RED + c], vec[V_RED + C + c]);
    } else {
      y = fmaf(x - vec[VC_MU + c / (GSIZE * CL)], vec[VC_RS + c], __ldg(bias + c));
    }
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

// gn_stats at CL > 1, for the cluster's channels: each block sums its own
// channels over rows < N, each group's sums are reduced across the blocks
// (8 threads a group, each over a share of its channels), and every block
// keeps the 32 group means (VC_MU) and the rstd·scale of every channel
// (VC_RS). `scale`: all channels. Every thread of the cluster calls it; the
// two passes' partial sums alternate between VC_RED and VC_RED2, so that a
// peer still reading one pass's sums after a cluster barrier never finds the
// next call's. It ends with a block barrier.
template <int CL>
__device__ __forceinline__ void gn_stats_cluster(const float* T, const float* __restrict__ scale,
                                                 int N, float* vec, const Jet<CL>& jet) {
  constexpr int GS = GSIZE * CL;  // channels a group
  const int tid = threadIdx.x, c = tid & (C - 1), half = tid >> 7;
  const int grp = (jet.col0() + c) / GS;
  const int red_group = tid >> 3, part = tid & 7;  // the group this thread reduces, its share
  const float inv_count = __fdividef(1.f, (float)(N * GS));
  // the group's sum over the cluster of partial sums at `off`
  auto group_total = [&](int off) {
    float total = 0.f;
    for (int q = part; q < GS; q += 8) {
      const float* red = jet.channel(vec + off, red_group * GS + q);
      total += red[0] + red[C];
    }
#pragma unroll
    for (int m = 1; m < 8; m <<= 1) total += __shfl_xor_sync(0xffffffffu, total, m);
    return total;
  };
  float s = 0.f;
  for (int r = half; r < N; r += 2) s += T[tix(r, c)];
  vec[VC_RED + half * C + c] = s;
  jet.sync();  // every block's sums
  float total = group_total(VC_RED);
  if (part == 0) vec[VC_MU + red_group] = total * inv_count;
  __syncthreads();
  const float mu = vec[VC_MU + grp];
  s = 0.f;
  for (int r = half; r < N; r += 2) {
    const float dv = T[tix(r, c)] - mu;
    s = fmaf(dv, dv, s);
  }
  vec[VC_RED2 + half * C + c] = s;
  jet.sync();
  total = group_total(VC_RED2);
  if (part == 0) vec[VC_RSTD + red_group] = rsqrtf(total * inv_count + GN_EPS);
  __syncthreads();
  for (int ch = tid; ch < C * CL; ch += THREADS) vec[VC_RS + ch] = vec[VC_RSTD + ch / GS] * scale[ch];
  __syncthreads();
}

// A double in the two floats' room at red[c], red[C + c] (its high and low
// 32-bit words: squares of the seeded flow's 1e19 entries pass float's range).
__device__ __forceinline__ void put_double(float* red, int c, double x) {
  reinterpret_cast<int*>(red)[c] = __double2hiint(x);
  reinterpret_cast<int*>(red)[C + c] = __double2loint(x);
}
__device__ __forceinline__ double get_double(const float* red, int c) {
  return __hiloint2double(reinterpret_cast<const int*>(red)[c],
                          reinterpret_cast<const int*>(red)[C + c]);
}

// A block's sum of one channel over its two halves of threads, as a double
// at red[c], red[C + c] (put_double). Every thread of the block calls it with
// its half's sum; it ends with a block barrier.
__device__ __forceinline__ void block_sum_double(double s, float* red) {
  const int tid = threadIdx.x, c = tid & (C - 1);
  if (tid >= C) put_double(red, c, s);
  __syncthreads();
  if (tid < C) put_double(red, c, s + get_double(red, c));  // only this thread touches c
  __syncthreads();
}

// gn_stats for a jet of two row blocks (RT > 1, any CL): gn_stats_cluster's
// plan over the cluster's channel and row blocks, with the sums in double.
// In float a jet of up to 256 slots, most of them dead rows of one value,
// loses the group mean's low bits, and the live rows' centred values with
// them: on the seeded transdimensional flow K7 then missed its gate against
// the plain GroupNorm (a Welford mean) on jets of one live particle. Each
// block's sum of a channel is one double (block_sum_double); the means and
// rstds are rounded to float once. Nl: the block's rows, N the jet's.
template <int CL, int RT>
__device__ __forceinline__ void gn_stats_rows(const float* T, const float* __restrict__ scale,
                                              int Nl, int N, float* vec, const Jet<CL, RT>& jet) {
  constexpr int GS = GSIZE * CL;  // channels a group
  const int tid = threadIdx.x, c = tid & (C - 1), half = tid >> 7;
  const int grp = (jet.col0() + c) / GS;
  const int red_group = tid >> 3, part = tid & 7;  // the group this thread reduces, its share
  const double count = (double)N * GS;
  // the group's sum over the cluster's blocks of the sums at `off`
  auto group_total = [&](int off) {
    double total = 0.0;
    for (int q = part; q < GS; q += 8) {
#pragma unroll
      for (int rb = 0; rb < RT; ++rb)
        total += get_double(jet.channel_at(vec + off, red_group * GS + q, rb), 0);
    }
#pragma unroll
    for (int m = 1; m < 8; m <<= 1) total += __shfl_xor_sync(0xffffffffu, total, m);
    return total;
  };
  double s = 0.0;
  for (int r = half; r < Nl; r += 2) s += (double)T[tix(r, c)];
  block_sum_double(s, vec + VC_RED);
  jet.sync();  // every block's sums
  const double total = group_total(VC_RED);
  if (part == 0) vec[VC_MU + red_group] = (float)(total / count);
  __syncthreads();
  const float mu = vec[VC_MU + grp];
  s = 0.0;
  for (int r = half; r < Nl; r += 2) {
    const double dv = (double)(T[tix(r, c)] - mu);
    s = fma(dv, dv, s);
  }
  block_sum_double(s, vec + VC_RED2);
  jet.sync();
  const double var = group_total(VC_RED2) / count;
  if (part == 0) vec[VC_RSTD + red_group] = (float)(1.0 / sqrt(var + (double)GN_EPS));
  __syncthreads();
  for (int ch = tid; ch < C * CL; ch += THREADS) vec[VC_RS + ch] = vec[VC_RSTD + ch / GS] * scale[ch];
  __syncthreads();
}

// GroupNorm's statistics for the Norm of the jet's tile T: `scale`, `bias`
// the cluster's (all channels); Nl the block's rows, N the jet's.
template <int CL, int RT>
__device__ __forceinline__ void group_stats(const float* T, const float* __restrict__ scale,
                                            const float* __restrict__ bias, int Nl, int N,
                                            float* vec, const Jet<CL, RT>& jet) {
  if constexpr (CL * RT == 1) {
    gn_stats(T, scale, bias, N, vec);
  } else if constexpr (RT == 1) {
    gn_stats_cluster<CL>(T, scale, N, vec, jet);
  } else {
    gn_stats_rows<CL, RT>(T, scale, Nl, N, vec, jet);
  }
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

// acc += A·W on the CUDA cores: fp32 fused multiply-adds in k order, each
// rounded to nearest (no one-signed error, unlike the tensor cores'
// accumulation). a_at(r, k): A's element (row r, column k); W (K, 128) the
// block's output columns, rows of ld floats in device memory, brought through
// the ring's slots (unused by the caller) 16 rows at a time by cp.async, two
// chunks ahead. The thread's elements are gemm_tc's (each_pair's). Every
// thread calls it; the warps whose rows all lie at or past the block's N
// only fetch (`live`). It begins and ends with a barrier.
constexpr int FMA_ROWS = 16;  // W rows a chunk: one slot
static_assert(FMA_ROWS * C <= STAGE && RING == 3, "a chunk fills one of three slots");
template <class AF>
__device__ __forceinline__ void gemm_fma(float (&acc)[64], const AF& a_at,
                                         const float* __restrict__ Wg, int ld, int K, float* slots,
                                         bool live) {
  const int nch = (K + FMA_ROWS - 1) / FMA_ROWS;
  const int r0 = frag_row0(), c0 = 2 * (threadIdx.x & 3);
  auto fetch = [&](int ch) {  // chunk ch into slot ch % RING, committed as a group
    if (ch < nch) {
      float* dst = slots + (ch % RING) * STAGE;
      for (int i = threadIdx.x; i < FMA_ROWS * C / 4; i += THREADS) {
        const int r = i / (C / 4), c4 = 4 * (i - r * (C / 4)), k = ch * FMA_ROWS + r;
        if (k < K) cp_async16(dst + r * C + c4, Wg + (size_t)k * ld + c4);
      }
    }
    cp_async_commit();
  };
  __syncthreads();  // the slots are free
  fetch(0);
  fetch(1);
#pragma unroll 1
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<1>();
    __syncthreads();  // chunk ch has landed for every thread; every read of chunk ch − 1 is done
    fetch(ch + 2);    // into the slot of chunk ch − 1
    if (live) {
      const float* ws = slots + (ch % RING) * STAGE + c0;
      const int kn = min(FMA_ROWS, K - ch * FMA_ROWS);
#pragma unroll 2
      for (int kk = 0; kk < kn; ++kk) {
        const int k = ch * FMA_ROWS + kk;
        const float x0 = a_at(r0, k), x1 = a_at(r0 + 8, k);
        const float* wr = ws + kk * C;
#pragma unroll
        for (int j = 0; j < KSTEPS; ++j) {
          const float2 w = *reinterpret_cast<const float2*>(wr + 8 * j);
          acc[4 * j] = fmaf(x0, w.x, acc[4 * j]);
          acc[4 * j + 1] = fmaf(x0, w.y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(x1, w.x, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(x1, w.y, acc[4 * j + 3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every read of the slots and of A is done
}

// A's element (row r, column k) of a TileA operand: its function of the
// tile's value, from the channel block that owns column k.
template <class F, int CL, int RT>
__device__ __forceinline__ float tile_at(const TileA<F, CL, RT>& A, int r, int k) {
  if constexpr (CL == 1) {
    return A.f(k, A.T[tix(r, k)]);
  } else {
    return A.f(k, A.jet.peer(A.T, k / C)[tix(r, k % C)]);
  }
}

// proj_in's product acc += x·W of a (N, Din) input x (rows of Din floats),
// W's ⌈Din/8⌉ stages next in the ring (zero rows past Din): the input's
// columns go through the work tile `a` in passes of up to 128 (zero past N
// and Din), each pass accumulating into the same registers. With FMA on the
// CUDA cores (gemm_fma; `w_in`: W's rows of ld floats from the block's
// column 0), the ring not read. Every thread of the block calls it; it ends
// with a barrier (`a` is free).
template <bool FMA = false>
__device__ __forceinline__ void project_in(float (&acc)[64], const float* __restrict__ x, int N,
                                           int Din, float* a, Ring& ring, bool live,
                                           const float* __restrict__ w_in = nullptr, int ld = 0) {
  const int Dp = (Din + STAGE_ROWS - 1) / STAGE_ROWS * STAGE_ROWS;
  for (int c0 = 0; c0 < Dp; c0 += C) {
    const int width = Dp - c0 < C ? Dp - c0 : C;
    for (int idx = threadIdx.x; idx < ROWS * width; idx += THREADS) {
      const int r = idx / width, c = idx - r * width;
      a[tix(r, c)] = (r < N && c0 + c < Din) ? x[r * Din + c0 + c] : 0.f;
    }
    __syncthreads();
    if constexpr (FMA) {
      gemm_fma(acc, [&](int r, int k) { return a[tix(r, k)]; }, w_in + (size_t)c0 * ld, ld,
               width, ring.slots, live);
    } else {
      // ends with a barrier: `a` is free for the next pass
      gemm_tc(acc, TileA<Plain>{a, {}}, width / STAGE_ROWS, ring, live);
    }
  }
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

// attend for heads of any width hd ≤ 8·NB (1 … 128) and in a cluster: the
// warp's 16 rows of Q (of the block's N) attend over the jet's n_keys keys,
// head by head over the heads that hold any of this block's channels; each head's
// output goes to this block's own channels of it. A head's channels are
// taken 8 at a time, those past hd as 0 (they add 0 to q·kᵀ, and their output
// is not stored). A head that lies across two blocks reads its peer's
// channels of q and k, and its output goes to `spill` (a tile in device
// memory, same layout), since the peer may still read this block's q; the
// caller copies it back after a cluster barrier (`unspill`). At RT > 1 the
// keys of row block rb are the rows of block (rb, ·)'s K and V, taken in row
// block order by one online softmax, and v is centred on the last key's
// value: o = v_last + Σ p (v − v_last) / Σ p. A jet's dead slots share one
// value, and on a jet of one live particle among 256 their 255 equal terms
// cancel the live one's in float32 sums (K7 then missed its gate against the
// plain version on the seeded transdimensional flow); centred, they are 0.
// Only the warp's own rows are written.
template <int CL, int RT, int NB>
__device__ __forceinline__ void attend_any(float* Q, const float* K, const float* V, int N,
                                           int n_keys, int hd, const Jet<CL, RT>& jet,
                                           float* spill) {
  constexpr int KC = NB == 16 ? 32 : 64;  // keys a softmax chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = 64 * (warp >> 2) + 16 * (warp & 3);
  if (row0 >= N) return;
  const int own = jet.col0(), hdp = (hd + 7) & ~7;
  const int qr = (row0 + g) * LDT;  // the thread's rows g and g + 8 of Q
  for (int head = own / hd; head * hd < own + C; ++head) {
    const int hc = head * hd;
    const int lo = max(hc, own) - own, hi = min(hc + hd, own + C) - own;  // own columns of the head
    const bool across = hc < own || hc + hd > own + C;
    float o[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.f, 0.f};
    // RT > 1: the last key's v (row n_keys − 1) at this block's columns, and
    // at the thread's B-fragment columns lo + 8n + g (0 past hi)
    const float* v_last = V;
    float v_ref[NB];
    if constexpr (RT > 1) {
      v_last = jet.at(V, (n_keys - 1) / ROWS, jet.rank) + ((n_keys - 1) % ROWS) * LDT;
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const int c = lo + 8 * n + g;
        v_ref[n] = lo + 8 * n < hi && c < hi ? v_last[c] : 0.f;
      }
    }
#pragma unroll 1
    for (int rb = 0; rb < RT; ++rb) {
      const int nk = RT == 1 ? n_keys : min(ROWS, n_keys - ROWS * rb);  // keys of row block rb
      const int kpad = (nk + 7) & ~7;
      const float* Vb = RT == 1 ? V : jet.at(V, rb, jet.rank);
      for (int kc = 0; kc < kpad; kc += KC) {
        const int nt = min(KC, kpad - kc) / 8;
        float s[KC / 8][4];
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        for (int kk = 0; kk < hdp; kk += 8) {
          const int e0 = kk + t, e1 = kk + t + 4;  // the head's channels of this k-step
          const bool in0 = e0 < hd, in1 = e1 < hd;
          const float* q0 = jet.channel(Q, hc + min(e0, hd - 1));
          const float* q1 = jet.channel(Q, hc + min(e1, hd - 1));
          const float* k0 = jet.channel_at(K, hc + min(e0, hd - 1), rb);
          const float* k1 = jet.channel_at(K, hc + min(e1, hd - 1), rb);
          uint32_t ah[4], al[4];
          split_fast(in0 ? q0[qr] : 0.f, ah[0], al[0]);
          split_fast(in0 ? q0[qr + 8 * LDT] : 0.f, ah[1], al[1]);
          split_fast(in1 ? q1[qr] : 0.f, ah[2], al[2]);
          split_fast(in1 ? q1[qr + 8 * LDT] : 0.f, ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < KC / 8; ++j) {
            if (j < nt) {
              const int kr = (kc + 8 * j + g) * LDT;
              uint32_t bh[2], bl[2];
              split_fast(in0 ? k0[kr] : 0.f, bh[0], bl[0]);
              split_fast(in1 ? k1[kr] : 0.f, bh[1], bl[1]);
              mma3_split(s[j], ah, al, bh, bl);
            }
          }
        }
        float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) {
          if (j < nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = kc + 8 * j + 2 * t + (e & 1);
              const float x = key < nk ? s[j][e] : -INFINITY;
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
          const float m = fmaxf(row_max[h], cmax[h]);
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
        // O += P·v over the head's own columns lo … hi − 1, 8 a block
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) {
          if (j < nt) {
            uint32_t ah[4], al[4];
            split(s[j][0], ah[0], al[0]);
            split(s[j][2], ah[1], al[1]);
            split(s[j][1], ah[2], al[2]);
            split(s[j][3], ah[3], al[3]);
            const float* v0 = Vb + (kc + 8 * j + 2 * t) * LDT;
#pragma unroll
            for (int n = 0; n < NB; ++n) {
              if (lo + 8 * n < hi) {
                const int c = lo + 8 * n + g;
                uint32_t bh[2], bl[2];
                if constexpr (RT == 1) {
                  split_fast(c < hi ? v0[c] : 0.f, bh[0], bl[0]);
                  split_fast(c < hi ? v0[LDT + c] : 0.f, bh[1], bl[1]);
                } else {
                  split_fast(c < hi ? v0[c] - v_ref[n] : 0.f, bh[0], bl[0]);
                  split_fast(c < hi ? v0[LDT + c] - v_ref[n] : 0.f, bh[1], bl[1]);
                }
                mma3_split(o[n], ah, al, bh, bl);
              }
            }
          }
        }
      }
    }
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 1);
      row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 2);
      inv[h] = __fdividef(1.f, row_sum[h]);
    }
    __syncwarp();  // every lane has read the head's q
    float* dst = across ? spill : Q;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = lo + 8 * n + 2 * t + e;
        if (c < hi) {
          if constexpr (RT == 1) {
            dst[qr + c] = o[n][e] * inv[0];
            dst[qr + 8 * LDT + c] = o[n][2 + e] * inv[1];
          } else {
            dst[qr + c] = fmaf(o[n][e], inv[0], v_last[c]);
            dst[qr + 8 * LDT + c] = fmaf(o[n][2 + e], inv[1], v_last[c]);
          }
        }
      }
    }
  }
  __syncwarp();
}

// After attend_any at CL > 1, once every block of the cluster has attended:
// the outputs of the heads that lie across two blocks, from `spill` into
// this block's columns of Q, rows < N. Every thread of the block calls it.
template <int CL, int RT>
__device__ __forceinline__ void unspill(float* Q, const float* spill, int N, int hd,
                                        const Jet<CL, RT>& jet) {
  const int own = jet.col0();
  const int first = own % hd ? hd - own % hd : 0;  // own columns of a head begun in the block before
  const int last = (own + C) % hd;                 // own columns of a head that goes on in the next
  for (int idx = threadIdx.x; idx < N * C; idx += THREADS) {
    const int r = idx / C, c = idx - r * C;
    if (c < first || c >= C - last) Q[r * LDT + c] = spill[r * LDT + c];
  }
  __syncthreads();
}

// n_blocks × (ResnetBlock, AttnBlock) on the residual stream h, the first
// tile of `smem` (rows from N on 0); the other two tiles are work space.
// `wblocks` points at the first block's weights (vectors read from there, of
// the cluster's 128·CL channels), `tp` at the jet's time row of the first
// block at this block's channels, the next block's tp_block_stride floats
// on; the ring's next stages are the blocks'; `park` is the block's scratch
// in device memory (SCRATCH_FLOATS). Every thread of the cluster calls it.
// HD: channels a head, for `attend`; HD = 0: heads of `hd` channels through
// attend_any<CL, RT, NB> (always in a cluster). N: the jet's slots, of which
// the block holds its row block's (block_rows). In a cluster it ends with a
// cluster barrier. FMA: every product on the CUDA cores (gemm_fma; K7 at
// RT > 1, the design note), the ring not read.
template <int CL, int RT, int HD, int NB, bool FMA = false>
__device__ __forceinline__ void gsdm_blocks(const float* __restrict__ wblocks,
                                            const BlockLayout& L, float* smem,
                                            const float* __restrict__ tp, size_t tp_block_stride,
                                            Ring& ring, float* park, int N, int n_blocks, int hd,
                                            float q_scale, const Jet<CL, RT>& jet) {
  static_assert(CL * RT == 1 || HD == 0, "a cluster attends through attend_any");
  float* h = smem;             // the residual stream
  float* a = smem + TILE;      // the ResnetBlock's hidden, then k
  float* v = smem + 2 * TILE;  // v
  float* vec = smem + S_VEC;
  const int Nl = block_rows(N, jet);  // the block's rows
  const bool live = 64 * (threadIdx.x >> 7) < Nl;  // the warpgroup's rows reach below Nl
  const int own = jet.col0();
  constexpr int KW = KSTEPS * CL;  // k-steps of a block's product
  float acc[64];
  // acc += A·W for the block's output columns of W (in, out) at `wm`
  auto product = [&](const auto& A, const float* __restrict__ wm) {
    if constexpr (FMA) {
      gemm_fma(acc, [&](int r, int k) { return tile_at(A, r, k); }, wm + own, C * CL, C * CL,
               ring.slots, live);
    } else {
      gemm_tc(acc, A, KW, ring, live);
    }
  };

  for (int blk = 0; blk < n_blocks; ++blk) {
    const float* wb = wblocks + (size_t)blk * L.stride;
    const float* wo = wb + own;  // this block's channels of the vectors
    const float* tpb = tp + blk * tp_block_stride;

    // ---- ResnetBlock
    group_stats(h, wb + L.gn1_s, wb + L.gn1_b, Nl, N, vec, jet);
    zero(acc);
    product(TileA<Norm<true, CL, RT>, CL, RT>{h, {vec, wb + L.gn1_b}, jet}, wb + L.w_c1);
    each_pair(acc, [&](int r, int c, int at, float v0, float v1) {
      const float2 b = ldg2(wo + L.b_c1 + c), tr = ldg2(tpb + c);
      const bool real = r < Nl;
      store2(a, at, real ? (v0 + b.x) + tr.x : 0.f, real ? (v1 + b.y) + tr.y : 0.f);
    });
    __syncthreads();
    group_stats(a, wb + L.gn2_s, wb + L.gn2_b, Nl, N, vec, jet);
    zero(acc);
    product(TileA<Norm<true, CL, RT>, CL, RT>{a, {vec, wb + L.gn2_b}, jet}, wb + L.w_c2);
    each_pair(acc, [&](int r, int c, int at, float v0, float v1) {
      if (r < Nl) {
        const float2 b = ldg2(wo + L.b_c2 + c);
        float2* p = reinterpret_cast<float2*>(h + at);
        const float2 x = *p;
        *p = make_float2(x.x + (v0 + b.x), x.y + (v1 + b.y));
      }
    });
    __syncthreads();

    // ---- AttnBlock: h parked, k into `a`, v into `v`, q into h's tile
    group_stats(h, wb + L.gna_s, wb + L.gna_b, Nl, N, vec, jet);
    for (int idx = threadIdx.x; idx < TILE / 4; idx += THREADS)
      reinterpret_cast<float4*>(park)[idx] = reinterpret_cast<const float4*>(h)[idx];
    const TileA<Norm<false, CL, RT>, CL, RT> hn{h, {vec, wb + L.gna_b}, jet};
    zero(acc);
    product(hn, wb + L.wk);
    each_pair(acc, [&](int r, int c, int at, float v0, float v1) {
      const float2 b = ldg2(wo + L.bk + c);
      const bool real = r < Nl;
      store2(a, at, real ? v0 + b.x : 0.f, real ? v1 + b.y : 0.f);
    });
    zero(acc);
    product(hn, wb + L.wv);
    each_pair(acc, [&](int r, int c, int at, float v0, float v1) {
      const float2 b = ldg2(wo + L.bv + c);
      const bool real = r < Nl;
      store2(v, at, real ? v0 + b.x : 0.f, real ? v1 + b.y : 0.f);
    });
    zero(acc);
    product(hn, wb + L.wq);  // its barriers end h's reads
    if constexpr (CL > 1) jet.sync();  // and the peers'
    each_pair(acc, [&](int r, int c, int at, float v0, float v1) {
      const float2 b = ldg2(wo + L.bq + c);
      store2(h, at, (v0 + b.x) * q_scale, (v1 + b.y) * q_scale);
    });
    jet.sync();  // k, v and q stored
    if constexpr (HD > 0) {
      attend<HD>(h, a, v, N);
    } else {
      float* spill = park + TILE;
      attend_any<CL, RT, NB>(h, a, v, Nl, N, hd, jet, spill);
      if constexpr (CL > 1) {
        if (C % hd) {  // heads across two blocks
          jet.sync();
          unspill(h, spill, Nl, hd, jet);
        }
        jet.sync();  // every block's output is in place: proj_out's A
      }
    }
    zero(acc);
    // the warps' A fragments are the rows they attended for: no barrier before (CL = 1)
    product(TileA<Plain, CL, RT>{h, {}, jet}, wb + L.wp);
    if constexpr (CL > 1) jet.sync();  // the peers have read h
    each_pair(acc, [&](int r, int c, int at, float v0, float v1) {
      float2 y = make_float2(0.f, 0.f);
      if (r < Nl) {
        const float2 b = ldg2(wo + L.bp + c), x = *reinterpret_cast<const float2*>(park + at);
        y = make_float2(x.x + (v0 + b.x), x.y + (v1 + b.y));
      }
      store2(h, at, y.x, y.y);
    });
    jet.sync();
  }
}

// Heads of hd channels at CL > 1, or of a width not a multiple of 8: the NB
// of attend_any (channel blocks of 8, a power of two ≥ ⌈hd / 8⌉).
__host__ __device__ constexpr int head_blocks(int hd) {
  return hd <= 8 ? 1 : hd <= 16 ? 2 : hd <= 32 ? 4 : hd <= 64 ? 8 : 16;
}

// Launch a jet kernel: at CL = 1 `grid` blocks that walk the jets; at CL > 1
// clusters of CL blocks (here the blocks a jet: channel blocks × row blocks),
// as many as are resident at once (and at most grid / CL, B), that walk the
// jets.
template <int CL, class... Params, class... Args>
cudaError_t launch_jets(void (*kernel)(Params...), int grid, int B, size_t smem, cudaStream_t s,
                        Args... args) {
  if constexpr (CL == 1) {
    kernel<<<grid, THREADS, smem, s>>>(args...);
    return cudaGetLastError();
  } else {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int resident = 0;
    cudaError_t err =
        cudaOccupancyMaxActiveClusters(&resident, reinterpret_cast<const void*>(kernel), &cfg);
    if (err != cudaSuccess) return err;
    if (resident < 1) return cudaErrorInvalidConfiguration;
    int clusters = grid / CL < resident ? grid / CL : resident;
    clusters = clusters < B ? clusters : B;
    if (clusters < 1) return cudaErrorInvalidValue;
    cfg.gridDim = dim3(clusters * CL);
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
}

}  // namespace mmps
