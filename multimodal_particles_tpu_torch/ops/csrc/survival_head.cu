// K6: the absorbing family's survival head, one launch for the whole head.
//
// Replaces the TPU kernel multimodal_particles_tpu/ops/survival_pallas.py
// (`survival_head_pallas`, body `_survival_kernel`): proj_in of [trunk hidden
// ‖ one-hot(mask)] → n_blocks × (ResnetBlock, AttnBlock) → pre_rate Dense →
// post_rate (C → 1). The blocks, their GroupNorm and attention, the shared
// memory plan and the design are gsdm_blocks.cuh's, shared with the gsdm
// stack (gsdm_stack.cu); this file adds the head's first product, with the
// mask's one-hot as two weight rows, and its two rate projections.
//
// What bounds it. A jet of N = 109 slots costs 0.22 M (proj_in) + per block
// 6 products of (N,128)·(128,128) and two heads of N·N·64 scores and values
// + 1.8 M (pre_rate): about 29.5 M multiply-adds at 2 blocks, against 7.4 KB
// of input and output. The bound is fp32 arithmetic on the CUDA cores. As
// separate PyTorch operators the head is some 60 launches a call that each
// move a (B·N, 128) tensor through device memory. At N ≤ 112 (the reference
// N = 109) a product leaves out the tile's last 16 rows.
//
// C interface (bound with ctypes by ops/survival_cuda.py): returns the
// cudaError_t of the launch, 0 on success.

#include "gsdm_blocks.cuh"

namespace mmps {

// Offsets in floats into the packed buffer (ops/survival_cuda.py::head_layout);
// matrices are (in, out) row-major.
struct HeadLayout {
  int w_in, w_oh0, w_oh1, b_in;
  int blocks;
  BlockLayout block;
  int w_pre, b_pre, w_post, b_post, total;
};

__host__ __device__ inline HeadLayout make_head_layout(int Dh, int n_blocks) {
  HeadLayout L;
  int o = 0;
  L.w_in = o;  o += Dh * C;
  L.w_oh0 = o; o += C;
  L.w_oh1 = o; o += C;
  L.b_in = o;  o += C;
  L.blocks = o;
  L.block = make_block_layout();
  o += n_blocks * L.block.stride;
  L.w_pre = o;  o += C * C;
  L.b_pre = o;  o += C;
  L.w_post = o; o += C;
  L.b_post = o; o += 1;
  L.total = o;
  return L;
}

// The whole head for one jet. Every thread of the block calls it. NI: the
// products cover the tile's first 16·NI rows (N ≤ 16·NI).
template <int NI>
__device__ void survival_jet(const float* __restrict__ w, const HeadLayout& L, float* smem,
                             const float* __restrict__ tp, size_t tp_block_stride,
                             const float* __restrict__ last, const float* __restrict__ mask,
                             float* __restrict__ out, float* park, int N, int Dh, int n_blocks,
                             int n_heads) {
  const int tid = threadIdx.x;
  float* h = smem;             // the residual stream
  float* a = smem + MAT;       // work tile
  float* tiles = smem + H_TILES;
  float* vec = smem + H_VEC;
  float* m = vec + HV_MASK;

  // ---- inputs: the trunk's hidden state into the first Dh columns of `a`
  for (int idx = tid; idx < ROWS * Dh; idx += THREADS) {
    const int r = idx / Dh, c = idx - r * Dh;
    a[r * WD + c] = r < N ? last[r * Dh + c] : 0.f;
  }
  if (tid < ROWS) m[tid] = tid < N ? mask[tid] : 0.f;
  __syncthreads();

  // ---- proj_in of [last ‖ one_hot(mask)]: last·W[:Dh] + W[Dh] + mask·(W[Dh+1] − W[Dh]) + b
  float acc[8][8];
  zero_acc(acc);
  gemm_acc<NI>(acc, a, w + L.w_in, Dh, tiles);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_row(i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(j);
      const float oh0 = w[L.w_oh0 + c];
      h[r * WD + c] = acc[i][j] + oh0 + m[r] * (w[L.w_oh1 + c] - oh0) + w[L.b_in + c];
    }
  }
  __syncthreads();

  h = gsdm_blocks<NI>(w + L.blocks, L.block, smem, tp, tp_block_stride, park, N, n_blocks,
                      n_heads);

  // ---- pre_rate Dense, then post_rate (C → 1) as a row product
  zero_acc(acc);
  gemm_acc<NI>(acc, h, w + L.w_pre, C, tiles);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_row(i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(j);
      a[r * WD + c] = acc[i][j] + w[L.b_pre + c];
    }
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < N; r += WARPS) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < C / 32; ++q) s = fmaf(a[r * WD + lane + 32 * q], w[L.w_post + lane + 32 * q], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[r] = s + w[L.b_post];
  }
  __syncthreads();  // the tiles are free for the block's next jet
}

template <int NI>
__global__ void __launch_bounds__(THREADS, 1)
survival_head_kernel(const float* __restrict__ w, const float* __restrict__ tp,
                     const float* __restrict__ last, const float* __restrict__ mask,
                     float* __restrict__ out, float* __restrict__ scratch, int B, int N, int Dh,
                     int n_blocks, int n_heads) {
  extern __shared__ __align__(16) float smem[];
  const HeadLayout L = make_head_layout(Dh, n_blocks);
  float* park = scratch + (size_t)blockIdx.x * MAT;
  for (int jet = blockIdx.x; jet < B; jet += gridDim.x) {
    const size_t p = (size_t)jet * N;
    survival_jet<NI>(w, L, smem, tp + (size_t)jet * C, (size_t)B * C, last + p * Dh, mask + p, out + p,
                 park, N, Dh, n_blocks, n_heads);
  }
}

}  // namespace mmps

// weights: the packed head; tp: (n_blocks, B, C) per-block time rows; last:
// (B, N, Dh); mask: (B, N) float; out: (B, N); scratch: (grid, 128, C).
extern "C" int mmp_survival_head(const void* w, const void* tp, const void* last,
                                 const void* mask, void* out, void* scratch, int grid, int B,
                                 int N, int Dh, int n_blocks, int n_heads, void* stream) {
  using namespace mmps;
  if (N < 1 || N > ROWS || Dh < KT || Dh > WD || Dh % KT != 0 || n_blocks < 1 || n_heads < 1 ||
      C % n_heads != 0 || (C / n_heads) % 32 != 0 || grid < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  // at the reference N = 109 the products skip the tile's last 16 rows
  auto kernel = N <= 16 * 7 ? survival_head_kernel<7> : survival_head_kernel<8>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)HEAD_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, HEAD_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(tp),
      static_cast<const float*>(last), static_cast<const float*>(mask),
      static_cast<float*>(out), static_cast<float*>(scratch), B, N, Dh, n_blocks, n_heads);
  return cudaGetLastError();
}
