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
// of input and output. On the tensor cores under the 3×TF32 split (three
// TF32 products a multiply-add) the operations bound it, at B = 4096 1.47 ms
// at the card's TF32 peak; the bytes take 0.01 ms. Each block also streams
// the 1.6 MB of prepared weights (hi and lo halves) from L2 for every jet.
//
// The first product runs over the trunk's Dh hidden columns (Dh / 8 stages
// of the stream); the one-hot's two weight rows enter its epilogue as
// W[Dh] + mask·(W[Dh+1] − W[Dh]). pre_rate's epilogue takes post_rate as a
// row product in registers: each thread's 32 columns of two rows, summed
// over the four threads that hold a row.
//
// C interface (bound with ctypes by ops/survival_cuda.py): returns the
// cudaError_t of the launch, 0 on success.

#include "gsdm_blocks.cuh"

namespace mmps {

// Offsets in floats into the packed buffer (ops/survival_cuda.py::head_layout);
// matrices are (in, out) row-major. The kernel reads the vectors, the one-hot
// rows and post_rate from here, the matrices from the tensor-core stream.
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

// The whole head for one jet. Every thread of the block calls it.
template <int HD>
__device__ void survival_jet(const float* __restrict__ w, const HeadLayout& L, float* smem,
                             Ring& ring, const float* __restrict__ tp, size_t tp_block_stride,
                             const float* __restrict__ last, const float* __restrict__ mask,
                             float* __restrict__ out, float* park, int N, int Dh, int n_blocks) {
  const int tid = threadIdx.x;
  float* h = smem;         // the residual stream
  float* a = smem + TILE;  // work tile
  const bool live = 64 * (tid >> 7) < N;

  // ---- inputs: the trunk's hidden state into the first Dh columns of `a`
  for (int idx = tid; idx < ROWS * Dh / 4; idx += THREADS) {
    const int r = idx / (Dh / 4), c = 4 * (idx - r * (Dh / 4));
    const float4 x = r < N ? __ldg(reinterpret_cast<const float4*>(last + r * Dh + c))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(a + tix(r, c)) = x;
  }
  __syncthreads();

  // ---- proj_in of [last ‖ one_hot(mask)]: last·W[:Dh] + W[Dh] + mask·(W[Dh+1] − W[Dh]) + b
  float acc[64];
  zero(acc);
  gemm_tc(acc, TileA<Plain>{a, {}}, Dh / STAGE_ROWS, ring, live);
  each_pair(acc, [&](int r, int c, int at, float v0, float v1) {
    float y[2] = {0.f, 0.f};
    if (r < N) {
      const float m = mask[r], x[2] = {v0, v1};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float oh0 = w[L.w_oh0 + c + e];
        y[e] = x[e] + oh0 + m * (w[L.w_oh1 + c + e] - oh0) + w[L.b_in + c + e];
      }
    }
    store2(h, at, y[0], y[1]);
  });
  __syncthreads();

  gsdm_blocks<HD>(w + L.blocks, L.block, smem, tp, tp_block_stride, ring, park, N, n_blocks);

  // ---- pre_rate Dense, then post_rate (C → 1) as a row product
  zero(acc);
  gemm_tc(acc, TileA<Plain>{h, {}}, KSTEPS, ring, live);
  float part[2] = {0.f, 0.f};  // rows r0, r0 + 8
#pragma unroll
  for (int j = 0; j < KSTEPS; ++j) {
    const int c = 8 * j + 2 * (tid & 3);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      part[i] = fmaf(acc[4 * j + 2 * i] + w[L.b_pre + c], w[L.w_post + c], part[i]);
      part[i] = fmaf(acc[4 * j + 2 * i + 1] + w[L.b_pre + c + 1], w[L.w_post + c + 1], part[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    part[i] += __shfl_xor_sync(0xffffffffu, part[i], 1);
    part[i] += __shfl_xor_sync(0xffffffffu, part[i], 2);
    const int r = frag_row0() + 8 * i;
    if (live && (tid & 3) == 0 && r < N) out[r] = part[i] + w[L.b_post];
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
survival_head_kernel(const float* __restrict__ w, const float* __restrict__ stream,
                     const float* __restrict__ tp, const float* __restrict__ last,
                     const float* __restrict__ mask, float* __restrict__ out,
                     float* __restrict__ scratch, int B, int N, int Dh, int n_blocks) {
  extern __shared__ __align__(16) float smem[];
  const HeadLayout L = make_head_layout(Dh, n_blocks);
  Ring ring{stream, Dh / STAGE_ROWS + n_blocks * BLOCK_STAGES + KSTEPS, smem + S_RING, 0};
  float* park = scratch + (size_t)blockIdx.x * TILE;
  ring.start();
  for (int jet = blockIdx.x; jet < B; jet += gridDim.x) {
    const size_t p = (size_t)jet * N;
    survival_jet<HD>(w, L, smem, ring, tp + (size_t)jet * C, (size_t)B * C, last + p * Dh,
                     mask + p, out + p, park, N, Dh, n_blocks);
  }
  cp_async_wait<0>();  // the stages fetched ahead for a jet that this block does not take
}

template <int HD>
cudaError_t launch_head(const void* w, const void* stream, const void* tp, const void* last,
                        const void* mask, void* out, void* scratch, int grid, int B, int N,
                        int Dh, int n_blocks, cudaStream_t s) {
  auto kernel = survival_head_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)HEAD_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, HEAD_SMEM_BYTES, s>>>(
      static_cast<const float*>(w), static_cast<const float*>(stream),
      static_cast<const float*>(tp), static_cast<const float*>(last),
      static_cast<const float*>(mask), static_cast<float*>(out), static_cast<float*>(scratch), B,
      N, Dh, n_blocks);
  return cudaGetLastError();
}

}  // namespace mmps

// weights: the packed head; stream: its tensor-core stages (proj_in's Dh / 8,
// the blocks', pre_rate's); tp: (n_blocks, B, C) per-block time rows; last:
// (B, N, Dh); mask: (B, N) float; out: (B, N); scratch: a tile of 128 × 132
// floats for each of the grid's blocks. Heads of 32, 64 or 128 channels; Dh
// a multiple of 16 up to 128.
extern "C" int mmp_survival_head(const void* w, const void* stream, const void* tp,
                                 const void* last, const void* mask, void* out, void* scratch,
                                 int grid, int B, int N, int Dh, int n_blocks, int n_heads,
                                 void* cuda_stream) {
  using namespace mmps;
  if (N < 1 || N > ROWS || Dh < 16 || Dh > C || Dh % 16 != 0 || n_blocks < 1 || n_heads < 1 ||
      C % n_heads != 0 || (C / n_heads) % 32 != 0 || grid < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int hd = C / n_heads;
  auto launch = hd == 32 ? launch_head<32> : hd == 64 ? launch_head<64> : launch_head<128>;
  return launch(w, stream, tp, last, mask, out, scratch, grid, B, N, Dh, n_blocks,
                static_cast<cudaStream_t>(cuda_stream));
}
