// K7: the transdimensional family's gsdm stack, one launch for the whole stack.
//
// Replaces the TPU kernel multimodal_particles_tpu/ops/gsdm_stack_pallas.py
// (`gsdm_stack_pallas`, body `_stack_kernel`): proj_in of a (B, N, Din) input
// → n_blocks × (ResnetBlock, AttnBlock) → the hidden state (B, N, C). The
// transdimensional network runs it twice an evaluation: the rate /
// nearest-atom head on [trunk hidden ‖ one-hot values] (Din = 24 at the
// reference widths) and the creation head on that ‖ distance ‖ nearest one-hot
// (Din = 27). The heads' small projections after it stay with the caller, as
// they stay outside the TPU kernel. The blocks, their GroupNorm and attention,
// the shared memory plan and the design are gsdm_blocks.cuh's, shared with
// the survival head (survival_head.cu); this file adds a first product of any
// input width and the store of the residual tile.
//
// What bounds it. A jet of N = 128 slots costs N·Din·128 (proj_in) + per block
// 6 products of (N,128)·(128,128) and two heads of N·N·64 scores and values:
// about 34 M multiply-adds at 2 blocks, against N·(Din + 128)·4 bytes (78 KB)
// of input and output. The bound is fp32 arithmetic on the CUDA cores: at
// B = 4096 the 0.28 TFLOP take 4.2 ms at the card's peak, the 0.32 GB 0.1 ms.
//
// The first product. The weight tiles are 16 input rows, and Din (24, 27) is
// no multiple of 16: the packed proj_in weight carries zero rows up to
// Dpad = 16·⌈Din/16⌉ (ops/gsdm_stack_cuda.py::stack_layout), and the input
// tile's columns from Din to Dpad are zeroed, so the product runs over Dpad.
// An input wider than the tile's 128 columns (the `--scaled` trunk's hidden
// state of 128 ‖ V ‖ 3: Din = 136 and 139) goes through the tile in passes of
// 128 columns, each accumulating into the same register tile, so the sum runs
// over the columns in the order of one pass over Dpad; Din ≤ 128 is one pass.
//
// C interface (bound with ctypes by ops/gsdm_stack_cuda.py): returns the
// cudaError_t of the launch, 0 on success.

#include "gsdm_blocks.cuh"

namespace mmps {

// The stack for one jet. Every thread of the block calls it. NI: the products
// cover the tile's first 16·NI rows (N ≤ 16·NI).
template <int NI>
__device__ void stack_jet(const float* __restrict__ w, const BlockLayout& L, float* smem,
                          const float* __restrict__ tp, size_t tp_block_stride,
                          const float* __restrict__ x, float* __restrict__ out, float* park,
                          int N, int Din, int Dpad, int n_blocks, int n_heads) {
  const int tid = threadIdx.x;
  float* h = smem;             // the residual stream
  float* a = smem + MAT;       // work tile
  float* tiles = smem + H_TILES;
  // packed buffer: proj_in weight (Dpad, C), its bias (C), then the blocks
  const float* w_in = w;
  const float* b_in = w + Dpad * C;
  const float* wblocks = b_in + C;

  // ---- proj_in, in passes of up to 128 input columns: the pass's columns
  // into the first `width` columns of `a`, zero past N and Din
  float acc[8][8];
  zero_acc(acc);
  for (int c0 = 0; c0 < Dpad; c0 += WD) {
    const int width = Dpad - c0 < WD ? Dpad - c0 : WD;
    for (int idx = tid; idx < ROWS * width; idx += THREADS) {
      const int r = idx / width, c = idx - r * width;
      a[r * WD + c] = (r < N && c0 + c < Din) ? x[r * Din + c0 + c] : 0.f;
    }
    __syncthreads();
    gemm_acc<NI>(acc, a, w_in + (size_t)c0 * C, width, tiles);  // ends with a barrier
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile_row(i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tile_col(j);
      h[r * WD + c] = acc[i][j] + b_in[c];
    }
  }
  __syncthreads();

  h = gsdm_blocks<NI>(wblocks, L, smem, tp, tp_block_stride, park, N, n_blocks, n_heads);

  // ---- the residual tile's first N rows are the output: rows of C floats, contiguous
  for (int idx = tid; idx < N * (C / 4); idx += THREADS)
    reinterpret_cast<float4*>(out)[idx] = reinterpret_cast<const float4*>(h)[idx];
  __syncthreads();  // the tiles are free for the block's next jet
}

template <int NI>
__global__ void __launch_bounds__(THREADS, 1)
gsdm_stack_kernel(const float* __restrict__ w, const float* __restrict__ tp,
                  const float* __restrict__ x, float* __restrict__ out,
                  float* __restrict__ scratch, int B, int N, int Din, int Dpad, int n_blocks,
                  int n_heads) {
  extern __shared__ __align__(16) float smem[];
  const BlockLayout L = make_block_layout();
  float* park = scratch + (size_t)blockIdx.x * MAT;
  for (int jet = blockIdx.x; jet < B; jet += gridDim.x) {
    const size_t p = (size_t)jet * N;
    stack_jet<NI>(w, L, smem, tp + (size_t)jet * C, (size_t)B * C, x + p * Din, out + p * C, park,
                  N, Din, Dpad, n_blocks, n_heads);
  }
}

}  // namespace mmps

// weights: the packed stack; tp: (n_blocks, B, C) per-block time rows; x:
// (B, N, Din); out: (B, N, C); scratch: (grid, 128, C).
extern "C" int mmp_gsdm_stack(const void* w, const void* tp, const void* x, void* out,
                              void* scratch, int grid, int B, int N, int Din, int n_blocks,
                              int n_heads, void* stream) {
  using namespace mmps;
  if (N < 1 || N > ROWS || Din < 1 || n_blocks < 1 || n_heads < 1 ||
      C % n_heads != 0 || (C / n_heads) % 32 != 0 || grid < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int Dpad = (Din + KT - 1) / KT * KT;
  auto kernel = N <= 16 * 7 ? gsdm_stack_kernel<7> : gsdm_stack_kernel<8>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)HEAD_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, HEAD_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<const float*>(tp), static_cast<const float*>(x),
      static_cast<float*>(out), static_cast<float*>(scratch), B, N, Din, Dpad, n_blocks, n_heads);
  return cudaGetLastError();
}
