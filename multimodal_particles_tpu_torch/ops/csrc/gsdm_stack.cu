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
// of input and output. On the tensor cores under the 3×TF32 split the
// operations bound it: at B = 4096 1.69 ms at the card's TF32 peak, the bytes
// 0.1 ms. Each block also streams the 1.6 MB of prepared weights from L2 for
// every jet.
//
// The first product. Its stages hold 8 input rows: the wrapper pads proj_in's
// weight with zero rows to Dp = 8·⌈Din/8⌉ in the tensor-core stream
// (ops/gsdm_stack_cuda.py::stack_stream: Din = 24 → 3 stages, 27 → 4, 136 →
// 17, 139 → 18), and the input tile's columns from Din to Dp are zeroed. An
// input wider than the tile's 128 columns (the `--scaled` trunk's hidden
// state of 128 ‖ V ‖ 3: Din = 136 and 139) goes through the tile in passes of
// 128 columns, each accumulating into the same registers.
//
// C interface (bound with ctypes by ops/gsdm_stack_cuda.py): returns the
// cudaError_t of the launch, 0 on success.

#include "gsdm_blocks.cuh"

namespace mmps {

// The stack for one jet. Every thread of the block calls it.
template <int HD>
__device__ void stack_jet(const float* __restrict__ w, const BlockLayout& L, float* smem,
                          Ring& ring, const float* __restrict__ tp, size_t tp_block_stride,
                          const float* __restrict__ x, float* __restrict__ out, float* park,
                          int N, int Din, int n_blocks) {
  const int tid = threadIdx.x;
  float* h = smem;         // the residual stream
  float* a = smem + TILE;  // work tile
  const bool live = 64 * (tid >> 7) < N;
  const int Dp = (Din + STAGE_ROWS - 1) / STAGE_ROWS * STAGE_ROWS;
  // packed buffer: proj_in's weight (Dpad, C) (read from the stream), its
  // bias (C), then the blocks
  const float* b_in = w + (size_t)((Din + 15) / 16 * 16) * C;
  const float* wblocks = b_in + C;

  // ---- proj_in, in passes of up to 128 input columns: the pass's columns
  // into the first `width` columns of `a`, zero past N and Din
  float acc[64];
  zero(acc);
  for (int c0 = 0; c0 < Dp; c0 += C) {
    const int width = Dp - c0 < C ? Dp - c0 : C;
    for (int idx = tid; idx < ROWS * width; idx += THREADS) {
      const int r = idx / width, c = idx - r * width;
      a[tix(r, c)] = (r < N && c0 + c < Din) ? x[r * Din + c0 + c] : 0.f;
    }
    __syncthreads();
    // ends with a barrier: `a` is free for the next pass
    gemm_tc(acc, TileA<Plain>{a, {}}, width / STAGE_ROWS, ring, live);
  }
  each_pair(acc, [&](int r, int c, int at, float v0, float v1) {
    const bool real = r < N;
    store2(h, at, real ? v0 + b_in[c] : 0.f, real ? v1 + b_in[c + 1] : 0.f);
  });
  __syncthreads();

  gsdm_blocks<HD>(wblocks, L, smem, tp, tp_block_stride, ring, park, N, n_blocks);

  // ---- the residual tile's first N rows are the output: rows of C floats, contiguous
  for (int idx = tid; idx < N * (C / 4); idx += THREADS) {
    const int r = idx / (C / 4), c = 4 * (idx - r * (C / 4));
    reinterpret_cast<float4*>(out)[idx] = *reinterpret_cast<const float4*>(h + tix(r, c));
  }
  __syncthreads();  // h is free for the block's next jet
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
gsdm_stack_kernel(const float* __restrict__ w, const float* __restrict__ stream,
                  const float* __restrict__ tp, const float* __restrict__ x,
                  float* __restrict__ out, float* __restrict__ scratch, int B, int N, int Din,
                  int n_blocks) {
  extern __shared__ __align__(16) float smem[];
  const BlockLayout L = make_block_layout();
  const int in_stages = (Din + STAGE_ROWS - 1) / STAGE_ROWS;
  Ring ring{stream, in_stages + n_blocks * BLOCK_STAGES, smem + S_RING, 0};
  float* park = scratch + (size_t)blockIdx.x * TILE;
  ring.start();
  for (int jet = blockIdx.x; jet < B; jet += gridDim.x) {
    const size_t p = (size_t)jet * N;
    stack_jet<HD>(w, L, smem, ring, tp + (size_t)jet * C, (size_t)B * C, x + p * Din,
                  out + p * C, park, N, Din, n_blocks);
  }
  cp_async_wait<0>();  // the stages fetched ahead for a jet that this block does not take
}

template <int HD>
cudaError_t launch_stack(const void* w, const void* stream, const void* tp, const void* x,
                         void* out, void* scratch, int grid, int B, int N, int Din, int n_blocks,
                         cudaStream_t s) {
  auto kernel = gsdm_stack_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)HEAD_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, HEAD_SMEM_BYTES, s>>>(
      static_cast<const float*>(w), static_cast<const float*>(stream),
      static_cast<const float*>(tp), static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<float*>(scratch), B, N, Din, n_blocks);
  return cudaGetLastError();
}

}  // namespace mmps

// weights: the packed stack; stream: its tensor-core stages (proj_in's
// ⌈Din/8⌉, then the blocks'); tp: (n_blocks, B, C) per-block time rows; x:
// (B, N, Din); out: (B, N, C); scratch: a tile of 128 × 132 floats for each
// of the grid's blocks. Heads of 32, 64 or 128 channels.
extern "C" int mmp_gsdm_stack(const void* w, const void* stream, const void* tp, const void* x,
                              void* out, void* scratch, int grid, int B, int N, int Din,
                              int n_blocks, int n_heads, void* cuda_stream) {
  using namespace mmps;
  if (N < 1 || N > ROWS || Din < 1 || n_blocks < 1 || n_heads < 1 || C % n_heads != 0 ||
      (C / n_heads) % 32 != 0 || grid < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int hd = C / n_heads;
  auto launch = hd == 32 ? launch_stack<32> : hd == 64 ? launch_stack<64> : launch_stack<128>;
  return launch(w, stream, tp, x, out, scratch, grid, B, N, Din, n_blocks,
                static_cast<cudaStream_t>(cuda_stream));
}
