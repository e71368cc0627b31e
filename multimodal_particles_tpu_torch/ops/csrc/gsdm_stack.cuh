// K7's device code: the kernel template that gsdm_stack.cu instantiates at
// transformer width 128 and gsdm_stack_c{256,384,512}.cu at the wider widths
// (one source a width, so that nvcc builds them side by side). The design
// and what bounds it: gsdm_stack.cu.
#pragma once

#include "gsdm_blocks.cuh"

namespace mmps {

// Stages of one block's stream: proj_in's ⌈Din/8⌉, then the blocks'.
__host__ __device__ inline int stack_stages(int Din, int n_blocks, int CL) {
  return (Din + STAGE_ROWS - 1) / STAGE_ROWS + n_blocks * BLOCK_STAGES * CL;
}

// The stack for one jet. Every thread of the jet's blocks calls it.
template <int CL, int HD, int NB>
__device__ void stack_jet(const float* __restrict__ w, const BlockLayout& L, float* smem,
                          Ring& ring, const float* __restrict__ tp, size_t tp_block_stride,
                          const float* __restrict__ x, float* __restrict__ out, float* park,
                          int N, int Din, int n_blocks, int hd, float q_scale,
                          const Jet<CL>& jet) {
  const int tid = threadIdx.x, W = C * CL, own = jet.col0();
  float* h = smem;         // the residual stream
  float* a = smem + TILE;  // work tile
  const bool live = 64 * (tid >> 7) < N;
  // packed buffer: proj_in's weight (Dpad, W) (read from the stream), its
  // bias (W), then the blocks
  const float* b_in = w + (size_t)((Din + 15) / 16 * 16) * W;
  const float* wblocks = b_in + W;

  // ---- proj_in, in passes of up to 128 input columns
  float acc[64];
  zero(acc);
  project_in(acc, x, N, Din, a, ring, live);
  each_pair(acc, [&](int r, int c, int at, float v0, float v1) {
    const bool real = r < N;
    store2(h, at, real ? v0 + b_in[own + c] : 0.f, real ? v1 + b_in[own + c + 1] : 0.f);
  });
  __syncthreads();

  gsdm_blocks<CL, HD, NB>(wblocks, L, smem, tp, tp_block_stride, ring, park, N, n_blocks, hd,
                          q_scale, jet);

  // ---- the residual tile's first N rows are this block's columns of the
  // output: rows of W floats
  for (int idx = tid; idx < N * (C / 4); idx += THREADS) {
    const int r = idx / (C / 4), c = 4 * (idx - r * (C / 4));
    *reinterpret_cast<float4*>(out + (size_t)r * W + own + c) =
        *reinterpret_cast<const float4*>(h + tix(r, c));
  }
  __syncthreads();  // h is free for the block's next jet
}

template <int CL, int HD, int NB>
__global__ void __launch_bounds__(THREADS, 1)
gsdm_stack_kernel(const float* __restrict__ w, const float* __restrict__ stream,
                  const float* __restrict__ tp, const float* __restrict__ x,
                  float* __restrict__ out, float* __restrict__ scratch, int B, int N, int Din,
                  int n_blocks, int hd) {
  extern __shared__ __align__(16) float smem[];
  Jet<CL> jet{0};
  if constexpr (CL > 1) jet.rank = (int)cg::this_cluster().block_rank();
  const int W = C * CL;
  const BlockLayout L = make_block_layout(W);
  const int total = stack_stages(Din, n_blocks, CL);
  Ring ring{stream + (size_t)jet.rank * total * STAGE, total, smem + S_RING, 0};
  float* park = scratch + (size_t)blockIdx.x * SCRATCH_FLOATS;
  const float q_scale = HD > 0 ? 1.f / sqrtf((float)HD) : (float)(1.0 / sqrt((double)hd));
  ring.start();
  for (int i = blockIdx.x / CL; i < B; i += gridDim.x / CL) {
    const size_t p = (size_t)i * N;
    stack_jet<CL, HD, NB>(w, L, smem, ring, tp + (size_t)i * W + jet.col0(), (size_t)B * W,
                          x + p * Din, out + p * W, park, N, Din, n_blocks, hd, q_scale, jet);
  }
  cp_async_wait<0>();  // the stages fetched ahead for a jet that this block does not take
  if constexpr (CL > 1) jet.sync();  // no block leaves while a peer may read its shared memory
}

template <int CL, int HD, int NB>
cudaError_t launch_stack(const void* w, const void* stream, const void* tp, const void* x,
                         void* out, void* scratch, int grid, int B, int N, int Din, int n_blocks,
                         int hd, cudaStream_t s) {
  auto kernel = gsdm_stack_kernel<CL, HD, NB>;
  constexpr size_t smem = smem_bytes<CL>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return launch_jets<CL>(kernel, grid, B, smem, s, static_cast<const float*>(w),
                         static_cast<const float*>(stream), static_cast<const float*>(tp),
                         static_cast<const float*>(x), static_cast<float*>(out),
                         static_cast<float*>(scratch), B, N, Din, n_blocks, hd);
}

// The launch at CL > 1 for heads of hd channels; one source a width
// (gsdm_stack_c256.cu, _c384.cu, _c512.cu).
template <int CL>
cudaError_t launch_stack_cluster(const void* w, const void* stream, const void* tp, const void* x,
                                 void* out, void* scratch, int grid, int B, int N, int Din,
                                 int n_blocks, int hd, cudaStream_t s);

#define MMPS_STACK_CLUSTER_DECL(CL)                                                               \
  template <>                                                                                     \
  cudaError_t launch_stack_cluster<CL>(const void* w, const void* stream, const void* tp,         \
                                       const void* x, void* out, void* scratch, int grid, int B, \
                                       int N, int Din, int n_blocks, int hd, cudaStream_t s);
MMPS_STACK_CLUSTER_DECL(2)
MMPS_STACK_CLUSTER_DECL(3)
MMPS_STACK_CLUSTER_DECL(4)

#define MMPS_STACK_CLUSTER(CL)                                                                    \
  template <>                                                                                     \
  cudaError_t launch_stack_cluster<CL>(const void* w, const void* stream, const void* tp,         \
                                       const void* x, void* out, void* scratch, int grid, int B, \
                                       int N, int Din, int n_blocks, int hd, cudaStream_t s) {    \
    auto launch = head_blocks(hd) == 1   ? launch_stack<CL, 0, 1>                                 \
                  : head_blocks(hd) == 2 ? launch_stack<CL, 0, 2>                                 \
                  : head_blocks(hd) == 4 ? launch_stack<CL, 0, 4>                                 \
                  : head_blocks(hd) == 8 ? launch_stack<CL, 0, 8>                                 \
                                         : launch_stack<CL, 0, 16>;                               \
    return launch(w, stream, tp, x, out, scratch, grid, B, N, Din, n_blocks, hd, s);             \
  }

}  // namespace mmps
