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
template <int CL, int RT, int HD, int NB>
__device__ void stack_jet(const float* __restrict__ w, const BlockLayout& L, float* smem,
                          Ring& ring, const float* __restrict__ tp, size_t tp_block_stride,
                          const float* __restrict__ x, float* __restrict__ out, float* park,
                          int N, int Din, int n_blocks, int hd, float q_scale,
                          const Jet<CL, RT>& jet) {
  const int tid = threadIdx.x, W = C * CL, own = jet.col0();
  float* h = smem;         // the residual stream
  float* a = smem + TILE;  // work tile
  const int Nl = block_rows(N, jet);  // the block's rows
  const bool live = 64 * (tid >> 7) < Nl;
  // packed buffer: proj_in's weight (Dpad, W) (read from the stream), its
  // bias (W), then the blocks
  const float* b_in = w + (size_t)((Din + 15) / 16 * 16) * W;
  const float* wblocks = b_in + W;

  // ---- proj_in, in passes of up to 128 input columns
  float acc[64];
  zero(acc);
  project_in<(RT > 1)>(acc, x, Nl, Din, a, ring, live, w + own, W);
  each_pair(acc, [&](int r, int c, int at, float v0, float v1) {
    const bool real = r < Nl;
    store2(h, at, real ? v0 + b_in[own + c] : 0.f, real ? v1 + b_in[own + c + 1] : 0.f);
  });
  __syncthreads();

  // past 128 slots every product on the CUDA cores (gsdm_blocks.cuh's design note)
  gsdm_blocks<CL, RT, HD, NB, (RT > 1)>(wblocks, L, smem, tp, tp_block_stride, ring, park, N,
                                        n_blocks, hd, q_scale, jet);

  // ---- the residual tile's first Nl rows are this block's columns of the
  // output: rows of W floats
  for (int idx = tid; idx < Nl * (C / 4); idx += THREADS) {
    const int r = idx / (C / 4), c = 4 * (idx - r * (C / 4));
    *reinterpret_cast<float4*>(out + (size_t)r * W + own + c) =
        *reinterpret_cast<const float4*>(h + tix(r, c));
  }
  __syncthreads();  // h is free for the block's next jet
}

template <int CL, int RT, int HD, int NB>
__global__ void __launch_bounds__(THREADS, 1)
gsdm_stack_kernel(const float* __restrict__ w, const float* __restrict__ stream,
                  const float* __restrict__ tp, const float* __restrict__ x,
                  float* __restrict__ out, float* __restrict__ scratch, int B, int N, int Din,
                  int n_blocks, int hd) {
  extern __shared__ __align__(16) float smem[];
  constexpr int K = CL * RT;  // blocks a jet
  Jet<CL, RT> jet{0, 0};
  if constexpr (RT == 1 && CL > 1) jet.rank = (int)cg::this_cluster().block_rank();
  if constexpr (RT > 1) {
    const int r = (int)cg::this_cluster().block_rank();
    jet.rank = r % CL;
    jet.rrow = r / CL;
  }
  const int W = C * CL;
  const BlockLayout L = make_block_layout(W);
  const int total = stack_stages(Din, n_blocks, CL);
  Ring ring{stream + (size_t)jet.rank * total * STAGE, total, smem + S_RING, 0};
  float* park = scratch + (size_t)blockIdx.x * SCRATCH_FLOATS;
  const float q_scale = HD > 0 ? 1.f / sqrtf((float)HD) : (float)(1.0 / sqrt((double)hd));
  if constexpr (RT == 1) ring.start();  // past 128 slots the stream is not read
  for (int i = blockIdx.x / K; i < B; i += gridDim.x / K) {
    const size_t p = (size_t)i * N + jet.row0();  // the block's first row of jet i
    stack_jet<CL, RT, HD, NB>(w, L, smem, ring, tp + (size_t)i * W + jet.col0(), (size_t)B * W,
                          x + p * Din, out + p * W, park, N, Din, n_blocks, hd, q_scale, jet);
  }
  cp_async_wait<0>();  // the stages fetched ahead for a jet that this block does not take
  if constexpr (K > 1) jet.sync();  // no block leaves while a peer may read its shared memory
}

template <int CL, int RT, int HD, int NB>
cudaError_t launch_stack(const void* w, const void* stream, const void* tp, const void* x,
                         void* out, void* scratch, int grid, int B, int N, int Din, int n_blocks,
                         int hd, cudaStream_t s) {
  auto kernel = gsdm_stack_kernel<CL, RT, HD, NB>;
  constexpr size_t smem = smem_bytes<CL, RT>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return launch_jets<CL * RT>(kernel, grid, B, smem, s, static_cast<const float*>(w),
                         static_cast<const float*>(stream), static_cast<const float*>(tp),
                         static_cast<const float*>(x), static_cast<float*>(out),
                         static_cast<float*>(scratch), B, N, Din, n_blocks, hd);
}

// The launch in a cluster (CL channel blocks × RT row blocks, CL · RT > 1)
// for heads of hd channels; one source a width and row count
// (gsdm_stack_c256.cu, _c384.cu, _c512.cu at RT = 1; gsdm_stack_r2.cu,
// _c256_r2.cu, _c384_r2.cu, _c512_r2.cu at RT = 2).
template <int CL, int RT>
cudaError_t launch_stack_cluster(const void* w, const void* stream, const void* tp, const void* x,
                                 void* out, void* scratch, int grid, int B, int N, int Din,
                                 int n_blocks, int hd, cudaStream_t s);

#define MMPS_STACK_CLUSTER_DECL(CL, RT)                                                           \
  template <>                                                                                     \
  cudaError_t launch_stack_cluster<CL, RT>(const void* w, const void* stream, const void* tp,     \
                                           const void* x, void* out, void* scratch, int grid,    \
                                           int B, int N, int Din, int n_blocks, int hd,          \
                                           cudaStream_t s);
MMPS_STACK_CLUSTER_DECL(2, 1)
MMPS_STACK_CLUSTER_DECL(3, 1)
MMPS_STACK_CLUSTER_DECL(4, 1)
MMPS_STACK_CLUSTER_DECL(1, 2)
MMPS_STACK_CLUSTER_DECL(2, 2)
MMPS_STACK_CLUSTER_DECL(3, 2)
MMPS_STACK_CLUSTER_DECL(4, 2)

#define MMPS_STACK_CLUSTER(CL, RT)                                                                \
  template <>                                                                                     \
  cudaError_t launch_stack_cluster<CL, RT>(const void* w, const void* stream, const void* tp,     \
                                           const void* x, void* out, void* scratch, int grid,    \
                                           int B, int N, int Din, int n_blocks, int hd,          \
                                           cudaStream_t s) {                                     \
    auto launch = head_blocks(hd) == 1   ? launch_stack<CL, RT, 0, 1>                             \
                  : head_blocks(hd) == 2 ? launch_stack<CL, RT, 0, 2>                             \
                  : head_blocks(hd) == 4 ? launch_stack<CL, RT, 0, 4>                             \
                  : head_blocks(hd) == 8 ? launch_stack<CL, RT, 0, 8>                             \
                                         : launch_stack<CL, RT, 0, 16>;                           \
    return launch(w, stream, tp, x, out, scratch, grid, B, N, Din, n_blocks, hd, s);             \
  }

}  // namespace mmps
