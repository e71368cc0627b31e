// K6's device code: the kernel template that survival_head.cu instantiates
// at transformer width 128 and survival_head_c{256,384,512}.cu at the wider
// widths (one source a width, so that nvcc builds them side by side). The
// design and what bounds it: survival_head.cu.
#pragma once

#include "gsdm_blocks.cuh"

namespace mmps {

// Offsets in floats into the packed buffer (ops/survival_cuda.py::head_layout);
// matrices are (in, out) row-major, W = 128·CL wide. The kernel reads the
// vectors, the one-hot rows and post_rate from here, the matrices from the
// tensor-core stream.
struct HeadLayout {
  int w_in, w_oh0, w_oh1, b_in;
  int blocks;
  BlockLayout block;
  int w_pre, b_pre, w_post, b_post, total;
};

__host__ __device__ inline HeadLayout make_head_layout(int Dh, int n_blocks, int W) {
  HeadLayout L;
  int o = 0;
  L.w_in = o;  o += Dh * W;
  L.w_oh0 = o; o += W;
  L.w_oh1 = o; o += W;
  L.b_in = o;  o += W;
  L.blocks = o;
  L.block = make_block_layout(W);
  o += n_blocks * L.block.stride;
  L.w_pre = o;  o += W * W;
  L.b_pre = o;  o += W;
  L.w_post = o; o += W;
  L.b_post = o; o += 1;
  L.total = o;
  return L;
}

// Stages of one block's stream: proj_in's ⌈Dh/8⌉, the blocks', pre_rate's.
__host__ __device__ inline int head_stages(int Dh, int n_blocks, int CL) {
  return (Dh + STAGE_ROWS - 1) / STAGE_ROWS + (n_blocks * BLOCK_STAGES + KSTEPS) * CL;
}

// The whole head for one jet. Every thread of the jet's blocks calls it.
template <int CL, int RT, int HD, int NB>
__device__ void survival_jet(const float* __restrict__ w, const HeadLayout& L, float* smem,
                             Ring& ring, const float* __restrict__ tp, size_t tp_block_stride,
                             const float* __restrict__ last, const float* __restrict__ mask,
                             float* __restrict__ out, float* park, int N, int Dh, int n_blocks,
                             int hd, float q_scale, const Jet<CL, RT>& jet) {
  const int tid = threadIdx.x;
  float* h = smem;         // the residual stream
  float* a = smem + TILE;  // work tile
  const int Nl = block_rows(N, jet);  // the block's rows
  const bool live = 64 * (tid >> 7) < Nl;
  const int own = jet.col0();

  // ---- proj_in of [last ‖ one_hot(mask)]: last·W[:Dh] + W[Dh] + mask·(W[Dh+1] − W[Dh]) + b
  float acc[64];
  zero(acc);
  project_in(acc, last, Nl, Dh, a, ring, live);
  each_pair(acc, [&](int r, int c, int at, float v0, float v1) {
    float y[2] = {0.f, 0.f};
    if (r < Nl) {
      const float m = mask[r], x[2] = {v0, v1};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float oh0 = w[L.w_oh0 + own + c + e];
        y[e] = x[e] + oh0 + m * (w[L.w_oh1 + own + c + e] - oh0) + w[L.b_in + own + c + e];
      }
    }
    store2(h, at, y[0], y[1]);
  });
  __syncthreads();

  gsdm_blocks<CL, RT, HD, NB>(w + L.blocks, L.block, smem, tp, tp_block_stride, ring, park,
                              N, n_blocks, hd, q_scale, jet);

  // ---- pre_rate Dense, then post_rate (C → 1) as a row product
  zero(acc);
  gemm_tc(acc, TileA<Plain, CL, RT>{h, {}, jet}, KSTEPS * CL, ring, live);
  float part[2] = {0.f, 0.f};  // rows r0, r0 + 8, over this block's channels
#pragma unroll
  for (int j = 0; j < KSTEPS; ++j) {
    const int c = own + 8 * j + 2 * (tid & 3);
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
  }
  if constexpr (CL == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = frag_row0() + 8 * i;
      if (live && (tid & 3) == 0 && r < Nl) out[r] = part[i] + w[L.b_post];
    }
  } else {
    // each block's partial sums of a row, added in block order by block 0
    float* vec = smem + S_VEC;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = frag_row0() + 8 * i;
      if (live && (tid & 3) == 0 && r < Nl) vec[VC_POST + r] = part[i];
    }
    jet.sync();
    if (jet.rank == 0 && tid < Nl) {
      float y = 0.f;
      for (int j = 0; j < CL; ++j) y += jet.peer(vec, j)[VC_POST + tid];
      out[tid] = y + w[L.b_post];
    }
  }
}

template <int CL, int RT, int HD, int NB>
__global__ void __launch_bounds__(THREADS, 1)
survival_head_kernel(const float* __restrict__ w, const float* __restrict__ stream,
                     const float* __restrict__ tp, const float* __restrict__ last,
                     const float* __restrict__ mask, float* __restrict__ out,
                     float* __restrict__ scratch, int B, int N, int Dh, int n_blocks, int hd) {
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
  const HeadLayout L = make_head_layout(Dh, n_blocks, W);
  const int total = head_stages(Dh, n_blocks, CL);
  Ring ring{stream + (size_t)jet.rank * total * STAGE, total, smem + S_RING, 0};
  float* park = scratch + (size_t)blockIdx.x * SCRATCH_FLOATS;
  const float q_scale = HD > 0 ? 1.f / sqrtf((float)HD) : (float)(1.0 / sqrt((double)hd));
  ring.start();
  for (int i = blockIdx.x / K; i < B; i += gridDim.x / K) {
    const size_t p = (size_t)i * N + jet.row0();  // the block's first row of jet i
    survival_jet<CL, RT, HD, NB>(w, L, smem, ring, tp + (size_t)i * W + jet.col0(), (size_t)B * W,
                             last + p * Dh, mask + p, out + p, park, N, Dh, n_blocks, hd, q_scale,
                             jet);
  }
  cp_async_wait<0>();  // the stages fetched ahead for a jet that this block does not take
  if constexpr (K > 1) jet.sync();  // no block leaves while a peer may read its shared memory
}

template <int CL, int RT, int HD, int NB>
cudaError_t launch_head(const void* w, const void* stream, const void* tp, const void* last,
                        const void* mask, void* out, void* scratch, int grid, int B, int N,
                        int Dh, int n_blocks, int hd, cudaStream_t s) {
  auto kernel = survival_head_kernel<CL, RT, HD, NB>;
  constexpr size_t smem = smem_bytes<CL, RT>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return launch_jets<CL * RT>(kernel, grid, B, smem, s, static_cast<const float*>(w),
                         static_cast<const float*>(stream), static_cast<const float*>(tp),
                         static_cast<const float*>(last), static_cast<const float*>(mask),
                         static_cast<float*>(out), static_cast<float*>(scratch), B, N, Dh,
                         n_blocks, hd);
}

// The launch in a cluster (CL channel blocks × RT row blocks, CL · RT > 1)
// for heads of hd channels; one source a width and row count
// (survival_head_c256.cu, _c384.cu, _c512.cu at RT = 1; survival_head_r2.cu,
// _c256_r2.cu, _c384_r2.cu, _c512_r2.cu at RT = 2).
template <int CL, int RT>
cudaError_t launch_head_cluster(const void* w, const void* stream, const void* tp, const void* last,
                                const void* mask, void* out, void* scratch, int grid, int B, int N,
                                int Dh, int n_blocks, int hd, cudaStream_t s);

#define MMPS_HEAD_CLUSTER_DECL(CL, RT)                                                            \
  template <>                                                                                     \
  cudaError_t launch_head_cluster<CL, RT>(const void* w, const void* stream, const void* tp,      \
                                          const void* last, const void* mask, void* out,         \
                                          void* scratch, int grid, int B, int N, int Dh,         \
                                          int n_blocks, int hd, cudaStream_t s);
MMPS_HEAD_CLUSTER_DECL(2, 1)
MMPS_HEAD_CLUSTER_DECL(3, 1)
MMPS_HEAD_CLUSTER_DECL(4, 1)
MMPS_HEAD_CLUSTER_DECL(1, 2)
MMPS_HEAD_CLUSTER_DECL(2, 2)
MMPS_HEAD_CLUSTER_DECL(3, 2)
MMPS_HEAD_CLUSTER_DECL(4, 2)

#define MMPS_HEAD_CLUSTER(CL, RT)                                                                 \
  template <>                                                                                     \
  cudaError_t launch_head_cluster<CL, RT>(const void* w, const void* stream, const void* tp,      \
                                          const void* last, const void* mask, void* out,         \
                                          void* scratch, int grid, int B, int N, int Dh,         \
                                          int n_blocks, int hd, cudaStream_t s) {                \
    auto launch = head_blocks(hd) == 1   ? launch_head<CL, RT, 0, 1>                              \
                  : head_blocks(hd) == 2 ? launch_head<CL, RT, 0, 2>                              \
                  : head_blocks(hd) == 4 ? launch_head<CL, RT, 0, 4>                              \
                  : head_blocks(hd) == 8 ? launch_head<CL, RT, 0, 8>                              \
                                         : launch_head<CL, RT, 0, 16>;                            \
    return launch(w, stream, tp, last, mask, out, scratch, grid, B, N, Dh, n_blocks, hd, s);     \
  }

}  // namespace mmps
