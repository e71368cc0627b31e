// K4 at the widths epic_wide.cuh's kernels are not compiled for: the
// kernel template that epic_wide_forward_h{128,256,384,512}.cu instantiate
// for local hidden widths 128 … 512 (a cluster of H / 128 blocks a jet), and
// epic_wide_forward_h{128,256,384,512}_r2.cu at every width for jets of 129 …
// 256 slots (a cluster of H / 128 × 2 row blocks). The design:
// epic_wide_any.cuh; the entry point: epic_wide_forward.cu.
#pragma once

#include "epic_wide_any.cuh"

namespace mmpw {

template <bool FOLD, int CL, int RB = 1>
__global__ void __launch_bounds__(THREADS, 1)
epic_wide_forward_any_kernel(const float* __restrict__ w, const float* __restrict__ tcw,
                             const float* __restrict__ l0t, Dims d, const float* __restrict__ t,
                             const float* __restrict__ x, const void* __restrict__ k,
                             const float* __restrict__ mask, float* __restrict__ out,
                             float* __restrict__ hidden, int N) {
  extern __shared__ __align__(16) float smem[];
  constexpr int CS = CL * RB;
  int me = 0;  // the cluster rank: row block me / CL, column block me % CL
  if constexpr (CS > 1) me = (int)cg::this_cluster().block_rank();
  const int rank = RB == 1 ? me : me % CL, rb = RB == 1 ? 0 : me / CL;
  const int jet = blockIdx.x / CS;
  const Layout L = make_layout(d);
  const JetRec R = make_jet_rec(d);
  const size_t p = (size_t)jet * N;
  const int* tokens = FOLD ? nullptr : static_cast<const int*>(k) + p;
  const float* values = FOLD ? static_cast<const float*>(k) + p * V : nullptr;
  cluster_sync<CS>();  // every block of the cluster has started
  wide_forward_jet_any<NoRecordAny, FOLD, CL, RB>(
      w, tcw, l0t, d, L, R, smem, t[jet], x + p * DC, tokens, values, mask + p, N,
      out + p * NOUT, hidden == nullptr ? nullptr : hidden + p * d.hidden, NoRecordAny(), rank,
      rb);
}

// The launch at local hidden width 128·CL and RB row blocks a jet (RB = 2:
// N > 128); one source a width and row-block count.
template <int CL, int RB = 1>
cudaError_t launch_forward_any(const void* w, const void* tcw, const void* l0t, const Dims& d,
                               const void* t, const void* x, const void* k, const void* mask,
                               void* out, void* hidden, int B, int N, cudaStream_t s);

#define MMPW_FORWARD_ANY_DECL(CL, RB)                                                            \
  template <>                                                                                    \
  cudaError_t launch_forward_any<CL, RB>(const void* w, const void* tcw, const void* l0t,       \
                                         const Dims& d, const void* t, const void* x,           \
                                         const void* k, const void* mask, void* out,            \
                                         void* hidden, int B, int N, cudaStream_t s);
MMPW_FORWARD_ANY_DECL(1, 1)
MMPW_FORWARD_ANY_DECL(2, 1)
MMPW_FORWARD_ANY_DECL(3, 1)
MMPW_FORWARD_ANY_DECL(4, 1)
MMPW_FORWARD_ANY_DECL(1, 2)
MMPW_FORWARD_ANY_DECL(2, 2)
MMPW_FORWARD_ANY_DECL(3, 2)
MMPW_FORWARD_ANY_DECL(4, 2)

#define MMPW_FORWARD_ANY_ROWS(CL, RB)                                                            \
  template <>                                                                                    \
  cudaError_t launch_forward_any<CL, RB>(const void* w, const void* tcw, const void* l0t,       \
                                         const Dims& d, const void* t, const void* x,           \
                                         const void* k, const void* mask, void* out,            \
                                         void* hidden, int B, int N, cudaStream_t s) {          \
    auto kernel = d.fold_discrete ? epic_wide_forward_any_kernel<true, CL, RB>                   \
                                  : epic_wide_forward_any_kernel<false, CL, RB>;                 \
    return launch_clusters<CL * RB>(                                                             \
        kernel, B, SMEM_BYTES_ANY, s, static_cast<const float*>(w),                              \
        static_cast<const float*>(tcw), static_cast<const float*>(l0t), d,                       \
        static_cast<const float*>(t), static_cast<const float*>(x), k,                           \
        static_cast<const float*>(mask), static_cast<float*>(out), static_cast<float*>(hidden),  \
        N);                                                                                      \
  }
// one row block (N ≤ 128)
#define MMPW_FORWARD_ANY(CL) MMPW_FORWARD_ANY_ROWS(CL, 1)

}  // namespace mmpw
