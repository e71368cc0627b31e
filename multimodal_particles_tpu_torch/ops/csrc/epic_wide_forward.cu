// K4: fused EPiC forward at the wide widths, one launch for the whole
// encoder. This file's kernel takes every width 128 with a discrete head of
// at most 64; the general kernel (epic_wide_forward_any.cuh, a cluster of
// hidden / 128 blocks a jet, instantiated by epic_wide_forward_h*.cu) every
// other width the JAX wide gate takes up to 512, mixed, and heads up to 512;
// on jets of 129 to 256 slots, at every width, the general kernel as a
// cluster of hidden / 128 × 2 row blocks (epic_wide_forward_h*_r2.cu).
//
// Replaces the TPU kernel multimodal_particles_tpu/ops/epic_pallas_wide.py
// (`epic_forward_pallas_wide`, body `_epic_wide_kernel` / `_forward_acts_wide`):
// input embeddings → EPiC projection → num_blocks EPiC layers → weight-normed
// output → continuous head and SELU discrete head, every feature width 128.
// As the JAX kernel, it also takes the trunks of the other two families at
// these widths: with a non-null `hidden` the same launch writes the trunk's
// last local hidden state (B, N, 128), `output_hidden_local`
// (epic_pallas_wide.py:209-210, :314-316); the discrete head may be wider than
// the vocabulary (the absorbing generator's is 56, :186-189); and with
// `fold_discrete` in the layout the discrete input is the particle's V channel
// values through a Dense, the transdimensional trunk's Linear-discrete
// embedding (:72-80, :124-127), read from `k` as (B, N, V) floats. Each is a
// template instance (epic_wide.cuh, `wide_forward_jet_ext`); the MBM one is
// the token, V-wide-head instance.
//
// What bounds it. With the broadcast thirds of local_0 and fc_local1 taken
// per jet, a particle costs (2 + 2·num_blocks)·128·128 multiply-adds, 0.23 M
// at 6 blocks: 0.48 TFLOP for 8192 jets of 128 particles, against 68 bytes of
// input and output a particle (+ 512 with the hidden output). The bound is
// arithmetic: 7.2 ms in fp32 on the CUDA cores, 2.9 ms as three TF32
// tensor-core products a multiply-add. Beside it sit two costs of the design:
// every block streams the whole packed buffer (4 MB at 6 blocks) from L2 for
// its one jet, three quarters of it for the per-jet global MLP, and 203 KB of
// shared memory leave room for one block of 8 warps per SM, so the per-jet
// serial phases (pooling, the global MLP, the heads) do not overlap products.
//
// Design (epic_wide.cuh, `wide_forward_jet_ext<NoRecord, FOLD, WIDE_HEAD>`):
// fc_local1's particle third and fc_local2 are wgmma products
// (m64n128k8 TF32, a warpgroup a 64-row half of the jet, skipped when the
// half lies past ⌈N/16⌉·16) at fp32 accuracy by the 3×TF32 split
// (tf32x3.cuh): A, the activations, split in registers; W as TF32 hi and lo
// halves that the wide packing lays out in the tensor cores' order once
// (ops/epic_cuda.py::tensor_core_weights), streamed from L2 through a
// ring of eight 8 KB stages by cp.async, six ahead, each product fetching the
// next one's first stages. local_0's particle two thirds are the embeddings'
// inputs times tables the wrapper folds (x·T_x + values·T_k or a token's row
// of T_k + a constant row), so local_0 needs no product. The skip copy h0
// stays in registers, in the place of the thread's accumulators. K5's
// recording forward is the same code with a recorder.
//
// C interface (bound with ctypes by ops/epic_wide_cuda.py): returns the
// cudaError_t of the launch, 0 on success.

#include "epic_wide_forward_any.cuh"

namespace mmpw {

template <bool FOLD, bool WIDE_HEAD>
__global__ void __launch_bounds__(THREADS, 1)
epic_wide_forward_kernel(const float* __restrict__ w, const float* __restrict__ tcw,
                         const float* __restrict__ l0t, Dims d, const float* __restrict__ t,
                         const float* __restrict__ x, const void* __restrict__ k,
                         const float* __restrict__ mask, float* __restrict__ out,
                         float* __restrict__ hidden, int N) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = make_layout(d.num_blocks, d.head_hidden, FOLD);
  const size_t p = (size_t)blockIdx.x * N;
  const int* tokens = FOLD ? nullptr : static_cast<const int*>(k) + p;
  const float* values = FOLD ? static_cast<const float*>(k) + p * V : nullptr;
  wide_forward_jet_ext<NoRecord, FOLD, WIDE_HEAD>(
      w, tcw, l0t, d, L, smem, t[blockIdx.x], x + p * DC, tokens, values, mask + p, N,
      out + p * NOUT, hidden == nullptr ? nullptr : hidden + p * WD, NoRecord());
}

template <bool FOLD, bool WIDE_HEAD>
cudaError_t launch(const void* w, const void* tcw, const void* l0t, const Dims& d, const void* t,
                   const void* x, const void* k, const void* mask, void* out, void* hidden, int B,
                   int N, cudaStream_t stream) {
  auto kernel = epic_wide_forward_kernel<FOLD, WIDE_HEAD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES_TC);
  if (err != cudaSuccess) return err;
  kernel<<<B, THREADS, SMEM_BYTES_TC, stream>>>(
      static_cast<const float*>(w), static_cast<const float*>(tcw), static_cast<const float*>(l0t),
      d, static_cast<const float*>(t), static_cast<const float*>(x), k,
      static_cast<const float*>(mask), static_cast<float*>(out), static_cast<float*>(hidden), N);
  return cudaGetLastError();
}

}  // namespace mmpw

// w: the packed weights; tcw: the tensor-core stages of fc_local1 and fc_local2
// and l0t: local_0's tables (ops/epic_cuda.py::tensor_core_weights), per layer
// and per column block of 128 of the local hidden width H, 16-byte aligned;
// k: (B, N) int tokens, or with fold_discrete (B, N, V) float channel values;
// hidden: (B, N, H) or null; 1 ≤ N ≤ 256. Every width 128 with a head of at
// most 64 takes this file's kernel; every other width the wide gate takes,
// and heads up to 512, take epic_wide_forward_any.cuh's, a cluster of H / 128
// blocks a jet; a jet of more than 128 slots, at every width, the latter's
// cluster of H / 128 × 2 row blocks (epic_wide_forward_h*_r2.cu).
extern "C" int mmp_epic_wide_forward(const void* w, const void* tcw, const void* l0t,
                                     const void* t, const void* x, const void* k,
                                     const void* mask, void* out, void* hidden, int B, int N,
                                     const int* dims, void* stream) {
  using namespace mmpw;
  const Dims d = dims_from(dims);
  if (!any_dims_supported(d, true) || N < 1 || N > MAX_RB * ROWS) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > ROWS) {
    auto launch = d.hidden == 128   ? launch_forward_any<1, 2>
                  : d.hidden == 256 ? launch_forward_any<2, 2>
                  : d.hidden == 384 ? launch_forward_any<3, 2>
                                    : launch_forward_any<4, 2>;
    return launch(w, tcw, l0t, d, t, x, k, mask, out, hidden, B, N, s);
  }
  if (!forward_dims_supported(d)) {
    auto launch = d.hidden == 128   ? launch_forward_any<1>
                  : d.hidden == 256 ? launch_forward_any<2>
                  : d.hidden == 384 ? launch_forward_any<3>
                                    : launch_forward_any<4>;
    return launch(w, tcw, l0t, d, t, x, k, mask, out, hidden, B, N, s);
  }
  const bool wide_head = d.head_hidden != V;
  if (d.fold_discrete)
    return wide_head ? launch<true, true>(w, tcw, l0t, d, t, x, k, mask, out, hidden, B, N, s)
                     : launch<true, false>(w, tcw, l0t, d, t, x, k, mask, out, hidden, B, N, s);
  return wide_head ? launch<false, true>(w, tcw, l0t, d, t, x, k, mask, out, hidden, B, N, s)
                   : launch<false, false>(w, tcw, l0t, d, t, x, k, mask, out, hidden, B, N, s);
}
