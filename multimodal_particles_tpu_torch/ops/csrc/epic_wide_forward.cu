// K4: fused EPiC forward at hidden 128, one launch for the whole encoder.
//
// Replaces the TPU kernel multimodal_particles_tpu/ops/epic_pallas_wide.py
// (`epic_forward_pallas_wide`, body `_epic_wide_kernel` / `_forward_acts_wide`):
// input embeddings → EPiC projection → num_blocks EPiC layers → weight-normed
// output → continuous head and SELU discrete head, every feature width 128.
//
// What bounds it. With the broadcast thirds of local_0 and fc_local1 taken
// per jet, a particle costs (2 + 2·num_blocks)·128·128 multiply-adds, 0.23 M
// at 6 blocks: 0.48 TFLOP for 8192 jets of 128 particles, against 68 bytes of
// input and output a particle. The bound is fp32 arithmetic on the CUDA
// cores. Below it sit two costs of this first design: every block streams the
// whole packed buffer (4 MB at 6 blocks) from L2 for its one jet, three
// quarters of it for the per-jet global MLP, and 212 KB of activation tiles
// leave room for one block of 8 warps per SM.
//
// C interface (bound with ctypes by ops/epic_wide_cuda.py): returns the
// cudaError_t of the launch, 0 on success.

#include "epic_wide.cuh"

namespace mmpw {

__global__ void __launch_bounds__(THREADS, 1)
epic_wide_forward_kernel(const float* __restrict__ w, Dims d, const float* __restrict__ t,
                         const float* __restrict__ x, const int* __restrict__ k,
                         const float* __restrict__ mask, float* __restrict__ out, int N) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = make_layout(d.num_blocks);
  const size_t p = (size_t)blockIdx.x * N;
  wide_forward_jet(w, d, L, smem, t[blockIdx.x], x + p * DC, k + p, mask + p, N, out + p * NOUT,
                   NoRecord());
}

}  // namespace mmpw

extern "C" int mmp_epic_wide_forward(const void* w, const void* t, const void* x, const void* k,
                                     const void* mask, void* out, int B, int N, const int* dims,
                                     void* stream) {
  using namespace mmpw;
  const Dims d = dims_from(dims);
  if (!dims_supported(d) || N < 1 || N > ROWS) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(epic_wide_forward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  epic_wide_forward_kernel<<<B, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), d, static_cast<const float*>(t), static_cast<const float*>(x),
      static_cast<const int*>(k), static_cast<const float*>(mask), static_cast<float*>(out), N);
  return cudaGetLastError();
}
