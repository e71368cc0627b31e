// K1: fused EPiC forward, one launch for the whole encoder.
//
// Replaces the TPU kernel multimodal_particles_tpu/ops/epic_pallas.py
// (`epic_forward_pallas`, body `_epic_kernel` / `_forward_acts`): input
// embeddings → EPiC projection → num_blocks EPiC layers → weight-normed
// output → continuous head and SELU discrete head.
//
// What bounds it. At config-berlin (hidden 16, 2 blocks, N = 128) the
// encoder is about 3.2k multiply-adds, some 6 kFLOP, per particle. Written
// as separate PyTorch operators, each of its ~40 steps reads and writes
// (B·N, 16..48) float32 activations in device memory, so the plain version
// is bound by memory traffic and by the count of launches, not by FLOPs.
// This kernel keeps every activation on chip: a thread holds its particle's
// activations in registers, the block holds the per-jet pooled state and the
// weights in shared memory, and device memory sees only the inputs (t, x, k,
// mask: 24 bytes a particle), the 44-byte output and the weights, which
// every block stages from L2 (about 30 KB a jet at config-berlin). What is
// left is fp32 arithmetic, plus that weight traffic from L2.
//
// C interface (bound with ctypes by ops/epic_cuda.py): returns the
// cudaError_t of the launch, 0 on success.

#include "epic_forward.cuh"

namespace mmp {

template <int H>
__global__ void __launch_bounds__(MAX_THREADS)
epic_forward_kernel(const float* __restrict__ w, Dims d, const float* __restrict__ t,
                    const float* __restrict__ x, const int* __restrict__ k,
                    const float* __restrict__ mask, float* __restrict__ out, int N) {
  extern __shared__ float smem[];
  const Layout L = make_layout(d);
  const int jet = blockIdx.x, slot = threadIdx.x;
  const bool active = slot < N;
  const size_t p = (size_t)jet * N + slot;

  float xv[DC] = {0.f, 0.f, 0.f};
  int kv = 0;
  float m = 0.f;
  if (active) {
#pragma unroll
    for (int c = 0; c < DC; ++c) xv[c] = x[p * DC + c];
    kv = k[p];
    m = mask[p];
  }
  float cont[DC], disc[V];
  epic_forward_particle<H>(w, d, L, smem, t[jet], xv, kv, m, cont, disc);
  if (active) {
    float* o = out + p * (DC + V);
#pragma unroll
    for (int c = 0; c < DC; ++c) o[c] = cont[c];
#pragma unroll
    for (int v = 0; v < V; ++v) o[DC + v] = disc[v];
  }
}

template <int H>
cudaError_t launch_epic_forward(const float* w, const Dims& d, const float* t, const float* x,
                                const int* k, const float* mask, float* out, int B, int N,
                                cudaStream_t stream) {
  int threads;
  size_t smem;
  cudaError_t err = prepare_launch(epic_forward_kernel<H>, d, N, &threads, &smem);
  if (err != cudaSuccess) return err;
  epic_forward_kernel<H><<<B, threads, smem, stream>>>(w, d, t, x, k, mask, out, N);
  return cudaGetLastError();
}

}  // namespace mmp

extern "C" int mmp_epic_forward(const void* w, const void* t, const void* x, const void* k,
                                const void* mask, void* out, int B, int N, const int* dims,
                                void* stream) {
  using namespace mmp;
  const Dims d = dims_from(dims);
  if (B == 0) return cudaSuccess;
  const auto* wf = static_cast<const float*>(w);
  const auto* tf = static_cast<const float*>(t);
  const auto* xf = static_cast<const float*>(x);
  const auto* ki = static_cast<const int*>(k);
  const auto* mf = static_cast<const float*>(mask);
  auto* of = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d.hidden) {
    case 16: return launch_epic_forward<16>(wf, d, tf, xf, ki, mf, of, B, N, s);
    case 32: return launch_epic_forward<32>(wf, d, tf, xf, ki, mf, of, B, N, s);
    case 64: return launch_epic_forward<64>(wf, d, tf, xf, ki, mf, of, B, N, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* mmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
