// K2: one whole MBM sampler step in one launch.
//
// Replaces the TPU kernel multimodal_particles_tpu/ops/sampler_pallas.py
// (`make_fused_sampler_step`, body `_step_kernel` / `_step_math`): time
// embedding from the scalar t → the shared EPiC forward (epic_forward.cuh)
// → Euler update x ← (x + dt·cont)·mask → telegraph single-jump token
// update, all in the thread that owns the particle.
//
// What bounds it. The 100-step sampler calls this 99 times; per step the
// encoder is some 6 kFLOP a particle at config-berlin (hidden 16, 2 blocks,
// N = 128). As separate PyTorch operators a step is some 60 launches that
// each move (B·N, 16..48) float32 activations through device memory, so the
// plain version is bound by launch count (small B) and memory traffic
// (large B), not by FLOPs. Here one launch per step reads x, k, mask and the
// two uniforms (28 bytes a particle) and writes x', k' (16 bytes); every
// activation stays in registers or shared memory, and only the weights are
// re-read, from L2, by each jet's block. What is left is fp32 arithmetic.
//
// The telegraph rate divides by 1 − w, w = exp(−Sγ(1−t)), which is about
// 1e-4 at the last step: w is computed with expf as sampler_pallas.py:82-83
// does, and the library is built without fast-math, so jump decisions follow
// the plain version.

#include "epic_forward.cuh"

namespace mmp {

template <int H>
__global__ void __launch_bounds__(MAX_THREADS)
sampler_step_kernel(const float* __restrict__ w, Dims d, const float* __restrict__ x,
                    const int* __restrict__ k, const float* __restrict__ mask,
                    const float* __restrict__ u, float* __restrict__ x_out,
                    int* __restrict__ k_out, float t, float dt, float gamma, int B, int N) {
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
  float cont[DC], logits[V];
  epic_forward_particle<H>(w, d, L, smem, t, xv, kv, m, cont, logits);
  if (!active) return;

  // Euler ODE step (bridges.py:382-395)
#pragma unroll
  for (int c = 0; c < DC; ++c) x_out[p * DC + c] = (xv[c] + dt * cont[c]) * m;

  // telegraph single-jump update (bridges.py:205-244, sampler_pallas.py:73-100)
  float mx = logits[0];
#pragma unroll
  for (int v = 1; v < V; ++v) mx = fmaxf(mx, logits[v]);
  float q[V], se = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    q[v] = expf(logits[v] - mx);
    se += q[v];
  }
  float qy = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    q[v] = q[v] / se;
    qy += v == kv ? q[v] : 0.f;
  }
  const float S = (float)V;
  const float wt = expf(-S * gamma * (1.0f - t));
  const float coef = (wt * S) / (1.0f - wt);
  float lam[V], lam_total = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    lam[v] = (1.0f + coef * q[v] + wt * qy) * dt;
    lam_total += lam[v];
  }
  const bool do_jump = u[p] < lam_total * expf(-lam_total);
  const float u2 = u[(size_t)B * N + p] * lam_total;
  int target = 0;
  float cdf = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    cdf += lam[v];
    target += u2 >= cdf ? 1 : 0;
  }
  target = min(max(target, 0), V - 1);
  k_out[p] = (do_jump ? target : kv) * (int)m;
}

template <int H>
cudaError_t launch_sampler_step(const float* w, const Dims& d, const float* x, const int* k,
                                const float* mask, const float* u, float* x_out, int* k_out,
                                float t, float dt, float gamma, int B, int N,
                                cudaStream_t stream) {
  int threads;
  size_t smem;
  cudaError_t err = prepare_launch(sampler_step_kernel<H>, d, N, &threads, &smem);
  if (err != cudaSuccess) return err;
  sampler_step_kernel<H><<<B, threads, smem, stream>>>(w, d, x, k, mask, u, x_out, k_out, t, dt,
                                                       gamma, B, N);
  return cudaGetLastError();
}

}  // namespace mmp

extern "C" int mmp_sampler_step(const void* w, const void* x, const void* k, const void* mask,
                                const void* u, void* x_out, void* k_out, float t, float dt,
                                float gamma, int B, int N, const int* dims, void* stream) {
  using namespace mmp;
  const Dims d = dims_from(dims);
  if (B == 0) return cudaSuccess;
  const auto* wf = static_cast<const float*>(w);
  const auto* xf = static_cast<const float*>(x);
  const auto* ki = static_cast<const int*>(k);
  const auto* mf = static_cast<const float*>(mask);
  const auto* uf = static_cast<const float*>(u);
  auto* xo = static_cast<float*>(x_out);
  auto* ko = static_cast<int*>(k_out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d.hidden) {
    case 16: return launch_sampler_step<16>(wf, d, xf, ki, mf, uf, xo, ko, t, dt, gamma, B, N, s);
    case 32: return launch_sampler_step<32>(wf, d, xf, ki, mf, uf, xo, ko, t, dt, gamma, B, N, s);
    case 64: return launch_sampler_step<64>(wf, d, xf, ki, mf, uf, xo, ko, t, dt, gamma, B, N, s);
    default: return cudaErrorInvalidValue;
  }
}
