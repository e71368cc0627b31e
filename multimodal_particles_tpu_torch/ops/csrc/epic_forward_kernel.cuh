// The narrow EPiC forward kernel and its launch, shared by the two sources
// that instantiate it: epic_forward.cu (tokens as the discrete input) and
// epic_forward_fold.cu (the folded Linear-discrete input). They are two
// sources so that their instantiations compile side by side.
#pragma once

#include "epic_forward.cuh"

namespace mmp {

// Writes the particle's final hidden state to its row of (B, N, H).
template <int H>
struct HiddenOut {
  float* row;  // null: the slot is past the jet's N, or no hidden output is asked for
  __device__ __forceinline__ void z_l0(int, float) const {}
  __device__ __forceinline__ void h_in(int, int, float) const {}
  __device__ __forceinline__ void z_fl1(int, int, float) const {}
  __device__ __forceinline__ void z_fl2(int, int, float) const {}
  __device__ __forceinline__ void h_final(int j, float v) const {
    if (row != nullptr) row[j] = v;
  }
  __device__ __forceinline__ void disc_pre(int, float) const {}
  __device__ __forceinline__ void z_h0(int, float) const {}
  __device__ __forceinline__ void p0(int, float) const {}
  __device__ __forceinline__ void p(int, int, float) const {}
};

// FOLD: `k` points at (B, N, V) float channel values, else at (B, N) int tokens.
template <int H, bool FOLD>
__global__ void __launch_bounds__(MAX_THREADS)
epic_forward_kernel(const float* __restrict__ w, Dims d, const float* __restrict__ t,
                    const float* __restrict__ x, const void* __restrict__ k,
                    const float* __restrict__ mask, float* __restrict__ out,
                    float* __restrict__ hidden, int N) {
  extern __shared__ float smem[];
  const Layout L = make_layout(d);
  const int jet = blockIdx.x, slot = threadIdx.x;
  const bool active = slot < N;
  const size_t p = (size_t)jet * N + slot;

  float xv[DC] = {0.f, 0.f, 0.f};
  int kv = 0;
  float kvals[V];
#pragma unroll
  for (int v = 0; v < V; ++v) kvals[v] = 0.f;
  float m = 0.f;
  if (active) {
#pragma unroll
    for (int c = 0; c < DC; ++c) xv[c] = x[p * DC + c];
    if constexpr (FOLD) {
      const float4* kf = reinterpret_cast<const float4*>(static_cast<const float*>(k) + p * V);
      const float4 lo = kf[0], hi = kf[1];
      kvals[0] = lo.x; kvals[1] = lo.y; kvals[2] = lo.z; kvals[3] = lo.w;
      kvals[4] = hi.x; kvals[5] = hi.y; kvals[6] = hi.z; kvals[7] = hi.w;
    } else {
      kv = static_cast<const int*>(k)[p];
    }
    m = mask[p];
  }
  float cont[DC], disc[V];
  const HiddenOut<H> rec{active && hidden != nullptr ? hidden + p * H : nullptr};
  epic_forward_particle<H, HiddenOut<H>, FOLD>(w, d, L, smem, t[jet], xv, kv, m, cont, disc, rec,
                                               kvals);
  if (active) {
    float* o = out + p * (DC + V);
#pragma unroll
    for (int c = 0; c < DC; ++c) o[c] = cont[c];
#pragma unroll
    for (int v = 0; v < V; ++v) o[DC + v] = disc[v];
  }
}

template <int H, bool FOLD>
cudaError_t launch_epic_forward(const float* w, const Dims& d, const float* t, const float* x,
                                   const void* k, const float* mask, float* out, float* hidden,
                                   int B, int N, cudaStream_t stream) {
  int threads;
  size_t smem;
  cudaError_t err = prepare_launch(epic_forward_kernel<H, FOLD>, d, N, &threads, &smem);
  if (err != cudaSuccess) return err;
  epic_forward_kernel<H, FOLD><<<B, threads, smem, stream>>>(w, d, t, x, k, mask, out, hidden, N);
  return cudaGetLastError();
}

// The C entry points' body: the launch at the layout's hidden width.
template <bool FOLD>
cudaError_t epic_forward_entry(const void* w, const void* t, const void* x, const void* k,
                               const void* mask, void* out, void* hidden, int B, int N,
                               const int* dims, void* stream) {
  const Dims d = dims_from(dims);
  if (d.head_hidden < 1 || d.fold_discrete != (FOLD ? 1 : 0)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const auto* wf = static_cast<const float*>(w);
  const auto* tf = static_cast<const float*>(t);
  const auto* xf = static_cast<const float*>(x);
  const auto* mf = static_cast<const float*>(mask);
  auto* of = static_cast<float*>(out);
  auto* hf = static_cast<float*>(hidden);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d.hidden) {
    case 16: return launch_epic_forward<16, FOLD>(wf, d, tf, xf, k, mf, of, hf, B, N, s);
    case 32: return launch_epic_forward<32, FOLD>(wf, d, tf, xf, k, mf, of, hf, B, N, s);
    case 64: return launch_epic_forward<64, FOLD>(wf, d, tf, xf, k, mf, of, hf, B, N, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mmp

