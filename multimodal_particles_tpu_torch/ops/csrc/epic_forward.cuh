// The narrow EPiC layout that the narrow kernels share: `Dims` (the C side
// of ops/epic_cuda.py::EpicDims), the packed weights' layout (`Layout`,
// ops/epic_cuda.py::weight_layout: the layout of the weights' gradient that
// the backward kernel K3, epic_backward.cu, writes) and the activations, as
// the JAX kernels share `_forward_acts` (multimodal_particles_tpu/ops/
// epic_pallas.py:183-272). The kernels themselves run their per-particle
// products on the tensor cores (narrow_tc.cuh): K1 (epic_forward_kernel.cuh),
// K2 (sampler_step.cu) and K3, whose recording rerun is K1's forward.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mmp {

constexpr int DC = 3;            // continuous features per particle
constexpr int V = 8;             // token vocabulary
constexpr int MAX_SLOTS = 512;  // particle slots a jet, at most (two row blocks past 256)
// the local hidden widths the kernels are instantiated for; the wrappers
// zero-pad any other width up to 64 to the next (ops/epic_cuda.py)
inline bool narrow_width(int hidden) {
  return hidden == 16 || hidden == 32 || hidden == 48 || hidden == 64;
}

// head_hidden: hidden width of the discrete head's MLP (V for MBM, 56 for the
// absorbing generator). fold_discrete: the discrete input is the particle's V
// channel values through a Dense (the transdimensional trunk's Linear-discrete
// embedding) instead of a token's table row; the layout then holds the
// Dense's bias after the table. The forward kernel (K1) takes any head width
// and the fold; the sampler step (K2) and the backward kernel (K3) are
// written for a head of width V and a token, and refuse anything else.
struct Dims {
  int hidden, hidden_glob, emb_t, emb_x, emb_k, num_blocks, use_skip, add_discrete_head;
  int head_hidden, fold_discrete;
};

inline Dims dims_from(const int* a) {
  return Dims{a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9]};
}

// What K2 and K3 take: the MBM layout.
inline bool token_layout(const Dims& d) { return d.head_hidden == V && d.fold_discrete == 0; }

// Offsets in floats: those before `blocks` absolute, a layer's from the
// start of its block, the heads' from `heads`.
struct Layout {
  int w_x, b_x, table, b_k, w_l0, b_l0, w_g0, b_g0, w_g1, b_g1, w_g2, b_g2;
  int blocks, block_stride;
  int fg1, bfg1, fg2, bfg2, fl1, bfl1, fl2, bfl2;
  int heads;
  int out_c, b_out_c, out_d, b_out_d, h0, b_h0, h1, b_h1;
  int total;
};

__host__ __device__ inline Layout make_layout(const Dims& d) {
  Layout L;
  const int H = d.hidden, Hg = d.hidden_glob, Et = d.emb_t;
  int o = 0;
  L.w_x = o;   o += d.emb_x * DC;
  L.b_x = o;   o += d.emb_x;
  L.table = o; o += V * d.emb_k;
  L.b_k = o;   o += d.fold_discrete ? d.emb_k : 0;  // the folded Dense's bias
  L.w_l0 = o;  o += H * (Et + d.emb_x + d.emb_k);
  L.b_l0 = o;  o += H;
  L.w_g0 = o;  o += H * (2 * H + Et);
  L.b_g0 = o;  o += H;
  L.w_g1 = o;  o += H * H;
  L.b_g1 = o;  o += H;
  L.w_g2 = o;  o += Hg * H;
  L.b_g2 = o;  o += Hg;
  L.blocks = o;
  int b = 0;
  L.fg1 = b;  b += H * (2 * H + Hg + Et);
  L.bfg1 = b; b += H;
  L.fg2 = b;  b += Hg * H;
  L.bfg2 = b; b += Hg;
  L.fl1 = b;  b += H * (H + Hg + Et);
  L.bfl1 = b; b += H;
  L.fl2 = b;  b += H * H;
  L.bfl2 = b; b += H;
  L.block_stride = b;
  o += d.num_blocks * b;
  L.heads = o;
  int h = 0;
  L.out_c = h;   h += DC * H;
  L.b_out_c = h; h += DC;
  L.out_d = h;   h += V * H;
  L.b_out_d = h; h += V;
  L.h0 = h;      h += d.head_hidden * V;
  L.b_h0 = h;    h += d.head_hidden;
  L.h1 = h;      h += V * d.head_hidden;
  L.b_h1 = h;    h += V;
  L.total = o + h;
  return L;
}

__device__ __forceinline__ float leaky(float x) { return x >= 0.f ? x : 0.01f * x; }

__device__ __forceinline__ float selu(float x) {
  const float alpha = 1.6732632423543772f, scale = 1.0507009873554805f;
  return scale * (x > 0.f ? x : alpha * expm1f(x));
}

}  // namespace mmp
