// Shared EPiC forward for the hand-written Hopper kernels
// (epic_forward.cu, sampler_step.cu), as the JAX kernels share
// `_forward_acts` (multimodal_particles_tpu/ops/epic_pallas.py:183-272).
//
// Design: one thread block per jet, one thread per particle slot.
//   * A particle's activations (h, the skip copy h0, the local hidden l1)
//     live in registers; the kernel is templated on the hidden width H so
//     that the unrolled loops index them at compile time.
//   * Packed weights are staged into shared memory one section at a time
//     (embedding + projection, each EPiC block, the heads), so the largest
//     stage and not the whole network bounds shared memory: about 9 KB at
//     hidden 16, about 124 KB at hidden 64.
//   * Masked per-jet sums are a warp-shuffle + shared-memory block reduction
//     with the mean's denominator max(Σmask, 1), so empty jets stay finite.
//   * The per-jet global MLP runs on warp 0. Its results reach the particles
//     as per-jet biases: the broadcast global state and context enter
//     fc_local1 through cl1 = W_fl1[:, H:]·[g_new ‖ ctx], computed once per
//     jet; the time embedding enters local_0 through ct = W_l0[:, :E_t]·temb.
//   * The context vector is the time embedding itself (epic_pallas.py:194).
// The buffer layout is ops/epic_cuda.py::weight_layout; make_layout mirrors it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace mmp {

constexpr int DC = 3;            // continuous features per particle
constexpr int V = 8;             // token vocabulary
constexpr int MAX_THREADS = 256; // particle slots per jet (one thread each)

struct Dims {
  int hidden, hidden_glob, emb_t, emb_x, emb_k, num_blocks, use_skip, add_discrete_head;
};

inline Dims dims_from(const int* a) {
  return Dims{a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7]};
}

// Offsets in floats. Stage 0 offsets are absolute; block offsets are from the
// start of a block; head offsets are from `heads`.
struct Layout {
  int w_x, b_x, table, w_l0, b_l0, w_g0, b_g0, w_g1, b_g1, w_g2, b_g2;
  int blocks, block_stride;
  int fg1, bfg1, fg2, bfg2, fl1, bfl1, fl2, bfl2;
  int heads, heads_len;
  int out_c, b_out_c, out_d, b_out_d, h0, b_h0, h1, b_h1;
  int total, max_stage;
};

__host__ __device__ inline Layout make_layout(const Dims& d) {
  Layout L;
  const int H = d.hidden, Hg = d.hidden_glob, Et = d.emb_t;
  int o = 0;
  L.w_x = o;   o += d.emb_x * DC;
  L.b_x = o;   o += d.emb_x;
  L.table = o; o += V * d.emb_k;
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
  L.h0 = h;      h += V * V;
  L.b_h0 = h;    h += V;
  L.h1 = h;      h += V * V;
  L.b_h1 = h;    h += V;
  L.heads_len = h;
  L.total = o + h;
  const int m01 = L.blocks > L.block_stride ? L.blocks : L.block_stride;
  L.max_stage = m01 > L.heads_len ? m01 : L.heads_len;
  return L;
}

// Per-jet scratch after the staged weights: temb, ct, red, pool, a0, a1,
// g, gskip, gnew, cl1.
__host__ __device__ inline int scratch_floats(const Dims& d, int nwarps) {
  const int H = d.hidden, Hg = d.hidden_glob, Et = d.emb_t;
  return 2 * Et + H * (nwarps + 6) + 4 * Hg;
}

inline size_t shared_bytes(const Dims& d, int threads) {
  return sizeof(float) * (size_t)(make_layout(d).max_stage + scratch_floats(d, threads / 32));
}

__device__ __forceinline__ float leaky(float x) { return x >= 0.f ? x : 0.01f * x; }

__device__ __forceinline__ float selu(float x) {
  const float alpha = 1.6732632423543772f, scale = 1.0507009873554805f;
  return scale * (x > 0.f ? x : alpha * expm1f(x));
}

__device__ __forceinline__ void load_stage(float* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
}

// Σ over the block of v; every thread gets the sum. Ends with a barrier.
__device__ __forceinline__ float block_sum_scalar(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nwarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// Masked pooling: s_j = Σ_particles h_j·m; writes pool[j] = s_j / denom and
// pool[H + j] = s_j. Ends with a barrier.
template <int H>
__device__ __forceinline__ void block_pool(const float (&h)[H], float m, float denom,
                                           float* red, float* pool) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    float s = h[j] * m;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp * H + j] = s;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += red[w * H + j];
    pool[j] = s / denom;
    pool[H + j] = s;
  }
  __syncthreads();
}

// Warp 0 only: out[j] = leaky(W[j,:]·x + b[j] (+ res[j])), W (n_out, n_in).
__device__ __forceinline__ void warp_dense(const float* W, const float* b, const float* x,
                                           int n_in, int n_out, const float* res, float* out) {
  const int lane = threadIdx.x & 31;
  for (int j = lane; j < n_out; j += 32) {
    const float* w = W + j * n_in;
    float acc = 0.f;
    for (int i = 0; i < n_in; ++i) acc = fmaf(w[i], x[i], acc);
    acc += b[j];
    if (res != nullptr) acc += res[j];
    out[j] = leaky(acc);
  }
  __syncwarp();
}

// The whole encoder for one particle slot of this block's jet. Every thread
// of the block must call it (it synchronises); slots past the jet's N pass
// m = 0 and contribute nothing to the pooled sums.
//   t    this jet's time
//   x, k, m  the particle's kinematics, token and mask
//   cont (DC) continuous head · mask; disc (V) discrete logits
template <int H>
__device__ void epic_forward_particle(const float* __restrict__ wglob, const Dims& d,
                                      const Layout& L, float* smem, float t,
                                      const float (&x)[DC], int k, float m,
                                      float (&cont)[DC], float (&disc)[V]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const int Hg = d.hidden_glob, Et = d.emb_t, Ex = d.emb_x, Ek = d.emb_k;
  float* sw = smem;
  float* temb = sw + L.max_stage;
  float* ct = temb + Et;
  float* red = ct + H;
  float* pool = red + nwarps * H;
  float* a0 = pool + 2 * H + Hg + Et;
  float* a1 = a0 + H;
  float* g = a1 + H;
  float* gskip = g + Hg;
  float* gnew = gskip + Hg;
  float* cl1 = gnew + Hg;

  // ---- stage 0: input embeddings + EPiC projection (epic.py:44-58)
  load_stage(sw, wglob, L.blocks);
  // sinusoidal time embedding [cos | sin], zero column when E_t is odd
  // (architectures/utils.py:15-34, sampler_pallas.py:42-51)
  const int half = Et / 2;
  for (int i = tid; i < Et; i += blockDim.x) {
    float v = 0.f;
    if (i < 2 * half) {
      const int f = i < half ? i : i - half;
      const float freq = expf(-9.210340371976184f * (float)f / (float)half);
      const float arg = t * freq;
      v = i < half ? cosf(arg) : sinf(arg);
    }
    temb[i] = v;
  }
  const float denom = fmaxf(block_sum_scalar(m, red), 1.f);

  const int n_l0 = Et + Ex + Ek;
  if (warp == 0) {
    for (int j = lane; j < H; j += 32) {
      float acc = 0.f;
      for (int i = 0; i < Et; ++i) acc = fmaf(sw[L.w_l0 + j * n_l0 + i], temb[i], acc);
      ct[j] = acc;
    }
  }
  __syncthreads();

  float h[H];
#pragma unroll
  for (int j = 0; j < H; ++j) h[j] = ct[j];
  for (int i = 0; i < Ex; ++i) {
    float xe = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) xe = fmaf(sw[L.w_x + i * DC + c], x[c], xe);
    xe += sw[L.b_x + i];
    const float* w = sw + L.w_l0 + Et + i;
#pragma unroll
    for (int j = 0; j < H; ++j) h[j] = fmaf(w[j * n_l0], xe, h[j]);
  }
  const bool k_valid = k >= 0 && k < V;
  for (int i = 0; i < Ek; ++i) {
    const float ke = k_valid ? sw[L.table + k * Ek + i] : 0.f;
    const float* w = sw + L.w_l0 + Et + Ex + i;
#pragma unroll
    for (int j = 0; j < H; ++j) h[j] = fmaf(w[j * n_l0], ke, h[j]);
  }
  // local_0 sees the masked features: W·(f·m) + b = (W·f)·m + b
#pragma unroll
  for (int j = 0; j < H; ++j) h[j] = leaky(h[j] * m + sw[L.b_l0 + j]);

  block_pool<H>(h, m, denom, red, pool);
#pragma unroll
  for (int j = 0; j < H; ++j) h[j] *= m;

  if (warp == 0) {
    for (int i = lane; i < Et; i += 32) pool[2 * H + i] = temb[i];
    __syncwarp();
    warp_dense(sw + L.w_g0, sw + L.b_g0, pool, 2 * H + Et, H, nullptr, a0);
    warp_dense(sw + L.w_g1, sw + L.b_g1, a0, H, H, nullptr, a1);
    warp_dense(sw + L.w_g2, sw + L.b_g2, a1, H, Hg, nullptr, g);
    for (int i = lane; i < Hg; i += 32) gskip[i] = d.use_skip ? g[i] : 0.f;
  }
  __syncthreads();

  float h0[H];
#pragma unroll
  for (int j = 0; j < H; ++j) h0[j] = d.use_skip ? h[j] : 0.f;

  // ---- EPiC layers (epic.py:61-88)
  const int n_g1 = 2 * H + Hg + Et, n_l1 = H + Hg + Et;
  for (int blk = 0; blk < d.num_blocks; ++blk) {
    load_stage(sw, wglob + L.blocks + blk * L.block_stride, L.block_stride);
    block_pool<H>(h, m, denom, red, pool);

    if (warp == 0) {
      for (int i = lane; i < Hg; i += 32) pool[2 * H + i] = g[i];
      for (int i = lane; i < Et; i += 32) pool[2 * H + Hg + i] = temb[i];
      __syncwarp();
      warp_dense(sw + L.fg1, sw + L.bfg1, pool, n_g1, H, nullptr, a0);
      warp_dense(sw + L.fg2, sw + L.bfg2, a0, H, Hg, g, gnew);
      for (int j = lane; j < H; j += 32) {
        const float* w = sw + L.fl1 + j * n_l1 + H;
        float acc = 0.f;
        for (int i = 0; i < Hg; ++i) acc = fmaf(w[i], gnew[i], acc);
        for (int i = 0; i < Et; ++i) acc = fmaf(w[Hg + i], temb[i], acc);
        cl1[j] = acc;
      }
      __syncwarp();
      for (int i = lane; i < Hg; i += 32) g[i] = gnew[i] + gskip[i];
    }
    __syncthreads();

    float l1[H];
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float* w = sw + L.fl1 + j * n_l1;
      float acc = cl1[j];
#pragma unroll
      for (int i = 0; i < H; ++i) acc = fmaf(w[i], h[i], acc);
      l1[j] = leaky(acc + sw[L.bfl1 + j]);
    }
#pragma unroll
    for (int j = 0; j < H; ++j) {
      const float* w = sw + L.fl2 + j * H;
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < H; ++i) acc = fmaf(w[i], l1[i], acc);
      h[j] = leaky(acc + sw[L.bfl2 + j] + h[j]) * m + h0[j];
    }
    __syncthreads();  // every thread is done with this block's weights
  }

  // ---- weight-normed output + heads (epic.py:122-125, mbm :65-72)
  load_stage(sw, wglob + L.heads, L.heads_len);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < H; ++i) acc = fmaf(sw[L.out_c + c * H + i], h[i], acc);
    cont[c] = (acc + sw[L.b_out_c + c]) * m;
  }
  float dpre[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < H; ++i) acc = fmaf(sw[L.out_d + v * H + i], h[i], acc);
    dpre[v] = (acc + sw[L.b_out_d + v]) * m;
  }
  if (d.add_discrete_head) {
    float a[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float acc = 0.f;
#pragma unroll
      for (int u = 0; u < V; ++u) acc = fmaf(sw[L.h0 + v * V + u], dpre[u], acc);
      a[v] = selu(acc + sw[L.b_h0 + v]);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float acc = 0.f;
#pragma unroll
      for (int u = 0; u < V; ++u) acc = fmaf(sw[L.h1 + v * V + u], a[u], acc);
      disc[v] = acc + sw[L.b_h1 + v];
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) disc[v] = dpre[v];
  }
}

// Validates the launch and sets the kernel's dynamic shared memory limit.
template <typename Kernel>
inline cudaError_t prepare_launch(Kernel kernel, const Dims& d, int N, int* threads, size_t* smem) {
  if (N < 1 || N > MAX_THREADS) return cudaErrorInvalidValue;
  *threads = (N + 31) / 32 * 32;
  *smem = shared_bytes(d, *threads);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

}  // namespace mmp
