// The narrow EPiC forward kernel (K1) and its launch, shared by the two
// sources that instantiate it: epic_forward.cu (tokens as the discrete input)
// and epic_forward_fold.cu (the folded Linear-discrete input). They are two
// sources so that their instantiations compile side by side. epic_forward.cu
// says what the kernel computes, how it is laid out and what bounds it. A
// jet's forward (`forward_jet`) is also the backward kernel's rerun
// (epic_backward.cu), with a recorder of what the backward reads.
#pragma once

#include "narrow_tc.cuh"

namespace mmp {
namespace k1 {

using namespace narrow;

constexpr int MAX_K1_THREADS = 512;  // ⌈256 / 16⌉ warps: a block's slots, at most

// What the kernel is written for: any head width (or none), either discrete
// input, per-jet vectors of any width.
inline bool forward_dims_supported(const Dims& d) {
  return narrow_width(d.hidden) && d.head_hidden >= 1 && d.hidden_glob >= 0 && d.emb_t >= 0 &&
         d.num_blocks >= 0;
}

// Floats before the staged buffer in shared memory: the two pool buffers,
// fc_local1's per-jet term, the jet's time terms, each warp's copy of the
// jet's time embedding and the three global vectors, rounded up to a float4.
__host__ __device__ inline int staged_offset(int nwarps, const Dims& d) {
  const int H = d.hidden;
  return pad4(2 * nwarps * (H + 1) + H + (1 + 2 * d.num_blocks) * H + nwarps * pad4(d.emb_t) +
              3 * d.hidden_glob);
}

// The shared memory of a jet's forward before the staged buffer (its layout:
// `staged_offset`), as each warp addresses it.
struct Scratch {
  float* red;     // two pool buffers of nwarps × (H + 1)
  float* jetv;    // fc_local1's per-jet term (H)
  float* tconst;  // the jet's time terms through g0 and every layer's fg1 and fl1b
  float* temb;    // this warp's copy of the jet's time embedding
  float* gv;      // the global vector g, its skip term and a layer's new g (warp 0's)
  float* gskip;
  float* gnew;
};

__device__ __forceinline__ Scratch scratch(float* red, const Dims& d) {
  const int H = d.hidden, nwarps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int n_time = 1 + 2 * d.num_blocks;
  Scratch S;
  S.red = red;
  S.jetv = red + 2 * nwarps * (H + 1);
  S.tconst = S.jetv + H;
  S.temb = S.tconst + n_time * H + warp * pad4(d.emb_t);
  S.gv = S.tconst + n_time * H + nwarps * pad4(d.emb_t);
  S.gskip = S.gv + d.hidden_glob;
  S.gnew = S.gskip + d.hidden_glob;
  return S;
}

// A recorder receives what the backward kernel (K3, epic_backward.cu) reads
// of a jet's forward; this one, K1's, nothing, and its `ON` keeps the forward
// as K1 computes it. Per particle (each thread its own C fragments): local_0's
// pre-activations, per layer h_in, z_fl1 and z_fl2, the head's
// pre-activations; per jet (warp 0): the pooled sums and the per-jet MLP's
// pre-activations, written where the `*_at` calls point.
struct NoRecord {
  static constexpr bool ON = false;
  __device__ __forceinline__ void z_l0(int, int, float) {}
  template <int NT>
  __device__ __forceinline__ void h_in(int, const float (&)[NT][4]) {}
  template <int NT>
  __device__ __forceinline__ void z_fl1(int, const float (&)[NT][4]) {}
  template <int NT>
  __device__ __forceinline__ void z_fl2(int, const float (&)[NT][4]) {}
  __device__ __forceinline__ void z_h0(int, const float (&)[1][4]) {}
  __device__ __forceinline__ void pooled(int, const LaneVec&, float) {}
  __device__ __forceinline__ void g_in(int, const float*) {}
  __device__ __forceinline__ float* z_g0_at() const { return nullptr; }
  __device__ __forceinline__ float* z_g1_at() const { return nullptr; }
  __device__ __forceinline__ float* z_g2_at() const { return nullptr; }
  __device__ __forceinline__ float* z_fg1_at(int) const { return nullptr; }
  __device__ __forceinline__ float* z_fg2_at(int) const { return nullptr; }
};

// leaky(W·[segments] + b (+ res)) lane-held, as `dense<true>` gives it; a
// recorder that is on gets the pre-activation at `z` first (the same values:
// the activation is applied to the same sum).
template <bool RES, class Rec, class... S>
__device__ __forceinline__ LaneVec leaky_dense(const Rec&, float* z, const float* __restrict__ W,
                                               const float* __restrict__ b, int n_out,
                                               LaneVec res, S... segs) {
  if constexpr (Rec::ON) {
    const LaneVec pre = dense<false, RES>(W, b, n_out, res, segs...);
    lane_store(z, pre, n_out);
    return LaneVec{{leaky(pre.v[0]), leaky(pre.v[1])}};
  } else {
    return dense<true, RES>(W, b, n_out, res, segs...);
  }
}

// out[0, n_out) = leaky(W·[segments] + b (+ res)) as `dense_to<true>` writes
// it; a recorder that is on gets the pre-activation at `z` first.
template <bool RES, class Rec, class... S>
__device__ __forceinline__ void leaky_dense_to(const Rec&, float* z, float* out,
                                               const float* __restrict__ W,
                                               const float* __restrict__ b, int n_out,
                                               const float* res, S... segs) {
  if constexpr (Rec::ON) {
    dense_to<false, RES>(z, W, b, n_out, res, segs...);
    for (int i = threadIdx.x & 31; i < n_out; i += 32) out[i] = leaky(z[i]);
    __syncwarp();
  } else {
    dense_to<true, RES>(out, W, b, n_out, res, segs...);
  }
}

// One jet's forward on the calling warp's 16 particle slots: K1's function.
// Every thread of the block calls it; it synchronises (the pools, across the
// jet's row blocks `rb`) and leaves the scratch in use (the caller's barrier
// frees it for the next jet). `sw`
// is the buffer (staged or global); `swj` its per-jet entries, the first
// `L.l0f` floats (the same buffer, or a copy of them in shared memory).
// FOLD: `k` points at (B, N, V) float channel values, else at (B, N) int
// tokens. `out` and `hidden` may be null. Returns the thread's rows' final
// local state h (C fragments), the masked output layer o (n-tile 0 the
// discrete pre-logits, 1 the continuous outputs) and the rows' masks m.
template <int H, bool FOLD, int RB, class Rec>
__device__ __forceinline__ void forward_jet(const float* sw, const float* swj, const TcLayout& L,
                                            const Dims& d, const Scratch& S,
                                            const RowBlocks<RB>& rb, int jet, int N,
                                            const float* __restrict__ t,
                                            const float* __restrict__ x,
                                            const void* __restrict__ k,
                                            const float* __restrict__ mask,
                                            float* __restrict__ out, float* __restrict__ hidden,
                                            Rec& rec, float (&h)[H / 8][4], float (&o)[2][4],
                                            float (&m)[2]) {
  constexpr int NT = H / 8;  // n-tiles of an H-wide product, and its k-steps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int Hg = d.hidden_glob, Et = d.emb_t, n_time = 1 + 2 * d.num_blocks;
  float* red = S.red;
  float* jetv = S.jetv;
  float* tconst = S.tconst;
  float* temb = S.temb;
  float* gv = S.gv;
  float* gskip = S.gskip;
  float* gnew = S.gnew;
  const int rows[2] = {rb.row0 + 16 * warp + g, rb.row0 + 16 * warp + g + 8};
  const LaneVec none{};
  const size_t p0 = (size_t)jet * N;

  // ---- the jet's time: its sinusoidal embedding [cos | sin], a zero column
  // when E_t is odd (architectures/utils.py:15-34), in each warp's own copy;
  // local_0's time term in every warp, and the terms through g0, fg1 and
  // fl1b spread over the warps, for warp 0's per-jet MLP after the first pool
  {
    const float tj = t[jet];
    const int half = Et / 2;
    for (int i = lane; i < Et; i += 32) {
      float v = 0.f;
      if (i < 2 * half) {
        const int f = i < half ? i : i - half;
        const float freq = expf(-9.210340371976184f * (float)f / (float)half);
        const float arg = tj * freq;
        v = i < half ? cosf(arg) : sinf(arg);
      }
      temb[i] = v;
    }
    __syncwarp();
  }
  const LaneVec ct = dense<false>(swj + L.t0, nullptr, H, none, seg(temb, Et));
  for (int v = warp; v < n_time; v += nwarps) {
    // v = 0: g0's time rows; v = 1 + 2·blk: fg1's, v = 2 + 2·blk: fl1b's
    const float* w = swj + L.g0 + 2 * H * H;
    if (v > 0) {
      const float* wb = swj + L.blocks + ((v - 1) >> 1) * L.block_stride;
      w = (v & 1) ? wb + L.fg1 + (2 * H + Hg) * H : wb + L.fl1b + Hg * H;
    }
    lane_store(tconst + v * H, dense<false>(w, nullptr, H, none, seg(temb, Et)), H);
  }

  // ---- the thread's two rows' inputs as local_0's A fragments: element e
  // holds row e >> 1 at input 2·tq + (e & 1) of [x, 1, 0, 0, 0, 0 | onehot(k)
  // or the channel values]; rows past N are empty slots
  float a[2][4];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const bool real = rows[hr] < N;
    const size_t p = p0 + rows[hr];
    m[hr] = real ? mask[p] : 0.f;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int i = 2 * tq + c;
      a[0][2 * hr + c] = i < DC ? (real ? x[p * DC + i] : 0.f) : (i == DC ? 1.f : 0.f);
    }
    if constexpr (FOLD) {
      const float2 kv = real ? *reinterpret_cast<const float2*>(static_cast<const float*>(k) +
                                                                p * V + 2 * tq)
                             : make_float2(0.f, 0.f);
      a[1][2 * hr] = kv.x;
      a[1][2 * hr + 1] = kv.y;
    } else {
      const int kv = real ? static_cast<const int*>(k)[p] : 0;
      a[1][2 * hr] = kv == 2 * tq ? 1.f : 0.f;
      a[1][2 * hr + 1] = kv == 2 * tq + 1 ? 1.f : 0.f;
    }
  }
  const float mcol[4] = {m[0], m[0], m[1], m[1]};

  // ---- local_0 (epic.py:44-58): the folded 16-deep product, then
  // (· + ct)·m + b: local_0 sees the masked features
  float h0[NT][4];
  {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[j][e] = 0.f;
    product<2, NT>(h, a, reinterpret_cast<const float4*>(sw + L.l0f));
    float ctc[NT][2], bl0[NT][4];
    at_columns<NT>(ctc, ct);
    set_bias<NT>(bl0, sw + L.bl0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float z = (h[j][e] + ctc[j][e & 1]) * mcol[e] + bl0[j][e];
        rec.z_l0(j, e, z);
        h[j][e] = leaky(z) * mcol[e];
        h0[j][e] = d.use_skip ? h[j][e] : 0.f;
      }
  }

  // ---- the projection's global MLP (epic.py:44-58); the first pool's
  // barrier also makes the time terms visible to warp 0
  const Pooled pooled = pool<H, true>(h, tq == 0 ? m[0] + m[1] : 0.f, red, rb);
  const float denom = fmaxf(pooled.msum, 1.f);
  LaneVec s = pooled.s, sm;
  if (warp == 0) {
    rec.pooled(-1, s, denom);
    sm.v[0] = s.v[0] / denom;
    sm.v[1] = s.v[1] / denom;
    const LaneVec a0 = leaky_dense<true>(rec, rec.z_g0_at(), swj + L.g0, swj + L.bg0, H,
                                         lane_load(tconst, H), seg(sm, H), seg(s, H));
    const LaneVec a1 = leaky_dense<false>(rec, rec.z_g1_at(), swj + L.g1, swj + L.bg1, H, none,
                                          seg(a0, H));
    leaky_dense_to<false>(rec, rec.z_g2_at(), gv, swj + L.g2, swj + L.bg2, Hg, nullptr,
                          seg(a1, H));
    for (int i = lane; i < Hg; i += 32) gskip[i] = d.use_skip ? gv[i] : 0.f;
  }

  // ---- EPiC layers (epic.py:61-88)
  for (int blk = 0; blk < d.num_blocks; ++blk) {
    const float* wb = swj + L.blocks + blk * L.block_stride;
    const float* pb = sw + L.pblocks + blk * L.pblock_stride;
    rec.h_in(blk, h);
    s = pool<H, false>(h, 0.f, red + ((blk + 1) & 1) * nwarps * (H + 1), rb).s;
    if (warp == 0) {
      rec.pooled(blk, s, denom);
      rec.g_in(blk, gv);
      sm.v[0] = s.v[0] / denom;
      sm.v[1] = s.v[1] / denom;
      const LaneVec fa = leaky_dense<true>(rec, rec.z_fg1_at(blk), wb + L.fg1, wb + L.bfg1, H,
                                           lane_load(tconst + (1 + 2 * blk) * H, H), seg(sm, H),
                                           seg(s, H), seg(gv, Hg));
      leaky_dense_to<true>(rec, rec.z_fg2_at(blk), gnew, wb + L.fg2, wb + L.bfg2, Hg, gv,
                           seg(fa, H));
      const LaneVec cl1 = dense<false, true>(wb + L.fl1b, wb + L.bfl1, H,
                                             lane_load(tconst + (2 + 2 * blk) * H, H),
                                             seg(gnew, Hg));
      for (int i = lane; i < Hg; i += 32) gv[i] = gnew[i] + gskip[i];
      __syncwarp();
      lane_store(jetv, cl1, H);
    }
    __syncthreads();

    // l1 = leaky(h·W_fl1[0:H] + cl1), the broadcast thirds and bias in cl1
    float l1[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 c = *reinterpret_cast<const float2*>(jetv + 8 * j + 2 * tq);
      l1[j][0] = l1[j][2] = c.x;
      l1[j][1] = l1[j][3] = c.y;
    }
    product<NT, NT>(l1, h, reinterpret_cast<const float4*>(pb + L.fl1f));
    rec.z_fl1(blk, l1);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) l1[j][e] = leaky(l1[j][e]);
    // h ← leaky(h + b + l1·W_fl2)·m + h0: the residual and bias first
    float b2[NT][4];
    set_bias<NT>(b2, pb + L.bfl2);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[j][e] += b2[j][e];
    product<NT, NT>(h, l1, reinterpret_cast<const float4*>(pb + L.fl2f));
    rec.z_fl2(blk, h);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[j][e] = leaky(h[j][e]) * mcol[e] + h0[j][e];
  }

  // ---- weight-normed output + heads (epic.py:122-125, mbm :65-72): n-tile
  // 0 the discrete pre-logits, n-tile 1 the continuous outputs (3 of 8
  // columns), both masked
  set_bias<2>(o, sw + L.bout);
  product<NT, 2>(o, h, reinterpret_cast<const float4*>(sw + L.outf));
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= mcol[e];
  float disc[1][4];
  if (d.add_discrete_head) {
    // Dense(head width) → SELU → Dense(V), 8 hidden units at a time: a tile's
    // SELU output is the second product's k-step of the same index
    const float pre[1][4] = {{o[0][0], o[0][1], o[0][2], o[0][3]}};
    set_bias<1>(disc, sw + L.bh1);
    const int tiles = (d.head_hidden + 7) / 8;
    for (int jt = 0; jt < tiles; ++jt) {
      float z[1][4];
      set_bias<1>(z, sw + L.bh0 + 8 * jt);
      product<1, 1>(z, pre, reinterpret_cast<const float4*>(sw + L.h0f) + jt * 32);
      rec.z_h0(jt, z);
#pragma unroll
      for (int e = 0; e < 4; ++e) z[0][e] = selu(z[0][e]);
      product<1, 1>(disc, z, reinterpret_cast<const float4*>(sw + L.h1f) + jt * 32);
    }
  } else {
    // the second output is the masked pre-logits (epic_pallas.py:288-290)
#pragma unroll
    for (int e = 0; e < 4; ++e) disc[0][e] = o[0][e];
  }

  // ---- out (B, N, 3 + V) and the hidden state (B, N, H): each thread writes
  // its own columns of its two rows
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (rows[hr] >= N) continue;
    const size_t p = p0 + rows[hr];
    if (out != nullptr) {
      float* op = out + p * (DC + V);
      op[DC + 2 * tq] = disc[0][2 * hr];
      op[DC + 2 * tq + 1] = disc[0][2 * hr + 1];
      if (2 * tq < DC) op[2 * tq] = o[1][2 * hr];
      if (2 * tq + 1 < DC) op[2 * tq + 1] = o[1][2 * hr + 1];
    }
    if (hidden != nullptr) {
      float* hp = hidden + p * H + 2 * tq;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        *reinterpret_cast<float2*>(hp + 8 * j) = make_float2(h[j][2 * hr], h[j][2 * hr + 1]);
    }
  }
}

// FOLD: `k` points at (B, N, V) float channel values, else at (B, N) int
// tokens. `hidden` may be null (no hidden output). RB: 1, or 2 for a launch
// in clusters of two blocks a jet (N > 256).
template <int H, int THREADS_MAX, bool FOLD, int RB>
__global__ void __launch_bounds__(THREADS_MAX, (min_blocks<H, THREADS_MAX>()))
epic_forward_kernel(const float* __restrict__ gw, Dims d, const float* __restrict__ t,
                    const float* __restrict__ x, const void* __restrict__ k,
                    const float* __restrict__ mask, float* __restrict__ out,
                    float* __restrict__ hidden, int B, int N, int staged) {
  // two pool buffers of nwarps × (H + 1), fc_local1's per-jet term (H), the
  // jet's time terms, each warp's time embedding, the global vectors, then
  // with `staged` the whole buffer
  extern __shared__ float red[];
  const TcLayout L = make_tc_layout(d);
  const Scratch S = scratch(red, d);
  const float* sw = gw;
  if (staged) {
    float* wsm = red + staged_offset(blockDim.x >> 5, d);
    for (int i = threadIdx.x; i < L.total / 4; i += blockDim.x)
      reinterpret_cast<float4*>(wsm)[i] = __ldg(reinterpret_cast<const float4*>(gw) + i);
    sw = wsm;
  }
  __syncthreads();
  NoRecord rec;
  const RowBlocks<RB> rb = row_blocks<RB>();
  rows_begin(rb);
  // a cluster of row blocks takes a jet: jets by cluster
  for (int jet = blockIdx.x / RB; jet < B; jet += gridDim.x / RB) {
    float h[H / 8][4], o[2][4], m[2];
    forward_jet<H, FOLD>(sw, sw, L, d, S, rb, jet, N, t, x, k, mask, out, hidden, rec, h, o, m);
    __syncthreads();  // the pool, per-jet and time buffers are free for the next jet
  }
  rows_end(rb);
}

template <int H, bool FOLD>
cudaError_t launch_epic_forward(const float* sw, const Dims& d, const float* t, const float* x,
                                const void* k, const float* mask, float* out, float* hidden,
                                int B, int N, cudaStream_t stream) {
  const int rb = row_blocks_for(N), threads = block_threads(N);
  const size_t total = sizeof(float) * make_tc_layout(d).total;
  const int staged = total <= MAX_STAGED_BYTES;
  const size_t smem = sizeof(float) * staged_offset(threads / 32, d) + (staged ? total : 0);
  // the parent's instances at one row block; past 256 slots the cluster's
  auto kernel = rb > 1 ? epic_forward_kernel<H, MAX_K1_THREADS, FOLD, 2>
                : threads <= 256 ? epic_forward_kernel<H, 256, FOLD, 1>
                                 : epic_forward_kernel<H, MAX_K1_THREADS, FOLD, 1>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int blocks;
  if ((err = resident_blocks((const void*)kernel, threads, smem, &blocks, rb)) != cudaSuccess)
    return err;
  // a persistent grid: every block (cluster of row blocks) walks over jets,
  // so a staged buffer is copied once a block and not once a jet
  const int grid = B * rb < blocks ? B * rb : blocks;
  return launch_rows(kernel, grid, threads, smem, rb, stream, sw, d, t, x, k, mask, out, hidden,
                     B, N, staged);
}

}  // namespace k1

// The C entry points' body: the launch at the layout's hidden width. `tcw`
// is the buffer (ops/epic_cuda.py::narrow_buffer).
template <bool FOLD>
cudaError_t epic_forward_entry(const void* tcw, const void* t, const void* x, const void* k,
                               const void* mask, void* out, void* hidden, int B, int N,
                               const int* dims, void* stream) {
  const Dims d = dims_from(dims);
  if (!k1::forward_dims_supported(d) || d.fold_discrete != (FOLD ? 1 : 0) || N < 1 ||
      N > MAX_SLOTS || B < 0)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const auto* sw = static_cast<const float*>(tcw);
  const auto* tf = static_cast<const float*>(t);
  const auto* xf = static_cast<const float*>(x);
  const auto* mf = static_cast<const float*>(mask);
  auto* of = static_cast<float*>(out);
  auto* hf = static_cast<float*>(hidden);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d.hidden) {
    case 16: return k1::launch_epic_forward<16, FOLD>(sw, d, tf, xf, k, mf, of, hf, B, N, s);
    case 32: return k1::launch_epic_forward<32, FOLD>(sw, d, tf, xf, k, mf, of, hf, B, N, s);
    case 48: return k1::launch_epic_forward<48, FOLD>(sw, d, tf, xf, k, mf, of, hf, B, N, s);
    case 64: return k1::launch_epic_forward<64, FOLD>(sw, d, tf, xf, k, mf, of, hf, B, N, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mmp
