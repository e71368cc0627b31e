// K2: one whole MBM sampler step in one launch, its per-particle products on
// the tensor cores.
//
// Replaces the TPU kernel multimodal_particles_tpu/ops/sampler_pallas.py
// (`make_fused_sampler_step`, body `_step_kernel` / `_step_math`, :54-101):
// time embedding from the scalar t → EPiC forward → Euler update
// x ← (x + dt·cont)·mask → telegraph single-jump token update.
//
// Design. A persistent grid (as many blocks as fit on the SMs, each walking
// over jets); a block of one warp per 16 particle slots (⌈N/16⌉ warps).
//   * A warp's 16 rows go through every per-particle product as
//     mma.sync.m16n8k8 TF32 products under the 3×TF32 split (tf32x3.cuh):
//     local_0's particle part, fc_local1's particle third and fc_local2 of
//     every EPiC layer, the output layer (discrete and continuous columns as
//     two 8-wide n-tiles) and the 8 → 8 → 8 discrete head. A product's
//     accumulator is the next one's A fragment as it stands: a thread holds
//     columns 2t and 2t + 1 of each 8-column n-tile, and the wrapper lays each
//     weight's k-step out so that the mma's k positions t and t + 4 read the
//     inputs 2t and 2t + 1 (ops/epic_cuda.py::narrow_buffer). The products
//     add into registers that already hold the bias and, for fc_local2, the
//     residual; the split's two small products go to sums of their own, so
//     that twice as many mma chains are in flight; activations are applied in
//     place.
//   * local_0's particle two thirds are folded with the x and token
//     embeddings by the wrapper: one 16-deep product of [x, 1, 0…, onehot(k)]
//     with [T_x; c; 0; T_k] (c: x's embedding bias through local_0).
//   * The buffer (≈ 35 KB at config-berlin; ops/epic_cuda.py::narrow_buffer,
//     the one K1 reads too) is staged into shared memory once a block, and
//     read from there; a buffer over 64 KB (hidden 64, or deep) is read
//     through L1 instead. The per-warp machinery (products, pools, the
//     per-jet dense layers, the buffer's layout) is narrow_tc.cuh, shared
//     with K1.
//   * The per-jet MLP (the global MLP, fc_local1's broadcast thirds) runs on
//     warp 0, its weights laid out (in, out) so that a lane reads its
//     output's column; the H-wide vectors are lane-held, the global vector g
//     and the time embedding (any width) sit in shared memory, and a layer
//     of g's width is computed 64 columns at a time. The time embedding's
//     terms through local_0, g0, fg1 and fl1 are the same for every jet of a
//     step (t is one scalar) and are computed once a block. A masked pool is a warp's
//     partial column sums into shared memory and one barrier; fc_local1's
//     per-jet term reaches the other warps through shared memory after a
//     second. A jet takes 1 + 2·num_blocks barriers.
//   * The telegraph update runs in two lanes of each quad, one row each,
//     after the quad's logits are gathered by shuffles; it uses expf without
//     fast-math: at the last step w ≈ 1e-4 and the rate divides by 1 − w, so
//     jump decisions must follow the plain version's accurate exponential.
//
// What bounds it. At config-berlin (hidden 16, 2 blocks, N = 128) the
// function needs 1,384 multiply-adds a particle in the per-particle
// products (local_0's particle part folded, 3·H + H/2; 2·H² a layer; the
// output layer's 11 columns; the head), 8.3 kFLOP on the tensor cores as
// three TF32 products; the kernel runs them padded (local_0 16 deep, the
// output layer 16 columns: 1,664 multiply-adds, 78 mma.sync a warp of 16
// particles). It reads x, k, mask and the two uniforms (28 bytes a
// particle) and writes x', k' (16 bytes). At B = 32768 the bytes bound it
// at 0.055 ms and the needed products on the tensor cores at 0.070 ms
// (chip_smoke.py's products-only bound). What the kernel spends
// (scripts/k2_variants.py on an H100, PERF.md §5) is each jet's chain of
// dependent steps: ≈ 40% the per-jet MLP on warp 0, while the block's other
// warps wait at a barrier, ≈ 30% the products' mma chains, the rest the
// pools, the loads and the telegraph update; four blocks an SM (a register
// bound) hide part of it.

#include "narrow_tc.cuh"

namespace mmp {
namespace k2 {

using namespace narrow;

constexpr int MAX_K2_THREADS = 512;  // ⌈256 / 16⌉ warps

// What the kernel is written for: a token input and a V-wide head (as every
// narrow kernel but the forward).
inline bool sampler_dims_supported(const Dims& d) {
  return token_layout(d) && (d.hidden == 16 || d.hidden == 32 || d.hidden == 64) &&
         d.hidden_glob >= 0 && d.emb_t >= 0 && d.num_blocks >= 0;
}

// Floats before the staged buffer in shared memory: the pool buffers, the
// per-jet term, the per-launch time terms, the time embedding and the three
// global vectors, rounded up to a float4.
__host__ __device__ inline int staged_offset(int nwarps, const Dims& d) {
  const int H = d.hidden;
  return pad4(2 * nwarps * (H + 1) + H + (1 + 2 * d.num_blocks) * H + d.emb_t +
              3 * d.hidden_glob);
}


template <int H, int THREADS_MAX>
__global__ void __launch_bounds__(THREADS_MAX, (min_blocks<H, THREADS_MAX>()))
sampler_step_kernel(const float* __restrict__ gw, Dims d, const float* __restrict__ x,
                    const int* __restrict__ k, const float* __restrict__ mask,
                    const float* __restrict__ u, float* __restrict__ x_out,
                    int* __restrict__ k_out, float t, float dt, float gamma, int B, int N,
                    int staged) {
  constexpr int NT = H / 8;  // n-tiles of an H-wide product, and its k-steps
  // two pool buffers of nwarps × (H + 1), fc_local1's per-jet term (H), the
  // time terms, the time embedding, the global vectors, then with `staged`
  // the whole buffer
  extern __shared__ float red[];
  const TcLayout L = make_tc_layout(d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int Hg = d.hidden_glob, Et = d.emb_t;
  float* jetv = red + 2 * nwarps * (H + 1);
  // the time embedding's terms through g0 and every layer's fg1 and fl1b:
  // the same for every jet of the launch (t is one scalar a step)
  float* tconst = jetv + H;
  float* temb = tconst + (1 + 2 * d.num_blocks) * H;
  // the global vector g, its skip term and a layer's new g (warp 0's)
  float* gv = temb + Et;
  float* gskip = gv + Hg;
  float* gnew = gskip + Hg;
  // sinusoidal time embedding [cos | sin] (architectures/utils.py:15-34)
  {
    const int half = Et / 2;
    for (int i = threadIdx.x; i < Et; i += blockDim.x) {
      float v = 0.f;
      if (i < 2 * half) {
        const int f = i < half ? i : i - half;
        const float freq = expf(-9.210340371976184f * (float)f / (float)half);
        const float arg = t * freq;
        v = i < half ? cosf(arg) : sinf(arg);
      }
      temb[i] = v;
    }
  }
  const float* sw = gw;
  if (staged) {
    float* wsm = red + staged_offset(nwarps, d);
    for (int i = threadIdx.x; i < L.total / 4; i += blockDim.x)
      reinterpret_cast<float4*>(wsm)[i] = __ldg(reinterpret_cast<const float4*>(gw) + i);
    sw = wsm;
  }
  __syncthreads();
  const int rows[2] = {16 * warp + g, 16 * warp + g + 8};

  // local_0's time third, the same for every particle of every jet (t is one
  // scalar a step)
  const LaneVec none{};
  const LaneVec ct = dense<false>(sw + L.t0, nullptr, H, none, seg(temb, Et));
  if (warp == 0) {
    lane_store(tconst, dense<false>(sw + L.g0 + 2 * H * H, nullptr, H, none, seg(temb, Et)), H);
    for (int blk = 0; blk < d.num_blocks; ++blk) {
      const float* wb = sw + L.blocks + blk * L.block_stride;
      lane_store(tconst + (1 + 2 * blk) * H,
                 dense<false>(wb + L.fg1 + (2 * H + Hg) * H, nullptr, H, none, seg(temb, Et)), H);
      lane_store(tconst + (2 + 2 * blk) * H,
                 dense<false>(wb + L.fl1b + Hg * H, nullptr, H, none, seg(temb, Et)), H);
    }
    __syncwarp();
  }


  for (int jet = blockIdx.x; jet < B; jet += gridDim.x) {
  const size_t p0 = (size_t)jet * N;
  // the thread's two rows' inputs; rows past N are empty slots
  float xv[2][DC], m[2];
  int kv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const bool real = rows[hr] < N;
    const size_t p = p0 + rows[hr];
#pragma unroll
    for (int c = 0; c < DC; ++c) xv[hr][c] = real ? x[p * DC + c] : 0.f;
    kv[hr] = real ? k[p] : 0;
    m[hr] = real ? mask[p] : 0.f;
  }
  const float mcol[4] = {m[0], m[0], m[1], m[1]};

  // ---- local_0 (epic.py:44-58): [x, 1, 0, 0, 0, 0 | onehot(k)]·[T_x; c; 0; T_k],
  // then (· + ct)·m + b: local_0 sees the masked features
  float h[NT][4], h0[NT][4];
  {
    float a[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1, i = 2 * tq + (e & 1);  // the row and input this element holds
      a[0][e] = i < DC ? xv[hr][i] : (i == DC ? 1.f : 0.f);
      a[1][e] = kv[hr] == i ? 1.f : 0.f;
    }
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
        h[j][e] = leaky((h[j][e] + ctc[j][e & 1]) * mcol[e] + bl0[j][e]) * mcol[e];
        h0[j][e] = d.use_skip ? h[j][e] : 0.f;
      }
  }

  // ---- the projection's global MLP (epic.py:44-58)
  const Pooled pooled = pool<H, true>(h, tq == 0 ? m[0] + m[1] : 0.f, red);
  const float denom = fmaxf(pooled.msum, 1.f);
  LaneVec s = pooled.s, sm;
  if (warp == 0) {
    sm.v[0] = s.v[0] / denom;
    sm.v[1] = s.v[1] / denom;
    const LaneVec a0 = dense<true, true>(sw + L.g0, sw + L.bg0, H, lane_load(tconst, H),
                                         seg(sm, H), seg(s, H));
    const LaneVec a1 = dense<true>(sw + L.g1, sw + L.bg1, H, none, seg(a0, H));
    dense_to<true>(gv, sw + L.g2, sw + L.bg2, Hg, nullptr, seg(a1, H));
    for (int i = lane; i < Hg; i += 32) gskip[i] = d.use_skip ? gv[i] : 0.f;
  }

  // ---- EPiC layers (epic.py:61-88)
  for (int blk = 0; blk < d.num_blocks; ++blk) {
    const float* wb = sw + L.blocks + blk * L.block_stride;
    const float* pb = sw + L.pblocks + blk * L.pblock_stride;
    s = pool<H, false>(h, 0.f, red + ((blk + 1) & 1) * nwarps * (H + 1)).s;
    if (warp == 0) {
      sm.v[0] = s.v[0] / denom;
      sm.v[1] = s.v[1] / denom;
      const LaneVec fa = dense<true, true>(wb + L.fg1, wb + L.bfg1, H,
                                           lane_load(tconst + (1 + 2 * blk) * H, H), seg(sm, H),
                                           seg(s, H), seg(gv, Hg));
      dense_to<true, true>(gnew, wb + L.fg2, wb + L.bfg2, Hg, gv, seg(fa, H));
      const LaneVec cl1 = dense<false, true>(wb + L.fl1b, wb + L.bfl1, H,
                                             lane_load(tconst + (2 + 2 * blk) * H, H),
                                             seg(gnew, Hg));
      for (int i = lane; i < Hg; i += 32) gv[i] = gnew[i] + gskip[i];
      __syncwarp();
      if (lane < H) jetv[lane] = cl1.v[0];
      if (lane + 32 < H) jetv[32 + lane] = cl1.v[1];
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
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[j][e] = leaky(h[j][e]) * mcol[e] + h0[j][e];
  }

  // ---- weight-normed output + heads (epic.py:122-125, mbm :65-72): n-tile
  // 0 the discrete pre-logits, n-tile 1 the continuous outputs (3 of 8
  // columns), both masked
  float o[2][4];
  set_bias<2>(o, sw + L.bout);
  product<NT, 2>(o, h, reinterpret_cast<const float4*>(sw + L.outf));
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= mcol[e];
  float disc[1][4];
  if (d.add_discrete_head) {
    // Dense(V) → SELU → Dense(V)
    float z[1][4];
    set_bias<1>(z, sw + L.bh0);
    const float pre[1][4] = {{o[0][0], o[0][1], o[0][2], o[0][3]}};
    product<1, 1>(z, pre, reinterpret_cast<const float4*>(sw + L.h0f));
#pragma unroll
    for (int e = 0; e < 4; ++e) z[0][e] = selu(z[0][e]);
    set_bias<1>(disc, sw + L.bh1);
    product<1, 1>(disc, z, reinterpret_cast<const float4*>(sw + L.h1f));
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) disc[0][e] = o[0][e];
  }

  // ---- the quad's rows: lane tq = 0 takes row g, tq = 1 row g + 8
  float logits[V], cont[DC];
  const int mine = tq & 1;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int src = 4 * g + q;
    const float r0a = __shfl_sync(FULL, disc[0][0], src), r0b = __shfl_sync(FULL, disc[0][1], src);
    const float r1a = __shfl_sync(FULL, disc[0][2], src), r1b = __shfl_sync(FULL, disc[0][3], src);
    logits[2 * q] = mine ? r1a : r0a;
    logits[2 * q + 1] = mine ? r1b : r0b;
  }
  {
    // the continuous columns 0, 1 in lane 4g, column 2 in lane 4g + 1
    const float r0c0 = __shfl_sync(FULL, o[1][0], 4 * g), r1c0 = __shfl_sync(FULL, o[1][2], 4 * g);
    const float r0c1 = __shfl_sync(FULL, o[1][1], 4 * g), r1c1 = __shfl_sync(FULL, o[1][3], 4 * g);
    const float r0c2 = __shfl_sync(FULL, o[1][0], 4 * g + 1);
    const float r1c2 = __shfl_sync(FULL, o[1][2], 4 * g + 1);
    cont[0] = mine ? r1c0 : r0c0;
    cont[1] = mine ? r1c1 : r0c1;
    cont[2] = mine ? r1c2 : r0c2;
  }
  const int row = mine ? rows[1] : rows[0];
  if (tq < 2 && row < N) {
  const size_t p = p0 + row;
  const float mr = mine ? m[1] : m[0];
  const int kr = mine ? kv[1] : kv[0];

  // Euler ODE step (bridges.py:382-395)
#pragma unroll
  for (int c = 0; c < DC; ++c)
    x_out[p * DC + c] = ((mine ? xv[1][c] : xv[0][c]) + dt * cont[c]) * mr;

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
    qy += v == kr ? q[v] : 0.f;
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
  k_out[p] = (do_jump ? target : kr) * (int)mr;
  }
  __syncthreads();  // the pool and per-jet buffers are free for the next jet
  }
}

template <int H>
cudaError_t launch_sampler_step(const float* sw, const Dims& d, const float* x, const int* k,
                                const float* mask, const float* u, float* x_out, int* k_out,
                                float t, float dt, float gamma, int B, int N,
                                cudaStream_t stream) {
  const int threads = 32 * ((N + 15) / 16);
  const size_t total = sizeof(float) * make_tc_layout(d).total;
  const int staged = total <= MAX_STAGED_BYTES;
  const size_t smem =
      sizeof(float) * staged_offset(threads / 32, d) + (staged ? total : 0);
  auto kernel = threads <= 256 ? sampler_step_kernel<H, 256> : sampler_step_kernel<H, MAX_K2_THREADS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int blocks;
  if ((err = resident_blocks((const void*)kernel, threads, smem, &blocks)) != cudaSuccess) return err;
  // a persistent grid: every block walks over jets, so a staged buffer is
  // copied once a block and not once a jet
  const int grid = B < blocks ? B : blocks;
  kernel<<<grid, threads, smem, stream>>>(sw, d, x, k, mask, u, x_out, k_out, t, dt, gamma, B, N,
                                          staged);
  return cudaGetLastError();
}

}  // namespace k2
}  // namespace mmp

extern "C" int mmp_sampler_step(const void* tcw, const void* x, const void* k, const void* mask,
                                const void* u, void* x_out, void* k_out, float t, float dt,
                                float gamma, int B, int N, const int* dims, void* stream) {
  using namespace mmp;
  const Dims d = dims_from(dims);
  if (!k2::sampler_dims_supported(d) || N < 1 || N > MAX_THREADS) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const auto* sw = static_cast<const float*>(tcw);
  const auto* xf = static_cast<const float*>(x);
  const auto* ki = static_cast<const int*>(k);
  const auto* mf = static_cast<const float*>(mask);
  const auto* uf = static_cast<const float*>(u);
  auto* xo = static_cast<float*>(x_out);
  auto* ko = static_cast<int*>(k_out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d.hidden) {
    case 16: return k2::launch_sampler_step<16>(sw, d, xf, ki, mf, uf, xo, ko, t, dt, gamma, B, N, s);
    case 32: return k2::launch_sampler_step<32>(sw, d, xf, ki, mf, uf, xo, ko, t, dt, gamma, B, N, s);
    case 64: return k2::launch_sampler_step<64>(sw, d, xf, ki, mf, uf, xo, ko, t, dt, gamma, B, N, s);
    default: return cudaErrorInvalidValue;
  }
}
