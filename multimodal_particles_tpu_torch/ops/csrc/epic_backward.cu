// K3 backward: d(packed weights) of the fused EPiC forward for a cotangent g
// (B, N, 3 + 8), in one persistent launch plus a deterministic reduction.
//
// Replaces the TPU kernel multimodal_particles_tpu/ops/epic_pallas_vjp.py
// (`make_epic_train_forward`, body `_bwd_kernel`, :91-240). The forward of
// the same custom op is the K1 kernel (epic_forward.cu): the JAX `_fwd_kernel`
// runs the same `_forward_acts`.
//
// Design.
//   * Layout as K1: a block walks over jets (jet = blockIdx.x, += gridDim.x),
//     one thread per particle slot. For each jet it reruns the shared forward
//     (epic_forward.cuh) with a recorder that writes the activations the
//     backward needs to this block's slice of a global scratch buffer —
//     per particle z_l0, and per EPiC block h_in, z_fl1, z_fl2, then h_final,
//     disc_pre, z_h0 (2 + 3·blocks hidden vectors and 16 floats: 144 floats
//     at config-berlin, 912 at hidden 64 / 4 blocks, which fit no register
//     file); per jet the pooled inputs p0 and p of each block. It reads no
//     residual of the forward launch. The per-jet global MLP values are
//     recomputed from p0 / p on warp 0.
//   * The walk back through the heads, the EPiC blocks (reversed) and the
//     projection stages the weights of each section into shared memory, as
//     the forward does. Masking follows `_bwd_kernel`: the heads' cotangents
//     are masked, pooled cotangents come back times the mask, the mean's
//     denominator is max(Σmask, 1), so an all-masked jet contributes exact
//     zeros except through the discrete head, whose output it has.
//   * Weight gradients are sums over particles of outer products dz·aᵀ. Each
//     is a small product over the particle axis: threads stage their dz and
//     a rows in shared memory, 64 slots at a time, and each thread owns
//     (out, in) elements of the gradient. Parts that are the same for every
//     particle of a jet (the broadcast global state and time embedding in
//     fc_local1 and local_0) use the per-jet sum of dz instead.
//   * Each block accumulates into its own row of a (grid, n_weights) buffer
//     (a thread always owns the same elements, so no atomics); a second
//     kernel sums the rows in a fixed order. The result does not depend on
//     the schedule. grid = SMs × resident blocks per SM, at most B.
//
// What bounds it. The recompute is K1's ~6 kFLOP a particle at
// config-berlin; the backward about twice that, plus the scratch traffic of
// the records (~0.6 KB a particle, L2-resident at config-berlin) and a
// read-modify-write of the block's 29 KB gradient row per jet (L2).
// Hidden 16 loops unroll fully and keep a particle's vectors in registers;
// at hidden 32 and 64 they unroll by 16, so those vectors live in local
// memory: compile time over speed at widths off the main path.
//
// C interface (bound with ctypes by ops/epic_vjp_cuda.py): each entry point
// returns the cudaError_t of its calls, 0 on success.

#include "epic_forward.cuh"

namespace mmp {

constexpr int CHUNK = 64;  // particle slots staged at a time for a weight-gradient product

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Offsets of the recorded activations: per particle in units of one value
// per slot, per jet in floats.
struct RecLayout {
  int hidden, zl0, blocks, block_stride, hf, dpre, zh0, particle_total;
  int pblocks, pstride, jet_total;
};

__host__ __device__ inline RecLayout make_rec_layout(const Dims& d) {
  RecLayout R;
  const int H = d.hidden;
  R.hidden = H;
  R.zl0 = 0;
  R.blocks = H;           // block b: h_in, z_fl1, z_fl2
  R.block_stride = 3 * H;
  R.hf = H + d.num_blocks * 3 * H;
  R.dpre = R.hf + H;
  R.zh0 = R.dpre + V;
  R.particle_total = R.zh0 + V;
  R.pblocks = 2 * H + d.emb_t;  // p0 first
  R.pstride = 2 * H + d.hidden_glob + d.emb_t;
  R.jet_total = R.pblocks + d.num_blocks * R.pstride;
  return R;
}

// Widest (dz ‖ a) row a particle stages for a weight-gradient product.
__host__ __device__ inline int stage_width(const Dims& d) {
  const int H = d.hidden;
  int s = imax(2 * V, V + H);
  s = imax(s, 2 * H);
  s = imax(s, H + d.emb_x + d.emb_k);
  s = imax(s, d.emb_x + DC);
  return imax(s, V + d.emb_k);
}

// Shared memory after the forward's: staging rows, then per-jet vectors.
__host__ __device__ inline int backward_extra_floats(const Dims& d) {
  const int H = d.hidden, Hg = d.hidden_glob, HM = imax(H, Hg);
  return CHUNK * stage_width(d) + 2 * Hg + 2 * H + 8 * HM + (2 * H + Hg + d.emb_t) + H;
}

// Writes the forward's activations to this block's scratch and reads them
// back; particle values are laid out [index][slot] so a warp's accesses are
// contiguous.
struct GlobalRecord {
  float* part;
  float* jet;
  RecLayout R;
  int T, slot;

  __device__ __forceinline__ void put(int i, float v) const { part[(size_t)i * T + slot] = v; }
  __device__ __forceinline__ float get(int i) const { return part[(size_t)i * T + slot]; }
  __device__ __forceinline__ const float* jet_p0() const { return jet; }
  __device__ __forceinline__ const float* jet_p(int b) const {
    return jet + R.pblocks + b * R.pstride;
  }
  __device__ __forceinline__ int blk(int b) const { return R.blocks + b * R.block_stride; }

  __device__ __forceinline__ void z_l0(int j, float v) const { put(R.zl0 + j, v); }
  __device__ __forceinline__ void h_in(int b, int j, float v) const { put(blk(b) + j, v); }
  __device__ __forceinline__ void z_fl1(int b, int j, float v) const {
    put(blk(b) + R.hidden + j, v);
  }
  __device__ __forceinline__ void z_fl2(int b, int j, float v) const {
    put(blk(b) + 2 * R.hidden + j, v);
  }
  __device__ __forceinline__ void h_final(int j, float v) const { put(R.hf + j, v); }
  __device__ __forceinline__ void disc_pre(int v, float x) const { put(R.dpre + v, x); }
  __device__ __forceinline__ void z_h0(int v, float x) const { put(R.zh0 + v, x); }
  __device__ __forceinline__ void p0(int i, float v) const { jet[i] = v; }
  __device__ __forceinline__ void p(int b, int i, float v) const {
    jet[R.pblocks + b * R.pstride + i] = v;
  }
};

__device__ __forceinline__ float dleaky(float z) { return z >= 0.f ? 1.f : 0.01f; }

// selu'(z) with the right-hand derivative at 0, as `_dselu`
// (epic_pallas_vjp.py:72-75).
__device__ __forceinline__ float dselu(float z) {
  const float alpha = 1.6732632423543772f, scale = 1.0507009873554805f;
  return scale * (z >= 0.f ? 1.f : alpha * expf(z));
}

// gw[o·ld + i] += Σ_slots dz[o]·a[i] and gb[o] += Σ_slots dz[o] (gb may be
// null). `fill(dz_row, a_row)` writes the calling thread's n_out dz values
// and n_in a values. Every thread of the block must call it; it ends with a
// barrier.
template <class Fill>
__device__ __forceinline__ void particle_outer(int n_out, int n_in, float* stg, Fill fill,
                                               float* gw, int ld, float* gb) {
  const int T = blockDim.x, tid = threadIdx.x;
  const int S = n_out + n_in, n_w = n_out * n_in;
  const int n_all = n_w + (gb != nullptr ? n_out : 0);
  for (int c0 = 0; c0 < T; c0 += CHUNK) {
    const int cn = T - c0 < CHUNK ? T - c0 : CHUNK;
    if (tid >= c0 && tid < c0 + cn) {
      float* row = stg + (tid - c0) * S;
      fill(row, row + n_out);
    }
    __syncthreads();
    for (int e = tid; e < n_all; e += T) {
      float acc = 0.f;
      if (e < n_w) {
        const int o = e / n_in, i = e - o * n_in;
        for (int q = 0; q < cn; ++q) acc = fmaf(stg[q * S + o], stg[q * S + n_out + i], acc);
        gw[o * ld + i] += acc;
      } else {
        const int o = e - n_w;
        for (int q = 0; q < cn; ++q) acc += stg[q * S + o];
        gb[o] += acc;
      }
    }
    __syncthreads();
  }
}

// gw[o·ld + i] += dz[o]·a[i], gb[o] += dz[o] for one jet's vectors; the
// block's threads share the elements.
__device__ __forceinline__ void jet_outer(const float* dz, int n_out, const float* a, int n_in,
                                          float* gw, int ld, float* gb) {
  const int n_w = n_out * n_in, n_all = n_w + (gb != nullptr ? n_out : 0);
  for (int e = threadIdx.x; e < n_all; e += blockDim.x) {
    if (e < n_w) {
      const int o = e / n_in, i = e - o * n_in;
      gw[o * ld + i] += dz[o] * a[i];
    } else {
      gb[e - n_w] += dz[e - n_w];
    }
  }
}

// Warp 0 only: z[j] = W[j,:]·x + b[j] (+ res[j]), the pre-activation that
// warp_dense applies leaky to, in the same order of operations.
__device__ __forceinline__ void warp_affine(const float* W, const float* b, const float* x,
                                            int n_in, int n_out, const float* res, float* z) {
  const int lane = threadIdx.x & 31;
  for (int j = lane; j < n_out; j += 32) {
    const float* w = W + j * n_in;
    float acc = 0.f;
    for (int i = 0; i < n_in; ++i) acc = fmaf(w[i], x[i], acc);
    acc += b[j];
    if (res != nullptr) acc += res[j];
    z[j] = acc;
  }
  __syncwarp();
}

// Warp 0 only: out[c] = Σ_o W[o·ld + c]·dz[o] (· leaky'(z[c]) when z is given).
__device__ __forceinline__ void warp_matT(const float* W, int ld, const float* dz, int n_out,
                                          int n_cols, const float* z, float* out) {
  const int lane = threadIdx.x & 31;
  for (int c = lane; c < n_cols; c += 32) {
    float s = 0.f;
    for (int o = 0; o < n_out; ++o) s = fmaf(W[o * ld + c], dz[o], s);
    out[c] = z != nullptr ? s * dleaky(z[c]) : s;
  }
  __syncwarp();
}

// The backward of one jet for one particle slot, after the recording
// forward; accumulates into this block's gradient row `grad` (flat layout).
// Every thread of the block must call it.
template <int H>
__device__ void epic_backward_particle(const float* __restrict__ wglob, const Dims& d,
                                       const Layout& L, const RecLayout& R, float* smem,
                                       const GlobalRecord& rec, const float (&xv)[DC], int kv,
                                       float m, const float (&gc)[DC], const float (&gd)[V],
                                       float* grad) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nwarps = blockDim.x >> 5;
  const int Hg = d.hidden_glob, Et = d.emb_t, Ex = d.emb_x, Ek = d.emb_k, nb = d.num_blocks;
  const int HM = imax(H, Hg);
  const int n_g0 = 2 * H + Et, n_g1 = 2 * H + Hg + Et, n_l1 = H + Hg + Et, n_l0 = Et + Ex + Ek;
  float* sw = smem;
  float* temb = scratch_temb(smem, L);
  float* red = scratch_red(smem, L, d);
  float* stg = smem + L.max_stage + scratch_floats(d, nwarps);
  float* dg = stg + CHUNK * stage_width(d);  // Hg: cotangent of the global state
  float* dsg = dg + Hg;                      // Hg: its skip-connection sum
  float* tmp = dsg + Hg;                     // 2H: block_pool output
  float* v0 = tmp + 2 * H;                   // recomputed per-jet activations
  float* v1 = v0 + HM;
  float* v2 = v1 + HM;
  float* v3 = v2 + HM;
  float* v4 = v3 + HM;
  float* dza = v4 + HM;                      // per-jet pre-activation cotangents
  float* dzb = dza + HM;
  float* dzc = dzb + HM;
  float* dpv = dzc + HM;                     // n_g1: cotangent of the pooled input
  float* dsum = dpv + n_g1;                  // H: cotangent of the masked sum

  const float denom = fmaxf(block_sum_scalar(m, red), 1.f);

  // ---- heads (their weights are still staged by the forward)
  float* gh = grad + L.heads;
  float hf[H];
#pragma unroll 16
  for (int j = 0; j < H; ++j) hf[j] = rec.get(R.hf + j);
  float dd[V];  // cotangent of disc_pre
  if (d.add_discrete_head) {
    float zh0[V], ah0[V], dpre[V], dz[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      zh0[v] = rec.get(R.zh0 + v);
      ah0[v] = selu(zh0[v]);
      dpre[v] = rec.get(R.dpre + v);
    }
    particle_outer(V, V, stg, [&](float* o, float* a) {
#pragma unroll
      for (int v = 0; v < V; ++v) { o[v] = gd[v]; a[v] = ah0[v]; }
    }, gh + L.h1, V, gh + L.b_h1);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) s = fmaf(sw[L.h1 + v * V + u], gd[v], s);
      dz[u] = s * dselu(zh0[u]);
    }
    particle_outer(V, V, stg, [&](float* o, float* a) {
#pragma unroll
      for (int v = 0; v < V; ++v) { o[v] = dz[v]; a[v] = dpre[v]; }
    }, gh + L.h0, V, gh + L.b_h0);
#pragma unroll
    for (int u = 0; u < V; ++u) {
      float s = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) s = fmaf(sw[L.h0 + v * V + u], dz[v], s);
      dd[u] = s;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) dd[v] = gd[v];
  }
  float dzo_c[DC], dzo_d[V];
#pragma unroll
  for (int c = 0; c < DC; ++c) dzo_c[c] = gc[c] * m;
#pragma unroll
  for (int v = 0; v < V; ++v) dzo_d[v] = dd[v] * m;
  particle_outer(DC, H, stg, [&](float* o, float* a) {
#pragma unroll
    for (int c = 0; c < DC; ++c) o[c] = dzo_c[c];
#pragma unroll 16
    for (int i = 0; i < H; ++i) a[i] = hf[i];
  }, gh + L.out_c, H, gh + L.b_out_c);
  particle_outer(V, H, stg, [&](float* o, float* a) {
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = dzo_d[v];
#pragma unroll 16
    for (int i = 0; i < H; ++i) a[i] = hf[i];
  }, gh + L.out_d, H, gh + L.b_out_d);
  float dh[H], dsl[H];
#pragma unroll 16
  for (int i = 0; i < H; ++i) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) s = fmaf(sw[L.out_c + c * H + i], dzo_c[c], s);
#pragma unroll
    for (int v = 0; v < V; ++v) s = fmaf(sw[L.out_d + v * H + i], dzo_d[v], s);
    dh[i] = s;
    dsl[i] = 0.f;
  }
  for (int i = tid; i < Hg; i += blockDim.x) {
    dg[i] = 0.f;
    dsg[i] = 0.f;
  }
  __syncthreads();  // the heads' weights are read; the next stage overwrites them

  // ---- EPiC layers, reversed (epic_pallas_vjp.py:148-190)
  for (int blk = nb - 1; blk >= 0; --blk) {
    load_stage(sw, wglob + L.blocks + blk * L.block_stride, L.block_stride);
    float* gb = grad + L.blocks + blk * L.block_stride;
    const float* pj = rec.jet_p(blk);
    __syncthreads();
    if (warp == 0) {
      warp_affine(sw + L.fg1, sw + L.bfg1, pj, n_g1, H, nullptr, v0);  // z_fg1
      for (int i = lane; i < H; i += 32) v1[i] = leaky(v0[i]);         // g1
      __syncwarp();
      warp_affine(sw + L.fg2, sw + L.bfg2, v1, H, Hg, pj + 2 * H, v2);  // z_fg2 (+ g_in)
      for (int i = lane; i < Hg; i += 32) {
        v3[i] = leaky(v2[i]);  // g_new
        if (d.use_skip) dsg[i] += dg[i];
      }
      __syncwarp();
    }
    __syncthreads();

    float zf1[H], zf2[H], hin[H], l1[H], dz2[H], dz1[H];
#pragma unroll 16
    for (int j = 0; j < H; ++j) {
      if (d.use_skip) dsl[j] += dh[j];
      hin[j] = rec.get(rec.blk(blk) + j);
      zf1[j] = rec.get(rec.blk(blk) + H + j);
      zf2[j] = rec.get(rec.blk(blk) + 2 * H + j);
      l1[j] = leaky(zf1[j]);
      dz2[j] = dh[j] * m * dleaky(zf2[j]);  // h_out = leaky(z_fl2)·m + skip
    }
    particle_outer(H, H, stg, [&](float* o, float* a) {
#pragma unroll 16
      for (int j = 0; j < H; ++j) { o[j] = dz2[j]; a[j] = l1[j]; }
    }, gb + L.fl2, H, gb + L.bfl2);
#pragma unroll 16
    for (int i = 0; i < H; ++i) {
      float s = 0.f;
#pragma unroll 16
      for (int j = 0; j < H; ++j) s = fmaf(sw[L.fl2 + j * H + i], dz2[j], s);
      dz1[i] = s * dleaky(zf1[i]);
    }
    particle_outer(H, H, stg, [&](float* o, float* a) {
#pragma unroll 16
      for (int j = 0; j < H; ++j) { o[j] = dz1[j]; a[j] = hin[j]; }
    }, gb + L.fl1, n_l1, gb + L.bfl1);
    // dh_in = dz_fl2 (residual) + W_fl1[:, :H]ᵀ dz_fl1
#pragma unroll 16
    for (int i = 0; i < H; ++i) {
      float s = dz2[i];
#pragma unroll 16
      for (int o = 0; o < H; ++o) s = fmaf(sw[L.fl1 + o * n_l1 + i], dz1[o], s);
      dh[i] = s;
    }
    // fc_local1's broadcast inputs [g_new ‖ ctx] are the same for every
    // particle: their gradient takes the per-jet sum of dz_fl1
    block_pool<H>(dz1, 1.f, 1.f, red, tmp);  // tmp[H + o] = Σ_particles dz_fl1
    jet_outer(tmp + H, H, v3, Hg, gb + L.fl1 + H, n_l1, nullptr);
    jet_outer(tmp + H, H, temb, Et, gb + L.fl1 + H + Hg, n_l1, nullptr);
    if (warp == 0) {
      // dz_fg2 = (dg + W_fl1[:, H:H+Hg]ᵀ Σdz_fl1) · leaky'(z_fg2)
      for (int j = lane; j < Hg; j += 32) {
        float s = dg[j];
        for (int o = 0; o < H; ++o) s = fmaf(sw[L.fl1 + o * n_l1 + H + j], tmp[H + o], s);
        dza[j] = s * dleaky(v2[j]);
      }
      __syncwarp();
      warp_matT(sw + L.fg2, H, dza, Hg, H, v0, dzb);       // dz_fg1
      warp_matT(sw + L.fg1, n_g1, dzb, H, n_g1, nullptr, dpv);  // d p
      for (int j = lane; j < H; j += 32) dsum[j] = dpv[H + j] + dpv[j] / denom;
      for (int j = lane; j < Hg; j += 32) dg[j] = dza[j] + dpv[2 * H + j];  // dg_in
      __syncwarp();
    }
    __syncthreads();
    jet_outer(dza, Hg, v1, H, gb + L.fg2, H, gb + L.bfg2);
    jet_outer(dzb, H, pj, n_g1, gb + L.fg1, n_g1, gb + L.bfg1);
    // s = pool(h_in·mask) → dh_in += dsum·mask
#pragma unroll 16
    for (int j = 0; j < H; ++j) dh[j] = fmaf(dsum[j], m, dh[j]);
    __syncthreads();  // the block's weights and dsum are read
  }

  // ---- skips fold into the projection outputs; projection backward
  // (epic_pallas_vjp.py:192-224)
  if (d.use_skip) {
#pragma unroll 16
    for (int j = 0; j < H; ++j) dh[j] += dsl[j];
  }
  load_stage(sw, wglob, L.blocks);
  const float* p0 = rec.jet_p0();
  __syncthreads();
  if (warp == 0) {
    if (d.use_skip)
      for (int i = lane; i < Hg; i += 32) dg[i] += dsg[i];
    warp_affine(sw + L.w_g0, sw + L.b_g0, p0, n_g0, H, nullptr, v0);  // z_g0
    for (int i = lane; i < H; i += 32) v1[i] = leaky(v0[i]);           // a_g0
    __syncwarp();
    warp_affine(sw + L.w_g1, sw + L.b_g1, v1, H, H, nullptr, v2);      // z_g1
    for (int i = lane; i < H; i += 32) v3[i] = leaky(v2[i]);           // a_g1
    __syncwarp();
    warp_affine(sw + L.w_g2, sw + L.b_g2, v3, H, Hg, nullptr, v4);     // z_g2
    for (int j = lane; j < Hg; j += 32) dza[j] = dg[j] * dleaky(v4[j]);  // dz_g2
    __syncwarp();
    warp_matT(sw + L.w_g2, H, dza, Hg, H, v2, dzb);            // dz_g1
    warp_matT(sw + L.w_g1, H, dzb, H, H, v0, dzc);             // dz_g0
    warp_matT(sw + L.w_g0, n_g0, dzc, H, n_g0, nullptr, dpv);  // d p0
    for (int j = lane; j < H; j += 32) dsum[j] = dpv[H + j] + dpv[j] / denom;
    __syncwarp();
  }
  __syncthreads();
  jet_outer(dza, Hg, v3, H, grad + L.w_g2, H, grad + L.b_g2);
  jet_outer(dzb, H, v1, H, grad + L.w_g1, H, grad + L.b_g1);
  jet_outer(dzc, H, p0, n_g0, grad + L.w_g0, n_g0, grad + L.b_g0);

  // h = leaky(z_l0)·m and s0 = pool(leaky(z_l0)·m)
  float dzl0[H];
#pragma unroll 16
  for (int j = 0; j < H; ++j) {
    const float zl0 = rec.get(R.zl0 + j);
    dzl0[j] = (dh[j] * m + dsum[j] * m) * dleaky(zl0);
  }
  const bool k_valid = kv >= 0 && kv < V;
  // local_0's x and k columns: features [x_emb ‖ k_emb]·m
  particle_outer(H, Ex + Ek, stg, [&](float* o, float* a) {
#pragma unroll 16
    for (int j = 0; j < H; ++j) o[j] = dzl0[j];
    for (int i = 0; i < Ex; ++i) {
      float xe = 0.f;
#pragma unroll
      for (int c = 0; c < DC; ++c) xe = fmaf(sw[L.w_x + i * DC + c], xv[c], xe);
      xe += sw[L.b_x + i];
      a[i] = xe * m;
    }
    for (int i = 0; i < Ek; ++i) a[Ex + i] = (k_valid ? sw[L.table + kv * Ek + i] : 0.f) * m;
  }, grad + L.w_l0 + Et, n_l0, grad + L.b_l0);
  // local_0's time columns: temb·m is the same for every particle
  block_pool<H>(dzl0, m, 1.f, red, tmp);  // tmp[H + o] = Σ_particles dz_l0·m
  jet_outer(tmp + H, H, temb, Et, grad + L.w_l0, n_l0, nullptr);
  // dfeats = W_l0ᵀ dz_l0 · m → d x_emb (embedding_continuous), d k_emb (table)
  particle_outer(Ex, DC, stg, [&](float* o, float* a) {
    for (int e = 0; e < Ex; ++e) {
      float s = 0.f;
#pragma unroll 16
      for (int j = 0; j < H; ++j) s = fmaf(sw[L.w_l0 + j * n_l0 + Et + e], dzl0[j], s);
      o[e] = s * m;
    }
#pragma unroll
    for (int c = 0; c < DC; ++c) a[c] = xv[c];
  }, grad + L.w_x, DC, grad + L.b_x);
  particle_outer(V, Ek, stg, [&](float* o, float* a) {
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = kv == v ? 1.f : 0.f;
    for (int e = 0; e < Ek; ++e) {
      float s = 0.f;
#pragma unroll 16
      for (int j = 0; j < H; ++j) s = fmaf(sw[L.w_l0 + j * n_l0 + Et + Ex + e], dzl0[j], s);
      a[e] = s * m;
    }
  }, grad + L.table, Ek, nullptr);
}

template <int H>
__global__ void __launch_bounds__(MAX_THREADS)
epic_backward_kernel(const float* __restrict__ w, Dims d, const float* __restrict__ t,
                     const float* __restrict__ x, const int* __restrict__ k,
                     const float* __restrict__ mask, const float* __restrict__ gout,
                     float* __restrict__ partials, float* __restrict__ records, int B, int N) {
  extern __shared__ float smem[];
  const Layout L = make_layout(d);
  const RecLayout R = make_rec_layout(d);
  const int T = blockDim.x, slot = threadIdx.x;
  const bool active = slot < N;
  float* grad = partials + (size_t)blockIdx.x * L.total;
  for (int i = slot; i < L.total; i += T) grad[i] = 0.f;
  const size_t rec_stride = (size_t)R.particle_total * T + R.jet_total;
  float* part = records + (size_t)blockIdx.x * rec_stride;
  const GlobalRecord rec{part, part + (size_t)R.particle_total * T, R, T, slot};
  __syncthreads();

  for (int jet = blockIdx.x; jet < B; jet += gridDim.x) {
    const size_t p = (size_t)jet * N + slot;
    float xv[DC] = {0.f, 0.f, 0.f}, gc[DC] = {0.f, 0.f, 0.f};
    float gd[V];
#pragma unroll
    for (int v = 0; v < V; ++v) gd[v] = 0.f;
    int kv = 0;
    float m = 0.f;
    if (active) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        xv[c] = x[p * DC + c];
        gc[c] = gout[p * (DC + V) + c];
      }
#pragma unroll
      for (int v = 0; v < V; ++v) gd[v] = gout[p * (DC + V) + DC + v];
      kv = k[p];
      m = mask[p];
    }
    float cont[DC], disc[V];
    epic_forward_particle<H>(w, d, L, smem, t[jet], xv, kv, m, cont, disc, rec);
    epic_backward_particle<H>(w, d, L, R, smem, rec, xv, kv, m, gc, gd, grad);
  }
}

// out[e] = Σ_rows partials[row, e], rows in order.
__global__ void reduce_partials(const float* __restrict__ partials, int rows, int n,
                                float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += partials[(size_t)r * n + e];
  out[e] = s;
}

template <int H>
cudaError_t backward_workspace(const Dims& d, int B, int N, int* grid, long long* floats) {
  int threads;
  size_t smem;
  const size_t extra = sizeof(float) * (size_t)backward_extra_floats(d);
  cudaError_t err = prepare_launch(epic_backward_kernel<H>, d, N, &threads, &smem, extra);
  if (err != cudaSuccess) return err;
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, epic_backward_kernel<H>, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int g = sms * per_sm;
  if (g > B) g = B;
  *grid = g < 1 ? 1 : g;
  const Layout L = make_layout(d);
  const RecLayout R = make_rec_layout(d);
  *floats = (long long)*grid * ((long long)L.total + (long long)R.particle_total * threads +
                                R.jet_total);
  return cudaSuccess;
}

template <int H>
cudaError_t launch_epic_backward(const float* w, const Dims& d, const float* t, const float* x,
                                 const int* k, const float* mask, const float* g, float* out,
                                 float* scratch, int grid, int B, int N, cudaStream_t stream) {
  int threads;
  size_t smem;
  const size_t extra = sizeof(float) * (size_t)backward_extra_floats(d);
  cudaError_t err = prepare_launch(epic_backward_kernel<H>, d, N, &threads, &smem, extra);
  if (err != cudaSuccess) return err;
  if (grid < 1) return cudaErrorInvalidValue;
  const Layout L = make_layout(d);
  float* partials = scratch;
  float* records = scratch + (size_t)grid * L.total;
  epic_backward_kernel<H><<<grid, threads, smem, stream>>>(w, d, t, x, k, mask, g, partials,
                                                          records, B, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_partials<<<(L.total + 255) / 256, 256, 0, stream>>>(partials, grid, L.total, out);
  return cudaGetLastError();
}

}  // namespace mmp

extern "C" int mmp_epic_backward_workspace(int B, int N, const int* dims, int* grid,
                                           long long* floats) {
  using namespace mmp;
  const Dims d = dims_from(dims);
  if (!token_layout(d)) return cudaErrorInvalidValue;  // written for a head as wide as the vocabulary and a token input
  switch (d.hidden) {
    case 16: return backward_workspace<16>(d, B, N, grid, floats);
    case 32: return backward_workspace<32>(d, B, N, grid, floats);
    case 64: return backward_workspace<64>(d, B, N, grid, floats);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int mmp_epic_backward(const void* w, const void* t, const void* x, const void* k,
                                 const void* mask, const void* g, void* out, void* scratch,
                                 int grid, int B, int N, const int* dims, void* stream) {
  using namespace mmp;
  const Dims d = dims_from(dims);
  if (!token_layout(d)) return cudaErrorInvalidValue;  // written for a head as wide as the vocabulary and a token input
  if (B == 0) return cudaSuccess;
  const auto* wf = static_cast<const float*>(w);
  const auto* tf = static_cast<const float*>(t);
  const auto* xf = static_cast<const float*>(x);
  const auto* ki = static_cast<const int*>(k);
  const auto* mf = static_cast<const float*>(mask);
  const auto* gf = static_cast<const float*>(g);
  auto* of = static_cast<float*>(out);
  auto* sf = static_cast<float*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d.hidden) {
    case 16: return launch_epic_backward<16>(wf, d, tf, xf, ki, mf, gf, of, sf, grid, B, N, s);
    case 32: return launch_epic_backward<32>(wf, d, tf, xf, ki, mf, gf, of, sf, grid, B, N, s);
    case 64: return launch_epic_backward<64>(wf, d, tf, xf, ki, mf, gf, of, sf, grid, B, N, s);
    default: return cudaErrorInvalidValue;
  }
}
