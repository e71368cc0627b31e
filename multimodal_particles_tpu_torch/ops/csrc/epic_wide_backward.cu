// K5 backward: d(packed weights) of the wide fused EPiC forward for a
// cotangent g (B, N, 3 + 8), in one persistent launch plus a deterministic
// reduction. This file's kernel takes every width 128; the general kernel
// (epic_wide_backward_any.cuh, a cluster of hidden / 128 blocks a jet,
// instantiated by epic_wide_backward_h*.cu) the other widths up to 512, and
// jets of 129 to 256 slots at every width as a cluster of hidden / 128 × 2
// row blocks (epic_wide_backward_h*_r2.cu).
//
// Replaces the TPU kernel multimodal_particles_tpu/ops/epic_pallas_wide_vjp.py
// (`make_epic_train_forward_wide`, body `_bwd_kernel`, :90-238). The forward
// of the same custom op is the K4 kernel (epic_wide_forward.cu): the JAX
// `_fwd_kernel` runs the same `_forward_acts_wide`.
//
// Design.
//   * A block walks over jets (jet = blockIdx.x, += gridDim.x). For each jet
//     it reruns the forward as K4 runs it (epic_wide.cuh's tensor-core
//     forward, wgmma under the 3×TF32 split, so that the rerun rounds as the
//     train forward did) with a recorder that writes what the walk back needs
//     to this block's slice of a global scratch: per EPiC block h_in and
//     z_fl1 (12 tiles of 64 KB at 6 blocks: no shared memory holds them),
//     the signs of z_l0 and of each block's z_fl2 (a warp's ballot a word);
//     per jet the pooled inputs and pre-activations of the global MLP. It
//     reads no residual of the forward launch.
//   * The walk back keeps the cotangent of h as a tile in shared memory, in
//     the forward's plan (rows of LDA_TC floats; the third tile is the weight
//     ring of the products or the operand a of a weight gradient).
//     dz·Wᵀ runs as the forward's products do (gemm_wg: wgmma, dz split in
//     registers, Wᵀ from stages the wrapper lays out once a call,
//     ops/epic_wide_vjp_cuda.py::tensor_core_transposed_stages). aᵀ·dz contracts the
//     particle axis, which wgmma cannot take as K for TF32 operands in shared
//     memory (both would have to be K-major, and a and dz are stored
//     particle-major): it runs on mma.sync.m16n8k8 with both fragments
//     loaded by hand from the two tiles and split by truncation, a warp a
//     32 × 64 piece of the (128, 128) gradient, which it adds into the
//     block's gradient row (always the same thread, so no atomics).
//   * Gradients of what is the same for every particle of a jet (the global
//     MLP, the broadcast thirds of fc_local1 and local_0) are rank-1 in a
//     jet's vectors, and they are three quarters of the packed buffer: a jet
//     only logs the vector pairs (a, dz), 36 KB, and when the block has
//     walked all its jets it contracts the pairs over them, so those rows of
//     the gradient are written once a block and not once a jet. local_0's
//     input side needs no 128-row product: with R = [x·m ‖ m ‖ onehot(k)·m]
//     (128, 12) and Q = Rᵀ·dz_l0 (12, 128), every gradient of w_x, b_x, the
//     table and w_l0 is a product of Q with a weight.
//   * Masking follows `_bwd_kernel`: the heads' cotangents are masked, pooled
//     cotangents come back times the mask, the mean's denominator is
//     max(Σmask, 1). leaky'(0) = 1 and selu'(0) = scale, as `_dleaky`/`_dselu`.
//   * Each block accumulates into its own row of a (grid, n_weights) buffer
//     (a thread always owns the same elements, so no atomics); a second
//     kernel sums the rows in a fixed order. The result does not depend on
//     the schedule. grid = one block per SM, at most B.
//
// What bounds it. The products: the rerun's 12 and the walk back's 24
// (128, 128, 128) products at 6 blocks, three TF32 products each under the
// split (their own tensor bound 7.5 ms at B = 8192 on an H100); then each
// jet's chain of dependent steps with one block an SM and nothing to hide its
// latency: the per-jet vector-matrix products (the global MLP and the
// broadcast thirds, forward and back, their weights streamed from L2 for
// every jet), the bytes a jet moves (the records: h_in and z_fl1 of each
// block, 0.8 MB written and read back, of z_l0 and z_fl2 only the signs,
// which is all leaky' needs; the per-particle quarter of the block's
// gradient row, 768 KB read and written once a jet), the elementwise passes
// and column sums. scripts/k5_variants.py splits it (PERF.md §5): at B = 8192
// ≈ 24% products, ≈ 21% per-jet vector-matrix products, ≈ 10% gradient row,
// ≈ 8% records. aᵀ·dz on wgmma (aᵀ from registers, dz transposed into
// K-major stages by the block) timed ≈ 4% slower than on mma.sync. The
// scratch is grid × (row + records + the block's jets × pairs), 0.95 GB for
// 8192 jets on 132 SMs.
//
// C interface (bound with ctypes by ops/epic_wide_vjp_cuda.py): each entry
// point returns the cudaError_t of its calls, 0 on success.

#include "epic_wide_backward_any.cuh"

namespace mmpw {

// Floats of one block's records: (h_in, z_fl1) per EPiC block, the skip
// cotangent's sum, the signs of z_l0 and of each block's z_fl2, then the
// per-jet vectors.
__host__ __device__ inline long long record_floats(int num_blocks) {
  return (long long)(1 + 2 * num_blocks) * MAT + (long long)(1 + num_blocks) * SIGN_WORDS +
         R_PROJ + (long long)num_blocks * R_GLOB;
}

// The backward's shared memory: the tensor-core forward's plan (three tiles
// of rows of LDA_TC floats, the staging area, the forward's vectors), the
// walk back's vectors in what the forward leaves dead (g, gskip, cl1, ct,
// its reduction buffer) and after it.
constexpr int B_DG = V_G, B_DSG = V_GSKIP, B_DZA = V_CL1, B_DZB = V_CT, B_DZC = V_RED_TC,
              B_DP = B_DZC + WD, B_DSUM = B_DP + 4 * WD, B_SDZ = B_DSUM + WD, B_RED = B_SDZ + WD,
              B_END = B_RED + 2 * WD;
constexpr size_t SMEM_BYTES_BWD = sizeof(float) * (size_t)(S_VEC_TC + B_END);
static_assert(SMEM_BYTES_BWD <= 232448, "over a block's 227 KB of shared memory");
static_assert(B_END >= V_END_TC, "the walk back's vectors end past the forward's");

// Pairs, and groups of the group table, that a block logs for a jet.
__host__ __device__ inline int pair_groups(int num_blocks) { return 3 * num_blocks + 4; }
__host__ __device__ inline int pair_floats(int num_blocks) {
  return num_blocks * (2 + 1 + 4 + 3) * WD + (1 + 1 + 3 + 1 + 4) * WD;
}

// Floats of one block's pair log: its jets' records, then the group table.
__host__ __device__ inline long long pair_block_floats(int num_blocks, int jets_per_block) {
  return (long long)jets_per_block * pair_floats(num_blocks) +
         ((GROUP_INTS * pair_groups(num_blocks) + 3) & ~3);
}

// The backward of one jet after the recording forward (S0 holds h_final);
// accumulates into this block's gradient row `grad`. tcw_t: per EPiC block
// the stages of W_fl2ᵀ, then of W_fl1[0:128]ᵀ (TC_LAYER floats a block).
// Every thread calls it.
__device__ void wide_backward_jet(const float* __restrict__ w, const float* __restrict__ tcw_t,
                                  const Dims& d, const Layout& L, float* smem,
                                  const GlobalRecord& rec, const float* __restrict__ gout, int N,
                                  float* grad, PairLog& pairs) {
  constexpr int LD = LDA_TC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = d.num_blocks;
  const int npad = (N + 15) & ~15, ksteps = (N + 7) / 8;
  float* S0 = smem;
  float* S1 = smem + ROWS * LD;
  float* S2 = smem + 2 * ROWS * LD;  // the products' weight ring, or a weight gradient's a
  float* tiles = smem + S_TILE_TC;
  float* vec = smem + S_VEC_TC;
  const float* m = vec + V_MASK;
  const float* xs = vec + V_X;
  const int* ks = reinterpret_cast<const int*>(vec + V_K);
  float* gnew = vec + V_GNEW;
  const float* temb = vec + V_TEMB;
  float* pv = vec + V_P;
  float* va = vec + V_VA;
  float* vb = vec + V_VB;
  float* dg = vec + B_DG;
  float* dsg = vec + B_DSG;
  float* dza = vec + B_DZA;
  float* dzb = vec + B_DZB;
  float* dzc = vec + B_DZC;
  float* dp = vec + B_DP;
  float* dsum = vec + B_DSUM;
  float* sdz = vec + B_SDZ;
  float* red = vec + B_RED;
  float4* S0v = reinterpret_cast<float4*>(S0);
  float4* S1v = reinterpret_cast<float4*>(S1);
  float4* S2v = reinterpret_cast<float4*>(S2);

  float denom = 0.f;
  for (int r = 0; r < ROWS; ++r) denom += m[r];
  denom = fmaxf(denom, 1.f);

  // ---- heads: one warp per row; the masked cotangents of (cont ‖ disc_pre)
  // go to DZ (128, 12) in the weight buffer
  stage_heads(w, L, tiles);
  if (tid < WD) {
    dg[tid] = 0.f;
    dsg[tid] = 0.f;
  }
  __syncthreads();
  float* DZ = tiles + T_DZ;
  {
    // small head gradients: lane l owns elements l and l + 32 of each 8 × 8
    // matrix (in, out) and, l < 8, one element of each bias
    float gh1[2] = {0.f, 0.f}, gh0[2] = {0.f, 0.f}, gb1 = 0.f, gb0 = 0.f;
    const int u0 = lane >> 3, u1 = u0 + 4, v0 = lane & 7;
    for (int r = warp; r < ROWS; r += THREADS / 32) {
      float p[NOUT], gc[DC], gd[V], dd[V];
      row_outputs(S0 + r * LD, tiles, m[r], p);
      const bool real = r < N;
#pragma unroll
      for (int c = 0; c < DC; ++c) gc[c] = real ? gout[r * NOUT + c] : 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) gd[v] = real ? gout[r * NOUT + DC + v] : 0.f;
      if (d.add_discrete_head) {
        float z[V], a[V], dz[V];
        head_hidden(p, tiles, z);
#pragma unroll
        for (int v = 0; v < V; ++v) a[v] = selu(z[v]);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          float s = 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) s = fmaf(tiles[T_WH1 + u * V + v], gd[v], s);
          dz[u] = s * dselu(z[u]);
        }
#pragma unroll
        for (int u = 0; u < V; ++u) {
          float s = 0.f;
#pragma unroll
          for (int v = 0; v < V; ++v) s = fmaf(tiles[T_WH0 + u * V + v], dz[v], s);
          dd[u] = s;
        }
        float a0 = 0.f, a1 = 0.f, q0 = 0.f, q1 = 0.f, gv = 0.f, zv = 0.f;
#pragma unroll
        for (int u = 0; u < V; ++u) {
          if (u == u0) { a0 = a[u]; q0 = p[DC + u]; }
          if (u == u1) { a1 = a[u]; q1 = p[DC + u]; }
          if (u == v0) { gv = gd[u]; zv = dz[u]; }
        }
        gh1[0] = fmaf(a0, gv, gh1[0]);
        gh1[1] = fmaf(a1, gv, gh1[1]);
        gh0[0] = fmaf(q0, zv, gh0[0]);
        gh0[1] = fmaf(q1, zv, gh0[1]);
        if (lane < V) {
          gb1 += gv;
          gb0 += zv;
        }
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) dd[v] = gd[v];
      }
      float val = 0.f;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        if (lane == c) val = gc[c] * m[r];
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (lane == DC + v) val = dd[v] * m[r];
      if (lane < 12) DZ[r * 12 + lane] = val;
    }
    if (d.add_discrete_head) {
      // the warps add their sums to the row one after the other
      for (int turn = 0; turn < THREADS / 32; ++turn) {
        if (warp == turn) {
          grad[L.h1 + lane] += gh1[0];
          grad[L.h1 + 32 + lane] += gh1[1];
          grad[L.h0 + lane] += gh0[0];
          grad[L.h0 + 32 + lane] += gh0[1];
          if (lane < V) {
            grad[L.b_h1 + lane] += gb1;
            grad[L.b_h0 + lane] += gb0;
          }
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();
  // output layer: dW (128, 11) = h_finalᵀ·DZ, db = Σ_rows DZ
  {
    const int i = tid & (WD - 1), o_lo = tid < WD ? 0 : 6, o_hi = tid < WD ? 6 : NOUT;
    float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < ROWS; ++r) {
      const float hv = S0[r * LD + i];
#pragma unroll
      for (int o = 0; o < 6; ++o)
        if (o_lo + o < o_hi) s[o] = fmaf(hv, DZ[r * 12 + o_lo + o], s[o]);
    }
    // every load of the row's six before any store
    float* dst[6];
    float old[6];
#pragma unroll
    for (int o = 0; o < 6; ++o) {
      const int oo = o_lo + o;
      dst[o] = oo < DC ? grad + L.out_c + i * DC + oo
                       : oo < o_hi ? grad + L.out_d + i * V + (oo - DC) : nullptr;
      old[o] = dst[o] != nullptr ? *dst[o] : 0.f;
    }
#pragma unroll
    for (int o = 0; o < 6; ++o)
      if (dst[o] != nullptr) *dst[o] = old[o] + s[o];
    if (tid < NOUT) {
      float b = 0.f;
      for (int r = 0; r < ROWS; ++r) b += DZ[r * 12 + tid];
      if (tid < DC) grad[L.b_out_c + tid] += b;
      else grad[L.b_out_d + tid - DC] += b;
    }
  }
  __syncthreads();
  // dh = DZ·W_outᵀ replaces h_final in S0
  for (int idx = tid; idx < MAT; idx += THREADS) {
    const int r = idx >> 7, c = idx & (WD - 1);
    float s = 0.f;
#pragma unroll
    for (int o = 0; o < NOUT; ++o) s = fmaf(DZ[r * 12 + o], tiles[T_HW + o * WD + c], s);
    S0[r * LD + c] = s;
  }
  float4* dsl = reinterpret_cast<float4*>(rec.dsl_mat(nb));
  if (d.use_skip)
    for (int i = tid; i < MAT / 4; i += THREADS) dsl[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  WgAcc acc;

  // ---- EPiC layers, reversed (epic_pallas_wide_vjp.py:145-187)
  for (int blk = nb - 1; blk >= 0; --blk) {
    const float* wb = w + L.blocks + (size_t)blk * L.block_stride;
    const float* tb = tcw_t + (size_t)blk * TC_LAYER;
    const int boff = L.blocks + blk * L.block_stride;
    float* gb = grad + boff;
    const float* gv = rec.globv + blk * R_GLOB;
    // h_out = leaky(z_fl2)·m + skip: S0 ← dz_fl2, S1 ← z_fl1, S2 ← l1 =
    // leaky(z_fl1), the records (z_fl1, z_fl2's signs) fetched into S1 and the
    // staging area by cp.async first; and the per-jet vectors p, g1, g_new.
    // The skip's cotangent (global, L2) is read four float4 at a time, all
    // before their stores.
    const unsigned* sgn = reinterpret_cast<const unsigned*>(tiles);
    tile_to_smem_async(S1, rec.z_fl1_mat(blk));
    signs_to_smem_async(reinterpret_cast<unsigned*>(tiles), rec.z_fl2_signs(blk));
    for (int i = tid; i < 4 * WD; i += THREADS) pv[i] = gv[R_P + i];
    if (tid < WD) {
      if (d.use_skip) dsg[tid] += dg[tid];
      va[tid] = leaky(gv[R_ZFG1 + tid]);
      gnew[tid] = leaky(gv[R_ZFG2 + tid]);
    }
    tf32x3::cp_async_wait<0>();
    __syncthreads();
    for (int i0 = tid; i0 < MAT / 4; i0 += 4 * THREADS) {
      float4 sk[4];
      if (d.use_skip)
#pragma unroll
        for (int u = 0; u < 4; ++u) sk[u] = dsl[i0 + u * THREADS];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * THREADS, at = at4(i);
        float4 v = S0v[at];
        if (d.use_skip) {
          sk[u].x += v.x; sk[u].y += v.y; sk[u].z += v.z; sk[u].w += v.w;
        }
        const int r = i >> 5, c = 4 * (i & 31);
        const float mr = m[r];
        v.x *= mr * dleaky_at(sgn, r, c);
        v.y *= mr * dleaky_at(sgn, r, c + 1);
        v.z *= mr * dleaky_at(sgn, r, c + 2);
        v.w *= mr * dleaky_at(sgn, r, c + 3);
        S0v[at] = v;
        const float4 y = S1v[at];
        S2v[at] = make_float4(leaky(y.x), leaky(y.y), leaky(y.z), leaky(y.w));
      }
      if (d.use_skip)
#pragma unroll
        for (int u = 0; u < 4; ++u) dsl[i0 + u * THREADS] = sk[u];
    }
    __syncthreads();
    // fc_local2: dW = l1ᵀ·dz_fl2, db = Σ_rows dz_fl2
    outer_mma(gb + L.fl2, WD, [&](int r, int c) { return S2[r * LD + c]; }, S0, ksteps);
    column_sums<LD>(S0, red, [](int, float v) { return v; },
                    [&](int c, float s) { gb[L.bfl2 + c] += s; });
    // dz_fl1 = (dz_fl2·W_fl2ᵀ)·leaky'(z_fl1), in place of z_fl1
    ring_prefetch(tb, S2);
    acc.zero();
    gemm_wg(acc, S0, tb, S2, nullptr, npad);
    acc.each([&](int, int r, int c, float a) { S1[r * LD + c] = a * dleaky(S1[r * LD + c]); });
    tile_to_smem_async(S2, rec.h_in_mat(blk));
    tf32x3::cp_async_wait<0>();
    __syncthreads();
    // fc_local1: the per-particle third, then the broadcast [g_new ‖ temb]
    // thirds from the per-jet sum of dz_fl1
    outer_mma(gb + L.fl1, WD, [&](int r, int c) { return S2[r * LD + c]; }, S1, ksteps);
    column_sums<LD>(S1, red, [](int, float v) { return v; }, [&](int c, float s) {
      sdz[c] = s;
      gb[L.bfl1 + c] += s;
    });
    pairs.put(boff + L.fl1 + WD * WD, gnew, 2 * WD, sdz, WD);
    // dh_in = dz_fl2 (residual) + dz_fl1·W_fl1[0:128]ᵀ
    ring_prefetch(tb + TC_FL2, S2);
    acc.zero();
    gemm_wg(acc, S1, tb + TC_FL2, S2, nullptr, npad);
    acc.each([&](int, int r, int c, float a) { S0[r * LD + c] += a; });
    // global MLP: dz_fg2 = (dg + W_fl1[128:256]·Σdz_fl1)·leaky'(z_fg2)
    jet_matvec_t(sdz, wb + L.fl1 + WD * WD, WD, WD, WD, [&](int j, float s) {
      dza[j] = (dg[j] + s) * dleaky(gv[R_ZFG2 + j]);
    });
    pairs.put(boff + L.fg2, va, WD, dza, WD);
    vec_add(gb + L.bfg2, dza);
    jet_matvec_t(dza, wb + L.fg2, WD, WD, WD, [&](int j, float s) {
      dzb[j] = s * dleaky(gv[R_ZFG1 + j]);
    });
    pairs.put(boff + L.fg1, pv, 4 * WD, dzb, WD);
    vec_add(gb + L.bfg1, dzb);
    jet_matvec_t(dzb, wb + L.fg1, WD, WD, 4 * WD, [&](int j, float s) { dp[j] = s; });
    if (tid < WD) {
      dsum[tid] = dp[WD + tid] + dp[tid] / denom;
      dg[tid] = dza[tid] + dp[2 * WD + tid];
    }
    __syncthreads();
    // s = pool(h_in·mask) → dh_in += dsum·mask
    for (int i = tid; i < MAT / 4; i += THREADS) {
      const float mr = m[i >> 5];
      const float4 ds = *reinterpret_cast<const float4*>(dsum + (i & 31) * 4);
      float4 v = S0v[at4(i)];
      v.x = fmaf(ds.x, mr, v.x);
      v.y = fmaf(ds.y, mr, v.y);
      v.z = fmaf(ds.z, mr, v.z);
      v.w = fmaf(ds.w, mr, v.w);
      S0v[at4(i)] = v;
    }
    __syncthreads();
  }

  // ---- skips fold into the projection outputs; projection backward
  // (epic_pallas_wide_vjp.py:189-222)
  {
    const float* pj = rec.projv;
    for (int i = tid; i < 3 * WD; i += THREADS) pv[i] = pj[R_P0 + i];
    if (tid < WD) {
      if (d.use_skip) dg[tid] += dsg[tid];
      va[tid] = leaky(pj[R_ZG0 + tid]);  // a_g0
      vb[tid] = leaky(pj[R_ZG1 + tid]);  // a_g1
      dza[tid] = dg[tid] * dleaky(pj[R_ZG2 + tid]);
    }
    __syncthreads();
    pairs.put(L.w_g2, vb, WD, dza, WD);
    vec_add(grad + L.b_g2, dza);
    jet_matvec_t(dza, w + L.w_g2, WD, WD, WD, [&](int j, float s) { dzb[j] = s * dleaky(pj[R_ZG1 + j]); });
    pairs.put(L.w_g1, va, WD, dzb, WD);
    vec_add(grad + L.b_g1, dzb);
    jet_matvec_t(dzb, w + L.w_g1, WD, WD, WD, [&](int j, float s) { dzc[j] = s * dleaky(pj[R_ZG0 + j]); });
    pairs.put(L.w_g0, pv, 3 * WD, dzc, WD);
    vec_add(grad + L.b_g0, dzc);
    jet_matvec_t(dzc, w + L.w_g0, WD, WD, 2 * WD, [&](int j, float s) { dp[j] = s; });
    if (tid < WD) dsum[tid] = dp[WD + tid] + dp[tid] / denom;
    __syncthreads();
  }
  // h = leaky(z_l0)·m and s0 = pool(leaky(z_l0)·m): S0 ← dz_l0, z_l0's
  // signs fetched into the staging area by cp.async first
  const unsigned* sgn = reinterpret_cast<const unsigned*>(tiles);
  signs_to_smem_async(reinterpret_cast<unsigned*>(tiles), rec.z_l0_signs());
  tf32x3::cp_async_wait<0>();
  __syncthreads();
  for (int i0 = tid; i0 < MAT / 4; i0 += 4 * THREADS) {
    float4 sk[4];
    if (d.use_skip)
#pragma unroll
      for (int u = 0; u < 4; ++u) sk[u] = dsl[i0 + u * THREADS];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * THREADS, at = at4(i), r = i >> 5, c = 4 * (i & 31);
      const float mr = m[r];
      const float4 ds = *reinterpret_cast<const float4*>(dsum + (i & 31) * 4);
      float4 v = S0v[at];
      if (d.use_skip) {
        v.x += sk[u].x; v.y += sk[u].y; v.z += sk[u].z; v.w += sk[u].w;
      }
      v.x = (v.x * mr + ds.x * mr) * dleaky_at(sgn, r, c);
      v.y = (v.y * mr + ds.y * mr) * dleaky_at(sgn, r, c + 1);
      v.z = (v.z * mr + ds.z * mr) * dleaky_at(sgn, r, c + 2);
      v.w = (v.w * mr + ds.w * mr) * dleaky_at(sgn, r, c + 3);
      S0v[at] = v;
    }
  }
  __syncthreads();
  // Q = Rᵀ·dz_l0 (12, 128) for R = [x·m ‖ m ‖ onehot(k)·m], and as row 12 the
  // plain column sum (b_l0's gradient); the two halves of the rows meet in
  // the weight buffer
  {
    const int o = tid & (WD - 1), half = tid >> 7;
    float q[NQ];
#pragma unroll
    for (int e = 0; e < NQ; ++e) q[e] = 0.f;
    for (int r = half * 64; r < half * 64 + 64; ++r) {
      const float dz = S0[r * LD + o];
      const float md = m[r] * dz;
      q[NQ - 1] += dz;
#pragma unroll
      for (int c = 0; c < DC; ++c) q[c] = fmaf(xs[r * DC + c], md, q[c]);
      q[DC] += md;
      const int kr = ks[r];
#pragma unroll
      for (int v = 0; v < V; ++v) q[DC + 1 + v] += kr == v ? md : 0.f;
    }
#pragma unroll
    for (int e = 0; e < NQ; ++e) tiles[half * NQ * WD + e * WD + o] = q[e];
  }
  __syncthreads();
  float* Q = tiles;
  for (int e = tid; e < NQ * WD; e += THREADS) Q[e] += tiles[NQ * WD + e];
  __syncthreads();
  vec_add(grad + L.b_l0, Q + (NQ - 1) * WD);
  // w_l0 (384, 128): rows of temb, of x_emb = x·w_x + b_x, of k_emb = table[k]
  pairs.put(L.w_l0, temb, WD, Q + DC * WD, WD);
  for (int i0 = tid; i0 < MAT / 4; i0 += 4 * THREADS) {
    float4* gx[4];
    float4* gk[4];
    float4 vxs[4], vks[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // the loads of four rows in flight together
      gx[u] = reinterpret_cast<float4*>(grad + L.w_l0 + WD * WD) + i0 + u * THREADS;
      gk[u] = reinterpret_cast<float4*>(grad + L.w_l0 + 2 * WD * WD) + i0 + u * THREADS;
      vxs[u] = *gx[u];
      vks[u] = *gk[u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
    const int i = i0 + u * THREADS;
    const int e = i >> 5, o4 = (i & 31) * 4;
    float4 vx = vxs[u], vk = vks[u];
#pragma unroll
    for (int c = 0; c <= DC; ++c) {
      const float a = c < DC ? w[L.w_x + c * WD + e] : w[L.b_x + e];
      const float4 qq = *reinterpret_cast<const float4*>(Q + c * WD + o4);
      vx.x = fmaf(a, qq.x, vx.x);
      vx.y = fmaf(a, qq.y, vx.y);
      vx.z = fmaf(a, qq.z, vx.z);
      vx.w = fmaf(a, qq.w, vx.w);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float a = w[L.table + v * WD + e];
      const float4 qq = *reinterpret_cast<const float4*>(Q + (DC + 1 + v) * WD + o4);
      vk.x = fmaf(a, qq.x, vk.x);
      vk.y = fmaf(a, qq.y, vk.y);
      vk.z = fmaf(a, qq.z, vk.z);
      vk.w = fmaf(a, qq.w, vk.w);
    }
    *gx[u] = vx;
    *gk[u] = vk;
    }
  }
  // dfeats = dz_l0·W_l0ᵀ·m reaches w_x, b_x and the table through Q
  for (int c = 0; c <= DC; ++c) {
    float* dst = c < DC ? grad + L.w_x + c * WD : grad + L.b_x;
    jet_matvec_t(Q + c * WD, w + L.w_l0 + WD * WD, WD, WD, WD, [&](int j, float s) { dst[j] += s; });
  }
  for (int v = 0; v < V; ++v) {
    float* dst = grad + L.table + v * WD;
    jet_matvec_t(Q + (DC + 1 + v) * WD, w + L.w_l0 + 2 * WD * WD, WD, WD, WD,
                 [&](int j, float s) { dst[j] += s; });
  }
}

__global__ void __launch_bounds__(THREADS, 1)
epic_wide_backward_kernel(const float* __restrict__ w, const float* __restrict__ tcw,
                          const float* __restrict__ l0t, const float* __restrict__ tcw_t, Dims d,
                          const float* __restrict__ t,
                          const float* __restrict__ x, const int* __restrict__ k,
                          const float* __restrict__ mask, const float* __restrict__ gout,
                          float* __restrict__ partials, float* __restrict__ records,
                          float* __restrict__ pair_log, int jets_per_block, int B, int N) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = make_layout(d.num_blocks);
  float* grad = partials + (size_t)blockIdx.x * L.row_stride;
  for (int i = threadIdx.x; i < L.total; i += THREADS) grad[i] = 0.f;
  float* base = records + (size_t)blockIdx.x * record_floats(d.num_blocks);
  auto* signs = reinterpret_cast<unsigned*>(base + (size_t)(1 + 2 * d.num_blocks) * MAT);
  float* projv = reinterpret_cast<float*>(signs + (size_t)(1 + d.num_blocks) * SIGN_WORDS);
  const GlobalRecord rec{base, signs, projv, projv + R_PROJ, R_GLOB};
  const int stride = pair_floats(d.num_blocks);
  float* pairs = pair_log + (size_t)blockIdx.x * pair_block_floats(d.num_blocks, jets_per_block);
  int* groups = reinterpret_cast<int*>(pairs + (size_t)jets_per_block * stride);
  __syncthreads();
  int n_jets = 0;
  for (int jet = blockIdx.x; jet < B; jet += gridDim.x, ++n_jets) {
    const size_t p = (size_t)jet * N;
    PairLog log{pairs + (size_t)n_jets * stride, groups, 0, 0};
    wide_forward_jet_ext<GlobalRecord, false, false>(
        w, tcw, l0t, d, L, smem, t[jet], x + p * DC, k + p, nullptr, mask + p, N, nullptr,
        nullptr, rec);
    wide_backward_jet(w, tcw_t, d, L, smem, rec, gout + p * NOUT, N, grad, log);
    __syncthreads();
  }
  contract_pairs(pairs, n_jets, stride, groups, pair_groups(d.num_blocks), grad);
}

// out[e] = Σ_rows partials[row, e], rows in order.
__global__ void wide_reduce_partials(const float* __restrict__ partials, int rows, int stride,
                                     int n, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += partials[(size_t)r * stride + e];
  out[e] = s;
}

inline cudaError_t backward_grid(int B, int* grid) {
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  *grid = sms < B ? sms : B;
  if (*grid < 1) *grid = 1;
  return cudaSuccess;
}

// The general kernel's grid: clusters of H / 128 blocks, at most one block
// an SM, at most one cluster a jet. Jets of more than 128 slots (N > 128):
// clusters of H / 128 × 2 blocks, as many as the card holds at once
// (cudaOccupancyMaxActiveClusters: a cluster of up to 8 blocks of ~213 KB
// must fit in one GPC, so a division of the SMs would overcount), at most
// one a jet.
inline cudaError_t backward_grid_any(const Dims& d, int B, int N, int* grid) {
  const int CL = d.hidden / WD;
  int clusters;
  if (N > ROWS) {
    auto resident = CL == 1 ? resident_backward_clusters<1, 2>
                    : CL == 2 ? resident_backward_clusters<2, 2>
                    : CL == 3 ? resident_backward_clusters<3, 2>
                              : resident_backward_clusters<4, 2>;
    cudaError_t err = resident(&clusters);
    if (err != cudaSuccess) return err;
    clusters = clusters < B ? clusters : B;
    if (clusters < 1) clusters = 1;
    *grid = clusters * CL * 2;
    return cudaSuccess;
  }
  int sms;
  cudaError_t err = backward_grid(1 << 30, &sms);
  if (err != cudaSuccess) return err;
  clusters = sms / CL < B ? sms / CL : B;
  if (clusters < 1) clusters = 1;
  *grid = clusters * CL;
  return cudaSuccess;
}

}  // namespace mmpw

// Every width 128 takes this file's kernel; every other width the wide gate
// takes (MBM's token input and vocabulary-wide head) epic_wide_backward_any.cuh's,
// and so does every width at N > 128 (1 ≤ N ≤ 256), with two row blocks.
extern "C" int mmp_epic_wide_backward_workspace(int B, int N, const int* dims, int* grid,
                                                long long* floats) {
  using namespace mmpw;
  const Dims d = dims_from(dims);
  if (!any_dims_supported(d, false) || N < 1 || N > MAX_RB * ROWS) return cudaErrorInvalidValue;
  if (!dims_supported(d) || N > ROWS) {
    cudaError_t err = backward_grid_any(d, B, N, grid);
    if (err != cudaSuccess) return err;
    const int CS = d.hidden / WD * (N > ROWS ? 2 : 1), clusters = *grid / CS;
    const int jets_per_cluster = (B + clusters - 1) / clusters;
    *floats = (long long)*grid * ((long long)make_layout(d).row_stride + record_floats_any(d) +
                                  pair_block_floats_any(d, CS, jets_per_cluster));
    return cudaSuccess;
  }
  cudaError_t err = backward_grid(B, grid);
  if (err != cudaSuccess) return err;
  const int jets_per_block = (B + *grid - 1) / *grid;
  *floats = (long long)*grid * ((long long)make_layout(d.num_blocks).row_stride +
                                record_floats(d.num_blocks) +
                                pair_block_floats(d.num_blocks, jets_per_block));
  return cudaSuccess;
}

// w: the packed weights; tcw, l0t: the forward's tensor-core stages and
// local_0's tables (as mmp_epic_wide_forward takes them); tcw_t: the
// transposed stages of the walk back's dz·Wᵀ (per layer and column block);
// grid and scratch as mmp_epic_wide_backward_workspace gives them.
extern "C" int mmp_epic_wide_backward(const void* w, const void* tcw, const void* l0t,
                                      const void* tcw_t, const void* t, const void* x,
                                      const void* k, const void* mask, const void* g, void* out,
                                      void* scratch, int grid, int B, int N, const int* dims,
                                      void* stream) {
  using namespace mmpw;
  const Dims d = dims_from(dims);
  if (!any_dims_supported(d, false) || N < 1 || N > MAX_RB * ROWS || grid < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  auto* partials = static_cast<float*>(scratch);
  cudaError_t err;
  if (!dims_supported(d) || N > ROWS) {
    const int CL = d.hidden / WD, CS = CL * (N > ROWS ? 2 : 1);
    if (grid % CS != 0) return cudaErrorInvalidValue;
    const Layout L = make_layout(d);
    const int clusters = grid / CS, jets_per_cluster = (B + clusters - 1) / clusters;
    float* records = partials + (size_t)grid * L.row_stride;
    float* pair_log = records + (size_t)grid * record_floats_any(d);
    auto launch = N > ROWS ? (CL == 1   ? launch_backward_any<1, 2>
                              : CL == 2 ? launch_backward_any<2, 2>
                              : CL == 3 ? launch_backward_any<3, 2>
                                        : launch_backward_any<4, 2>)
                           : (CL == 1   ? launch_backward_any<1>
                              : CL == 2 ? launch_backward_any<2>
                              : CL == 3 ? launch_backward_any<3>
                                        : launch_backward_any<4>);
    if ((err = launch(w, tcw, l0t, tcw_t, d, t, x, k, mask, g, partials, records, pair_log,
                      jets_per_cluster, grid, B, N, s)) != cudaSuccess)
      return err;
    wide_reduce_partials<<<(L.total + 255) / 256, 256, 0, s>>>(
        partials, grid, L.row_stride, L.total, static_cast<float*>(out));
    return cudaGetLastError();
  }
  err = cudaFuncSetAttribute(epic_wide_backward_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES_BWD);
  if (err != cudaSuccess) return err;
  const Layout L = make_layout(d.num_blocks);
  float* records = partials + (size_t)grid * L.row_stride;
  float* pair_log = records + (size_t)grid * record_floats(d.num_blocks);
  const int jets_per_block = (B + grid - 1) / grid;
  epic_wide_backward_kernel<<<grid, THREADS, SMEM_BYTES_BWD, s>>>(
      static_cast<const float*>(w), static_cast<const float*>(tcw), static_cast<const float*>(l0t),
      static_cast<const float*>(tcw_t), d, static_cast<const float*>(t), static_cast<const float*>(x),
      static_cast<const int*>(k), static_cast<const float*>(mask), static_cast<const float*>(g),
      partials, records, pair_log, jets_per_block, B, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wide_reduce_partials<<<(L.total + 255) / 256, 256, 0, s>>>(
      partials, grid, L.row_stride, L.total, static_cast<float*>(out));
  return cudaGetLastError();
}
