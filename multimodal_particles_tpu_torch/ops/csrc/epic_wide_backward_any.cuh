// K5 at the widths epic_wide_backward.cu is not compiled for: MBM's encoder
// (token input, a discrete head as wide as the vocabulary) with the local
// hidden width H, the global width G, the time embedding T and the token
// embeddings each 128, 256, 384 or 512, mixed. The kernel template that
// epic_wide_backward_h{128,256,384,512}.cu instantiate; the entry points are
// epic_wide_backward.cu's.
//
// Design: epic_wide_backward.cu's, on a cluster of CL = H / 128 blocks a
// jet, block `rank` owning columns 128·rank … + 127 of every activation tile
// (epic_wide_any.cuh). The clusters walk over the jets (a persistent grid).
//   * The recording rerun is K4's general forward (wide_forward_jet_any) with
//     a recorder: each block records its own columns of h_in and z_fl1 and
//     its own signs, and its own copy of the per-jet vectors, into its own
//     records.
//   * dz·Wᵀ runs on gemm_cl as the forward's products do, dz from the peers'
//     tiles, the block's own output columns of the transposed stages.
//   * aᵀ·dz for the block's own output columns: outer products over the
//     cluster's column blocks of a, which the block reads from the peers'
//     shared memory (l1 = leaky(z_fl1), from their z_fl1 tiles) or from the
//     peers' records in device memory (h_in, read through L2).
//   * The per-jet vectors of widths up to 512 and their transposed
//     vector-matrix products run in every block of the cluster, in the same
//     order (every block holds the same bits); the gradients they give are
//     shared out by column blocks of 128 (block rank takes columns
//     128·rank, 128·(rank + CL), …): the rank-1 pairs it logs, the biases it
//     adds. The heads' and the output biases' gradients are block 0's.
//   * The heads: each block's columns' part of the output layer for every
//     row, the parts added in block order by every block, which then runs
//     the head's backward for every row (DZ, the cotangent of the 11
//     outputs, in every block).
//   * Every gradient element is added by one block into its own gradient
//     row; the reduction kernel sums the rows.
// Jets of 129 … 256 slots (RB = 2, epic_wide_backward_h*_r2.cu): a cluster of
// CL × 2 row blocks (epic_wide_any.cuh), each block the plan above on its
// 128 rows, with its own records and gradient row. What sums over rows is
// added by each row block for its own rows (the per-row products, the
// biases of fc_local1/fc_local2 and local_0, the heads', the output layer's,
// Q and all that follows from it: each is linear in its rows' cotangents).
// Only the per-jet cotangent Σ_rows dz_fl1 feeds the per-jet vectors'
// backward, whose result every row comes back to: the row blocks' sums meet
// in the reduction buffer behind a cluster barrier, added row block 0 first,
// so that every block runs the global MLP's backward on the same bits; its
// pairs and biases are shared out over all CL × 2 blocks (by cluster rank),
// fc_local1's broadcast pairs are row block 0's.
// Shared memory: the forward's general plan (the tiles h and l1, the ring of
// four stages, the staging area, the forward's vectors) and the walk back's
// vectors after them; the weight gradient's a is never a tile of its own.
#pragma once

#include "epic_wide_any.cuh"
#include "epic_wide_backward.cuh"

namespace mmpw {

constexpr int BA_DZA = A_END, BA_DZB = BA_DZA + MAX_WIDTH, BA_DZC = BA_DZB + MAX_WIDTH,
              BA_DSUM = BA_DZC + MAX_WIDTH, BA_SDZ = BA_DSUM + MAX_WIDTH, BA_DP = BA_SDZ + MAX_WIDTH,
              BA_END = BA_DP + 4 * MAX_WIDTH;
constexpr size_t SMEM_BYTES_BWD_ANY = sizeof(float) * (size_t)(SA_VEC + BA_END);
static_assert(SMEM_BYTES_BWD_ANY <= 232448, "over a block's 227 KB of shared memory");
static_assert(T_BH1 + 8 <= T_DZ && T_DZ + ROWS * 12 <= TC_STAGING, "the staging area overruns");
static_assert(2 * NQ * WD <= TC_STAGING, "Q overruns the staging area");

// Floats of one block's records: (h_in, z_fl1) per EPiC block and the skip
// cotangent's sum, its own columns; the signs of z_l0 and of each block's
// z_fl2; the per-jet vectors.
__host__ __device__ inline long long record_floats_any(const Dims& d) {
  const JetRec R = make_jet_rec(d);
  return (long long)(1 + 2 * d.num_blocks) * MAT + (long long)(1 + d.num_blocks) * SIGN_WORDS +
         R.proj + (long long)d.num_blocks * R.glob;
}

// The block's records in the layout of record_floats_any.
__device__ __forceinline__ GlobalRecord record_at(float* base, const Dims& d, const JetRec& R) {
  auto* signs = reinterpret_cast<unsigned*>(base + (size_t)(1 + 2 * d.num_blocks) * MAT);
  float* projv = reinterpret_cast<float*>(signs + (size_t)(1 + d.num_blocks) * SIGN_WORDS);
  return GlobalRecord{base, signs, projv, projv + R.proj, R.glob};
}

// Pairs and groups a block logs for a jet, at most (block 0 takes the most
// column blocks of a vector); n_out: the width of dz, a blocks' share
// ⌈n_out / 128 / CL⌉ column blocks.
__host__ __device__ inline int owned_blocks(int n_out, int CL) {
  return (n_out / WD + CL - 1) / CL;
}
__host__ __device__ inline int pair_groups_any(const Dims& d, int CL) {
  const int cg = owned_blocks(d.hidden_glob, CL), ch = owned_blocks(d.hidden, CL);
  return d.num_blocks * (1 + cg + ch) + cg + 2 * ch + 1;
}
__host__ __device__ inline int pair_floats_any(const Dims& d, int CL) {
  const int H = d.hidden, G = d.hidden_glob, T = d.emb_t;
  const int cg = owned_blocks(G, CL), ch = owned_blocks(H, CL);
  const int layer = (G + T + WD) + cg * (H + WD) + ch * (2 * H + G + T + WD);
  const int proj = cg * (H + WD) + ch * (H + WD) + ch * (2 * H + T + WD) + (T + WD);
  return d.num_blocks * layer + proj;
}
__host__ __device__ inline long long pair_block_floats_any(const Dims& d, int CL, int jets) {
  return (long long)jets * pair_floats_any(d, CL) +
         ((GROUP_INTS * pair_groups_any(d, CL) + 3) & ~3);
}

// The backward of one jet after the recording forward (S0 holds the block's
// columns of h_final; the peers' records of this jet are complete). tcw_t:
// per EPiC block the stages of W_fl2ᵀ, then of W_fl1[0:H]ᵀ, each as CL column
// blocks of 16·CL stages. `records`/`rec_floats`: every block's records, so
// that the peers' h_in can be read. Accumulates into this block's gradient
// row `grad`. Every thread of the jet's blocks calls it.
// The jet's gout and mask from its slot 0, N slots; `rank` the block's
// column block, `rb` its row block (RB > 1: N > 128).
template <int CL, int RB = 1>
__device__ void wide_backward_jet_any(const float* __restrict__ w, const float* __restrict__ tcw_t,
                                      const Dims& d, const Layout& L, const JetRec& R, float* smem,
                                      const GlobalRecord& rec, const float* records,
                                      long long rec_floats, const float* __restrict__ gout,
                                      const float* __restrict__ mask, int N, float* grad,
                                      PairLog& pairs, int rank, int rb = 0) {
  constexpr int LD = LDA_TC;
  constexpr int NKT = CL * WD / TC_KT;
  constexpr int CS = CL * RB;
  constexpr size_t PROD = (size_t)NKT * TC_STAGE;
  constexpr size_t LAYER = 2 * CL * PROD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = d.num_blocks, H = d.hidden, G = d.hidden_glob, T = d.emb_t;
  const int X = d.emb_x, K = d.emb_k, col0 = WD * rank;
  // the row block's slots row0 … row0 + n − 1; `base` the cluster rank of its
  // column block 0, `me` this block's
  const int row0 = RB > 1 ? ROWS * rb : 0, base = RB > 1 ? CL * rb : 0, me = base + rank;
  const int n = RB > 1 ? min(ROWS, N - row0) : N;
  gout += (size_t)row0 * NOUT;
  const int npad = (n + 15) & ~15, ksteps = (n + 7) / 8;
  float* S0 = smem;
  float* S1 = smem + ROWS * LD;
  float* ring = smem + SA_RING;
  float* tiles = smem + SA_STAGING;
  float* vec = smem + SA_VEC;
  const float* m = vec + A_MASK;
  const float* xs = vec + A_X;
  const int* ks = reinterpret_cast<const int*>(vec + A_K);
  float* temb = vec + A_TEMB;
  float* gnew = temb - G;
  float* pv = vec + A_P;
  float* va = vec + A_VA;
  float* vb = vec + A_VB;
  float* dg = vec + A_G;
  float* dsg = vec + A_GSKIP;
  float* red = vec + A_RED;
  float* dza = vec + BA_DZA;
  float* dzb = vec + BA_DZB;
  float* dzc = vec + BA_DZC;
  float* dsum = vec + BA_DSUM;
  float* sdz = vec + BA_SDZ;
  float* dp = vec + BA_DP;
  float4* S0v = reinterpret_cast<float4*>(S0);
  // the block's records of column peer q of its row block (q = rank: its own)
  auto records_of = [&](int q) {
    return records + (size_t)(blockIdx.x - me + base + q) * (size_t)rec_floats;
  };

  const float denom = jet_denominator<RB>(m, mask, N);

  // ---- heads: each block's part of every row's outputs, then in every
  // block the masked cotangents of (cont ‖ disc_pre) of every row into DZ
  // (128, 12) in the staging area; the heads' gradients are block 0's
  stage_outputs_own(w, L, col0, tiles);
  if (tid < V) {
    tiles[T_BH0 + tid] = w[L.b_h0 + tid];
    tiles[T_BH1 + tid] = w[L.b_h1 + tid];
  }
  if (tid < V * V) {
    tiles[T_WH0 + tid] = w[L.h0 + tid];
    tiles[T_WH1 + tid] = w[L.h1 + tid];
  }
  for (int j = tid; j < G; j += THREADS) {
    dg[j] = 0.f;
    dsg[j] = 0.f;
  }
  __syncthreads();
  float* part = dp;
  output_parts(S0, tiles, n, part);
  cluster_sync<CS>();  // every block's parts
  float* DZ = tiles + T_DZ;
  {
    float gh1[2] = {0.f, 0.f}, gh0[2] = {0.f, 0.f}, gb1 = 0.f, gb0 = 0.f;
    const int u0 = lane >> 3, u1 = u0 + 4, v0 = lane & 7;
    for (int r = warp; r < ROWS; r += THREADS / 32) {
      float p[NOUT], gc[DC], gd[V], dd[V];
      const bool real = r < n;
      if (real) {
        row_from_parts<CL, CS>(part, tiles, m[r], r, rank, p, base);
      } else {
#pragma unroll
        for (int o = 0; o < NOUT; ++o) p[o] = 0.f;
      }
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
    if (d.add_discrete_head && rank == 0) {
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
  cluster_sync<CS>();  // every block has read the parts: the part buffer is free
  // output layer, the block's rows: dW (own 128, 11) = h_finalᵀ·DZ; db = Σ_rows DZ (block 0)
  {
    const int i = tid & (WD - 1), o_lo = tid < WD ? 0 : 6, o_hi = tid < WD ? 6 : NOUT;
    float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < ROWS; ++r) {
      const float hv = S0[r * LD + i];
#pragma unroll
      for (int o = 0; o < 6; ++o)
        if (o_lo + o < o_hi) s[o] = fmaf(hv, DZ[r * 12 + o_lo + o], s[o]);
    }
    float* dst[6];
    float old[6];
#pragma unroll
    for (int o = 0; o < 6; ++o) {
      const int oo = o_lo + o;
      dst[o] = oo < DC ? grad + L.out_c + (col0 + i) * DC + oo
                       : oo < o_hi ? grad + L.out_d + (col0 + i) * V + (oo - DC) : nullptr;
      old[o] = dst[o] != nullptr ? *dst[o] : 0.f;
    }
#pragma unroll
    for (int o = 0; o < 6; ++o)
      if (dst[o] != nullptr) *dst[o] = old[o] + s[o];
    if (rank == 0 && tid < NOUT) {
      float b = 0.f;
      for (int r = 0; r < ROWS; ++r) b += DZ[r * 12 + tid];
      if (tid < DC) grad[L.b_out_c + tid] += b;
      else grad[L.b_out_d + tid - DC] += b;
    }
  }
  __syncthreads();
  // dh = DZ·W_outᵀ, the block's columns, replaces h_final in S0
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
    const float* tb = tcw_t + (size_t)blk * LAYER;
    const int boff = L.blocks + blk * L.block_stride;
    float* gb = grad + boff;
    const float* gv = rec.globv + blk * R.glob;
    // S0 ← dz_fl2, S1 ← z_fl1 (the block's columns), the records fetched by
    // cp.async first; the per-jet vectors p, g1, g_new
    const unsigned* sgn = reinterpret_cast<const unsigned*>(tiles);
    tile_to_smem_async(S1, rec.z_fl1_mat(blk));
    signs_to_smem_async(reinterpret_cast<unsigned*>(tiles), rec.z_fl2_signs(blk));
    for (int i = tid; i < 2 * H + G + T; i += THREADS) pv[i] = gv[R.p + i];
    for (int j = tid; j < G; j += THREADS) {
      if (d.use_skip) dsg[j] += dg[j];
      gnew[j] = leaky(gv[R.zfg2 + j]);
    }
    for (int j = tid; j < H; j += THREADS) va[j] = leaky(gv[R.zfg1 + j]);
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
      }
      if (d.use_skip)
#pragma unroll
        for (int u = 0; u < 4; ++u) dsl[i0 + u * THREADS] = sk[u];
    }
    cluster_sync<CS>();  // every block's dz_fl2 and z_fl1
    // fc_local2: dW[rows of block q, own columns] += l1_qᵀ·dz_fl2, l1 = leaky(z_fl1) of
    // block q's tile; db = Σ_rows dz_fl2
    for (int q = 0; q < CL; ++q) {
      const float* s1q = peer_ptr<CS>(S1, base + q, me);
      outer_mma(gb + L.fl2 + (size_t)WD * q * H + col0, H,
                [&](int r, int c) { return leaky(s1q[r * LD + c]); }, S0, ksteps);
    }
    column_sums<LD>(S0, red, [](int, float v) { return v; },
                    [&](int c, float s) { gb[L.bfl2 + col0 + c] += s; });
    cluster_sync<CS>();  // every block has read this block's z_fl1
    // dz_fl1 = (dz_fl2·W_fl2ᵀ)·leaky'(z_fl1), in place of z_fl1
    ring_prefetch<RING_ANY>(tb + rank * PROD, ring);
    acc.zero();
    gemm_cl<CL, CS>(acc, S0, tb + rank * PROD, ring, nullptr, npad, rank, base);
    acc.each([&](int, int r, int c, float a) { S1[r * LD + c] = a * dleaky(S1[r * LD + c]); });
    cluster_sync<CS>();  // every block's dz_fl1; every read of dz_fl2 is done
    // fc_local1: the per-particle third (h_in of block q from its records),
    // then the broadcast [g_new ‖ temb] thirds from the per-jet sum of dz_fl1
    for (int q = 0; q < CL; ++q) {
      const float* hq = GlobalRecord{const_cast<float*>(records_of(q)), nullptr, nullptr,
                                        nullptr, 0}.h_in_mat(blk);
      outer_mma(gb + L.fl1 + (size_t)WD * q * H + col0, H,
                [&](int r, int c) { return __ldcg(hq + r * WD + c); }, S1, ksteps);
    }
    if constexpr (RB == 1) {
      column_sums<LD>(S1, red, [](int, float v) { return v; }, [&](int c, float s) {
        for (int q = 0; q < CL; ++q) peer_ptr<CL>(sdz, q, rank)[col0 + c] = s;
        gb[L.bfl1 + col0 + c] += s;
      });
    } else {
      // the row blocks' sums meet in red[RED_ROWS …], row block 0 first
      column_sums<LD>(S1, red, [](int, float v) { return v; }, [&](int c, float s) {
        red[RED_ROWS + c] = s;
        gb[L.bfl1 + col0 + c] += s;
      });
      cluster_sync<CS>();  // every row block's sums
      if (tid < WD) {
        float s = 0.f;
        for (int r = 0; r < RB; ++r) s += peer_ptr<CS>(red, r * CL + rank, me)[RED_ROWS + tid];
        for (int q = 0; q < CL; ++q) peer_ptr<CS>(sdz, base + q, me)[col0 + tid] = s;
      }
    }
    if (rb == 0) pairs.put(boff + L.fl1 + H * H + col0, gnew, G + T, sdz + col0, H);
    // dh_in = dz_fl2 (residual) + dz_fl1·W_fl1[0:H]ᵀ
    ring_prefetch<RING_ANY>(tb + (CL + rank) * PROD, ring);
    acc.zero();
    gemm_cl<CL, CS>(acc, S1, tb + (CL + rank) * PROD, ring, nullptr, npad, rank, base);
    acc.each([&](int, int r, int c, float a) { S0[r * LD + c] += a; });
    cluster_sync<CS>();  // every block's Σdz_fl1; every read of dz_fl1 is done
    // global MLP: dz_fg2 = (dg + W_fl1[H:H+G]·Σdz_fl1)·leaky'(z_fg2)
    jet_matvec_t(sdz, wb + L.fl1 + (size_t)H * H, H, H, G, [&](int j, float s) {
      dza[j] = (dg[j] + s) * dleaky(gv[R.zfg2 + j]);
    });
    pairs.put_shared(boff + L.fg2, va, H, dza, G, me, CS);
    vec_add(gb + L.bfg2, dza, G, me, CS);
    jet_matvec_t(dza, wb + L.fg2, G, G, H, [&](int j, float s) {
      dzb[j] = s * dleaky(gv[R.zfg1 + j]);
    });
    pairs.put_shared(boff + L.fg1, pv, 2 * H + G + T, dzb, H, me, CS);
    vec_add(gb + L.bfg1, dzb, H, me, CS);
    jet_matvec_t(dzb, wb + L.fg1, H, H, 2 * H + G, [&](int j, float s) { dp[j] = s; });
    for (int j = tid; j < H; j += THREADS) dsum[j] = dp[H + j] + dp[j] / denom;
    for (int j = tid; j < G; j += THREADS) dg[j] = dza[j] + dp[2 * H + j];
    __syncthreads();
    // s = pool(h_in·mask) → dh_in += dsum·mask
    for (int i = tid; i < MAT / 4; i += THREADS) {
      const float mr = m[i >> 5];
      const float4 ds = *reinterpret_cast<const float4*>(dsum + col0 + (i & 31) * 4);
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
    for (int i = tid; i < 2 * H + T; i += THREADS) pv[i] = pj[R.p0 + i];
    for (int j = tid; j < G; j += THREADS) {
      if (d.use_skip) dg[j] += dsg[j];
      dza[j] = dg[j] * dleaky(pj[R.zg2 + j]);
    }
    for (int j = tid; j < H; j += THREADS) {
      va[j] = leaky(pj[R.zg0 + j]);  // a_g0
      vb[j] = leaky(pj[R.zg1 + j]);  // a_g1
    }
    __syncthreads();
    pairs.put_shared(L.w_g2, vb, H, dza, G, me, CS);
    vec_add(grad + L.b_g2, dza, G, me, CS);
    jet_matvec_t(dza, w + L.w_g2, G, G, H,
                 [&](int j, float s) { dzb[j] = s * dleaky(pj[R.zg1 + j]); });
    pairs.put_shared(L.w_g1, va, H, dzb, H, me, CS);
    vec_add(grad + L.b_g1, dzb, H, me, CS);
    jet_matvec_t(dzb, w + L.w_g1, H, H, H,
                 [&](int j, float s) { dzc[j] = s * dleaky(pj[R.zg0 + j]); });
    pairs.put_shared(L.w_g0, pv, 2 * H + T, dzc, H, me, CS);
    vec_add(grad + L.b_g0, dzc, H, me, CS);
    jet_matvec_t(dzc, w + L.w_g0, H, H, 2 * H, [&](int j, float s) { dp[j] = s; });
    for (int j = tid; j < H; j += THREADS) dsum[j] = dp[H + j] + dp[j] / denom;
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
      const float4 ds = *reinterpret_cast<const float4*>(dsum + col0 + (i & 31) * 4);
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
  // Q = Rᵀ·dz_l0 (12, own 128) for R = [x·m ‖ m ‖ onehot(k)·m], and as row 12
  // the plain column sum (b_l0's gradient); the two halves of the rows meet
  // in the staging area
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
  if (tid < WD) grad[L.b_l0 + col0 + tid] += Q[(NQ - 1) * WD + tid];
  // w_l0 ((T + X + K), H), the block's columns: rows of temb (a pair), of
  // x_emb = x·w_x + b_x and of k_emb = table[k] (through Q, the block's rows)
  pairs.put(L.w_l0 + col0, temb, T, Q + DC * WD, H);
  for (int idx = tid; idx < (X + K) * (WD / 4); idx += THREADS) {
    const int e = idx >> 5, o4 = (idx & 31) * 4;
    float4* dst = reinterpret_cast<float4*>(grad + L.w_l0 + (size_t)(T + e) * H + col0 + o4);
    float4 acc4 = *dst;
    if (e < X) {
#pragma unroll
      for (int c = 0; c <= DC; ++c) {
        const float a = c < DC ? w[L.w_x + c * X + e] : w[L.b_x + e];
        const float4 qq = *reinterpret_cast<const float4*>(Q + c * WD + o4);
        acc4.x = fmaf(a, qq.x, acc4.x);
        acc4.y = fmaf(a, qq.y, acc4.y);
        acc4.z = fmaf(a, qq.z, acc4.z);
        acc4.w = fmaf(a, qq.w, acc4.w);
      }
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float a = w[L.table + v * K + (e - X)];
        const float4 qq = *reinterpret_cast<const float4*>(Q + (DC + 1 + v) * WD + o4);
        acc4.x = fmaf(a, qq.x, acc4.x);
        acc4.y = fmaf(a, qq.y, acc4.y);
        acc4.z = fmaf(a, qq.z, acc4.z);
        acc4.w = fmaf(a, qq.w, acc4.w);
      }
    }
    *dst = acc4;
  }
  // dfeats = dz_l0·W_l0ᵀ·m reaches w_x, b_x and the table through Q: each
  // block adds its columns' part
  for (int c = 0; c <= DC; ++c) {
    float* dst = c < DC ? grad + L.w_x + c * X : grad + L.b_x;
    jet_matvec_t(Q + c * WD, w + L.w_l0 + (size_t)T * H + col0, WD, H, X,
                 [&](int j, float s) { dst[j] += s; });
  }
  for (int v = 0; v < V; ++v) {
    float* dst = grad + L.table + v * K;
    jet_matvec_t(Q + (DC + 1 + v) * WD, w + L.w_l0 + (size_t)(T + X) * H + col0, WD, H, K,
                 [&](int j, float s) { dst[j] += s; });
  }
}

template <int CL, int RB = 1>
__global__ void __launch_bounds__(THREADS, 1)
epic_wide_backward_any_kernel(const float* __restrict__ w, const float* __restrict__ tcw,
                              const float* __restrict__ l0t, const float* __restrict__ tcw_t,
                              Dims d, const float* __restrict__ t, const float* __restrict__ x,
                              const int* __restrict__ k, const float* __restrict__ mask,
                              const float* __restrict__ gout, float* __restrict__ partials,
                              float* __restrict__ records, float* __restrict__ pair_log,
                              int jets_per_cluster, int B, int N) {
  extern __shared__ __align__(16) float smem[];
  constexpr int CS = CL * RB;
  int me = 0;  // the cluster rank: row block me / CL, column block me % CL
  if constexpr (CS > 1) me = (int)cg::this_cluster().block_rank();
  const int rank = RB == 1 ? me : me % CL, rb = RB == 1 ? 0 : me / CL;
  const Layout L = make_layout(d);
  const JetRec R = make_jet_rec(d);
  float* grad = partials + (size_t)blockIdx.x * L.row_stride;
  for (int i = threadIdx.x; i < L.total; i += THREADS) grad[i] = 0.f;
  const long long rec_floats = record_floats_any(d);
  const GlobalRecord rec = record_at(records + (size_t)blockIdx.x * (size_t)rec_floats, d, R);
  const int stride = pair_floats_any(d, CS);
  float* pairs = pair_log + (size_t)blockIdx.x * pair_block_floats_any(d, CS, jets_per_cluster);
  int* groups = reinterpret_cast<int*>(pairs + (size_t)jets_per_cluster * stride);
  cluster_sync<CS>();  // every block of the cluster has started
  int n_jets = 0, n_groups = 0;
  for (int jet = blockIdx.x / CS; jet < B; jet += gridDim.x / CS, ++n_jets) {
    const size_t p = (size_t)jet * N;
    PairLog log{pairs + (size_t)n_jets * stride, groups, 0, 0};
    wide_forward_jet_any<GlobalRecord, false, CL, RB>(
        w, tcw, l0t, d, L, R, smem, t[jet], x + p * DC, k + p, nullptr, mask + p, N, nullptr,
        nullptr, rec, rank, rb);
    wide_backward_jet_any<CL, RB>(w, tcw_t, d, L, R, smem, rec, records, rec_floats,
                                  gout + p * NOUT, mask + p, N, grad, log, rank, rb);
    n_groups = log.idx;
    cluster_sync<CS>();  // the peers are done with this jet's tiles and records
  }
  contract_pairs(pairs, n_jets, stride, groups, n_groups, grad);
}

// The launch at local hidden width 128·CL and RB row blocks a jet (RB = 2:
// N > 128), grid blocks; one source a width and row-block count. At RB = 2
// the persistent grid is as many clusters as the card holds at once
// (`resident_backward_clusters`), at most one a jet.
template <int CL, int RB = 1>
cudaError_t launch_backward_any(const void* w, const void* tcw, const void* l0t,
                                const void* tcw_t, const Dims& d, const void* t, const void* x,
                                const void* k, const void* mask, const void* g, float* partials,
                                float* records, float* pair_log, int jets_per_cluster, int grid,
                                int B, int N, cudaStream_t s);
template <int CL, int RB>
cudaError_t resident_backward_clusters(int* clusters);

#define MMPW_BACKWARD_ANY_DECL(CL, RB)                                                           \
  template <>                                                                                    \
  cudaError_t launch_backward_any<CL, RB>(const void* w, const void* tcw, const void* l0t,      \
                                          const void* tcw_t, const Dims& d, const void* t,      \
                                          const void* x, const void* k, const void* mask,       \
                                          const void* g, float* partials, float* records,       \
                                          float* pair_log, int jets_per_cluster, int grid,      \
                                          int B, int N, cudaStream_t s);
MMPW_BACKWARD_ANY_DECL(1, 1)
MMPW_BACKWARD_ANY_DECL(2, 1)
MMPW_BACKWARD_ANY_DECL(3, 1)
MMPW_BACKWARD_ANY_DECL(4, 1)
MMPW_BACKWARD_ANY_DECL(1, 2)
MMPW_BACKWARD_ANY_DECL(2, 2)
MMPW_BACKWARD_ANY_DECL(3, 2)
MMPW_BACKWARD_ANY_DECL(4, 2)
template <> cudaError_t resident_backward_clusters<1, 2>(int* clusters);
template <> cudaError_t resident_backward_clusters<2, 2>(int* clusters);
template <> cudaError_t resident_backward_clusters<3, 2>(int* clusters);
template <> cudaError_t resident_backward_clusters<4, 2>(int* clusters);

#define MMPW_BACKWARD_ANY_ROWS(CL, RB)                                                           \
  template <>                                                                                    \
  cudaError_t launch_backward_any<CL, RB>(const void* w, const void* tcw, const void* l0t,      \
                                          const void* tcw_t, const Dims& d, const void* t,      \
                                          const void* x, const void* k, const void* mask,       \
                                          const void* g, float* partials, float* records,       \
                                          float* pair_log, int jets_per_cluster, int grid,      \
                                          int B, int N, cudaStream_t s) {                        \
    return launch_clusters<CL * RB>(                                                             \
        epic_wide_backward_any_kernel<CL, RB>, grid / (CL * RB), SMEM_BYTES_BWD_ANY, s,          \
        static_cast<const float*>(w), static_cast<const float*>(tcw),                            \
        static_cast<const float*>(l0t), static_cast<const float*>(tcw_t), d,                     \
        static_cast<const float*>(t), static_cast<const float*>(x), static_cast<const int*>(k),  \
        static_cast<const float*>(mask), static_cast<const float*>(g), partials, records,        \
        pair_log, jets_per_cluster, B, N);                                                       \
  }
// one row block (N ≤ 128)
#define MMPW_BACKWARD_ANY(CL) MMPW_BACKWARD_ANY_ROWS(CL, 1)
// two row blocks (N > 128), and the persistent grid's cluster count
#define MMPW_BACKWARD_ANY_R2(CL)                                                                 \
  MMPW_BACKWARD_ANY_ROWS(CL, 2)                                                                  \
  template <>                                                                                    \
  cudaError_t resident_backward_clusters<CL, 2>(int* clusters) {                                 \
    return resident_clusters<CL * 2>(epic_wide_backward_any_kernel<CL, 2>, SMEM_BYTES_BWD_ANY,   \
                                     clusters);                                                  \
  }

}  // namespace mmpw
