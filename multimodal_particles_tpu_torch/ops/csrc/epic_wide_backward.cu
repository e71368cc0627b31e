// K5 backward: d(packed weights) of the wide fused EPiC forward for a
// cotangent g (B, N, 3 + 8), in one persistent launch plus a deterministic
// reduction.
//
// Replaces the TPU kernel multimodal_particles_tpu/ops/epic_pallas_wide_vjp.py
// (`make_epic_train_forward_wide`, body `_bwd_kernel`, :90-238). The forward
// of the same custom op is the K4 kernel (epic_wide_forward.cu): the JAX
// `_fwd_kernel` runs the same `_forward_acts_wide`.
//
// Design.
//   * A block walks over jets (jet = blockIdx.x, += gridDim.x). For each jet
//     it reruns the shared forward (epic_wide.cuh) with a recorder that
//     writes what the walk back needs to this block's slice of a global
//     scratch: per particle z_l0 and, per EPiC block, h_in, z_fl1, z_fl2
//     (19 tiles of 64 KB at 6 blocks: no shared memory holds them); per jet
//     the pooled inputs and pre-activations of the global MLP. It reads no
//     residual of the forward launch.
//   * The walk back keeps the cotangent of h as a tile in shared memory.
//     dz·Wᵀ products stream W transposed through the weight buffer; weight
//     gradients aᵀ·dz contract the row axis of two tiles, each thread owning
//     an 8 × 8 piece. Gradients of what is the same for every particle of a
//     jet (the global MLP, the broadcast thirds of fc_local1 and local_0)
//     are rank-1 in a jet's vectors, and they are three quarters of the
//     packed buffer: a jet only logs the vector pairs (a, dz), 36 KB, and
//     when the block has walked all its jets it contracts the pairs over
//     them, so those rows of the gradient are written once a block and not
//     once a jet. local_0's input side needs no 128-row product: with
//     R = [x·m ‖ m ‖ onehot(k)·m] (128, 12) and Q = Rᵀ·dz_l0 (12, 128), every
//     gradient of w_x, b_x, the table and w_l0 is a product of Q with a
//     weight.
//   * Masking follows `_bwd_kernel`: the heads' cotangents are masked, pooled
//     cotangents come back times the mask, the mean's denominator is
//     max(Σmask, 1). leaky'(0) = 1 and selu'(0) = scale, as `_dleaky`/`_dselu`.
//   * Each block accumulates into its own row of a (grid, n_weights) buffer
//     (a thread always owns the same elements, so no atomics); a second
//     kernel sums the rows in a fixed order. The result does not depend on
//     the schedule. grid = one block per SM, at most B.
//
// What bounds it. About three times the forward's arithmetic (the rerun, two
// dz·Wᵀ and two aᵀ·dz products per EPiC block). Beside that, per jet: the
// per-particle quarter of the block's gradient row (1 MB at 6 blocks) is
// read and written once, the records (1.3 MB) written and read back, and
// the packed weights streamed twice from L2. The scratch is grid × (row +
// records + the block's jets × pairs), 1.0 GB for 8192 jets on 132 SMs.
//
// C interface (bound with ctypes by ops/epic_wide_vjp_cuda.py): each entry
// point returns the cudaError_t of its calls, 0 on success.

#include "epic_wide.cuh"

namespace mmpw {

constexpr int NQ = DC + 1 + V + 1;  // rows of Q in the local_0 backward

__device__ __forceinline__ float dleaky(float z) { return z >= 0.f ? 1.f : 0.01f; }

__device__ __forceinline__ float dselu(float z) {
  const float alpha = 1.6732632423543772f, scale = 1.0507009873554805f;
  return scale * (z >= 0.f ? 1.f : alpha * expf(z));
}

// Floats of one block's records: z_l0, (h_in, z_fl1, z_fl2) per EPiC block,
// the skip cotangent's sum, then the per-jet vectors.
__host__ __device__ inline long long record_floats(int num_blocks) {
  return (long long)(2 + 3 * num_blocks) * MAT + R_PROJ + (long long)num_blocks * R_GLOB;
}

struct GlobalRecord {
  static constexpr bool HEADS = false;
  float* mats;
  float* projv;
  float* globv;

  __device__ __forceinline__ float* mat(int i) const { return mats + (size_t)i * MAT; }
  __device__ __forceinline__ float* z_l0_mat() const { return mat(0); }
  __device__ __forceinline__ float* h_in_mat(int b) const { return mat(1 + 3 * b); }
  __device__ __forceinline__ float* z_fl1_mat(int b) const { return mat(2 + 3 * b); }
  __device__ __forceinline__ float* z_fl2_mat(int b) const { return mat(3 + 3 * b); }
  __device__ __forceinline__ float* dsl_mat(int nb) const { return mat(1 + 3 * nb); }

  __device__ __forceinline__ void z_l0(int r, int c, float v) const { mat(0)[r * WD + c] = v; }
  __device__ __forceinline__ void z_fl1(int b, int r, int c, float v) const {
    z_fl1_mat(b)[r * WD + c] = v;
  }
  __device__ __forceinline__ void z_fl2(int b, int r, int c, float v) const {
    z_fl2_mat(b)[r * WD + c] = v;
  }
  __device__ __forceinline__ void h_in(int b, const float* S) const {
    float4* dst = reinterpret_cast<float4*>(h_in_mat(b));
    const float4* src = reinterpret_cast<const float4*>(S);
    for (int i = threadIdx.x; i < MAT / 4; i += THREADS) dst[i] = src[i];
  }
  __device__ __forceinline__ void proj(int i, float v) const { projv[i] = v; }
  __device__ __forceinline__ void glob(int b, int i, float v) const { globv[b * R_GLOB + i] = v; }
};

// acc += A · Wᵀ for A (128, 128) in shared memory and W (128, 128) row-major
// in global memory: the tile of Wᵀ is transposed on its way into the buffer.
// Every thread calls it; it ends with a barrier.
__device__ __forceinline__ void gemm_acc_t(float (&acc)[8][8], const float* A,
                                           const float* __restrict__ Wg, float* tiles) {
  const int j = threadIdx.x & (WD - 1), q = threadIdx.x >> 7;
  const float4* src = reinterpret_cast<const float4*>(Wg + (size_t)j * WD + q * 8);
  float4 n0 = __ldg(src), n1 = __ldg(src + 1);
  for (int kt = 0; kt < WD / KT; ++kt) {
    float* tile = tiles + (kt & 1) * KT * WD + q * 8 * WD + j;
    tile[0 * WD] = n0.x; tile[1 * WD] = n0.y; tile[2 * WD] = n0.z; tile[3 * WD] = n0.w;
    tile[4 * WD] = n1.x; tile[5 * WD] = n1.y; tile[6 * WD] = n1.z; tile[7 * WD] = n1.w;
    if (kt + 1 < WD / KT) {
      n0 = __ldg(src + (kt + 1) * (KT / 4));
      n1 = __ldg(src + (kt + 1) * (KT / 4) + 1);
    }
    // one barrier a tile: the buffer written two tiles on is the one every
    // thread has left by then
    __syncthreads();
    tile_fma(acc, A, kt * KT, tiles + (kt & 1) * KT * WD);
  }
  __syncthreads();
}

// acc[ii][j] += Σ_rows fa(A[r, 8·ty + ii]) · D[r, col(j)]: the thread's piece
// of aᵀ·dz for two tiles in shared memory.
template <class FA>
__device__ __forceinline__ void outer_acc(float (&acc)[8][8], const float* A, FA fa,
                                          const float* D) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 2
  for (int r = 0; r < ROWS; ++r) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + r * WD + ty * 8);
    const float4 a1 = *reinterpret_cast<const float4*>(A + r * WD + ty * 8 + 4);
    const float4 lo = *reinterpret_cast<const float4*>(D + r * WD + tx * 4);
    const float4 hi = *reinterpret_cast<const float4*>(D + r * WD + 64 + tx * 4);
    const float a[8] = {fa(a0.x), fa(a0.y), fa(a0.z), fa(a0.w),
                        fa(a1.x), fa(a1.y), fa(a1.z), fa(a1.w)};
    const float dz[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], dz[j], acc[i][j]);
  }
}

// gm (128, 128) += the thread's piece from outer_acc.
__device__ __forceinline__ void add_outer(float* gm, const float (&acc)[8][8]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float4* p = reinterpret_cast<float4*>(gm + (ty * 8 + i) * WD + hh * 64 + tx * 4);
      float4 v = *p;
      v.x += acc[i][4 * hh + 0];
      v.y += acc[i][4 * hh + 1];
      v.z += acc[i][4 * hh + 2];
      v.w += acc[i][4 * hh + 3];
      *p = v;
    }
  }
}

// Rank-1 weight gradients a ⊗ dz of one jet, logged and not applied: `put`
// copies the pair to this jet's record and notes (gradient offset, rows,
// record offset) in the block's group table; every jet logs the same groups
// in the same order. Every thread of the block calls `put`.
constexpr int GROUP_INTS = 3;
__host__ __device__ inline int pair_groups(int num_blocks) { return 3 * num_blocks + 4; }
__host__ __device__ inline int pair_floats(int num_blocks) {
  return num_blocks * (2 + 1 + 4 + 3) * WD + (1 + 1 + 3 + 1 + 4) * WD;
}

// Floats of one block's pair log: its jets' records, then the group table.
__host__ __device__ inline long long pair_block_floats(int num_blocks, int jets_per_block) {
  return (long long)jets_per_block * pair_floats(num_blocks) +
         ((GROUP_INTS * pair_groups(num_blocks) + 3) & ~3);
}

struct PairLog {
  float* rec;
  int* groups;
  int off, idx;

  __device__ __forceinline__ void put(int grad_offset, const float* a, int n_a, const float* dz) {
    const int tid = threadIdx.x;
    for (int i = tid; i < n_a; i += THREADS) rec[off + i] = a[i];
    if (tid < WD) rec[off + n_a + tid] = dz[tid];
    if (tid == 0) {
      groups[GROUP_INTS * idx] = grad_offset;
      groups[GROUP_INTS * idx + 1] = n_a;
      groups[GROUP_INTS * idx + 2] = off;
    }
    off += n_a + WD;
    ++idx;
  }
};

// grad[g.offset + i·128 + o] += Σ_jets a_jet[i]·dz_jet[o] for every logged
// group, jets in the order the block walked them. A thread owns 4 rows × 4
// columns at a time. Every thread of the block calls it.
__device__ __forceinline__ void contract_pairs(const float* pairs, int n_jets, int stride,
                                               const int* groups, int n_groups, float* grad) {
  const int o4 = (threadIdx.x & 31) * 4, ig = (threadIdx.x >> 5) * 4;
  for (int g = 0; g < n_groups; ++g) {
    const int goff = groups[GROUP_INTS * g], n_a = groups[GROUP_INTS * g + 1];
    const float* base = pairs + groups[GROUP_INTS * g + 2];
    for (int i0 = ig; i0 < n_a; i0 += 32) {
      float4 acc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int j = 0; j < n_jets; ++j) {
        const float* rec = base + (size_t)j * stride;
        const float4 dz = __ldg(reinterpret_cast<const float4*>(rec + n_a + o4));
        const float4 a = __ldg(reinterpret_cast<const float4*>(rec + i0));
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r].x = fmaf(av[r], dz.x, acc[r].x);
          acc[r].y = fmaf(av[r], dz.y, acc[r].y);
          acc[r].z = fmaf(av[r], dz.z, acc[r].z);
          acc[r].w = fmaf(av[r], dz.w, acc[r].w);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float4* p = reinterpret_cast<float4*>(grad + goff + (size_t)(i0 + r) * WD + o4);
        float4 v = *p;
        v.x += acc[r].x; v.y += acc[r].y; v.z += acc[r].z; v.w += acc[r].w;
        *p = v;
      }
    }
  }
}

__device__ __forceinline__ void vec_add(float* gb, const float* dz) {
  if (threadIdx.x < WD) gb[threadIdx.x] += dz[threadIdx.x];
}

// out[j] = Σ_o v[o]·W[j, o] for j < n_out, W rows of 128 in global memory:
// one warp a row; lane 0 calls post(j, out[j]). Ends with a barrier.
template <class Post>
__device__ __forceinline__ void jet_matvec_t(const float* v, const float* __restrict__ Wg,
                                             int n_out, Post post) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4 vv = *reinterpret_cast<const float4*>(v + lane * 4);
  for (int j = warp; j < n_out; j += THREADS / 32) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(Wg + (size_t)j * WD) + lane);
    float s = vv.x * w.x;
    s = fmaf(vv.y, w.y, s);
    s = fmaf(vv.z, w.z, s);
    s = fmaf(vv.w, w.w, s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) post(j, s);
  }
  __syncthreads();
}

// The backward of one jet after the recording forward (S0 holds h_final);
// accumulates into this block's gradient row `grad`. Every thread calls it.
__device__ void wide_backward_jet(const float* __restrict__ w, const Dims& d, const Layout& L,
                                  float* smem, const GlobalRecord& rec,
                                  const float* __restrict__ gout, int N, float* grad,
                                  PairLog& pairs) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = d.num_blocks;
  float* S0 = smem;
  float* S1 = smem + MAT;
  float* S2 = smem + 2 * MAT;
  float* tiles = smem + S_TILE;
  float* vec = smem + S_VEC;
  const float* m = vec + V_MASK;
  const float* xs = vec + V_X;
  const int* ks = reinterpret_cast<const int*>(vec + V_K);
  float* gnew = vec + V_GNEW;
  const float* temb = vec + V_TEMB;
  float* pv = vec + V_P;
  float* va = vec + V_VA;
  float* vb = vec + V_VB;
  float* dg = vec + V_DG;
  float* dsg = vec + V_DSG;
  float* dza = vec + V_DZA;
  float* dzb = vec + V_DZB;
  float* dzc = vec + V_DZC;
  float* dp = vec + V_DP;
  float* dsum = vec + V_DSUM;
  float* sdz = vec + V_SDZ;
  float* red = vec + V_RED;
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
      row_outputs(S0 + r * WD, tiles, m[r], p);
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
      const float hv = S0[r * WD + i];
#pragma unroll
      for (int o = 0; o < 6; ++o)
        if (o_lo + o < o_hi) s[o] = fmaf(hv, DZ[r * 12 + o_lo + o], s[o]);
    }
#pragma unroll
    for (int o = 0; o < 6; ++o) {
      const int oo = o_lo + o;
      if (oo < DC) grad[L.out_c + i * DC + oo] += s[o];
      else if (oo < o_hi) grad[L.out_d + i * V + (oo - DC)] += s[o];
    }
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
    S0[idx] = s;
  }
  float4* dsl = reinterpret_cast<float4*>(rec.dsl_mat(nb));
  if (d.use_skip)
    for (int i = tid; i < MAT / 4; i += THREADS) dsl[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  float acc[8][8];

  // ---- EPiC layers, reversed (epic_pallas_wide_vjp.py:145-187)
  for (int blk = nb - 1; blk >= 0; --blk) {
    const float* wb = w + L.blocks + (size_t)blk * L.block_stride;
    const int boff = L.blocks + blk * L.block_stride;
    float* gb = grad + boff;
    const float* gv = rec.globv + blk * R_GLOB;
    // h_out = leaky(z_fl2)·m + skip: S0 ← dz_fl2, S1 ← z_fl1, and the
    // per-jet vectors p, g1, g_new
    {
      const float4* z2 = reinterpret_cast<const float4*>(rec.z_fl2_mat(blk));
      const float4* z1 = reinterpret_cast<const float4*>(rec.z_fl1_mat(blk));
      for (int i = tid; i < MAT / 4; i += THREADS) {
        float4 v = S0v[i];
        if (d.use_skip) {
          float4 s = dsl[i];
          s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
          dsl[i] = s;
        }
        const float mr = m[i >> 5];
        const float4 z = z2[i];
        v.x *= mr * dleaky(z.x);
        v.y *= mr * dleaky(z.y);
        v.z *= mr * dleaky(z.z);
        v.w *= mr * dleaky(z.w);
        S0v[i] = v;
        S1v[i] = z1[i];
      }
      for (int i = tid; i < 4 * WD; i += THREADS) pv[i] = gv[R_P + i];
      if (tid < WD) {
        if (d.use_skip) dsg[tid] += dg[tid];
        va[tid] = leaky(gv[R_ZFG1 + tid]);
        gnew[tid] = leaky(gv[R_ZFG2 + tid]);
      }
    }
    __syncthreads();
    // fc_local2: dW = l1ᵀ·dz_fl2, db = Σ_rows dz_fl2
    zero_acc(acc);
    outer_acc(acc, S1, Leaky(), S0);
    add_outer(gb + L.fl2, acc);
    column_sums(S0, red, [](int, float v) { return v; },
                [&](int c, float s) { gb[L.bfl2 + c] += s; });
    // dz_fl1 = (dz_fl2·W_fl2ᵀ)·leaky'(z_fl1), in place of z_fl1
    zero_acc(acc);
    gemm_acc_t(acc, S0, wb + L.fl2, tiles);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int at = tile_row(i) * WD + tile_col(j);
        S1[at] = acc[i][j] * dleaky(S1[at]);
      }
    }
    {
      const float4* hin = reinterpret_cast<const float4*>(rec.h_in_mat(blk));
      for (int i = tid; i < MAT / 4; i += THREADS) S2v[i] = hin[i];
    }
    __syncthreads();
    // fc_local1: the per-particle third, then the broadcast [g_new ‖ temb]
    // thirds from the per-jet sum of dz_fl1
    zero_acc(acc);
    outer_acc(acc, S2, Identity(), S1);
    add_outer(gb + L.fl1, acc);
    column_sums(S1, red, [](int, float v) { return v; }, [&](int c, float s) {
      sdz[c] = s;
      gb[L.bfl1 + c] += s;
    });
    pairs.put(boff + L.fl1 + WD * WD, gnew, 2 * WD, sdz);
    // dh_in = dz_fl2 (residual) + dz_fl1·W_fl1[0:128]ᵀ
    zero_acc(acc);
    gemm_acc_t(acc, S1, wb + L.fl1, tiles);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) S0[tile_row(i) * WD + tile_col(j)] += acc[i][j];
    }
    // global MLP: dz_fg2 = (dg + W_fl1[128:256]·Σdz_fl1)·leaky'(z_fg2)
    jet_matvec_t(sdz, wb + L.fl1 + WD * WD, WD, [&](int j, float s) {
      dza[j] = (dg[j] + s) * dleaky(gv[R_ZFG2 + j]);
    });
    pairs.put(boff + L.fg2, va, WD, dza);
    vec_add(gb + L.bfg2, dza);
    jet_matvec_t(dza, wb + L.fg2, WD, [&](int j, float s) {
      dzb[j] = s * dleaky(gv[R_ZFG1 + j]);
    });
    pairs.put(boff + L.fg1, pv, 4 * WD, dzb);
    vec_add(gb + L.bfg1, dzb);
    jet_matvec_t(dzb, wb + L.fg1, 4 * WD, [&](int j, float s) { dp[j] = s; });
    if (tid < WD) {
      dsum[tid] = dp[WD + tid] + dp[tid] / denom;
      dg[tid] = dza[tid] + dp[2 * WD + tid];
    }
    __syncthreads();
    // s = pool(h_in·mask) → dh_in += dsum·mask
    for (int i = tid; i < MAT / 4; i += THREADS) {
      const float mr = m[i >> 5];
      const float4 ds = *reinterpret_cast<const float4*>(dsum + (i & 31) * 4);
      float4 v = S0v[i];
      v.x = fmaf(ds.x, mr, v.x);
      v.y = fmaf(ds.y, mr, v.y);
      v.z = fmaf(ds.z, mr, v.z);
      v.w = fmaf(ds.w, mr, v.w);
      S0v[i] = v;
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
    pairs.put(L.w_g2, vb, WD, dza);
    vec_add(grad + L.b_g2, dza);
    jet_matvec_t(dza, w + L.w_g2, WD, [&](int j, float s) { dzb[j] = s * dleaky(pj[R_ZG1 + j]); });
    pairs.put(L.w_g1, va, WD, dzb);
    vec_add(grad + L.b_g1, dzb);
    jet_matvec_t(dzb, w + L.w_g1, WD, [&](int j, float s) { dzc[j] = s * dleaky(pj[R_ZG0 + j]); });
    pairs.put(L.w_g0, pv, 3 * WD, dzc);
    vec_add(grad + L.b_g0, dzc);
    jet_matvec_t(dzc, w + L.w_g0, 2 * WD, [&](int j, float s) { dp[j] = s; });
    if (tid < WD) dsum[tid] = dp[WD + tid] + dp[tid] / denom;
    __syncthreads();
  }
  // h = leaky(z_l0)·m and s0 = pool(leaky(z_l0)·m): S0 ← dz_l0
  {
    const float4* zl0 = reinterpret_cast<const float4*>(rec.z_l0_mat());
    for (int i = tid; i < MAT / 4; i += THREADS) {
      const float mr = m[i >> 5];
      const float4 ds = *reinterpret_cast<const float4*>(dsum + (i & 31) * 4);
      const float4 z = zl0[i];
      float4 v = S0v[i];
      if (d.use_skip) {
        const float4 s = dsl[i];
        v.x += s.x; v.y += s.y; v.z += s.z; v.w += s.w;
      }
      v.x = (v.x * mr + ds.x * mr) * dleaky(z.x);
      v.y = (v.y * mr + ds.y * mr) * dleaky(z.y);
      v.z = (v.z * mr + ds.z * mr) * dleaky(z.z);
      v.w = (v.w * mr + ds.w * mr) * dleaky(z.w);
      S0v[i] = v;
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
      const float dz = S0[r * WD + o];
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
  pairs.put(L.w_l0, temb, WD, Q + DC * WD);
  for (int i = tid; i < MAT / 4; i += THREADS) {
    const int e = i >> 5, o4 = (i & 31) * 4;
    float4* gx = reinterpret_cast<float4*>(grad + L.w_l0 + WD * WD) + i;
    float4* gk = reinterpret_cast<float4*>(grad + L.w_l0 + 2 * WD * WD) + i;
    float4 vx = *gx, vk = *gk;
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
    *gx = vx;
    *gk = vk;
  }
  // dfeats = dz_l0·W_l0ᵀ·m reaches w_x, b_x and the table through Q
  for (int c = 0; c <= DC; ++c) {
    float* dst = c < DC ? grad + L.w_x + c * WD : grad + L.b_x;
    jet_matvec_t(Q + c * WD, w + L.w_l0 + WD * WD, WD, [&](int j, float s) { dst[j] += s; });
  }
  for (int v = 0; v < V; ++v) {
    float* dst = grad + L.table + v * WD;
    jet_matvec_t(Q + (DC + 1 + v) * WD, w + L.w_l0 + 2 * WD * WD, WD,
                 [&](int j, float s) { dst[j] += s; });
  }
}

__global__ void __launch_bounds__(THREADS, 1)
epic_wide_backward_kernel(const float* __restrict__ w, Dims d, const float* __restrict__ t,
                          const float* __restrict__ x, const int* __restrict__ k,
                          const float* __restrict__ mask, const float* __restrict__ gout,
                          float* __restrict__ partials, float* __restrict__ records,
                          float* __restrict__ pair_log, int jets_per_block, int B, int N) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = make_layout(d.num_blocks);
  float* grad = partials + (size_t)blockIdx.x * L.row_stride;
  for (int i = threadIdx.x; i < L.total; i += THREADS) grad[i] = 0.f;
  float* base = records + (size_t)blockIdx.x * record_floats(d.num_blocks);
  float* projv = base + (size_t)(2 + 3 * d.num_blocks) * MAT;
  const GlobalRecord rec{base, projv, projv + R_PROJ};
  const int stride = pair_floats(d.num_blocks);
  float* pairs = pair_log + (size_t)blockIdx.x * pair_block_floats(d.num_blocks, jets_per_block);
  int* groups = reinterpret_cast<int*>(pairs + (size_t)jets_per_block * stride);
  __syncthreads();
  int n_jets = 0;
  for (int jet = blockIdx.x; jet < B; jet += gridDim.x, ++n_jets) {
    const size_t p = (size_t)jet * N;
    PairLog log{pairs + (size_t)n_jets * stride, groups, 0, 0};
    wide_forward_jet(w, d, L, smem, t[jet], x + p * DC, k + p, mask + p, N,
                     static_cast<float*>(nullptr), rec);
    wide_backward_jet(w, d, L, smem, rec, gout + p * NOUT, N, grad, log);
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

}  // namespace mmpw

extern "C" int mmp_epic_wide_backward_workspace(int B, int N, const int* dims, int* grid,
                                                long long* floats) {
  using namespace mmpw;
  const Dims d = dims_from(dims);
  if (!dims_supported(d) || N < 1 || N > ROWS) return cudaErrorInvalidValue;
  cudaError_t err = backward_grid(B, grid);
  if (err != cudaSuccess) return err;
  const int jets_per_block = (B + *grid - 1) / *grid;
  *floats = (long long)*grid * ((long long)make_layout(d.num_blocks).row_stride +
                                record_floats(d.num_blocks) +
                                pair_block_floats(d.num_blocks, jets_per_block));
  return cudaSuccess;
}

extern "C" int mmp_epic_wide_backward(const void* w, const void* t, const void* x, const void* k,
                                      const void* mask, const void* g, void* out, void* scratch,
                                      int grid, int B, int N, const int* dims, void* stream) {
  using namespace mmpw;
  const Dims d = dims_from(dims);
  if (!dims_supported(d) || N < 1 || N > ROWS || grid < 1) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(epic_wide_backward_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const Layout L = make_layout(d.num_blocks);
  auto* partials = static_cast<float*>(scratch);
  float* records = partials + (size_t)grid * L.row_stride;
  float* pair_log = records + (size_t)grid * record_floats(d.num_blocks);
  const int jets_per_block = (B + grid - 1) / grid;
  auto s = static_cast<cudaStream_t>(stream);
  epic_wide_backward_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      static_cast<const float*>(w), d, static_cast<const float*>(t), static_cast<const float*>(x),
      static_cast<const int*>(k), static_cast<const float*>(mask), static_cast<const float*>(g),
      partials, records, pair_log, jets_per_block, B, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  wide_reduce_partials<<<(L.total + 255) / 256, 256, 0, s>>>(
      partials, grid, L.row_stride, L.total, static_cast<float*>(out));
  return cudaGetLastError();
}
