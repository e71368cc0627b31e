// What the wide backward kernels share (epic_wide_backward.cu at every width
// 128, epic_wide_backward_any.cuh at the others): the slopes, the tiles'
// sign records and their cp.async loads, the recorder, the weight gradients'
// outer products on mma.sync, the log of rank-1 pairs and its contraction,
// the transposed vector-matrix products.
#pragma once

#include "epic_wide.cuh"

namespace mmpw {

constexpr int NQ = DC + 1 + V + 1;  // rows of Q in the local_0 backward

__device__ __forceinline__ float dleaky(float z) { return z >= 0.f ? 1.f : 0.01f; }

__device__ __forceinline__ float dselu(float z) {
  const float alpha = 1.6732632423543772f, scale = 1.0507009873554805f;
  return scale * (z >= 0.f ? 1.f : alpha * expf(z));
}

// A tile's signs, a bit an element: what the walk back needs of z_l0 and of
// each block's z_fl2 (their leaky's slope), a 32nd of the tile's bytes.
constexpr int SIGN_WORDS = MAT / 32;

// Float4 i of a (128, 128) tile, counted row by row, in a tile with rows of
// LDA_TC floats.
__device__ __forceinline__ int at4(int i) { return (i >> 5) * (LDA_TC / 4) + (i & 31); }

// leaky'(z) of element (r, c) from its tile's signs (GlobalRecord::put_sign:
// WgAcc's places), in shared memory.
__device__ __forceinline__ float dleaky_at(const unsigned* signs, int r, int c) {
  const int warp = 4 * (r >> 6) + ((r >> 4) & 3), i = 4 * (c >> 3) + 2 * ((r >> 3) & 1) + (c & 1);
  return (signs[64 * warp + i] >> (4 * (r & 7) + ((c >> 1) & 3))) & 1u ? 1.f : 0.01f;
}

// cp.async of a tile's signs into shared memory, committed as one group; the
// caller waits.
__device__ __forceinline__ void signs_to_smem_async(unsigned* dst, const unsigned* __restrict__ src) {
  for (int i = threadIdx.x; i < SIGN_WORDS / 4; i += THREADS) tf32x3::cp_async16(dst + 4 * i, src + 4 * i);
  tf32x3::cp_async_commit();
}

// cp.async of a record's (128, 128) tile (rows of 128 floats) into a shared
// tile with rows of LDA_TC floats, committed as one group; the caller waits.
__device__ __forceinline__ void tile_to_smem_async(float* dst, const float* __restrict__ src) {
  for (int i = threadIdx.x; i < MAT / 4; i += THREADS)
    tf32x3::cp_async16(dst + 4 * at4(i), src + 4 * i);
  tf32x3::cp_async_commit();
}

// the rows a warp of a transposed vector-matrix product has in flight
constexpr int MATVEC_T_ROWS = 8;

// z ≥ 0 of element i (WgAcc's index) over the warp's 32 threads: word
// 64·warp + i of the tile's signs, bit lane. Every thread calls it.
__device__ __forceinline__ void put_sign(unsigned* words, int i, float z) {
  const unsigned bits = __ballot_sync(0xffffffffu, z >= 0.f);
  if ((threadIdx.x & 31) == 0) words[64 * (threadIdx.x >> 5) + i] = bits;
}

// The recorder of the backward's rerun: into the block's records in device
// memory, per EPiC block h_in and z_fl1 (the block's 128 columns, rows of
// 128 floats), the signs of z_l0 and of each block's z_fl2 (WgAcc's places),
// and the per-jet vectors, the projection's at projv and each layer's at
// globv, glob_stride floats a layer.
struct GlobalRecord {
  static constexpr bool HEADS = false;
  float* mats;
  unsigned* signs;
  float* projv;
  float* globv;
  int glob_stride;

  __device__ __forceinline__ float* mat(int i) const { return mats + (size_t)i * MAT; }
  __device__ __forceinline__ float* h_in_mat(int b) const { return mat(2 * b); }
  __device__ __forceinline__ float* z_fl1_mat(int b) const { return mat(2 * b + 1); }
  __device__ __forceinline__ float* dsl_mat(int nb) const { return mat(2 * nb); }
  __device__ __forceinline__ unsigned* z_l0_signs() const { return signs; }
  __device__ __forceinline__ unsigned* z_fl2_signs(int b) const {
    return signs + (size_t)(1 + b) * SIGN_WORDS;
  }
  __device__ __forceinline__ void z_l0(int i, int, int, float z) const {
    put_sign(z_l0_signs(), i, z);
  }
  __device__ __forceinline__ void z_fl1(int b, int r, int c, float v) const {
    z_fl1_mat(b)[r * WD + c] = v;
  }
  __device__ __forceinline__ void z_fl2(int b, int i, int, int, float z) const {
    put_sign(z_fl2_signs(b), i, z);
  }
  __device__ __forceinline__ void h_in(int b, const float* S, int ld) const {
    float4* dst = reinterpret_cast<float4*>(h_in_mat(b));
    for (int i = threadIdx.x; i < MAT / 4; i += THREADS)
      dst[i] = *reinterpret_cast<const float4*>(S + (i >> 5) * ld + 4 * (i & 31));
  }
  __device__ __forceinline__ void proj(int i, float v) const { projv[i] = v; }
  __device__ __forceinline__ void glob(int b, int i, float v) const { globv[b * glob_stride + i] = v; }
};

// gm (128 columns, rows of ld floats) += aᵀ·dz over the tiles' rows below
// 8·ksteps: a's element (row, column) given by A(row, column) (a tile, a
// peer's tile, or a record in device memory), D (dz) in shared memory with
// rows of LDA_TC floats. On the tensor cores at fp32 accuracy:
// mma.sync.m16n8k8 with the particle axis as K, both fragments loaded by hand
// and split by truncation, three TF32 products. Warp w takes the a-columns
// 32·(w >> 1) … + 31 and the dz-columns 64·(w & 1) … + 63, and adds its piece
// into gm (the same thread always owns the same elements). Every thread
// calls it; no barrier.
template <class AF>
__device__ __forceinline__ void outer_mma(float* gm, int ld, const AF& A, const float* D,
                                          int ksteps) {
  using namespace tf32x3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int i0 = 32 * (warp >> 1), o0 = 64 * (warp & 1);
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int r = 8 * ks + t;
    const float* dr = D + r * LDA_TC + o0 + g;
    Frag<4> a[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int c = i0 + 16 * mi + g;
      split_fast(A(r, c), a[mi].hi[0], a[mi].lo[0]);
      split_fast(A(r, c + 8), a[mi].hi[1], a[mi].lo[1]);
      split_fast(A(r + 4, c), a[mi].hi[2], a[mi].lo[2]);
      split_fast(A(r + 4, c + 8), a[mi].hi[3], a[mi].lo[3]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      Frag<2> b;
      split_fast(dr[8 * j], b.hi[0], b.lo[0]);
      split_fast(dr[4 * LDA_TC + 8 * j], b.hi[1], b.lo[1]);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) mma3(acc[mi][j], a[mi], b);
    }
  }
  float2* p[2][8][2];
  float2 v[2][8][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        p[mi][j][h] = reinterpret_cast<float2*>(gm + (size_t)(i0 + 16 * mi + g + 8 * h) * ld + o0 +
                                                8 * j + 2 * t);
        v[mi][j][h] = *p[mi][j][h];
      }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        v[mi][j][h].x += acc[mi][j][2 * h];
        v[mi][j][h].y += acc[mi][j][2 * h + 1];
        *p[mi][j][h] = v[mi][j][h];
      }
}

// Rank-1 weight gradients a ⊗ dz of one jet over 128 gradient columns,
// logged and not applied: `put` copies a and the 128 entries of dz to this
// jet's record and notes (gradient offset, rows, record offset, row stride)
// in the block's group table; every jet logs the same groups in the same
// order. When the block has walked its jets it contracts the pairs over them
// (`contract_pairs`), so those rows of the gradient are written once a block
// and not once a jet. Every thread of the block calls `put`.
constexpr int GROUP_INTS = 4;

struct PairLog {
  float* rec;
  int* groups;
  int off, idx;

  // grad[goff + i·ld + o] gets a[i]·dz[o], i < n_a, o < 128
  __device__ __forceinline__ void put(int grad_offset, const float* a, int n_a, const float* dz,
                                      int ld) {
    const int tid = threadIdx.x;
    for (int i = tid; i < n_a; i += THREADS) rec[off + i] = a[i];
    if (tid < WD) rec[off + n_a + tid] = dz[tid];
    if (tid == 0) {
      groups[GROUP_INTS * idx] = grad_offset;
      groups[GROUP_INTS * idx + 1] = n_a;
      groups[GROUP_INTS * idx + 2] = off;
      groups[GROUP_INTS * idx + 3] = ld;
    }
    off += n_a + WD;
    ++idx;
  }
  // a ⊗ dz for the column blocks of dz (n_out wide, rows of n_out) this block takes
  __device__ __forceinline__ void put_shared(int grad_offset, const float* a, int n_a,
                                             const float* dz, int n_out, int rank, int CL) {
    for (int c0 = WD * rank; c0 < n_out; c0 += WD * CL) put(grad_offset + c0, a, n_a, dz + c0, n_out);
  }
};

// grad[g.offset + i·ld + o] += Σ_jets a_jet[i]·dz_jet[o] for every logged
// group, jets in the order the block walked them. A thread owns 4 rows × 4
// columns at a time. Every thread of the block calls it.
__device__ __forceinline__ void contract_pairs(const float* pairs, int n_jets, int stride,
                                                   const int* groups, int n_groups, float* grad) {
  const int o4 = (threadIdx.x & 31) * 4, ig = (threadIdx.x >> 5) * 4;
  for (int g = 0; g < n_groups; ++g) {
    const int goff = groups[GROUP_INTS * g], n_a = groups[GROUP_INTS * g + 1];
    const int ld = groups[GROUP_INTS * g + 3];
    const float* base = pairs + groups[GROUP_INTS * g + 2];
    for (int i0 = ig; i0 < n_a; i0 += 32) {
      float4 acc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
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
        float4* p = reinterpret_cast<float4*>(grad + goff + (size_t)(i0 + r) * ld + o4);
        float4 v = *p;
        v.x += acc[r].x; v.y += acc[r].y; v.z += acc[r].z; v.w += acc[r].w;
        *p = v;
      }
    }
  }
}

// gb[j] += dz[j] for the column blocks of an n-wide vector that block `rank`
// of CL takes (at every width 128 the one block's 128).
__device__ __forceinline__ void vec_add(float* gb, const float* dz, int n = WD, int rank = 0,
                                        int CL = 1) {
  for (int c0 = WD * rank; c0 < n; c0 += WD * CL)
    if (threadIdx.x < WD) gb[c0 + threadIdx.x] += dz[c0 + threadIdx.x];
}

// out[j] = Σ_{o<n} v[o]·W[j·ld + o] for j < n_rows, W in global memory, n a
// multiple of 128 (at every width 128: n = ld = 128): one warp a row,
// MATVEC_T_ROWS rows a warp at once (their loads in flight together: one
// block an SM hides no L2 latency); lane u of the warp calls post(j, out[j])
// for its u-th row (the posts that read or add to global memory run side by
// side). Ends with a barrier.
template <class Post>
__device__ __forceinline__ void jet_matvec_t(const float* v, const float* __restrict__ Wg, int n,
                                             int ld, int n_rows, Post post) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int WARPS = THREADS / 32;
  for (int j0 = warp; j0 < n_rows; j0 += WARPS * MATVEC_T_ROWS) {
    float s[MATVEC_T_ROWS];
#pragma unroll
    for (int u = 0; u < MATVEC_T_ROWS; ++u) s[u] = 0.f;
    for (int c0 = 0; c0 < n; c0 += WD) {
      const float4 vv = *reinterpret_cast<const float4*>(v + c0 + lane * 4);
      float4 w[MATVEC_T_ROWS];
#pragma unroll
      for (int u = 0; u < MATVEC_T_ROWS; ++u) {
        const int j = j0 + WARPS * u;
        w[u] = j < n_rows ? __ldg(reinterpret_cast<const float4*>(Wg + (size_t)j * ld + c0) + lane)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < MATVEC_T_ROWS; ++u) {
        s[u] = fmaf(vv.x, w[u].x, s[u]);
        s[u] = fmaf(vv.y, w[u].y, s[u]);
        s[u] = fmaf(vv.z, w[u].z, s[u]);
        s[u] = fmaf(vv.w, w[u].w, s[u]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < MATVEC_T_ROWS; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
    float mine = s[0];
#pragma unroll
    for (int u = 1; u < MATVEC_T_ROWS; ++u)
      if (lane == u) mine = s[u];
    if (lane < MATVEC_T_ROWS && j0 + WARPS * lane < n_rows) post(j0 + WARPS * lane, mine);
  }
  __syncthreads();
}


}  // namespace mmpw
