// K8: the masked multi-head attention core of an AttnBlock, one launch for a
// batch of jets.
//
// Replaces the TPU kernel multimodal_particles_tpu/ops/attention_pallas.py
// (`attention_core_pallas`, body `_attn_kernel`, oracle `_core_jnp`): per jet
// and head, softmax over the keys of q·kᵀ/√d plus an additive key bias, times
// v. The bias is −1e9 on the keys whose (B, N, 1) mask is 0, and there is
// none without a mask. q, k, v and the output are (B, N, C), before proj_out
// and the residual, heads contiguous channel ranges of C / n_heads (C, the
// row stride, any multiple of 4; the wrapper takes 128 … 512). The
// gradient is not a kernel: the JAX package's custom VJP is autodiff of the
// einsum (:123-128), and ops/attention_cuda.py's autograd Function does the
// same with the plain version.
//
// What bounds it. A jet of N slots costs 2·N²·C multiply-adds (scores and
// values over the heads together), 4.2 M at N = 128, against 4·N·C·4 bytes
// (256 KB) of q, k, v in and the output out. On the tensor cores, three TF32
// products a multiply-add (tf32x3.cuh) make 24 operations a byte against the
// card's 148 (495 TFLOP/s over 3.35 TB/s): the bytes bound it.
//
// Design: a block of 8 warps a (jet, head) pair, ⌈N/16⌉ warps of 16 query
// rows each doing the work.
//   * q, k and v of the pair come into shared memory by cp.async, rows of
//     hd + 4 floats (no bank conflict in the fragment reads), rows from N to
//     ⌈N/16⌉·16 zero-filled; q and k in one group, v in a second that lands
//     while the first keys are scored. At hd = 64 a pair takes 102 KB, so two
//     blocks share an SM and one's loads overlap the other's products.
//   * S = q·kᵀ and O = P·v are mma.sync.m16n8k8 TF32 products under the
//     3×TF32 split, fp32 accumulators in registers. k's rows are the K-major
//     B operand as they are stored; no transpose.
//   * The softmax runs in registers over chunks of 64 keys with a running
//     maximum and sum (the output rescaled when the maximum rises). Keys past
//     N never enter it; a masked key's score is q·k/√d − 1e9 as in the plain
//     version, so a wholly masked jet gives the mean of its values.
//   * P goes from the accumulator fragment to the A fragment without a
//     shuffle: the product's keys are taken in the order the accumulator
//     holds them (column t of the A fragment is key 2t, column t + 4 key
//     2t + 1), and v's rows are read in that order.
//   * The 1/√d scale multiplies the fp32 score, as the einsum does.
//   * Each warp stages its 16 output rows in its own q rows and stores them
//     as float4.
//   * Jets of 129 … 256 slots (the SPLIT instances): q, k and v of a pair at
//     256 rows and head width 128 take 405 KB, past a block's 227 KB. So a
//     block takes a (jet, head, query half) item, its 128 query rows in the
//     q tile, and streams the keys through the k and v tiles in two blocks
//     of 128 rows, the online softmax carried from the first to the second;
//     the key bias holds all N keys. The first half's item and the second's
//     each load k and v (the second read mostly from L2). At N = 256, C = 128
//     the operations bound it (16.8 M multiply-adds a jet against 512 KB).
//     At N ≤ 128 the instances are the ones above.
//   * A head of hd channels runs in the instance for HD = 8, 16, 32, 64 or
//     128 ≥ hd. Where hd < HD (3, 12, 48, 96, …: the PADDED instances) the
//     head's channels are loaded by plain loads and zero-padded to HD
//     inside the kernel: the padded q·k columns add 0, and the padded output
//     columns are not stored. Where hd = HD the loads and stores are the
//     ones above.
//
// C interface (bound with ctypes by ops/attention_cuda.py): returns the
// cudaError_t of the launch, 0 on success.

#include <math.h>

#include "tf32x3.cuh"

namespace mmpa {

using namespace tf32x3;

constexpr int ROWS = 128;     // query rows and keys a block holds
constexpr int MAX_N = 2 * ROWS;  // particle slots per jet
constexpr int THREADS = 256;  // 8 warps of 16 query rows
constexpr int KC = 64;        // keys a softmax chunk
constexpr float MASKED_KEY_BIAS = -1e9f;  // attention_pallas.py:149

// SPLIT: the instance for N > 128 (its key bias holds all MAX_N keys).
template <int HD, bool SPLIT = false>
struct Smem {
  static constexpr int LD = HD + 4;  // row stride in floats
  static constexpr int MAT = ROWS * LD;
  static constexpr size_t BYTES = sizeof(float) * (size_t)(3 * MAT + (SPLIT ? MAX_N : ROWS));
  static_assert(BYTES <= 232448, "over a block's 227 KB of shared memory");
};

// The rows r0 … r0 + rows − 1 of a (jet, head) pair's matrix `src` (rows of
// C floats from `base`) into `dst` (rows of LD floats) by cp.async, rows from
// `rows` to the next multiple of 16 zero-filled.
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, size_t base,
                                          int r0, int rows, int C) {
  constexpr int LD = Smem<HD>::LD, F4 = HD / 4;
  const int pad = (rows + 15) & ~15;
  for (int idx = threadIdx.x; idx < pad * F4; idx += THREADS) {
    const int r = idx / F4, c = (idx % F4) * 4;
    const bool real = r < rows;
    cp_async16(dst + r * LD + c, src + base + (size_t)(r0 + (real ? r : 0)) * C + c, real);
  }
}

// The same for a head narrower than the instance, by plain loads: zero past
// hd and `rows`.
template <int HD>
__device__ __forceinline__ void load_rows_padded(float* dst, const float* __restrict__ src,
                                                 size_t base, int r0, int rows, int C, int hd) {
  constexpr int LD = Smem<HD>::LD;
  const int pad = (rows + 15) & ~15;
  for (int idx = threadIdx.x; idx < pad * HD; idx += THREADS) {
    const int r = idx / HD, c = idx % HD;
    dst[r * LD + c] = r < rows && c < hd ? src[base + (size_t)(r0 + r) * C + c] : 0.f;
  }
}

// HD: the instance's head width; hd the head's channels, HD unless PADDED
// (hd < HD, the rest zero-padded); C: the row stride, n_heads · hd. SPLIT
// (N > 128): a block takes a (jet, head, query half) item, 128 query rows,
// and streams the keys and values through its tiles in blocks of 128 rows,
// the online softmax carried on from one key block to the next.
template <int HD, bool MASKED, bool PADDED, bool SPLIT = false>
__global__ void __launch_bounds__(THREADS, HD == 128 ? 1 : 2)
attention_core_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ mask,
                      float* __restrict__ out, int B, int N, int C, int n_heads, int hd,
                      float scale) {
  constexpr int LD = Smem<HD>::LD, F4 = HD / 4, NT = HD / 8;
  constexpr int HALVES = SPLIT ? 2 : 1;  // query blocks a (jet, head) pair
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = smem + Smem<HD>::MAT;
  float* Vs = smem + 2 * Smem<HD>::MAT;
  float* kbias = smem + 3 * Smem<HD>::MAT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int row0 = 16 * warp;

  for (int item = blockIdx.x; item < B * n_heads * HALVES; item += gridDim.x) {
    const int pair = SPLIT ? item / 2 : item;
    const int jet = pair / n_heads, head = pair % n_heads;
    const size_t base = (size_t)jet * N * C + (size_t)head * hd;
    // the item's query rows q0 … q0 + nq − 1; at SPLIT the second half's
    // item holds rows 128 … N − 1
    const int q0 = SPLIT ? ROWS * (item % 2) : 0;
    const int nq = SPLIT ? min(ROWS, N - q0) : N;
    const bool active = row0 < nq;
    // at SPLIT, the keys of the first block: the item's query half may be the other one
    const int nk0 = SPLIT ? ROWS : N;
    const int npad = (nk0 + 15) & ~15;  // the keys the products run over (SPLIT: the block's)
    if constexpr (SPLIT) {
      if constexpr (!PADDED) {
        load_rows<HD>(Qs, q, base, q0, nq, C);
        load_rows<HD>(Ks, k, base, 0, ROWS, C);
        cp_async_commit();
        load_rows<HD>(Vs, v, base, 0, ROWS, C);
        cp_async_commit();
      } else {
        load_rows_padded<HD>(Qs, q, base, q0, nq, C, hd);
        load_rows_padded<HD>(Ks, k, base, 0, ROWS, C, hd);
        load_rows_padded<HD>(Vs, v, base, 0, ROWS, C, hd);
      }
      for (int r = tid; r < N; r += THREADS)
        kbias[r] = MASKED && !(mask[(size_t)jet * N + r] > 0.f) ? MASKED_KEY_BIAS : 0.f;
    } else if constexpr (!PADDED) {
      for (int idx = tid; idx < npad * F4; idx += THREADS) {
        const int r = idx / F4, c = (idx % F4) * 4;
        const bool real = r < N;
        const size_t src = base + (size_t)(real ? r : 0) * C + c;
        cp_async16(Qs + r * LD + c, q + src, real);
        cp_async16(Ks + r * LD + c, k + src, real);
      }
      cp_async_commit();
      for (int idx = tid; idx < npad * F4; idx += THREADS) {
        const int r = idx / F4, c = (idx % F4) * 4;
        const bool real = r < N;
        cp_async16(Vs + r * LD + c, v + base + (size_t)(real ? r : 0) * C + c, real);
      }
      cp_async_commit();
    } else {  // a head narrower than the instance: zero past hd and N
      for (int idx = tid; idx < npad * HD; idx += THREADS) {
        const int r = idx / HD, c = idx % HD;
        const bool real = r < N && c < hd;
        const size_t src = base + (size_t)r * C + c;
        Qs[r * LD + c] = real ? q[src] : 0.f;
        Ks[r * LD + c] = real ? k[src] : 0.f;
        Vs[r * LD + c] = real ? v[src] : 0.f;
      }
    }
    if constexpr (!SPLIT) {
      if (tid < N) kbias[tid] = MASKED && !(mask[(size_t)jet * N + tid] > 0.f) ? MASKED_KEY_BIAS : 0.f;
    }
    cp_async_wait<1>();
    __syncthreads();

    float o[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float row_max[2] = {-INFINITY, -INFINITY}, row_sum[2] = {0.f, 0.f};
    const float* qa = Qs + (row0 + g) * LD + t;

#pragma unroll 1
    for (int kblk = 0; kblk < HALVES; ++kblk) {  // key blocks of 128 rows (one unless SPLIT)
      const int k0 = ROWS * kblk;  // the key block's first key
      const int nk = SPLIT ? min(ROWS, N - k0) : N;  // its keys
      const int kpad = SPLIT ? (nk + 15) & ~15 : npad;
      if (SPLIT && kblk > 0) {
        __syncthreads();  // every warp is done with the keys and values before
        if constexpr (!PADDED) {
          load_rows<HD>(Ks, k, base, k0, nk, C);
          cp_async_commit();
          load_rows<HD>(Vs, v, base, k0, nk, C);
          cp_async_commit();
        } else {
          load_rows_padded<HD>(Ks, k, base, k0, nk, C, hd);
          load_rows_padded<HD>(Vs, v, base, k0, nk, C, hd);
        }
        cp_async_wait<1>();
        __syncthreads();
      }
      for (int kc = 0; kc < kpad; kc += KC) {
        const int nt = min(KC, kpad - kc) / 8;  // key tiles of 8 in this chunk
        float s[KC / 8][4];
#pragma unroll
        for (int j = 0; j < KC / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        if (active) {
          // S = q·kᵀ over the chunk's keys
#pragma unroll 2
          for (int kk = 0; kk < HD; kk += 8) {
            Frag<4> a;
            a.set(0, qa[kk]);
            a.set(1, qa[8 * LD + kk]);
            a.set(2, qa[kk + 4]);
            a.set(3, qa[8 * LD + kk + 4]);
#pragma unroll
            for (int j = 0; j < KC / 8; ++j) {
              if (j < nt) {
                const float* kb = Ks + (kc + 8 * j + g) * LD + kk + t;
                Frag<2> b;
                b.set(0, kb[0]);
                b.set(1, kb[4]);
                mma3(s[j], a, b);
              }
            }
          }
        }
        if (kc == 0) {  // v has landed while the first chunk was scored
          cp_async_wait<0>();
          __syncthreads();
        }
        if (active) {
          // the softmax's running maximum and sum; rows g (s[.][0..1]) and g + 8
          float cmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
          for (int j = 0; j < KC / 8; ++j) {
            if (j < nt) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int key = kc + 8 * j + 2 * t + (e & 1);
                const float x = key < nk ? s[j][e] * scale + kbias[k0 + key] : -INFINITY;
                s[j][e] = x;
                cmax[e >> 1] = fmaxf(cmax[e >> 1], x);
              }
            }
          }
          float factor[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            cmax[h] = fmaxf(cmax[h], __shfl_xor_sync(0xffffffffu, cmax[h], 1));
            cmax[h] = fmaxf(cmax[h], __shfl_xor_sync(0xffffffffu, cmax[h], 2));
            const float m = fmaxf(row_max[h], cmax[h]);  // finite: a chunk holds a key < N
            factor[h] = expf(row_max[h] - m);
            row_max[h] = m;
            row_sum[h] *= factor[h];
          }
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            o[n][0] *= factor[0];
            o[n][1] *= factor[0];
            o[n][2] *= factor[1];
            o[n][3] *= factor[1];
          }
#pragma unroll
          for (int j = 0; j < KC / 8; ++j) {
            if (j < nt) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                s[j][e] = expf(s[j][e] - row_max[e >> 1]);
                row_sum[e >> 1] += s[j][e];
              }
            }
          }
          // O += P·v, keys in the accumulator's order (2t, 2t + 1)
#pragma unroll
          for (int j = 0; j < KC / 8; ++j) {
            if (j < nt) {
              Frag<4> a;
              a.set(0, s[j][0]);
              a.set(1, s[j][2]);
              a.set(2, s[j][1]);
              a.set(3, s[j][3]);
              const float* vb = Vs + (kc + 8 * j + 2 * t) * LD + g;
#pragma unroll
              for (int n = 0; n < NT; ++n) {
                Frag<2> b;
                b.set(0, vb[8 * n]);
                b.set(1, vb[LD + 8 * n]);
                mma3(o[n], a, b);
              }
            }
          }
        }
      }
    }

    if (active) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 1);
        row_sum[h] += __shfl_xor_sync(0xffffffffu, row_sum[h], 2);
      }
      // the warp's own q rows are free: stage the output there
      __syncwarp();
      float* stage = Qs + (row0 + g) * LD + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        *reinterpret_cast<float2*>(stage + 8 * n) =
            make_float2(o[n][0] / row_sum[0], o[n][1] / row_sum[0]);
        *reinterpret_cast<float2*>(stage + 8 * LD + 8 * n) =
            make_float2(o[n][2] / row_sum[1], o[n][3] / row_sum[1]);
      }
      __syncwarp();
      const int rows = min(16, nq - row0);
      float* dst = out + base + (size_t)q0 * C;  // the item's first query row
      if constexpr (!PADDED) {
        for (int idx = lane; idx < rows * F4; idx += 32) {
          const int r = row0 + idx / F4, c = (idx % F4) * 4;
          *reinterpret_cast<float4*>(dst + (size_t)r * C + c) =
              *reinterpret_cast<const float4*>(Qs + r * LD + c);
        }
      } else {
        for (int idx = lane; idx < rows * hd; idx += 32) {
          const int r = row0 + idx / hd, c = idx % hd;
          dst[(size_t)r * C + c] = Qs[r * LD + c];
        }
      }
    }
    __syncthreads();  // the tiles are free for the block's next item
  }
}

template <int HD, bool SPLIT>
cudaError_t launch_instance(const float* q, const float* k, const float* v, const float* mask,
                            float* out, int grid, int B, int N, int C, int n_heads,
                            cudaStream_t stream) {
  const int hd = C / n_heads;
  auto kernel = hd == HD ? (mask != nullptr ? attention_core_kernel<HD, true, false, SPLIT>
                                            : attention_core_kernel<HD, false, false, SPLIT>)
                         : (mask != nullptr ? attention_core_kernel<HD, true, true, SPLIT>
                                            : attention_core_kernel<HD, false, true, SPLIT>);
  constexpr size_t smem = Smem<HD, SPLIT>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)hd));  // hd**-0.5 as the einsum takes it
  kernel<<<grid, THREADS, smem, stream>>>(q, k, v, mask, out, B, N, C, n_heads, hd, scale);
  return cudaGetLastError();
}

// N ≤ 128: a block a (jet, head) pair; N > 128: a block a (jet, head, query
// half) item.
template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, const float* mask, float* out,
                   int grid, int B, int N, int C, int n_heads, cudaStream_t stream) {
  auto run = N > ROWS ? launch_instance<HD, true> : launch_instance<HD, false>;
  return run(q, k, v, mask, out, grid, B, N, C, n_heads, stream);
}

}  // namespace mmpa

// q, k, v, out: (B, N, C) float32, 16-byte aligned; mask: (B, N) float32 or
// null; N ≤ 256. A block an item, a (jet, head) pair at N ≤ 128 and a (jet,
// head, query half) at N > 128: grid = B · n_heads (· 2 at N > 128), or fewer
// blocks that walk the items. C a multiple of 4, heads of 1 … 128 channels.
extern "C" int mmp_attention_core(const void* q, const void* k, const void* v, const void* mask,
                                  void* out, int grid, int B, int N, int channels, int n_heads,
                                  void* stream) {
  using namespace mmpa;
  const int C = channels;
  if (N < 1 || N > MAX_N || C < 4 || C % 4 != 0 || n_heads < 1 || C % n_heads != 0 ||
      C / n_heads > 128 || grid < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* mf = static_cast<const float*>(mask);
  auto* of = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hd = C / n_heads;
  auto run = hd <= 8 ? launch<8> : hd <= 16 ? launch<16> : hd <= 32 ? launch<32>
           : hd <= 64 ? launch<64> : launch<128>;
  return run(qf, kf, vf, mf, of, grid, B, N, C, n_heads, s);
}
