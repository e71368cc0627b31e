// K8: the masked multi-head attention core of an AttnBlock, one launch for a
// batch of jets.
//
// Replaces the TPU kernel multimodal_particles_tpu/ops/attention_pallas.py
// (`attention_core_pallas`, body `_attn_kernel`, oracle `_core_jnp`): per jet
// and head, softmax over the keys of q·kᵀ/√d plus an additive key bias, times
// v. The bias is −1e9 on the keys whose (B, N, 1) mask is 0, and there is
// none without a mask. q, k, v and the output are (B, N, C), before proj_out
// and the residual, heads contiguous channel ranges of C / n_heads. The
// gradient is not a kernel: the JAX package's custom VJP is autodiff of the
// einsum (:123-128), and ops/attention_cuda.py's autograd Function does the
// same with the plain version.
//
// What bounds it. A jet of N slots costs 2·N²·C multiply-adds (scores and
// values over the heads together), 4.2 M at N = 128, against 4·N·C·4 bytes
// (256 KB) of q, k, v in and the output out: 32 floating-point operations a
// byte against the card's 20 (67 TFLOP/s over 3.35 TB/s), so fp32 arithmetic
// on the CUDA cores bounds it, with the bytes close behind.
//
// Design: the attention of the gsdm stacks (gsdm_blocks.cuh::attention_rows)
// with its key-bias flag on. One block of 256 threads a jet: q (scaled) in
// one (128, 128) tile of shared memory, k transposed and XOR-swizzled in the
// second, v in the third, four query rows a warp, the result over q's rows,
// then stored. No tile is written past N; the scores of the keys past N that
// the lanes compute are left out of the softmax. The bias comes from the mask
// in the kernel, so a masked call is one launch too.
//
// C interface (bound with ctypes by ops/attention_cuda.py): returns the
// cudaError_t of the launch, 0 on success.

#include "gsdm_blocks.cuh"

namespace mmps {

constexpr int AV_BIAS = 0, AV_PROB = ROWS, AV_END = AV_PROB + WARPS * ROWS * RG;
constexpr size_t ATTN_SMEM_BYTES = sizeof(float) * (size_t)(3 * MAT + AV_END);
static_assert(ATTN_SMEM_BYTES <= 232448, "over a block's 227 KB of shared memory");
constexpr float MASKED_KEY_BIAS = -1e9f;  // attention_pallas.py:149

template <bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
attention_core_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ mask,
                      float* __restrict__ out, int B, int N, int n_heads) {
  extern __shared__ __align__(16) float smem[];
  float* Q = smem;
  float* KT = smem + MAT;
  float* Vt = smem + 2 * MAT;
  float* kbias = smem + 3 * MAT + AV_BIAS;
  float* prob = smem + 3 * MAT + AV_PROB;
  const int tid = threadIdx.x;
  const float scale = rsqrtf((float)(C / n_heads));
  for (int jet = blockIdx.x; jet < B; jet += gridDim.x) {
    const size_t p = (size_t)jet * N * C;
    const float4* q4 = reinterpret_cast<const float4*>(q + p);
    const float4* k4 = reinterpret_cast<const float4*>(k + p);
    const float4* v4 = reinterpret_cast<const float4*>(v + p);
    for (int idx = tid; idx < N * (C / 4); idx += THREADS) {
      float4 a = __ldg(q4 + idx);
      a.x *= scale; a.y *= scale; a.z *= scale; a.w *= scale;
      reinterpret_cast<float4*>(Q)[idx] = a;
      reinterpret_cast<float4*>(Vt)[idx] = __ldg(v4 + idx);
      const float4 b = __ldg(k4 + idx);
      const int r = idx / (C / 4), c = (idx % (C / 4)) * 4;
      KT[kt_index(c, r)] = b.x;
      KT[kt_index(c + 1, r)] = b.y;
      KT[kt_index(c + 2, r)] = b.z;
      KT[kt_index(c + 3, r)] = b.w;
    }
    if (MASKED && tid < N) kbias[tid] = mask[(size_t)jet * N + tid] > 0.f ? 0.f : MASKED_KEY_BIAS;
    __syncthreads();
    attention_rows<MASKED>(Q, KT, Vt, N, n_heads, prob, kbias);
    __syncthreads();
    float4* o4 = reinterpret_cast<float4*>(out + p);
    for (int idx = tid; idx < N * (C / 4); idx += THREADS)
      o4[idx] = reinterpret_cast<const float4*>(Q)[idx];
    __syncthreads();  // the tiles are free for the block's next jet
  }
}

}  // namespace mmps

// q, k, v, out: (B, N, C) float32, 16-byte aligned; mask: (B, N) float32 or
// null. One block a jet (grid = B, or fewer blocks that walk the jets).
extern "C" int mmp_attention_core(const void* q, const void* k, const void* v, const void* mask,
                                  void* out, int grid, int B, int N, int channels, int n_heads,
                                  void* stream) {
  using namespace mmps;
  if (N < 1 || N > ROWS || channels != C || n_heads < 1 || C % n_heads != 0 ||
      (C / n_heads) % 32 != 0 || grid < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  auto kernel = mask != nullptr ? attention_core_kernel<true> : attention_core_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)ATTN_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, ATTN_SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(mask), static_cast<float*>(out), B, N, n_heads);
  return cudaGetLastError();
}
