// Tensor-core products at fp32 accuracy for the hand-written Hopper kernels:
// K8 (attention_core.cu) by warp-level mma.sync.m16n8k8, K4's per-particle
// products (epic_wide.cuh, gemm_wg) by warpgroup wgmma.m64n128k8.
//
// TF32 keeps 10 of fp32's 23 mantissa bits. The 3×TF32 split writes
// a = a_hi + a_lo with a_hi = tf32(a) and a_lo = tf32(a − a_hi), and computes
// a·b ≈ a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, three tensor-core products
// accumulated in fp32. Two splits: `split` rounds both halves to nearest
// (cvt.rna; hi + lo holds x to 2⁻²² of it), for K8's operands and, in the
// wrapper, K4's weights; `split_fast` truncates both (to 2⁻²⁰ of x, one
// instruction fewer), for K4's A operand, split in the product's inner loop.
// What the split leaves out, a_lo·b_lo, is 2⁻²⁰ of a·b or less, far below
// K4's and K8's gates (tests/test_torch_tf32_split.py models both splits).
//
// `mma.sync.m16n8k8` TF32 fragments (PTX ISA, "Matrix Fragments for
// mma.m16n8k8"), with g = lane / 4 and t = lane % 4:
//   A (16 × 8, row): a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4],
//                    a3 = A[g + 8][t + 4]
//   B (8 × 8, col):  b0 = B[t][g], b1 = B[t + 4][g]
//   C (16 × 8):      c0 = C[g][2t], c1 = C[g][2t + 1], c2 = C[g + 8][2t],
//                    c3 = C[g + 8][2t + 1]
// wgmma.m64nNk8 with A from registers takes each warp's 16 rows of A in the
// same A fragment and gives each warp's 16 rows of D as N / 8 C fragments.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to 21 or more bits; both are TF32 bit patterns, rounded to
// nearest.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// x = hi + lo with hi = x truncated to TF32 and lo = x − hi exact, left as
// fp32 bits: the tensor cores read a TF32 operand's top 19 bits, so lo
// counts truncated to its own 10 mantissa bits (21 bits in all), at two
// instructions where `split` takes three.
__device__ __forceinline__ void split_fast(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// One fragment of A (4 values) or B (2 values), split.
template <int R>
struct Frag {
  uint32_t hi[R], lo[R];
  __device__ __forceinline__ void set(int i, float x) { split(x, hi[i], lo[i]); }
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b at fp32 accuracy: the two small products first, then the large one.
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a, const Frag<2>& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// 16 bytes from global to shared memory without the registers; with
// `real` false the 16 bytes are zeros and `src` is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool real = true) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(real ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most `PENDING` of this thread's committed groups are in flight.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// ---- wgmma: a warpgroup's (4 warps') asynchronous 64 × 128 × 8 TF32 product

// A shared-memory matrix descriptor without swizzle: 8-row × 16-byte core
// matrices stored as 128 contiguous bytes; `k_stride` bytes between core
// matrices along K (the leading byte offset), `mn_stride` bytes between those
// along M or N (the stride byte offset).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t k_stride, uint32_t mn_stride) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((k_stride >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((mn_stride >> 4) & 0x3FFF) << 32);
}

// d (64 × 128, fp32) += a (64 × 8, TF32, registers) · b (8 × 128, TF32, K-major
// in shared memory). a is the warp's rows of the mma.m16n8k8 A fragment (warp
// w of the warpgroup holds rows 16w … 16w + 15); d[4j … 4j + 3] is the C
// fragment of columns 8j … 8j + 7.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Orders register writes before the next wgmma (A and the accumulators).
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Waits until at most PENDING of the warpgroup's committed wgmma groups run.
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(PENDING) : "memory");
}
// Keeps the compiler from touching accumulators that a wgmma is writing.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Makes this thread's shared-memory writes (cp.async included) visible to
// the tensor cores' reads (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

}  // namespace tf32x3
