// K1 with the folded Linear-discrete input: the narrow EPiC forward kernel
// (epic_forward_kernel.cuh; epic_forward.cu says what it computes, how and
// what bounds it) instantiated for a packing whose discrete embedding is a
// Dense over the particle's V channel values, the transdimensional trunk's
// (`fold_discrete=True`, multimodal_particles_tpu/ops/epic_pallas.py:107-131,
// :199-205). `k` is the (B, N, V) float channel values, 8-byte aligned; they
// take the one-hot token's place in local_0's folded product.
//
// C interface (bound with ctypes by ops/epic_cuda.py): returns the
// cudaError_t of the launch, 0 on success.

#include "epic_forward_kernel.cuh"

extern "C" int mmp_epic_forward_fold(const void* tcw, const void* t, const void* x, const void* k,
                                     const void* mask, void* out, void* hidden, int B, int N,
                                     const int* dims, void* stream) {
  return mmp::epic_forward_entry<true>(tcw, t, x, k, mask, out, hidden, B, N, dims, stream);
}
