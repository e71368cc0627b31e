// K1: fused EPiC forward, one launch for the whole encoder.
//
// Replaces the TPU kernel multimodal_particles_tpu/ops/epic_pallas.py
// (`epic_forward_pallas`, body `_epic_kernel` / `_forward_acts`): input
// embeddings → EPiC projection → num_blocks EPiC layers → weight-normed
// output → continuous head and SELU discrete head (any hidden width). With a
// non-null `hidden` the same launch also writes the trunk's last local hidden
// state (B, N, H), the kernel's third output `output_hidden_local`
// (epic_pallas.py:291-292), which the survival head and the gsdm stacks read.
// With `fold_discrete` in the layout the discrete input is the particle's V
// channel values through a Dense, the transdimensional trunk's Linear-discrete
// embedding (`fold_discrete=True`, epic_pallas.py:107-131, :199-205): the
// kernel then reads `kvals` (B, N, V) float and no tokens; that instantiation
// is epic_forward_fold.cu's, this source holds the token one. The kernel
// itself is epic_forward_kernel.cuh.
//
// What bounds it. At config-berlin (hidden 16, 2 blocks, N = 128) the
// encoder is about 3.2k multiply-adds, some 6 kFLOP, per particle. Written
// as separate PyTorch operators, each of its ~40 steps reads and writes
// (B·N, 16..48) float32 activations in device memory, so the plain version
// is bound by memory traffic and by the count of launches, not by FLOPs.
// This kernel keeps every activation on chip: a thread holds its particle's
// activations in registers, the block holds the per-jet pooled state and the
// weights in shared memory, and device memory sees only the inputs (t, x, k,
// mask: 24 bytes a particle), the 44-byte output and the weights, which
// every block stages from L2 (about 30 KB a jet at config-berlin). What is
// left is fp32 arithmetic, plus that weight traffic from L2.
//
// C interface (bound with ctypes by ops/epic_cuda.py): returns the
// cudaError_t of the launch, 0 on success.

#include "epic_forward_kernel.cuh"

extern "C" int mmp_epic_forward(const void* w, const void* t, const void* x, const void* k,
                                const void* mask, void* out, void* hidden, int B, int N,
                                const int* dims, void* stream) {
  return mmp::epic_forward_entry<false>(w, t, x, k, mask, out, hidden, B, N, dims, stream);
}

extern "C" const char* mmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
