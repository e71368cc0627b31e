// K1: fused EPiC forward, one launch for the whole encoder, its per-particle
// products on the tensor cores.
//
// Replaces the TPU kernel multimodal_particles_tpu/ops/epic_pallas.py
// (`epic_forward_pallas`, body `_epic_kernel` / `_forward_acts`): input
// embeddings → EPiC projection → num_blocks EPiC layers → weight-normed
// output → continuous head and SELU discrete head (any hidden width, or none:
// then the second output is the masked pre-logits). With a non-null `hidden`
// the same launch also writes the trunk's last local hidden state (B, N, H),
// the kernel's third output `output_hidden_local` (epic_pallas.py:291-292),
// which the survival head and the gsdm stacks read. With `fold_discrete` in
// the layout the discrete input is the particle's V channel values through a
// Dense, the transdimensional trunk's Linear-discrete embedding
// (`fold_discrete=True`, epic_pallas.py:107-131, :199-205): the kernel then
// reads `k` as (B, N, V) float and no tokens; that instantiation is
// epic_forward_fold.cu's, this source holds the token one. The kernel itself
// is epic_forward_kernel.cuh, on the machinery it shares with K2
// (narrow_tc.cuh).
//
// Design. A persistent grid (as many blocks as fit on the SMs, each walking
// over jets); a block of one warp per 16 particle slots (⌈N/16⌉ warps); a jet
// of 257–512 slots a thread-block cluster of two such blocks, one a half of
// its slots, whose pools add both blocks' partial sums through distributed
// shared memory (narrow_tc.cuh `pool`), so that both run the per-jet MLP on
// the same bits. Hidden widths 16, 32, 48 and 64 are instances; the wrappers
// zero-pad any other width up to 64 to the next (exact: a padded unit has
// zero weights in and out and a zero bias, and leaky(0) = 0).
//   * A warp's 16 rows go through every per-particle product as
//     mma.sync.m16n8k8 TF32 products under the 3×TF32 split (tf32x3.cuh):
//     local_0's particle two thirds (folded with the x and discrete
//     embeddings into one 16-deep product of [x, 1, 0…, onehot(k) or the 8
//     channel values] with [T_x; c; 0; T_k]), fc_local1's particle third and
//     fc_local2 of every EPiC layer, the output layer (discrete and
//     continuous columns as two 8-wide n-tiles) and the discrete head, a
//     runtime loop over its 8-column tiles. A product's accumulator is the
//     next one's A fragment through the k order that the buffer's layout
//     permutes (ops/epic_cuda.py::narrow_buffer_plan).
//   * The buffer (≈ 35 KB at config-berlin, ≈ 42 KB with the absorbing
//     generator's 56-wide head) is staged into shared memory once a block; a
//     buffer over 64 KB is read through L1.
//   * Each jet has its own time. At a jet's start every warp computes the
//     time embedding and local_0's time term itself (no barrier), and the
//     warps share the jet's other time terms (through g0, and every layer's
//     fc_global1 and fc_local1), which the first pool's barrier makes
//     visible to warp 0. Warp 0 runs the per-jet MLP after each pool (the
//     global MLP, fc_local1's broadcast thirds), as in K2: a jet takes 1 +
//     2·num_blocks barriers. Splitting each of the MLP's layers over the
//     warps, with a barrier a layer, was timed 1.5× (two warps, a named
//     barrier) to 1.7× (every warp) slower on an H100 (PERF.md §6).
//
// What bounds it. At config-berlin (hidden 16, 2 blocks, N = 128) the
// function needs 1,384 multiply-adds a particle in the per-particle products
// (chip_smoke.py::encoder_macs), 8.3 kFLOP on the tensor cores as three TF32
// products, and reads 24 bytes a particle (t, x, k, mask) and writes 44. The
// kernel runs the products padded (local_0 16 deep, the output layer 16
// columns, the head's tiles 8 wide). What it spends (scripts/k1_variants.py
// on an H100, PERF.md §5) is each jet's chain of dependent steps: ≈ 44%
// warp 0's per-jet MLP while the other warps wait, ≈ 36% the products' mma
// chains, the rest the pools, the time terms and the loads and stores.
//
// C interface (bound with ctypes by ops/epic_cuda.py): returns the
// cudaError_t of the launch, 0 on success.

#include "epic_forward_kernel.cuh"

extern "C" int mmp_epic_forward(const void* tcw, const void* t, const void* x, const void* k,
                                const void* mask, void* out, void* hidden, int B, int N,
                                const int* dims, void* stream) {
  return mmp::epic_forward_entry<false>(tcw, t, x, k, mask, out, hidden, B, N, dims, stream);
}

extern "C" const char* mmp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
