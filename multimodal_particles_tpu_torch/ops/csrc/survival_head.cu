// K6: the absorbing family's survival head, one launch for the whole head.
//
// Replaces the TPU kernel multimodal_particles_tpu/ops/survival_pallas.py
// (`survival_head_pallas`, body `_survival_kernel`): proj_in of [trunk hidden
// ‖ one-hot(mask)] → n_blocks × (ResnetBlock, AttnBlock) → pre_rate Dense →
// post_rate (C → 1). The blocks, their GroupNorm and attention, the shared
// memory plan and the design are gsdm_blocks.cuh's, shared with the gsdm
// stack (gsdm_stack.cu); this file adds the head's first product, with the
// mask's one-hot as two weight rows, and its two rate projections.
//
// What bounds it. A jet of N = 109 slots costs 0.22 M (proj_in) + per block
// 6 products of (N,128)·(128,128) and two heads of N·N·64 scores and values
// + 1.8 M (pre_rate): about 29.5 M multiply-adds at 2 blocks, against 7.4 KB
// of input and output. On the tensor cores under the 3×TF32 split (three
// TF32 products a multiply-add) the operations bound it, at B = 4096 1.47 ms
// at the card's TF32 peak; the bytes take 0.01 ms. Each block also streams
// the 1.6 MB of prepared weights (hi and lo halves) from L2 for every jet.
//
// The first product runs over the trunk's Dh hidden columns (⌈Dh/8⌉ stages
// of the stream, zero rows past Dh; a trunk wider than 128 in passes of 128
// columns, as the gsdm stack's); the one-hot's two weight rows enter its
// epilogue as W[Dh] + mask·(W[Dh+1] − W[Dh]). pre_rate's epilogue takes
// post_rate as a row product in registers: each thread's 32 columns of two
// rows, summed over the four threads that hold a row (at transformer width
// 256–512, over a block's 128 channels, and the blocks' sums of a row added
// by the cluster's first block).
//
// The kernel (survival_head.cuh) is instantiated here at transformer width
// 128 (heads of 8, 16, 32, 64 or 128 channels through gsdm_blocks.cuh's
// `attend`, of 1, 2 or 4 through `attend_any`) and in
// survival_head_c{256,384,512}.cu as clusters of 2, 3 and 4 blocks a jet.
// A jet of 129 … 256 slots is a cluster of C/128 × 2 blocks, each owning 128
// rows (survival_head_r2.cu and _c{256,384,512}_r2.cu; gsdm_blocks.cuh's row
// blocks): at N = 256, C = 128, 2 blocks, Dh = 16 a jet is 88.6 M
// multiply-adds, the operations' bound at B = 4096 4.4 ms on the tensor
// cores.
//
// C interface (bound with ctypes by ops/survival_cuda.py): returns the
// cudaError_t of the launch, 0 on success.

#include "survival_head.cuh"

// weights: the packed head; stream: its tensor-core stages (each block of a
// cluster its own: proj_in's ⌈Dh/8⌉, the blocks', pre_rate's); tp: (n_blocks,
// B, W) per-block time rows; last: (B, N, Dh); mask: (B, N) float; out: (B,
// N); scratch: two tiles of 128 × 132 floats for each of the grid's blocks.
// W (channels): 128, 256, 384 or 512; heads of W / n_heads ≤ 128 channels;
// any Dh ≥ 1 (proj_in runs over it in passes of 128 columns); 1 ≤ N ≤ 256;
// grid ≥ W / 128, × 2 past 128 slots.
extern "C" int mmp_survival_head(const void* w, const void* stream, const void* tp,
                                 const void* last, const void* mask, void* out, void* scratch,
                                 int grid, int B, int N, int Dh, int n_blocks, int n_heads,
                                 int channels, void* cuda_stream) {
  using namespace mmps;
  const int CL = channels / C;
  if (channels % C != 0 || CL < 1 || CL > MAX_CL || N < 1 || N > ROWS * MAX_RT || Dh < 1 ||
      n_blocks < 1 || n_heads < 1 || channels % n_heads != 0 ||
      channels / n_heads > C || grid < CL * (N > ROWS ? 2 : 1))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int hd = channels / n_heads;
  const cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  if (N > ROWS) {  // two row blocks a jet
    auto launch = CL == 1   ? launch_head_cluster<1, 2>
                  : CL == 2 ? launch_head_cluster<2, 2>
                  : CL == 3 ? launch_head_cluster<3, 2>
                            : launch_head_cluster<4, 2>;
    return launch(w, stream, tp, last, mask, out, scratch, grid, B, N, Dh, n_blocks, hd, s);
  }
  if (CL > 1) {
    auto launch = CL == 2   ? launch_head_cluster<2, 1>
                  : CL == 3 ? launch_head_cluster<3, 1>
                            : launch_head_cluster<4, 1>;
    return launch(w, stream, tp, last, mask, out, scratch, grid, B, N, Dh, n_blocks, hd, s);
  }
  auto launch = hd == 8     ? launch_head<1, 1, 8, 0>
                : hd == 16  ? launch_head<1, 1, 16, 0>
                : hd == 32  ? launch_head<1, 1, 32, 0>
                : hd == 64  ? launch_head<1, 1, 64, 0>
                : hd == 128 ? launch_head<1, 1, 128, 0>
                            : launch_head<1, 1, 0, 1>;  // 1, 2 or 4 channels
  return launch(w, stream, tp, last, mask, out, scratch, grid, B, N, Dh, n_blocks, hd, s);
}
