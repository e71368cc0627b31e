// K7: the transdimensional family's gsdm stack, one launch for the whole stack.
//
// Replaces the TPU kernel multimodal_particles_tpu/ops/gsdm_stack_pallas.py
// (`gsdm_stack_pallas`, body `_stack_kernel`): proj_in of a (B, N, Din) input
// → n_blocks × (ResnetBlock, AttnBlock) → the hidden state (B, N, C). The
// transdimensional network runs it twice an evaluation: the rate /
// nearest-atom head on [trunk hidden ‖ one-hot values] (Din = 24 at the
// reference widths) and the creation head on that ‖ distance ‖ nearest one-hot
// (Din = 27). The heads' small projections after it stay with the caller, as
// they stay outside the TPU kernel. The blocks, their GroupNorm and attention,
// the shared memory plan and the design are gsdm_blocks.cuh's, shared with
// the survival head (survival_head.cu); this file adds a first product of any
// input width and the store of the residual tile.
//
// What bounds it. A jet of N = 128 slots costs N·Din·128 (proj_in) + per block
// 6 products of (N,128)·(128,128) and two heads of N·N·64 scores and values:
// about 34 M multiply-adds at 2 blocks, against N·(Din + 128)·4 bytes (78 KB)
// of input and output. On the tensor cores under the 3×TF32 split the
// operations bound it: at B = 4096 1.69 ms at the card's TF32 peak, the bytes
// 0.1 ms. Each block also streams the 1.6 MB of prepared weights from L2 for
// every jet.
//
// The first product. Its stages hold 8 input rows: the wrapper pads proj_in's
// weight with zero rows to Dp = 8·⌈Din/8⌉ in the tensor-core stream
// (ops/gsdm_stack_cuda.py::stack_stream: Din = 24 → 3 stages, 27 → 4, 136 →
// 17, 139 → 18), and the input tile's columns from Din to Dp are zeroed. An
// input wider than the tile's 128 columns (the `--scaled` trunk's hidden
// state of 128 ‖ V ‖ 3: Din = 136 and 139) goes through the tile in passes of
// 128 columns, each accumulating into the same registers.
//
// The kernel (gsdm_stack.cuh) is instantiated here at transformer width 128
// (heads of 8, 16, 32, 64 or 128 channels through gsdm_blocks.cuh's `attend`,
// of 1, 2 or 4 through `attend_any`) and in gsdm_stack_c{256,384,512}.cu as
// clusters of 2, 3 and 4 blocks a jet, each block writing its 128 columns of
// the output. A jet of 129 … 256 slots is a cluster of C/128 × 2 blocks, each
// owning 128 rows (gsdm_stack_r2.cu and _c{256,384,512}_r2.cu); at N = 256,
// C = 128, 2 blocks, Din = 27 a jet is 84.8 M multiply-adds, the operations'
// bound at B = 4096 4.2 ms on the tensor cores.
//
// C interface (bound with ctypes by ops/gsdm_stack_cuda.py): returns the
// cudaError_t of the launch, 0 on success.

#include "gsdm_stack.cuh"

// weights: the packed stack; stream: its tensor-core stages (each block of a
// cluster its own: proj_in's ⌈Din/8⌉, then the blocks'); tp: (n_blocks, B, W)
// per-block time rows; x: (B, N, Din); out: (B, N, W); scratch: two tiles of
// 128 × 132 floats for each of the grid's blocks. W (channels): 128, 256, 384
// or 512; heads of W / n_heads ≤ 128 channels; 1 ≤ N ≤ 256; grid ≥ W / 128,
// × 2 past 128 slots.
extern "C" int mmp_gsdm_stack(const void* w, const void* stream, const void* tp, const void* x,
                              void* out, void* scratch, int grid, int B, int N, int Din,
                              int n_blocks, int n_heads, int channels, void* cuda_stream) {
  using namespace mmps;
  const int CL = channels / C;
  if (channels % C != 0 || CL < 1 || CL > MAX_CL || N < 1 || N > ROWS * MAX_RT || Din < 1 ||
      n_blocks < 1 || n_heads < 1 || channels % n_heads != 0 || channels / n_heads > C ||
      grid < CL * (N > ROWS ? 2 : 1))
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int hd = channels / n_heads;
  const cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  if (N > ROWS) {  // two row blocks a jet
    auto launch = CL == 1   ? launch_stack_cluster<1, 2>
                  : CL == 2 ? launch_stack_cluster<2, 2>
                  : CL == 3 ? launch_stack_cluster<3, 2>
                            : launch_stack_cluster<4, 2>;
    return launch(w, stream, tp, x, out, scratch, grid, B, N, Din, n_blocks, hd, s);
  }
  if (CL > 1) {
    auto launch = CL == 2   ? launch_stack_cluster<2, 1>
                  : CL == 3 ? launch_stack_cluster<3, 1>
                            : launch_stack_cluster<4, 1>;
    return launch(w, stream, tp, x, out, scratch, grid, B, N, Din, n_blocks, hd, s);
  }
  auto launch = hd == 8     ? launch_stack<1, 1, 8, 0>
                : hd == 16  ? launch_stack<1, 1, 16, 0>
                : hd == 32  ? launch_stack<1, 1, 32, 0>
                : hd == 64  ? launch_stack<1, 1, 64, 0>
                : hd == 128 ? launch_stack<1, 1, 128, 0>
                            : launch_stack<1, 1, 0, 1>;  // 1, 2 or 4 channels
  return launch(w, stream, tp, x, out, scratch, grid, B, N, Din, n_blocks, hd, s);
}
