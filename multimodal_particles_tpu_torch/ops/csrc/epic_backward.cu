// K3 backward's C entry points and its hidden-16 instances; the kernel, what
// it computes and what bounds it are epic_backward.cuh's, the other widths'
// instances epic_backward_h32.cu, epic_backward_h48.cu, epic_backward_h64.cu.
//
// C interface (bound with ctypes by ops/epic_vjp_cuda.py): each entry point
// returns the cudaError_t of its calls, 0 on success.

#include "epic_backward.cuh"

extern "C" int mmp_epic_backward_workspace(int B, int N, const int* dims, int* grid,
                                           long long* floats) {
  using namespace mmp;
  const Dims d = dims_from(dims);
  if (!k3::backward_dims_supported(d) || N < 1 || N > MAX_SLOTS || B < 0)
    return cudaErrorInvalidValue;
  switch (d.hidden) {
    case 16: return k3::workspace<16>(d, B, N, grid, floats);
    case 32: return k3::workspace<32>(d, B, N, grid, floats);
    case 48: return k3::workspace<48>(d, B, N, grid, floats);
    case 64: return k3::workspace<64>(d, B, N, grid, floats);
    default: return cudaErrorInvalidValue;
  }
}

// buf: the buffer K1 read (ops/epic_cuda.py::narrow_buffer: K1's entries,
// then the transposed fragments); w: the packed weights (the per-jet MLP's
// transposed products and local_0's input side read them); fwd_out: null,
// or (B, N, 3 + V) for the rerun's outputs.
extern "C" int mmp_epic_backward(const void* buf, const void* w, const void* t, const void* x,
                                 const void* k, const void* mask, const void* g, void* out,
                                 void* fwd_out, void* scratch, int grid, int B, int N,
                                 const int* dims, void* stream) {
  using namespace mmp;
  const Dims d = dims_from(dims);
  if (!k3::backward_dims_supported(d) || N < 1 || N > MAX_SLOTS || B < 0 || grid < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const auto* bf = static_cast<const float*>(buf);
  const auto* wf = static_cast<const float*>(w);
  const auto* tf = static_cast<const float*>(t);
  const auto* xf = static_cast<const float*>(x);
  const auto* ki = static_cast<const int*>(k);
  const auto* mf = static_cast<const float*>(mask);
  const auto* gf = static_cast<const float*>(g);
  auto* of = static_cast<float*>(out);
  auto* ff = static_cast<float*>(fwd_out);
  auto* sf = static_cast<float*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d.hidden) {
    case 16: return k3::launch<16>(bf, wf, d, tf, xf, ki, mf, gf, of, ff, sf, grid, B, N, s);
    case 32: return k3::launch<32>(bf, wf, d, tf, xf, ki, mf, gf, of, ff, sf, grid, B, N, s);
    case 48: return k3::launch<48>(bf, wf, d, tf, xf, ki, mf, gf, of, ff, sf, grid, B, N, s);
    case 64: return k3::launch<64>(bf, wf, d, tf, xf, ki, mf, gf, of, ff, sf, grid, B, N, s);
    default: return cudaErrorInvalidValue;
  }
}
