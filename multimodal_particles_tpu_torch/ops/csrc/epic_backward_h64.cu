// K3 backward at hidden width 64: epic_backward.cuh's launches instantiated
// (the kernel at one and at two row blocks), which epic_backward.cu's entry
// points call.

#include "epic_backward.cuh"

namespace mmp {
namespace k3 {
template cudaError_t workspace<64>(const Dims&, int, int, int*, long long*);
template cudaError_t launch<64>(const float*, const float*, const Dims&, const float*,
                                const float*, const int*, const float*, const float*,
                                float*, float*, float*, int, int, int, cudaStream_t);
}  // namespace k3
}  // namespace mmp
