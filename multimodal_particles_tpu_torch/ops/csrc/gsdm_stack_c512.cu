// K7 at transformer width 512: the gsdm stack's kernel as a cluster of 4
// blocks a jet (gsdm_stack.cuh, gsdm_blocks.cuh), instantiated for every head
// width; its own source so that nvcc builds it beside the others.

#include "gsdm_stack.cuh"

namespace mmps {
MMPS_STACK_CLUSTER(4, 1)
}  // namespace mmps
