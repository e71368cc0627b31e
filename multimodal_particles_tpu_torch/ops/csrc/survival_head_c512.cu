// K6 at transformer width 512: the survival head's kernel as a cluster of
// 4 blocks a jet (survival_head.cuh, gsdm_blocks.cuh), instantiated for every
// head width; its own source so that nvcc builds it beside the others.

#include "survival_head.cuh"

namespace mmps {
MMPS_HEAD_CLUSTER(4, 1)
}  // namespace mmps
