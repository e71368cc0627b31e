// K6 at transformer width 128 on jets of 129 … 256 slots: the survival head's kernel
// as a cluster of 1 channel block × 2 row blocks a jet (survival_head.cuh,
// gsdm_blocks.cuh), instantiated for every head width; its own source so
// that nvcc builds it beside the others.

#include "survival_head.cuh"

namespace mmps {
MMPS_HEAD_CLUSTER(1, 2)
}  // namespace mmps
