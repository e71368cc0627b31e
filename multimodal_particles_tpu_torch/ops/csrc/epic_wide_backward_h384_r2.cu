// K5 at local hidden width 384 on jets of 129 … 256 slots: a cluster of
// 3 column blocks × 2 row blocks a jet (epic_wide_backward_any.cuh), with any
// global, time-embedding and token-embedding widths the wide gate takes; its
// own source so that nvcc builds it beside the others.

#include "epic_wide_backward_any.cuh"

namespace mmpw {
MMPW_BACKWARD_ANY_R2(3)
}  // namespace mmpw
