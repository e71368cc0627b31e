// K4 at local hidden width 256 on jets of 129 … 256 slots: a cluster of
// 2 column blocks × 2 row blocks a jet (epic_wide_forward_any.cuh), with any
// global, time-embedding and head widths the wide gate takes; its own source
// so that nvcc builds it beside the others.

#include "epic_wide_forward_any.cuh"

namespace mmpw {
MMPW_FORWARD_ANY_ROWS(2, 2)
}  // namespace mmpw
