// K4 at local hidden width 512 (a cluster of 4 blocks a jet) with any
// global, time-embedding and head widths the wide gate takes
// (epic_wide_forward_any.cuh); its own source so that nvcc builds it beside
// the others.

#include "epic_wide_forward_any.cuh"

namespace mmpw {
MMPW_FORWARD_ANY(4)
}  // namespace mmpw
