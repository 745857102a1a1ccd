// The binary traversal kernel's postponed-leaf forms (flat_trace.cuh,
// kPostpone): 2 <= cursors <= kMaxCursors leaves held per ray, in every
// form, node format and residency of flat_trace.cu.  A library of its own,
// so that its nvcc runs beside the others.
#include "flat_trace.cuh"

extern "C" int flat_trace_c_launch(FLAT_LAUNCH_ARGS) {
    return flat_dispatch(FlatLaunch<true>{}, cursors >= 2 && cursors <= tpu_rt_torch::kMaxCursors,
                         FLAT_LAUNCH_CALL);
}
