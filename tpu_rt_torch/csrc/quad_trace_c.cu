// The 4-wide traversal kernel's postponed-leaf forms (quad_trace.cuh,
// kPostpone): 2 <= cursors <= kMaxCursors leaves held per ray, in every
// form and residency of quad_trace.cu.  A library of its own, so that its
// nvcc runs beside the others.
#include "quad_trace.cuh"

extern "C" int quad_trace_c_launch(QUAD_LAUNCH_ARGS) {
    return quad_dispatch(QuadLaunch<true>{}, cursors >= 2 && cursors <= tpu_rt_torch::kMaxCursors,
                         QUAD_LAUNCH_CALL);
}
