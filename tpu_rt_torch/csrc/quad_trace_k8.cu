// The 4-wide traversal kernel's slot forms with K = 8 rays a thread
// (quad_trace.cuh quad_slots_kernel, trace_common.cuh persistent_slots):
// closest and any hit, uv, counters, three residencies, at cursors = 1, with
// U (`units`) and S (`tile`) read at run time.  A library of its own, so
// that its nvcc runs beside the others.
#include "quad_trace.cuh"

extern "C" int quad_trace_k8_launch(int units, int tile, QUAD_LAUNCH_ARGS) {
    return quad_dispatch(QuadSlotLaunch<8>{units, tile}, cursors == 1 && slots_ok(units, tile),
                         QUAD_LAUNCH_CALL);
}
