// The binary traversal kernel's slot forms with K = 4 rays a thread
// (flat_trace.cuh flat_slots_kernel, trace_common.cuh persistent_slots):
// closest and any hit, uv, counters, f32 or bf16 nodes, three residencies,
// at cursors = 1, with U (`units`) and S (`tile`) read at run time.  A
// library of its own, so that its nvcc runs beside the others.
#include "flat_trace.cuh"

extern "C" int flat_trace_k4_launch(int units, int tile, FLAT_LAUNCH_ARGS) {
    return flat_dispatch(FlatSlotLaunch<4>{units, tile}, cursors == 1 && slots_ok(units, tile),
                         FLAT_LAUNCH_CALL);
}
