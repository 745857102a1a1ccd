// The binary traversal kernel's forms with one leaf drained as soon as it
// is reached (cursors = 1): closest and any hit, uv, counters, f32 or bf16
// nodes, three residencies (flat_trace.cuh).
#include "flat_trace.cuh"

extern "C" int flat_trace_launch(FLAT_LAUNCH_ARGS) {
    return flat_dispatch(FlatLaunch<false>{}, cursors == 1, FLAT_LAUNCH_CALL);
}
