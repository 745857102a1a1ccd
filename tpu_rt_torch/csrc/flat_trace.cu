// The binary traversal kernel's forms of the first versions (closest and
// any hit, uv, counters, f32 or bf16 nodes, three residencies;
// flat_trace.cuh), with one leaf drained as soon as it is reached
// (cursors = 1).
#include "flat_trace.cuh"

extern "C" int flat_trace_launch(FLAT_LAUNCH_ARGS) {
    return flat_dispatch(FlatKernelFor<false>{}, cursors == 1, FLAT_LAUNCH_CALL);
}
