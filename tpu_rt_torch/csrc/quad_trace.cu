// The 4-wide traversal kernel's forms with one leaf drained as soon as it
// is reached (cursors = 1): closest and any hit, uv, counters, three
// residencies (quad_trace.cuh), and the first versions of the vmem frame
// forms.
#include "quad_trace.cuh"

extern "C" int quad_trace_launch(QUAD_LAUNCH_ARGS) {
    return quad_dispatch(QuadLaunch<false>{}, cursors == 1, QUAD_LAUNCH_CALL);
}
