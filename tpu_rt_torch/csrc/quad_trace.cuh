// Traversal of the 4-wide BVH (QuadBVH) for NVIDIA Hopper: closest hit and
// any hit, each with or without the barycentrics and the per-ray counters.
//
// Replaces: tpu_rt/trace/packet2.py `_kernel2` in its 4-wide (`w4`) node-unit
// form with the VPU Woop-triangle drain -- the Pallas kernel behind
// `trace_packet4` and the `packet4` routing tracer -- in its closest-hit
// form, its any_hit=True form (packet2.py:552-567, :881-883), its
// want_uv=True form (:466-468, :568-571, :891-893, :902-904) and its
// count_iters form (:432-433, :921-933), which here counts per ray.
//
// What it computes: for each ray, the nearest Woop-triangle hit (closest
// hit) or the first accepted hit in visit order (any hit) over the QuadBVH
// that tpu_rt_torch.bvh.collapse.collapse4 emits, exactly as the host
// oracle `trace_quad_scalar` (tpu_rt_torch/bvh/collapse.py) does and in the
// same order:
//   - children are visited in stored order when d[hint] >= 0 for this ray,
//     reversed otherwise (the Pallas kernel votes a packet-mean sign);
//   - every hit leaf of a node is drained, in visit order, before the
//     nearest (first in visit order) hit inner child is taken;
//   - the other hit inner children are pushed so that the nearest pops
//     first;
//   - any hit: the ray writes its hit and returns at its first accepted
//     hit, as the oracle's `done` flag and the reference's per-lane anyHit
//     abort (kepler_dynamic_fetch.cu:376-381) do.  The Pallas kernel keeps
//     the ray in its packet and refuses later hits instead, and orders
//     children by a packet vote, so its occluder may differ; hit vs miss
//     cannot.
//   - want_uv: u, v of the accepted hit, the oracle's (collapse.py:323-326);
//   - stats: node_tests (quad nodes visited) and tri_tests (triangles
//     tested), as the plain version counts them.  The Pallas census counts
//     loop iterations per grid step, a packet's; per-ray counts are the
//     SIMT quantity.
// The three forms are template flags (trace_common.cuh), one instantiation
// each, so the frame forms carry no any-hit, uv or counter code.
//
// Postponed leaves (kPostpone; tpu_rt's C > 1 leaf cursors, packet2.py:72-77,
// refill :572-587, drain :783-897, which trace_packet4 passes through,
// :1188): each hit leaf child, in visit order, is held instead of drained,
// and the held leaves are drained when `cursors` of them are held or the
// stack is empty (trace_common.cuh `Postponed`).  The slab tests of a node
// still use the hit distance from before its leaves, so t stays the
// oracle's bit for bit; tri may differ at exact-t ties, the any-hit
// occluder may differ, and node / triangle tests grow.  quad_trace.cu
// instantiates the forms without the flag, quad_trace_c.cu those with it,
// so that each library is built by its own nvcc.
//
// Residencies (tpu_rt/trace/packet2.py:501-515, :906-944, the "mixed" and
// "hbm" DMA paths of `_kernel2`; trace_packet4's rule :1168-1175): two more
// template flags pick the cache policy of the node and Woop loads
// (trace_common.cuh).  "vmem" is the code above; "mixed" streams the Woop
// rows and runs under an L2 access-policy window that keeps the node table
// persisting; "hbm" streams both.  All three compute the same function, so
// their results are bit-equal to the plain version's.
// With -fmad=false and no fast math, every float op below is the oracle's
// op in the oracle's order, so (tri, t, u, v) equal the plain PyTorch
// version's (tpu_rt_torch/trace/quad_kernel.py) bit for bit.
//
// What bounds it: a data-dependent walk.  On a large scene (dragon: quad
// nodes 2.6-5.2 MB, Woop rows 58 MB) the triangle table no longer fits the
// L2 with everything else, and streamed triangle rows could evict the node
// records every ray needs first; the mixed residency keeps the nodes in the
// persisting part of the L2 and lets triangle rows pass through.  Each node
// is one 128-byte record (8 float4 loads, one cache line) and each triangle one 64-byte Woop row
// (up to 4 float4 loads); for the bunny both tables (0.8 MB + 9 MB) sit in
// the 50 MB L2, so the bound is load latency and warp divergence, not
// device-memory bandwidth (conference: 2.1 MB + 23.6 MB, in L2 too).  Any
// hit ends a ray at its first occluder, so short AO rays visit few nodes;
// an AO batch's cost is its unoccluded rays, which walk every node their
// segment crosses.  Measured on an H100 (PERF.md): 1-3% of the bound from
// the rows its rays read, and on dragon the streamed forms (mixed, hbm)
// were 11-21% slower than plain loads.  This first version is simple and
// exact: one ray per thread, a per-thread stack in local memory, no packet
// or persistent-thread scheduling yet.
//
// Layouts (row-major, contiguous):
//   nodes [Q,32] f32: cols 6j..6j+5 child j box (lo.x,hi.x,lo.y,hi.y,lo.z,
//     hi.z; empty slots NaN), cols 24..27 child links as int32 bits
//     (>= 0 node, < 0 leaf ~(first | count << 24), SENT empty), col 28 the
//     order hint axis as int32 bits.  Links alias NaN patterns, so they are
//     only ever read with __float_as_int, never used in a float op.
//   woop [R,16] f32: cols 0..11 the Woop rows (z, u, v), col 12 the
//     original triangle id as int32 bits.
//   origin, dirn [N,3] f32; tmin, tmax [N] f32 (tmax < 0: skip the ray).
// Outputs: tri [N] i32 (-1 miss), t [N] f32 (tmax where missed); u, v [N]
// f32 (want_uv); node_tests, tri_tests [N] i32 (stats).

#pragma once

#include "trace_common.cuh"

#ifndef STACK_SIZE
#error "STACK_SIZE must be defined by the build (tpu_rt_torch/trace/quad_kernel.py)"
#endif

namespace {

using namespace tpu_rt_torch;

constexpr int kSent = 0x7FFFFFFF;
constexpr int kCountShift = 24;
constexpr int kFirstMask = (1 << kCountShift) - 1;

// Drain the leaf behind `link` = ~(first | count << 24).
template <bool kAnyHit, bool kWantUv, bool kStats, bool kStreamTris>
__device__ __forceinline__ bool drain_leaf(const float4* __restrict__ woop, int link,
                                           const Ray& r, Hit& h) {
    const int c = ~link;
    return drain<kAnyHit, kWantUv, kStats, kStreamTris>(woop, c & kFirstMask,
                                                        (c >> kCountShift) & 0xFF, r, h);
}

template <bool kAnyHit, bool kWantUv, bool kStats, bool kStreamNodes, bool kStreamTris,
          bool kPostpone>
__global__ void __launch_bounds__(kBlock)
quad_trace_kernel(const float4* __restrict__ nodes, int n_nodes,
                  const float4* __restrict__ woop,
                  const float* __restrict__ origin, const float* __restrict__ dirn,
                  const float* __restrict__ tmin, const float* __restrict__ tmax,
                  int* __restrict__ out_tri, float* __restrict__ out_t,
                  float* __restrict__ out_u, float* __restrict__ out_v,
                  int* __restrict__ out_node_tests, int* __restrict__ out_tri_tests,
                  int n_rays, int cursors) {
    const int ray = blockIdx.x * blockDim.x + threadIdx.x;
    if (ray >= n_rays) return;

    Hit h{tmax[ray], -1, 0.0f, 0.0f, 0, 0};
    if (!(h.t < 0.0f) && n_nodes > 0) {
        const Ray r = load_ray(origin, dirn, tmin, ray);
        Postponed held;
        const auto drain_link = [&](int link) {
            return drain_leaf<kAnyHit, kWantUv, kStats, kStreamTris>(woop, link, r, h);
        };
        // Hold a hit leaf child; drain the held leaves once `cursors` are
        // held.  True at an accepted any-hit triangle.
        const auto hold = [&](bool v, int k) {
            return v && k < 0 && held.add(k) == cursors && held.drain(drain_link);
        };

        int stack[STACK_SIZE];
        int sp = 0;
        int node = 0;
        for (;;) {
            if constexpr (kStats) ++h.node_tests;
            const float4* rec = nodes + static_cast<size_t>(node) * 8;
            const float4 q0 = load<kStreamNodes>(rec), q1 = load<kStreamNodes>(rec + 1);
            const float4 q2 = load<kStreamNodes>(rec + 2), q3 = load<kStreamNodes>(rec + 3);
            const float4 q4 = load<kStreamNodes>(rec + 4), q5 = load<kStreamNodes>(rec + 5);
            const float4 q6 = load<kStreamNodes>(rec + 6), q7 = load<kStreamNodes>(rec + 7);
            const int l0 = __float_as_int(q6.x), l1 = __float_as_int(q6.y);
            const int l2 = __float_as_int(q6.z), l3 = __float_as_int(q6.w);
            const int hint = __float_as_int(q7.x);

            // All four slab tests use the hit distance from before this
            // node's leaves are drained, as the oracle does.
            const bool h0 = l0 != kSent && slab(r, h.t, q0.x, q0.y, q0.z, q0.w, q1.x, q1.y);
            const bool h1 = l1 != kSent && slab(r, h.t, q1.z, q1.w, q2.x, q2.y, q2.z, q2.w);
            const bool h2 = l2 != kSent && slab(r, h.t, q3.x, q3.y, q3.z, q3.w, q4.x, q4.y);
            const bool h3 = l3 != kSent && slab(r, h.t, q4.z, q4.w, q5.x, q5.y, q5.z, q5.w);

            // Visit order: stored order if this ray's direction along the
            // hint axis is >= 0, reversed otherwise.
            const float dh = hint == 0 ? r.dx : (hint == 1 ? r.dy : r.dz);
            const bool fwd = dh >= 0.0f;
            const bool v0 = fwd ? h0 : h3, v1 = fwd ? h1 : h2;
            const bool v2 = fwd ? h2 : h1, v3 = fwd ? h3 : h0;
            const int k0 = fwd ? l0 : l3, k1 = fwd ? l1 : l2;
            const int k2 = fwd ? l2 : l1, k3 = fwd ? l3 : l0;

            if constexpr (kPostpone) {
                if (hold(v0, k0) || hold(v1, k1) || hold(v2, k2) || hold(v3, k3)) break;
            } else if constexpr (kAnyHit) {
                // Stop at the first accepted hit: write it and return.
                if ((v0 && k0 < 0 && drain_leaf<true, kWantUv, kStats, kStreamTris>(woop, k0, r, h)) ||
                    (v1 && k1 < 0 && drain_leaf<true, kWantUv, kStats, kStreamTris>(woop, k1, r, h)) ||
                    (v2 && k2 < 0 && drain_leaf<true, kWantUv, kStats, kStreamTris>(woop, k2, r, h)) ||
                    (v3 && k3 < 0 && drain_leaf<true, kWantUv, kStats, kStreamTris>(woop, k3, r, h))) {
                    break;
                }
            } else {
                if (v0 && k0 < 0) drain_leaf<false, kWantUv, kStats, kStreamTris>(woop, k0, r, h);
                if (v1 && k1 < 0) drain_leaf<false, kWantUv, kStats, kStreamTris>(woop, k1, r, h);
                if (v2 && k2 < 0) drain_leaf<false, kWantUv, kStats, kStreamTris>(woop, k2, r, h);
                if (v3 && k3 < 0) drain_leaf<false, kWantUv, kStats, kStreamTris>(woop, k3, r, h);
            }

            // Inner children: continue with the first in visit order; push
            // the others last-first so the second pops next.  The host
            // (upload_quad) guarantees 3 * tree depth <= STACK_SIZE.
            int next = -1;
            if (v3 && k3 >= 0) next = k3;
            if (v2 && k2 >= 0) { if (next >= 0) stack[sp++] = next; next = k2; }
            if (v1 && k1 >= 0) { if (next >= 0) stack[sp++] = next; next = k1; }
            if (v0 && k0 >= 0) { if (next >= 0) stack[sp++] = next; next = k0; }
            if (next >= 0) {
                node = next;
                continue;
            }
            if (sp == 0) {
                if constexpr (kPostpone) held.drain(drain_link);
                break;
            }
            node = stack[--sp];
        }
    }
    store_hit<kWantUv, kStats>(h, ray, out_tri, out_t, out_u, out_v, out_node_tests,
                               out_tri_tests);
}

// The launch behind the C ABI of quad_trace.cu (kPostpone false, cursors
// 1) and quad_trace_c.cu (kPostpone true, 2 <= cursors <= kMaxCursors).
// `any_hit`, `want_uv` and `stats` pick the form and `stream_nodes`,
// `stream_tris` the residency (trace_common.cuh); u, v and the counters may
// be null in the forms that do not write them.  `window_bytes` > 0 attaches
// the mixed residency's L2 window over the node table, with the persisting
// set-aside `set_aside` (launch_window).  Launches on `stream` and returns
// the first CUDA error.
template <bool kPostpone>
int quad_launch(const void* nodes, int n_nodes, const void* woop,
                const void* origin, const void* dirn, const void* tmin, const void* tmax,
                void* out_tri, void* out_t, void* out_u, void* out_v,
                void* out_node_tests, void* out_tri_tests, int n_rays, int cursors,
                int any_hit, int want_uv, int stats, int stream_nodes,
                int stream_tris, size_t window_bytes, size_t set_aside, void* stream) {
    if (kPostpone ? (cursors < 2 || cursors > kMaxCursors) : cursors != 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSuccess;
    if (n_rays > 0) {
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        const int grid = (n_rays + kBlock - 1) / kBlock;
        dispatch_form(any_hit != 0, want_uv != 0, stats != 0, [&](auto a, auto u, auto c) {
            const bool ok = dispatch_residency(stream_nodes != 0, stream_tris != 0,
                                               [&](auto sn, auto st) {
                err = launch_window(
                    quad_trace_kernel<decltype(a)::value, decltype(u)::value, decltype(c)::value,
                                      decltype(sn)::value, decltype(st)::value, kPostpone>,
                    grid, s, nodes, window_bytes, set_aside,
                    static_cast<const float4*>(nodes), n_nodes, static_cast<const float4*>(woop),
                    static_cast<const float*>(origin), static_cast<const float*>(dirn),
                    static_cast<const float*>(tmin), static_cast<const float*>(tmax),
                    static_cast<int*>(out_tri), static_cast<float*>(out_t),
                    static_cast<float*>(out_u), static_cast<float*>(out_v),
                    static_cast<int*>(out_node_tests), static_cast<int*>(out_tri_tests), n_rays,
                    cursors);
            });
            if (!ok) err = cudaErrorInvalidValue;
        });
    }
    return static_cast<int>(err);
}

}  // namespace

// The C ABI of both quad libraries (ctypes; tpu_rt_torch/trace/common.py
// CudaTraceKernel.launch): the arguments of quad_launch.
#define QUAD_LAUNCH_ARGS                                                                   \
    const void *nodes, int n_nodes, const void *woop, const void *origin, const void *dirn, \
        const void *tmin, const void *tmax, void *out_tri, void *out_t, void *out_u,        \
        void *out_v, void *out_node_tests, void *out_tri_tests, int n_rays, int cursors,    \
        int any_hit, int want_uv, int stats, int stream_nodes, int stream_tris,             \
        size_t window_bytes, size_t set_aside, void *stream
#define QUAD_LAUNCH_CALL                                                                    \
    nodes, n_nodes, woop, origin, dirn, tmin, tmax, out_tri, out_t, out_u, out_v,           \
        out_node_tests, out_tri_tests, n_rays, cursors, any_hit, want_uv, stats,            \
        stream_nodes, stream_tris, window_bytes, set_aside, stream
