// Traversal of the binary BVH (FlatBVH) for NVIDIA Hopper: closest hit and
// any hit, each with or without the barycentrics and the per-ray counters.
//
// Replaces: tpu_rt/trace/packet2.py `_kernel2` in its binary f32 node-unit
// form (:704-770) on `pack_tables2` records (:126-258) -- the Pallas kernel
// behind `trace_packet2` and the `packet` routing tracer -- in its
// closest-hit, any_hit=True, want_uv=True and count_iters forms.
//
// What it computes: for each ray, the nearest Woop-triangle hit (closest
// hit) or the first accepted hit in visit order (any hit) over the FlatBVH
// that tpu_rt_torch.bvh.flatten emits, exactly as the host oracle
// `trace_flat_scalar` (tpu_rt_torch/trace/cpu_reference.py:170-291) does
// and in the same order:
//   - both children are slab-tested against the hit distance so far;
//   - if both are hit, the ray continues with the child of the smaller
//     entry distance and pushes the other (`c1min < c0min` swaps them);
//     if one is hit, it continues there; if none, it pops;
//   - a link < 0 is a leaf, reached directly or popped off the stack: its
//     triangles are drained in order and the ray pops again;
//   - any hit: the ray stops at its first accepted triangle.
// The Pallas kernel orders a packet's children by a split-axis vote
// (packet2.py:718-735); that vote is a packet's, so this kernel does not
// copy it, and against `trace_packet2` only hit vs miss of an any-hit ray
// is comparable.  node_tests (inner nodes visited) and tri_tests
// (triangles tested) count what the oracle's RayStats count
// (cpu_reference.py:223, :254), so they equal `per_ray_node_tests` and
// `per_ray_tri_tests`.  With -fmad=false and no fast math, every float op
// is the oracle's in its order, so (tri, t, u, v) equal it bit for bit.
//
// Node formats and residencies (row 6 of the kernel table, the large-scene
// variants of `_kernel2`):
//   - kBf16Nodes replaces the bf16 node unit (packet2.py:680-703) on
//     `pack_tables2`'s bf16 records (:238-255), in the port's own layout
//     (tpu_rt_torch/trace/tables.py pack_bf16_nodes): 32 bytes per node,
//     two int4 loads instead of four float4 loads.  Each bound is widened
//     exactly (__int_as_float(w << 16), __int_as_float(w & 0xFFFF0000)) and
//     tested with the f32 slab test.  The bounds were rounded outward, so a
//     box only grows: no hit is lost, (t, and tri up to exact-t ties) stay
//     the f32 tree's, but entry distances, and with them the visit order
//     and the counters, are the bf16 tree's.  Its bit-exact reference is
//     the plain version on the same record (trace_flat_plain decodes it
//     with the same integer ops).
//   - kStreamNodes / kStreamTris: the "mixed" and "hbm" residencies
//     (packet2.py:501-515, :906-944; tables2_residency :361-373), load
//     cache hints plus, for mixed, an L2 window over the node table
//     (trace_common.cuh).  Same function, bit-equal results.
//   - kPostpone replaces the C > 1 leaf cursors (packet2.py:72-77, refill
//     :572-587, drain :783-897): a leaf reached is held, not drained, until
//     `cursors` leaves are held or the stack is empty (trace_common.cuh
//     `Postponed`).  t stays the oracle's bit for bit.
//
// Files: this header holds the kernel and its dispatch; flat_trace.cu
// instantiates the forms without kPostpone (the first versions' code),
// flat_trace_c.cu those with it, and flat_trace_mxu.cu the tensor-core
// triangle phase on the same node step (visit_inner), each a library of
// its own built by its own nvcc.
//
// What bounds it: a data-dependent walk, as in quad_trace.cu, but with
// half-line nodes: each node is 64 bytes (4 float4 loads), a binary tree is
// about twice as deep as the quad tree, and leaves hold a few triangles, so
// a ray makes about 2-3x as many dependent node loads.  Bunny's and
// conference's tables fit the 50 MB L2; dragon's do not (nodes 19.7 MB f32
// or 9.8 MB bf16, Woop rows 58.3 MB), which is what the bf16 records and
// the mixed residency address: fewer node bytes per visit, and node
// records kept in L2 while triangle rows stream past them.  Measured on
// an H100 (PERF.md): every form runs at 2-7% of the bound from the rows
// its rays read, so dependent-load latency and divergence bound it, not
// bytes; the bf16 records cost time (twice the triangle tests) and the
// streamed forms were never faster than plain loads.  First version:
// one ray per thread, a per-thread stack of STACK_SIZE entries in local
// memory (one per level: upload_flat refuses a deeper tree).
//
// Layouts (row-major, contiguous):
//   nodes [N,16] f32: cols 0..3 child 0 (lo.x, hi.x, lo.y, hi.y), cols 4..7
//     child 1 (lo.x, hi.x, lo.y, hi.y), cols 8..11 (c0 lo.z, c0 hi.z, c1 lo.z,
//     c1 hi.z), cols 12, 13 the child links as int32 bits (>= 0 an inner
//     row, < 0 a leaf whose first Woop row is ~link).  Links are only ever
//     read with __float_as_int.
//   woop [R,16] f32: cols 0..11 the Woop rows (z, u, v), col 12 the
//     original triangle id as int32 bits.
//   or, with bf16 nodes, nodes [N,8] i32: words 0..5 the 12 bounds as bf16
//     pairs (column 2j in the low half, 2j + 1 in the high half, columns as
//     above), words 6, 7 the child links.
//   leaf_counts [C] i32: the triangle count of the leaf starting at row
//     first is leaf_counts[min(first, C - 1)] (C = R + 1; the last entry is
//     the empty leaf).
//   origin, dirn [N,3] f32; tmin, tmax [N] f32 (tmax < 0: skip the ray).
// Outputs as quad_trace.cuh.

#pragma once

#include "trace_common.cuh"

#ifndef STACK_SIZE
#error "STACK_SIZE must be defined by the build (tpu_rt_torch/trace/flat_kernel.py)"
#endif

namespace {

using namespace tpu_rt_torch;

// bf16 halves of one node word, widened exactly to f32.
__device__ __forceinline__ float bf16_lo(int w) { return __int_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(int w) {
    return __int_as_float(w & static_cast<int>(0xFFFF0000u));
}

// One visit of the inner node `node` (>= 0), as the oracle: both children
// slab-tested against the hit distance so far; with both hit, `node` moves
// to the nearer entry and the other is pushed; with one hit, to that one.
// Returns false when neither is hit: the ray must pop.  Shared by
// flat_trace_kernel and the tensor-core form (flat_trace_mxu.cu).
template <bool kStats, bool kBf16Nodes, bool kStreamNodes>
__device__ __forceinline__ bool visit_inner(const float4* __restrict__ nodes, const Ray& r,
                                            Hit& h, int& node, int* stack, int& sp) {
    if constexpr (kStats) ++h.node_tests;
    float near0, near1;
    bool hit0, hit1;
    int c0, c1;
    if constexpr (kBf16Nodes) {
        const int4* rec = reinterpret_cast<const int4*>(nodes) + static_cast<size_t>(node) * 2;
        const int4 a = load<kStreamNodes>(rec), b = load<kStreamNodes>(rec + 1);
        hit0 = slab_near(r, h.t, bf16_lo(a.x), bf16_hi(a.x), bf16_lo(a.y), bf16_hi(a.y),
                         bf16_lo(b.x), bf16_hi(b.x), near0);
        hit1 = slab_near(r, h.t, bf16_lo(a.z), bf16_hi(a.z), bf16_lo(a.w), bf16_hi(a.w),
                         bf16_lo(b.y), bf16_hi(b.y), near1);
        c0 = b.z;
        c1 = b.w;
    } else {
        const float4* rec = nodes + static_cast<size_t>(node) * 4;
        const float4 q0 = load<kStreamNodes>(rec), q1 = load<kStreamNodes>(rec + 1);
        const float4 q2 = load<kStreamNodes>(rec + 2);
        const float4 q3 = load<kStreamNodes>(rec + 3);
        hit0 = slab_near(r, h.t, q0.x, q0.y, q0.z, q0.w, q2.x, q2.y, near0);
        hit1 = slab_near(r, h.t, q1.x, q1.y, q1.z, q1.w, q2.z, q2.w, near1);
        c0 = __float_as_int(q3.x);
        c1 = __float_as_int(q3.y);
    }
    if (hit0 && hit1) {
        // Nearer entry first; the other waits on the stack.
        if (near1 < near0) {
            const int c = c0;
            c0 = c1;
            c1 = c;
        }
        stack[sp++] = c1;
        node = c0;
        return true;
    }
    if (hit0 || hit1) {
        node = hit0 ? c0 : c1;
        return true;
    }
    return false;
}

template <bool kAnyHit, bool kWantUv, bool kStats, bool kBf16Nodes, bool kStreamNodes,
          bool kStreamTris, bool kPostpone>
__global__ void __launch_bounds__(kBlock)
flat_trace_kernel(const float4* __restrict__ nodes, int n_nodes,
                  const float4* __restrict__ woop,
                  const int* __restrict__ leaf_counts, int n_counts,
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
        const auto drain_link = [&](int link) {
            const int first = ~link;
            const int count = load<kStreamTris>(leaf_counts + min(first, n_counts - 1));
            return drain<kAnyHit, kWantUv, kStats, kStreamTris>(woop, first, count, r, h);
        };
        Postponed held;

        int stack[STACK_SIZE];
        int sp = 0;
        int node = 0;
        for (;;) {
            if (node >= 0) {
                if (visit_inner<kStats, kBf16Nodes, kStreamNodes>(nodes, r, h, node, stack, sp)) {
                    continue;
                }
            } else if constexpr (kPostpone) {
                if (held.add(node) == cursors && held.drain(drain_link)) break;
            } else {
                if (drain_link(node)) break;
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

// Checks the host arguments, picks the instantiation of `kernel_for`'s
// template from the form flags, the node format and the residency, and
// launches it through launch_window: the launch behind the C ABI of
// flat_trace.cu, flat_trace_c.cu and flat_trace_mxu.cu.  `kernel_for(a, u,
// c, bf, sn, st)` returns the kernel for those std::integral_constant
// flags; `cursors_ok` is the form's rule for `cursors`.
template <typename KernelFor>
int flat_dispatch(KernelFor kernel_for, bool cursors_ok, const void* nodes, int n_nodes,
                  int bf16_nodes, const void* woop, const void* leaf_counts, int n_counts,
                  const void* origin, const void* dirn, const void* tmin, const void* tmax,
                  void* out_tri, void* out_t, void* out_u, void* out_v, void* out_node_tests,
                  void* out_tri_tests, int n_rays, int cursors, int any_hit, int want_uv,
                  int stats, int stream_nodes, int stream_tris, size_t window_bytes,
                  size_t set_aside, void* stream) {
    if (!cursors_ok) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSuccess;
    if (n_rays > 0) {
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        const int grid = (n_rays + kBlock - 1) / kBlock;
        dispatch_form(any_hit != 0, want_uv != 0, stats != 0, [&](auto a, auto u, auto c) {
            const auto launch = [&](auto bf) {
                return dispatch_residency(stream_nodes != 0, stream_tris != 0,
                                          [&](auto sn, auto st) {
                    err = launch_window(
                        kernel_for(a, u, c, bf, sn, st), grid, s, nodes, window_bytes, set_aside,
                        static_cast<const float4*>(nodes), n_nodes,
                        static_cast<const float4*>(woop), static_cast<const int*>(leaf_counts),
                        n_counts, static_cast<const float*>(origin),
                        static_cast<const float*>(dirn), static_cast<const float*>(tmin),
                        static_cast<const float*>(tmax), static_cast<int*>(out_tri),
                        static_cast<float*>(out_t), static_cast<float*>(out_u),
                        static_cast<float*>(out_v), static_cast<int*>(out_node_tests),
                        static_cast<int*>(out_tri_tests), n_rays, cursors);
                });
            };
            const bool ok = bf16_nodes ? launch(std::true_type{}) : launch(std::false_type{});
            if (!ok) err = cudaErrorInvalidValue;
        });
    }
    return static_cast<int>(err);
}

}  // namespace

// The C ABI of the binary libraries (ctypes; tpu_rt_torch/trace/common.py
// CudaTraceKernel.launch), as quad_trace.cuh's with the node format
// (`bf16_nodes`) and the leaf-count table added.
#define FLAT_LAUNCH_ARGS                                                                    \
    const void *nodes, int n_nodes, int bf16_nodes, const void *woop,                      \
        const void *leaf_counts, int n_counts, const void *origin, const void *dirn,        \
        const void *tmin, const void *tmax, void *out_tri, void *out_t, void *out_u,        \
        void *out_v, void *out_node_tests, void *out_tri_tests, int n_rays, int cursors,    \
        int any_hit, int want_uv, int stats, int stream_nodes, int stream_tris,             \
        size_t window_bytes, size_t set_aside, void *stream
#define FLAT_LAUNCH_CALL                                                                    \
    nodes, n_nodes, bf16_nodes, woop, leaf_counts, n_counts, origin, dirn, tmin, tmax,      \
        out_tri, out_t, out_u, out_v, out_node_tests, out_tri_tests, n_rays, cursors,       \
        any_hit, want_uv, stats, stream_nodes, stream_tris, window_bytes, set_aside, stream

// flat_trace_kernel with kPostpone as the template argument.
template <bool kPostpone>
struct FlatKernelFor {
    template <typename A, typename U, typename C, typename B, typename SN, typename ST>
    auto operator()(A, U, C, B, SN, ST) const {
        return flat_trace_kernel<A::value, U::value, C::value, B::value, SN::value, ST::value,
                                 kPostpone>;
    }
};
