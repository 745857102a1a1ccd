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
// Design (trace_common.cuh, the schedule): persistent warps that fetch rays
// from a global pool and refill below kRefill active lanes; a
// while-while loop in which a node test queues the node's hit leaves (at
// most 4, in visit order) and the lane waits until every active lane of the
// warp has leaf work or has ended; then one loop over the queued (leaf,
// triangle) pairs, the same Woop code path in every lane.  The node test
// takes the inner children at once, the first in visit order next and the
// others pushed: they do not depend on the leaves, which are drained before
// the next node test, where the oracle drains them.  The queue is the
// tested node and a mask of its hit leaf slots; a leaf's link is read again
// from the record when its turn comes.  The postponed forms hold their
// leaves as before and drain them in the leaf phase.  The top of the stack
// is a register; the rest is in local memory (or shared memory, sized from
// the tree's need: the other side of chip_smoke.py's A/B).  The frame forms
// take 48 registers, 10 blocks of 128 threads per SM; held to 40 (what a
// __launch_bounds__ minimum of 12 blocks asks), ptxas spills (chip_smoke.py
// phase 1), so the minimum is 1.
//
// What bounds it: a data-dependent walk.  Each node is one 128-byte record
// (8 float4 loads, one cache line) and each triangle one 64-byte Woop row
// (up to 4 float4 loads).  Bunny's tables (0.8 MB + 9 MB) and conference's
// (2.1 MB + 23.6 MB) sit in the 50 MB L2; on dragon (quad nodes 2.6-5.2 MB,
// Woop rows 58 MB) the triangle rows could evict the node records every ray
// needs first, which the mixed residency addresses (nodes persisting,
// triangle rows streamed).  So the bound is the latency of the dependent
// node loads and the warp's divergence, not device-memory bandwidth: the
// first versions ran at 1-3% of the bound from the rows their rays read
// (PERF.md).  The schedule answers the divergence: a warp no longer waits
// for its slowest ray (any hit ends a ray at its first occluder, so an AO
// warp's lanes finish far apart), and the four per-slot drains of the
// first version, which lanes with leaves in different slots ran one after
// another, are one loop.  What is left is the node test's chain of
// dependent loads and the leaf loop's length, which the warp's longest
// queue sets.
//
// The first versions (quad_first_kernel: one ray per thread, a stack of
// STACK_SIZE entries in local memory, each hit leaf drained in its own
// statement) stay compiled for the vmem frame forms, for chip_smoke.py's
// A/B only.
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

namespace {

using namespace tpu_rt_torch;

constexpr int kSent = 0x7FFFFFFF;
constexpr int kCountShift = 24;
constexpr int kFirstMask = (1 << kCountShift) - 1;

// Drain the leaf behind `link` = ~(first | count << 24) (the first versions).
template <bool kAnyHit, bool kWantUv, bool kStats, bool kStreamTris>
__device__ __forceinline__ bool drain_leaf(const float4* __restrict__ woop, int link,
                                           const Ray& r, Hit& h) {
    const int c = ~link;
    return drain<kAnyHit, kWantUv, kStats, kStreamTris>(woop, c & kFirstMask,
                                                        (c >> kCountShift) & 0xFF, r, h);
}

// The first version of the vmem f32 frame forms, kept for the A/B: one ray
// per thread, a per-thread stack in local memory, each hit leaf drained in
// its own statement, in visit order, before the inner children are taken.
template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
quad_first_kernel(const float4* __restrict__ nodes, int n_nodes,
                  const float4* __restrict__ woop,
                  const float* __restrict__ origin, const float* __restrict__ dirn,
                  const float* __restrict__ tmin, const float* __restrict__ tmax,
                  int* __restrict__ out_tri, float* __restrict__ out_t, int n_rays) {
    const int ray = blockIdx.x * blockDim.x + threadIdx.x;
    if (ray >= n_rays) return;

    Hit h{tmax[ray], -1, 0.0f, 0.0f, 0, 0};
    if (!(h.t < 0.0f) && n_nodes > 0) {
        const Ray r = load_ray(origin, dirn, tmin, ray);
        int stack[STACK_SIZE];
        int sp = 0;
        int node = 0;
        for (;;) {
            const float4* rec = nodes + static_cast<size_t>(node) * 8;
            const float4 q0 = rec[0], q1 = rec[1], q2 = rec[2], q3 = rec[3];
            const float4 q4 = rec[4], q5 = rec[5], q6 = rec[6], q7 = rec[7];
            const int l0 = __float_as_int(q6.x), l1 = __float_as_int(q6.y);
            const int l2 = __float_as_int(q6.z), l3 = __float_as_int(q6.w);
            const int hint = __float_as_int(q7.x);
            const bool h0 = l0 != kSent && slab(r, h.t, q0.x, q0.y, q0.z, q0.w, q1.x, q1.y);
            const bool h1 = l1 != kSent && slab(r, h.t, q1.z, q1.w, q2.x, q2.y, q2.z, q2.w);
            const bool h2 = l2 != kSent && slab(r, h.t, q3.x, q3.y, q3.z, q3.w, q4.x, q4.y);
            const bool h3 = l3 != kSent && slab(r, h.t, q4.z, q4.w, q5.x, q5.y, q5.z, q5.w);
            const float dh = hint == 0 ? r.dx : (hint == 1 ? r.dy : r.dz);
            const bool fwd = dh >= 0.0f;
            const bool v0 = fwd ? h0 : h3, v1 = fwd ? h1 : h2;
            const bool v2 = fwd ? h2 : h1, v3 = fwd ? h3 : h0;
            const int k0 = fwd ? l0 : l3, k1 = fwd ? l1 : l2;
            const int k2 = fwd ? l2 : l1, k3 = fwd ? l3 : l0;
            if constexpr (kAnyHit) {
                if ((v0 && k0 < 0 && drain_leaf<true, false, false, false>(woop, k0, r, h)) ||
                    (v1 && k1 < 0 && drain_leaf<true, false, false, false>(woop, k1, r, h)) ||
                    (v2 && k2 < 0 && drain_leaf<true, false, false, false>(woop, k2, r, h)) ||
                    (v3 && k3 < 0 && drain_leaf<true, false, false, false>(woop, k3, r, h))) {
                    break;
                }
            } else {
                if (v0 && k0 < 0) drain_leaf<false, false, false, false>(woop, k0, r, h);
                if (v1 && k1 < 0) drain_leaf<false, false, false, false>(woop, k1, r, h);
                if (v2 && k2 < 0) drain_leaf<false, false, false, false>(woop, k2, r, h);
                if (v3 && k3 < 0) drain_leaf<false, false, false, false>(woop, k3, r, h);
            }
            int next = -1;
            if (v3 && k3 >= 0) next = k3;
            if (v2 && k2 >= 0) { if (next >= 0) stack[sp++] = next; next = k2; }
            if (v1 && k1 >= 0) { if (next >= 0) stack[sp++] = next; next = k1; }
            if (v0 && k0 >= 0) { if (next >= 0) stack[sp++] = next; next = k0; }
            if (next >= 0) {
                node = next;
                continue;
            }
            if (sp == 0) break;
            node = stack[--sp];
        }
    }
    out_tri[ray] = h.tri;
    out_t[ray] = h.t;
}

// Bits of a lane's leaf queue (QuadLane::qmask): bits 0-3 the hit leaf
// children of leaf_node not yet drained, by visit position; kReverse when
// the visit order is the stored order reversed.
constexpr unsigned kLeafBits = 0xFu;
constexpr unsigned kReverse = 1u << 8;

// One lane of the persistent 4-wide kernel: its ray, its hit, the node it
// tests next, its leaf queue (the hit leaves of leaf_node), the leaf it
// drains next (`pending`, a leaf link, or 0), its stack and, in the
// postponed forms, its held leaves.  A node test takes the node's inner
// children at once (the next, the pushes): they do not depend on its
// leaves, which the lane drains before its next node test, as the oracle
// does.
template <bool kAnyHit, bool kWantUv, bool kStats, bool kStreamNodes, bool kStreamTris,
          bool kPostpone, bool kShared>
struct QuadLane {
    int ray = -1;
    LeanRay r;
    Hit h;
    int node;
    int leaf_node;
    unsigned qmask;
    int pending = 0;
    TraversalStack<kShared> stack;
    Postponed held;
    int ready;   // held leaves to drain now (postponed forms)

    __device__ __forceinline__ bool active() const { return ray >= 0; }
    __device__ __forceinline__ bool walking() const { return ray >= 0 && pending == 0; }

    __device__ __forceinline__ void finish(const TraceArgs& a) {
        store_hit<kWantUv, kStats>(h, ray, a.out_tri, a.out_t, a.out_u, a.out_v,
                                   a.out_node_tests, a.out_tri_tests);
        ray = -1;
        pending = 0;
    }

    __device__ __forceinline__ void start(const TraceArgs& a, int i) {
        ray = i;
        h = Hit{a.tmax[i], -1, 0.0f, 0.0f, 0, 0};
        pending = 0;
        if (h.t < 0.0f || a.n_nodes <= 0) {
            finish(a);
            return;
        }
        r = load_lean_ray(a.origin, a.dirn, a.tmin, i);
        node = 0;
        qmask = 0;
        stack.clear();
        if constexpr (kPostpone) {
            held.n = 0;
            ready = 0;
        }
    }

    // The inner children (`inner` by visit position, links k0..k3 in visit
    // order): the first next, the others pushed last-first so that the
    // second pops next; with none, the stack's top (kEmpty: the walk ends).
    __device__ __forceinline__ int advance(unsigned inner, int k0, int k1, int k2, int k3) {
        int next = kEmpty;
        if (inner & 8u) next = k3;
        if (inner & 4u) { if (next != kEmpty) stack.push(next); next = k2; }
        if (inner & 2u) { if (next != kEmpty) stack.push(next); next = k1; }
        if (inner & 1u) { if (next != kEmpty) stack.push(next); next = k0; }
        return next != kEmpty ? next : stack.pop();
    }

    // The next leaf to drain, in the oracle's order: leaf_node's hit leaves
    // in visit order (or, postponed, the held leaves once `cursors` are
    // held, and all of them when the walk ends).  False when no leaf is
    // left; then `node` is the next node to test, or kEmpty.
    __device__ __forceinline__ bool next_leaf(const TraceArgs& a, int& link) {
        for (;;) {
            if constexpr (kPostpone) {
                if (ready > 0) {
                    link = held.link[0];
                    held.pop();
                    --ready;
                    return true;
                }
            }
            if (qmask & kLeafBits) {
                const int p = __ffs(qmask & kLeafBits) - 1;
                qmask &= ~(1u << p);
                const int slot = (qmask & kReverse) ? 3 - p : p;
                const int l = ldg<kStreamNodes>(reinterpret_cast<const int*>(a.nodes) +
                                                static_cast<size_t>(leaf_node) * 32 + 24 + slot);
                if constexpr (!kPostpone) {
                    link = l;
                    return true;
                } else {
                    if (held.add(l) == a.cursors) ready = a.cursors;
                    continue;
                }
            }
            if constexpr (kPostpone) {
                if (node == kEmpty && held.n > 0) {
                    ready = held.n;
                    continue;
                }
            }
            return false;
        }
    }

    // After a node test or a leaf: the next leaf to drain (`pending`), or,
    // with none, the walk goes on, or the ray ends.
    __device__ __forceinline__ void settle(const TraceArgs& a) {
        if (!next_leaf(a, pending)) {
            pending = 0;
            if (node == kEmpty) finish(a);
        }
    }

    // One node test: the four slab tests against the hit distance from
    // before the node's leaves, the visit order, the inner children, the
    // leaf queue.
    __device__ __forceinline__ void node_step(const TraceArgs& a) {
        if constexpr (kStats) ++h.node_tests;
        const float4* rec = a.nodes + static_cast<size_t>(node) * 8;
        const float4 q6 = ldg<kStreamNodes>(rec + 6);
        const int l0 = __float_as_int(q6.x), l1 = __float_as_int(q6.y);
        const int l2 = __float_as_int(q6.z), l3 = __float_as_int(q6.w);
        const int hint = __float_as_int(ldg<kStreamNodes>(&rec[7].x));
        const float4 q0 = ldg<kStreamNodes>(rec), q1 = ldg<kStreamNodes>(rec + 1);
        const bool h0 = l0 != kSent && slab(r, h.t, q0.x, q0.y, q0.z, q0.w, q1.x, q1.y);
        const float4 q2 = ldg<kStreamNodes>(rec + 2);
        const bool h1 = l1 != kSent && slab(r, h.t, q1.z, q1.w, q2.x, q2.y, q2.z, q2.w);
        const float4 q3 = ldg<kStreamNodes>(rec + 3), q4 = ldg<kStreamNodes>(rec + 4);
        const bool h2 = l2 != kSent && slab(r, h.t, q3.x, q3.y, q3.z, q3.w, q4.x, q4.y);
        const float4 q5 = ldg<kStreamNodes>(rec + 5);
        const bool h3 = l3 != kSent && slab(r, h.t, q4.z, q4.w, q5.x, q5.y, q5.z, q5.w);

        // Visit order: stored if d[hint] >= 0 for this ray, else reversed.
        const float dh = hint == 0 ? r.dx : (hint == 1 ? r.dy : r.dz);
        const bool fwd = dh >= 0.0f;
        const bool v0 = fwd ? h0 : h3, v1 = fwd ? h1 : h2;
        const bool v2 = fwd ? h2 : h1, v3 = fwd ? h3 : h0;
        const int k0 = fwd ? l0 : l3, k1 = fwd ? l1 : l2;
        const int k2 = fwd ? l2 : l1, k3 = fwd ? l3 : l0;
        const unsigned leaves = (v0 && k0 < 0 ? 1u : 0u) | (v1 && k1 < 0 ? 2u : 0u) |
                                (v2 && k2 < 0 ? 4u : 0u) | (v3 && k3 < 0 ? 8u : 0u);
        const unsigned inner = (v0 && k0 >= 0 ? 1u : 0u) | (v1 && k1 >= 0 ? 2u : 0u) |
                               (v2 && k2 >= 0 ? 4u : 0u) | (v3 && k3 >= 0 ? 8u : 0u);
        leaf_node = node;
        qmask = leaves | (fwd ? 0u : kReverse);
        node = advance(inner, k0, k1, k2, k3);
        settle(a);
    }

    // The leaf phase of this lane: every queued (leaf, triangle) pair.
    __device__ __forceinline__ void drain(const TraceArgs& a) {
        while (pending < 0) {
            const int c = ~pending;
            const int first = c & kFirstMask;
            const int end = first + ((c >> kCountShift) & 0xFF);
            for (int i = first; i < end; ++i) {
                if constexpr (kStats) ++h.tri_tests;
                if (woop_test<kWantUv, kStreamTris>(a.woop, i, r, h) && kAnyHit) {
                    finish(a);
                    return;
                }
            }
            settle(a);
        }
    }
};

// A minimum of one block per SM: ptxas then gives the form the registers
// it asks for; with no minimum it aims lower (PERF.md).
template <bool kAnyHit, bool kWantUv, bool kStats, bool kStreamNodes, bool kStreamTris,
          bool kPostpone, bool kShared>
__global__ void __launch_bounds__(kBlock, 1)
quad_trace_kernel(const __grid_constant__ TraceArgs a) {
    QuadLane<kAnyHit, kWantUv, kStats, kStreamNodes, kStreamTris, kPostpone, kShared> lane;
    int stack[STACK_SIZE];   // the local-memory stack (kShared false)
    lane.stack.bind(stack);
    persistent_warps(lane, a);
}

// The launch behind the C ABI of quad_trace.cu (kPostpone false, cursors
// 1) and quad_trace_c.cu (kPostpone true, 2 <= cursors <= kMaxCursors).
// `any_hit`, `want_uv` and `stats` pick the form and `stream_nodes`,
// `stream_tris` the residency (trace_common.cuh); u, v and the counters may
// be null in the forms that do not write them.  `window_bytes` > 0 attaches
// the mixed residency's L2 window over the node table, with the persisting
// set-aside `set_aside` (launch_window).  `design` picks the persistent
// kernel (kPersistent) or, for the vmem frame forms at cursors = 1 only,
// the first version (kFirst) or the shared-memory stack (kSharedStack);
// `stack_need` is the tree's stack need (3 x depth),
// `counter` the 4-byte ray pool, `shape` (may be null) receives the launch
// shape (trace_common.cuh LaunchCtx).  Launches on `stream` and returns the
// first CUDA error.
template <bool kPostpone>
int quad_launch(const void* nodes, int n_nodes, const void* woop,
                const void* origin, const void* dirn, const void* tmin, const void* tmax,
                void* out_tri, void* out_t, void* out_u, void* out_v,
                void* out_node_tests, void* out_tri_tests, int n_rays, int cursors,
                int any_hit, int want_uv, int stats, int stream_nodes,
                int stream_tris, size_t window_bytes, size_t set_aside, int design,
                int stack_need, void* counter, void* shape, void* stream) {
    const bool frame_vmem = !kPostpone && !want_uv && !stats && !stream_nodes && !stream_tris;
    if ((kPostpone ? (cursors < 2 || cursors > kMaxCursors) : cursors != 1) ||
        design < kPersistent || design > kSharedStack ||
        (design != kPersistent && !frame_vmem) || stack_need < 0 || stack_need > STACK_SIZE ||
        counter == nullptr) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = cudaSuccess;
    if (n_rays > 0) {
        const LaunchCtx ctx{static_cast<cudaStream_t>(stream), nodes, window_bytes, set_aside,
                            design, stack_need, static_cast<int*>(shape)};
        if constexpr (!kPostpone) {
            if (design == kFirst) {
                const auto go = [&](auto kernel) {
                    return launch_per_ray(
                        kernel, n_rays, 0, ctx, static_cast<const float4*>(nodes), n_nodes,
                        static_cast<const float4*>(woop), static_cast<const float*>(origin),
                        static_cast<const float*>(dirn), static_cast<const float*>(tmin),
                        static_cast<const float*>(tmax), static_cast<int*>(out_tri),
                        static_cast<float*>(out_t), n_rays);
                };
                err = any_hit ? go(quad_first_kernel<true>) : go(quad_first_kernel<false>);
                return static_cast<int>(err);
            }
        }
        const TraceArgs args{static_cast<const float4*>(nodes), n_nodes,
                             static_cast<const float4*>(woop), nullptr, 0,
                             static_cast<const float*>(origin), static_cast<const float*>(dirn),
                             static_cast<const float*>(tmin), static_cast<const float*>(tmax),
                             static_cast<int*>(out_tri), static_cast<float*>(out_t),
                             static_cast<float*>(out_u), static_cast<float*>(out_v),
                             static_cast<int*>(out_node_tests), static_cast<int*>(out_tri_tests),
                             n_rays, cursors, static_cast<unsigned*>(counter)};
        const size_t smem = design == kSharedStack ? stack_smem(stack_need) : 0;
        dispatch_form(any_hit != 0, want_uv != 0, stats != 0, [&](auto a, auto u, auto c) {
            const bool ok = dispatch_residency(stream_nodes != 0, stream_tris != 0,
                                               [&](auto sn, auto st) {
                constexpr bool kA = decltype(a)::value, kU = decltype(u)::value;
                constexpr bool kC = decltype(c)::value, kSn = decltype(sn)::value;
                constexpr bool kSt = decltype(st)::value;
                if (design == kPersistent) {
                    err = launch_persistent(
                        quad_trace_kernel<kA, kU, kC, kSn, kSt, kPostpone, false>, n_rays, smem,
                        counter, ctx, args);
                } else if constexpr (!kU && !kC && !kSn && !kSt && !kPostpone) {
                    err = launch_persistent(
                        quad_trace_kernel<kA, kU, kC, kSn, kSt, kPostpone, true>, n_rays, smem,
                        counter, ctx, args);
                } else {
                    err = cudaErrorInvalidValue;
                }
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
        size_t window_bytes, size_t set_aside, int design, int stack_need, void *counter,   \
        void *shape, void *stream
#define QUAD_LAUNCH_CALL                                                                    \
    nodes, n_nodes, woop, origin, dirn, tmin, tmax, out_tri, out_t, out_u, out_v,           \
        out_node_tests, out_tri_tests, n_rays, cursors, any_hit, want_uv, stats,            \
        stream_nodes, stream_tris, window_bytes, set_aside, design, stack_need, counter,    \
        shape, stream
