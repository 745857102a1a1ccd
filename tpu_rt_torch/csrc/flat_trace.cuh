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
// `per_ray_tri_tests`; stack is the most entries the ray's stack held in
// local memory at once (at most one a level).  With -fmad=false and no
// fast math, every float op is the oracle's in its order, so (tri, t, u, v)
// equal it bit for bit.
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
// instantiates the forms without kPostpone, flat_trace_c.cu those with it, flat_trace_mxu.cu the tensor-core
// triangle phase on FlatLane with held leaves, and flat_trace_k<K>.cu the
// slot forms (flat_slots_kernel: tpu_rt's K, U and tile, trace_common.cuh
// persistent_slots), each a library of its own built by its own nvcc.
//
// Design (trace_common.cuh, the schedule): persistent warps that fetch rays
// from a global pool and refill below kRefill active lanes, and a
// while-while loop: the node phase runs while any lane stands on an inner
// node; a lane that reaches a leaf (directly or off the stack) waits; then
// the warp drains, one (leaf, triangle) pair per lane and step, and a lane
// whose leaf is done pops on, draining the leaves it pops until it pops an
// inner node, as the oracle does.  The postponed forms hold a leaf they
// reach and pop on; they drain in the leaf phase.  The top of the stack is
// a register; the rest is in local memory.  The frame forms take 44-45
// registers, 10 blocks of 128 threads per SM.
//
// What bounds it: a data-dependent walk, as in quad_trace.cu, but with
// half-line nodes: each node is 64 bytes (4 float4 loads), a binary tree is
// about twice as deep as the quad tree, and leaves hold a few triangles, so
// a ray makes about 2-3x as many dependent node loads.  Bunny's and
// conference's tables fit the 50 MB L2; dragon's do not (nodes 19.7 MB f32
// or 9.8 MB bf16, Woop rows 58.3 MB), which is what the bf16 records and
// the mixed residency address: fewer node bytes per visit, and node
// records kept in L2 while triangle rows stream past them.  A kernel of
// one ray per thread ran at 2-7% of the bound from the rows its rays read
// (PERF.md), so dependent-load latency and divergence bound it, not bytes;
// the schedule takes the divergence between rays (a warp no longer waits
// for its slowest ray) and between the node and leaf code paths (a
// ray-per-thread if-if loop runs them in turns).  What is left is the chain
// of dependent node loads of each ray.
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

namespace {

using namespace tpu_rt_torch;

// bf16 halves of one node word, widened exactly to f32.
__device__ __forceinline__ float bf16_lo(int w) { return __int_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(int w) {
    return __int_as_float(w & static_cast<int>(0xFFFF0000u));
}

// A node's record as a slot form loads it: four float4 (f32 nodes) or two
// int4 (bf16 nodes).
struct F32Rec {
    float4 q0, q1, q2, q3;
};
struct Bf16Rec {
    int4 a, b;
};

// The record of inner node `node`, read through ldg (the streaming hint
// with kStreamNodes).
template <bool kBf16Nodes, bool kStreamNodes>
__device__ __forceinline__ auto load_record(const float4* __restrict__ nodes, int node) {
    const auto get = [](const auto* p) { return ldg<kStreamNodes>(p); };
    if constexpr (kBf16Nodes) {
        const int4* rec = reinterpret_cast<const int4*>(nodes) + static_cast<size_t>(node) * 2;
        const int4 a = get(rec), b = get(rec + 1);
        return Bf16Rec{a, b};
    } else {
        const float4* rec = nodes + static_cast<size_t>(node) * 4;
        const float4 q0 = get(rec), q1 = get(rec + 1);
        const float4 q2 = get(rec + 2);
        const float4 q3 = get(rec + 3);
        return F32Rec{q0, q1, q2, q3};
    }
}

// The two children of a node record: each slab-tested against the hit
// distance so far (hit0, near0, hit1, near1) and their links (c0, c1).
template <typename R>
__device__ __forceinline__ void record_children(const Bf16Rec& rec, const R& r, float hit_t,
                                                bool& hit0, float& near0, int& c0, bool& hit1,
                                                float& near1, int& c1) {
    const int4 a = rec.a, b = rec.b;
    hit0 = slab_near(r, hit_t, bf16_lo(a.x), bf16_hi(a.x), bf16_lo(a.y), bf16_hi(a.y),
                     bf16_lo(b.x), bf16_hi(b.x), near0);
    hit1 = slab_near(r, hit_t, bf16_lo(a.z), bf16_hi(a.z), bf16_lo(a.w), bf16_hi(a.w),
                     bf16_lo(b.y), bf16_hi(b.y), near1);
    c0 = b.z;
    c1 = b.w;
}
template <typename R>
__device__ __forceinline__ void record_children(const F32Rec& rec, const R& r, float hit_t,
                                                bool& hit0, float& near0, int& c0, bool& hit1,
                                                float& near1, int& c1) {
    hit0 = slab_near(r, hit_t, rec.q0.x, rec.q0.y, rec.q0.z, rec.q0.w, rec.q2.x, rec.q2.y, near0);
    hit1 = slab_near(r, hit_t, rec.q1.x, rec.q1.y, rec.q1.z, rec.q1.w, rec.q2.z, rec.q2.w, near1);
    c0 = __float_as_int(rec.q3.x);
    c1 = __float_as_int(rec.q3.y);
}

// The two children of inner node `node`: its record (load_record) and
// their slab tests (record_children).
template <bool kBf16Nodes, bool kStreamNodes, typename R>
__device__ __forceinline__ void test_children(const float4* __restrict__ nodes, int node,
                                              const R& r, float hit_t, bool& hit0,
                                              float& near0, int& c0, bool& hit1, float& near1,
                                              int& c1) {
    record_children(load_record<kBf16Nodes, kStreamNodes>(nodes, node), r, hit_t,
                    hit0, near0, c0, hit1, near1, c1);
}

// One lane of the persistent binary kernel: its ray, its hit, its link
// (an inner node to test, a leaf, or kEmpty), the leaf it drains next
// (`pending`, a leaf link, or 0), its stack (and in the counter forms the
// stack's high-water, StackHigh) and, in the postponed forms, its held
// leaves.
template <bool kAnyHit, bool kWantUv, bool kStats, bool kBf16Nodes, bool kStreamNodes,
          bool kStreamTris, bool kPostpone>
struct FlatLane : StackHigh<kStats> {
    int ray = -1;
    LeanRay r;
    Hit h;
    int node;
    int pending = 0;
    TraversalStack stack;
    Postponed held;
    int ready;   // held leaves to drain now (postponed forms)

    __device__ __forceinline__ bool active() const { return ray >= 0; }
    __device__ __forceinline__ bool walking() const { return ray >= 0 && pending == 0; }

    __device__ __forceinline__ void finish(const TraceArgs& a) {
        store_hit<kWantUv, kStats>(h, this->high(), ray, a.out_tri, a.out_t, a.out_u,
                                   a.out_v, a.out_node_tests, a.out_tri_tests, a.out_stack);
        ray = -1;
        pending = 0;
    }

    __device__ __forceinline__ void start(const TraceArgs& a, int i) {
        ray = i;
        this->clear_high();
        h = Hit{a.tmax[i], -1, 0.0f, 0.0f, 0, 0};
        pending = 0;
        if (h.t < 0.0f || a.n_nodes <= 0) {
            finish(a);
            return;
        }
        r = load_lean_ray(a.origin, a.dirn, a.tmin, i);
        node = 0;
        stack.clear();
        if constexpr (kPostpone) {
            held.n = 0;
            ready = 0;
        }
    }

    // The next leaf to drain, in the oracle's order: the leaf the lane
    // stands on, then the leaves it pops (or, postponed, the held leaves
    // once `cursors` are held, and all of them when the walk ends).  False
    // when no leaf is left; then `node` is the next inner node, or kEmpty.
    __device__ __forceinline__ bool next_leaf(const TraceArgs& a, int& link) {
        for (;;) {
            if constexpr (kPostpone) {
                if (ready > 0) {
                    link = held.link[0];
                    held.pop();
                    --ready;
                    return true;
                }
                if (node == kEmpty && held.n > 0) {
                    ready = held.n;
                    continue;
                }
            }
            if (node >= 0) return false;
            const int l = node;
            node = stack.pop();
            if constexpr (!kPostpone) {
                link = l;
                return true;
            } else {
                if (held.add(l) == a.cursors) ready = a.cursors;
            }
        }
    }

    // After a node visit or a leaf: the next leaf to drain (`pending`), or,
    // with none, the walk goes on, or the ray ends.
    __device__ __forceinline__ void settle(const TraceArgs& a) {
        if (!next_leaf(a, pending)) {
            pending = 0;
            if (node == kEmpty) finish(a);
        }
    }

    // One visit of the inner node `node`, as the oracle: both children
    // slab-tested against the hit distance so far, then `take`.
    __device__ __forceinline__ void node_step(const TraceArgs& a) {
        if constexpr (kStats) ++h.node_tests;
        float near0, near1;
        bool hit0, hit1;
        int c0, c1;
        test_children<kBf16Nodes, kStreamNodes>(a.nodes, node, r, h.t, hit0, near0, c0, hit1,
                                                near1, c1);
        take(a, hit0, near0, c0, hit1, near1, c1);
    }

    // The slot forms' node step in two parts: the record of the node the
    // lane stands on (of row 0 when it does not walk), then node_step's
    // visit of it.
    using Rec = std::conditional_t<kBf16Nodes, Bf16Rec, F32Rec>;
    __device__ __forceinline__ Rec fetch(const TraceArgs& a, bool walk) const {
        return load_record<kBf16Nodes, kStreamNodes>(a.nodes, walk ? node : 0);
    }
    __device__ __forceinline__ void step(const TraceArgs& a, const Rec& rec) {
        if constexpr (kStats) ++h.node_tests;
        float near0, near1;
        bool hit0, hit1;
        int c0, c1;
        record_children(rec, r, h.t, hit0, near0, c0, hit1, near1, c1);
        take(a, hit0, near0, c0, hit1, near1, c1);
    }

    // A node visit's move, from its children's slab tests: with both hit,
    // the nearer entry next and the other pushed; with one, that one; with
    // none, the lane pops.
    __device__ __forceinline__ void take(const TraceArgs& a, bool hit0, float near0, int c0,
                                         bool hit1, float near1, int c1) {
        if (hit0 && hit1) {
            if (near1 < near0) {
                const int c = c0;
                c0 = c1;
                c1 = c;
            }
            this->push(stack, c1);
            node = c0;
        } else if (hit0 || hit1) {
            node = hit0 ? c0 : c1;
        } else {
            node = stack.pop();
        }
        if (node < 0 || node == kEmpty) settle(a);
    }

    // The leaf phase of this lane: every queued (leaf, triangle) pair, one
    // Woop row at a time.
    __device__ __forceinline__ void drain(const TraceArgs& a) { drain_units(a, 1); }

    // The leaf phase of a slot: every queued (leaf, triangle) pair, `units`
    // Woop rows at a time (test_rows).
    __device__ __forceinline__ void drain_units(const TraceArgs& a, int units) {
        while (pending < 0) {
            const int first = ~pending;
            const int end =
                first + ldg<kStreamTris>(a.leaf_counts + min(first, a.n_counts - 1));
            if (test_rows<kAnyHit, kWantUv, kStats, kStreamTris>(a.woop, first, end, units, r,
                                                                  h)) {
                finish(a);
                return;
            }
            settle(a);
        }
    }
};

// A minimum of one block per SM: ptxas then gives the form the registers
// it asks for; with no minimum it aims lower (PERF.md).
template <bool kAnyHit, bool kWantUv, bool kStats, bool kBf16Nodes, bool kStreamNodes,
          bool kStreamTris, bool kPostpone>
__global__ void __launch_bounds__(kBlock, 1)
flat_trace_kernel(const __grid_constant__ TraceArgs a) {
    FlatLane<kAnyHit, kWantUv, kStats, kBf16Nodes, kStreamNodes, kStreamTris, kPostpone> lane;
    int stack[STACK_SIZE];   // the stack below its top, in local memory
    lane.stack.bind(stack);
    persistent_warps(lane, a);
}

// The slot forms (flat_trace_k*.cu; trace_common.cuh persistent_slots):
// kSlots lane states per thread, each with its own local-memory stack, U
// Woop rows at a time (`units`) and the block's pool of `tile` rays.
template <int kSlots, bool kAnyHit, bool kWantUv, bool kStats, bool kBf16Nodes,
          bool kStreamNodes, bool kStreamTris>
__global__ void __launch_bounds__(kBlock, 1)
flat_slots_kernel(const __grid_constant__ TraceArgs a, int units, unsigned tile) {
    FlatLane<kAnyHit, kWantUv, kStats, kBf16Nodes, kStreamNodes, kStreamTris, false> slot[kSlots];
    int stack[kSlots][STACK_SIZE];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) slot[s].stack.bind(stack[s]);
    persistent_slots(slot, a, units, tile);
}

// Checks the host arguments, picks the instantiation of `launch_form`'s
// template from the form flags, the node format and the residency, and
// calls it: the launch behind the C ABI of flat_trace.cu, flat_trace_c.cu,
// flat_trace_mxu.cu and flat_trace_k<K>.cu.  `launch_form(a, u, c, bf, sn,
// st, args, ctx)` launches the form for those std::integral_constant flags
// and returns its CUDA error; `cursors_ok` is the library's rule for
// `cursors`.  The other arguments are quad_dispatch's (quad_trace.cuh),
// with the node format (`bf16_nodes`) and the leaf-count table added.
template <typename LaunchForm>
int flat_dispatch(LaunchForm launch_form, bool cursors_ok, const void* nodes, int n_nodes,
                  int bf16_nodes, const void* woop, const void* leaf_counts, int n_counts,
                  const void* origin, const void* dirn, const void* tmin, const void* tmax,
                  void* out_tri, void* out_t, void* out_u, void* out_v, void* out_node_tests,
                  void* out_tri_tests, void* out_stack, int n_rays, int cursors, int any_hit,
                  int want_uv, int stats, int stream_nodes, int stream_tris, size_t window_bytes,
                  size_t set_aside, void* counter, void* shape, void* stream) {
    if (!cursors_ok) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaSuccess;
    if (n_rays > 0) {
        const LaunchCtx ctx{static_cast<cudaStream_t>(stream), nodes, window_bytes, set_aside,
                            static_cast<int*>(shape)};
        const TraceArgs args{static_cast<const float4*>(nodes), n_nodes,
                             static_cast<const float4*>(woop),
                             static_cast<const int*>(leaf_counts), n_counts,
                             static_cast<const float*>(origin), static_cast<const float*>(dirn),
                             static_cast<const float*>(tmin), static_cast<const float*>(tmax),
                             static_cast<int*>(out_tri), static_cast<float*>(out_t),
                             static_cast<float*>(out_u), static_cast<float*>(out_v),
                             static_cast<int*>(out_node_tests), static_cast<int*>(out_tri_tests),
                             n_rays, cursors, static_cast<unsigned*>(counter),
                             static_cast<int*>(out_stack)};
        dispatch_form(any_hit != 0, want_uv != 0, stats != 0, [&](auto a, auto u, auto c) {
            const auto launch = [&](auto bf) {
                return dispatch_residency(stream_nodes != 0, stream_tris != 0,
                                          [&](auto sn, auto st) {
                    err = launch_form(a, u, c, bf, sn, st, args, ctx);
                });
            };
            const bool ok = bf16_nodes ? launch(std::true_type{}) : launch(std::false_type{});
            if (!ok) err = cudaErrorInvalidValue;
        });
    }
    return static_cast<int>(err);
}

// The launch of one form of the persistent kernel (flat_trace.cu with
// kPostpone false, flat_trace_c.cu with it).
template <bool kPostpone>
struct FlatLaunch {
    template <typename A, typename U, typename C, typename B, typename SN, typename ST>
    cudaError_t operator()(A, U, C, B, SN, ST, const TraceArgs& args, const LaunchCtx& ctx) const {
        if (args.counter == nullptr) return cudaErrorInvalidValue;
        return launch_persistent(flat_trace_kernel<A::value, U::value, C::value, B::value,
                                                   SN::value, ST::value, kPostpone>,
                                 args.n_rays, 0, args.counter, ctx, args);
    }
};

// The launch of one slot form (flat_trace_k<kSlots>.cu), persistent and
// at cursors = 1 only, with U (`units`) and S (`tile`) from the C ABI.
template <int kSlots>
struct FlatSlotLaunch {
    int units;
    int tile;

    template <typename A, typename U, typename C, typename B, typename SN, typename ST>
    cudaError_t operator()(A, U, C, B, SN, ST, const TraceArgs& args, const LaunchCtx& ctx) const {
        if (args.counter == nullptr) return cudaErrorInvalidValue;
        LaunchCtx slots_ctx = ctx;
        slots_ctx.slots = kSlots;
        return launch_persistent(flat_slots_kernel<kSlots, A::value, U::value, C::value, B::value,
                                                   SN::value, ST::value>,
                                 args.n_rays, 0, args.counter, slots_ctx, args, units,
                                 static_cast<unsigned>(tile));
    }
};

}  // namespace

// The C ABI of the binary libraries (ctypes; tpu_rt_torch/trace/common.py
// CudaTraceKernel.launch), as quad_trace.cuh's with the node format
// (`bf16_nodes`) and the leaf-count table added.
#define FLAT_LAUNCH_ARGS                                                                    \
    const void *nodes, int n_nodes, int bf16_nodes, const void *woop,                      \
        const void *leaf_counts, int n_counts, const void *origin, const void *dirn,        \
        const void *tmin, const void *tmax, void *out_tri, void *out_t, void *out_u,        \
        void *out_v, void *out_node_tests, void *out_tri_tests, void *out_stack,            \
        int n_rays, int cursors, int any_hit, int want_uv, int stats, int stream_nodes,     \
        int stream_tris, size_t window_bytes, size_t set_aside, void *counter, void *shape, \
        void *stream
#define FLAT_LAUNCH_CALL                                                                    \
    nodes, n_nodes, bf16_nodes, woop, leaf_counts, n_counts, origin, dirn, tmin, tmax,      \
        out_tri, out_t, out_u, out_v, out_node_tests, out_tri_tests, out_stack, n_rays,     \
        cursors, any_hit, want_uv, stats, stream_nodes, stream_tris, window_bytes,          \
        set_aside, counter, shape, stream
