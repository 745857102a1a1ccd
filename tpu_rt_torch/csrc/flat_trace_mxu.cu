// The binary traversal kernel with a tensor-core leaf phase, for NVIDIA
// Hopper: closest hit and any hit, each with or without u, v and the
// per-ray counters, on f32 or bf16 node records in any residency.
//
// Replaces: tpu_rt/trace/packet2.py `_kernel2` in its MXU triangle-unit
// form (mxu=True, :792-862, ray matrix :978-993; trace_packet2 :1052-1114
// with U = MAX_LEAF = 8, :1110-1111), composed with its C leaf cursors
// (:72-77) as tpu_rt composes them.  trace_packet4 never takes it (:1187).
//
// What it computes: the walk of flat_trace.cuh (the oracle's order), but a
// leaf is tested whole, as one candidate group of up to 8 triangles
// (mxu_leaf.cuh): the six Woop dot products by FP64 mma, rounded once to
// f32, t = Oz / Dz, the leaf's winner the smallest t with ties to the
// largest triangle id, merged with a strict t < hit_t.  So t is
// "f32-class": within an ulp or so of the oracle's, which multiplies by
// 1 / Dz; tri equals the oracle's but on rays that graze an edge or tie.
// The plain version, tpu_rt_torch/trace/flat_kernel.py with mxu=True, takes
// the same dot products in float64 and rounds them once, so the kernel
// equals it bit for bit.
//
// Design: the persistent warps of trace_common.cuh (dynamic ray fetch with
// a refill below kRefill lanes, the while-while loop) with FlatLane's node
// step (ldg, the lean ray, the stack's top in a register) and its held
// leaves (`Postponed`, cursors = 1..kMaxCursors: a lane drains what it
// holds once it holds `cursors` leaves or its stack is empty).  The leaf
// phase is the warp's (MxuLane::drain below): an mma needs all 32 lanes,
// and tests 8 rays against one leaf.  In each round the warp forms up to 4
// groups, one per 8-lane tile of the mma, each the leaf of the first lane
// still without a group and up to 8 lanes, in lane order, that drain it
// (lanes anywhere in the warp: with the refill, the rays that share a leaf
// are rarely in one 8-lane tile).  Per group, all loads of its leaf go out
// together; the tile runs 2 DMMA (Oz, Dz), and 4 more only when one of its
// rays has a candidate with t in range, then the epilogue in the D
// fragments (mxu_leaf.cuh tile_best).  So a round settles up to 4
// distinct leaves, and the only shared memory is the warp's ray table
// (1,408 bytes), which a lane writes when it starts a ray and reloads its
// ray from after the leaf phase: the ray's registers are free during the
// leaf phase, whose registers set the resident blocks.  Each lane drains
// its leaves in the order it found them, so no result depends on which
// rays share a warp or a tile; any hit ends a ray at its first accepted
// leaf winner.  Leaves must hold at most 8 triangles: upload_flat records
// the widest and trace_flat(mxu=True) refuses wider ones, as pack_tables2
// does (:170).
//
// The first version stays compiled for the vmem f32 frame forms at
// cursors = 1, for chip_smoke.py's A/B only (design "first",
// flat_mxu_first_kernel: one ray per thread, one leaf per warp round, the
// products through a 7,104-byte table per warp).
//
// What bounds it: the walk is flat_trace.cuh's (dependent node loads,
// divergence), at the occupancy the leaf phase's registers leave; the leaf
// phase does 8 x 8 candidate-ray pairs per tile where a group needs its
// rays x count of them, and its f64-to-f32 conversions and epilogue are
// the same for every pair.  PERF.md gives its
// times against the scalar drain and its ablation (mxu_ablate.cu).

#include "flat_trace.cuh"
#include "mxu_leaf.cuh"

namespace {

// One lane of the persistent MXU kernel: FlatLane with held leaves (the
// walk, the stack, the queue of leaves to drain), plus its entry in the
// warp's ray table (mxu_rays) and the warp-collective leaf phase.  A
// round forms up to 4 groups, one per 8-lane tile of the mma: the leaf of
// the first lane still without a group, and up to 8 lanes of the warp, in
// lane order, that drain it; row r of the tile is the group's r-th lane.
template <bool kAnyHit, bool kWantUv, bool kStats, bool kBf16Nodes, bool kStreamNodes,
          bool kStreamTris>
struct MxuLane
    : FlatLane<kAnyHit, kWantUv, kStats, kBf16Nodes, kStreamNodes, kStreamTris, true, false> {
    using Base = FlatLane<kAnyHit, kWantUv, kStats, kBf16Nodes, kStreamNodes, kStreamTris, true,
                          false>;

    // FlatLane's start, then the ray (and its tmax) into the warp's table.
    __device__ __forceinline__ void start(const TraceArgs& a, int i) {
        Base::start(a, i);
        if (this->active()) {
            const LeanRay& r = this->r;
            put_ray(mxu_rays(threadIdx.x >> 5), threadIdx.x & 31, r.ox, r.oy, r.oz, r.dx, r.dy,
                    r.dz, r.t_min, this->h.t);
        }
    }

    // The leaf phase, on every lane of the warp: rounds while any lane has a
    // leaf to drain (`pending`).  A round forms its groups (the table's
    // row_lane gets each tile's row lanes), then loads each tile's leaf and
    // forms its products (mxu_leaf.cuh tile_best).  The group's lanes merge
    // the leaf's winner and move on to their next leaf (FlatLane::settle)
    // or, any hit, end at an accepted one.
    __device__ __forceinline__ void drain(const TraceArgs& a) {
        const int lane = threadIdx.x & 31;
        MxuRays& rays = mxu_rays(threadIdx.x >> 5);
        __syncwarp();   // the table entries the lanes wrote since the last phase
        for (;;) {
            unsigned want = __ballot_sync(kFullMask, this->pending < 0);
            if (want == 0) break;
            LeafHit got = no_hit();
            int got_count = 0;
            bool mine = false;
            // Up to 4 groups, one at a time: form it, write its rows' lanes
            // (row_lane[t]), load its leaf, form the products.
#pragma unroll 1
            for (int t = 0; t < 4 && want != 0; ++t) {   // the same on every lane
                const int link = __shfl_sync(kFullMask, this->pending, __ffs(want) - 1);
                unsigned g = __ballot_sync(kFullMask, this->pending == link) & want;
                if (__popc(g) > kMxuLeaf) g &= (2u << nth_lane(g, kMxuLeaf - 1)) - 1u;
                want &= ~g;
                int my_row = 0;
                if ((g >> lane) & 1u) {
                    my_row = __popc(g & ((1u << lane) - 1u));
                    rays.row_lane[t][my_row] = lane;
                }
                __syncwarp();   // row_lane[t]
                const int first = ~link;
                const int count =
                    min(ldg<kStreamTris>(a.leaf_counts + min(first, a.n_counts - 1)), kMxuLeaf);
                const TileLeaf leaf =
                    tile_leaf<kStreamTris>(a.woop, first, a.n_counts - 2, count, lane);
                const int rows = __popc(g), r = lane >> 2;
                const int src = rays.row_lane[t][min(r, rows - 1)];
                const LeafHit b = tile_best<kWantUv>(tile_b(leaf, lane), tile_ray(rays, src, lane),
                                                     r < rows && ((g >> src) & 1u), leaf.id,
                                                     leaf.count, lane);
                const LeafHit w = row_winner<kWantUv>(b, my_row);
                if ((g >> lane) & 1u) {
                    got = w;
                    got_count = leaf.count;
                    mine = true;
                }
            }
            __syncwarp();   // row_lane is rewritten next round
            if (mine) {
                Hit& h = this->h;
                if (got.t < h.t) {
                    h.t = got.t;
                    h.tri = got.tri;
                    if constexpr (kWantUv) {
                        h.u = got.u;
                        h.v = got.v;
                    }
                }
                if constexpr (kStats) h.tri_tests += got_count;
                if (kAnyHit && h.tri >= 0) {
                    this->finish(a);
                } else {
                    this->settle(a);
                }
            }
        }
        __syncwarp();   // every read of the table is done before a lane rewrites it
        // The lane's ray again, from the table: the same bits as start's
        // (safe_inv is load_lean_ray's op), and nothing in the leaf phase
        // reads it, so its registers are free for the leaf phase's.
        const float4 o = rays.o[lane], d = rays.d[lane];
        this->r = LeanRay{o.x, o.y, o.z, d.x, d.y, d.z, safe_inv(d.x), safe_inv(d.y),
                          safe_inv(d.z), rays.range[lane].x};
    }
};

// A minimum of one block per SM, as flat_trace_kernel.
template <bool kAnyHit, bool kWantUv, bool kStats, bool kBf16Nodes, bool kStreamNodes,
          bool kStreamTris>
__global__ void __launch_bounds__(kBlock, 1)
flat_trace_mxu_kernel(const __grid_constant__ TraceArgs a) {
    MxuLane<kAnyHit, kWantUv, kStats, kBf16Nodes, kStreamNodes, kStreamTris> lane;
    int stack[STACK_SIZE];   // the local-memory stack
    lane.stack.bind(stack);
    persistent_warps(lane, a);
}

// The first version of the vmem f32 frame forms, kept for the A/B: one ray
// per thread, the first versions' node step (visit_inner), and a leaf phase
// that tests one leaf per warp round: the first lane's oldest leaf is
// broadcast, the lanes whose oldest leaf it is form the group, every lane
// loads its A element, the warp runs 6 products x (the n8 tiles that hold a
// lane of the group) mma into the product table, and the group's lanes
// read their columns and pick the leaf's winner.
template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
flat_mxu_first_kernel(const float4* __restrict__ nodes, int n_nodes,
                      const float4* __restrict__ woop,
                      const int* __restrict__ leaf_counts, int n_counts,
                      const float* __restrict__ origin, const float* __restrict__ dirn,
                      const float* __restrict__ tmin, const float* __restrict__ tmax,
                      int* __restrict__ out_tri, float* __restrict__ out_t, int n_rays) {
    constexpr int cursors = 1;
    const int lane = threadIdx.x & 31;
    MxuWarp& s = mxu_warp(threadIdx.x >> 5);
    const int ray = blockIdx.x * blockDim.x + threadIdx.x;
    const bool in_range = ray < n_rays;

    Hit h{in_range ? tmax[ray] : -1.0f, -1, 0.0f, 0.0f, 0, 0};
    const float t_max = h.t;
    Ray r{};
    if (in_range) r = load_ray(origin, dirn, tmin, ray);
    put_ray(s, lane, r, in_range);
    __syncwarp();

    bool walking = in_range && !(h.t < 0.0f) && n_nodes > 0;
    Postponed held;
    int stack[STACK_SIZE];
    int sp = 0;
    int node = 0;
    for (;;) {
        // Walk until `cursors` leaves are held or the stack is empty.
        while (walking && held.n < cursors) {
            if (node >= 0) {
                if (visit_inner<false, false, false>(nodes, r, h, node, stack, sp)) continue;
            } else {
                held.add(node);
            }
            if (sp == 0) {
                walking = false;
            } else {
                node = stack[--sp];
            }
        }
        // Leaf phase: one leaf group at a time, the whole warp.
        for (;;) {
            const unsigned pending = __ballot_sync(kFullMask, held.n > 0);
            if (pending == 0) break;
            const int link = __shfl_sync(kFullMask, held.link[0], __ffs(pending) - 1);
            const unsigned group = __ballot_sync(kFullMask, held.n > 0 && held.link[0] == link);
            const int first = ~link;
            const int count = min(leaf_counts[min(first, n_counts - 1)], kMxuLeaf);
            leaf_products(leaf_a<false>(woop, first, count, lane), group, s, lane);
            if (group & (1u << lane)) {
                held.pop();
                const LeafHit b = leaf_best<false>(s, lane, woop, first, count, r.t_min, t_max);
                if (b.t < h.t && (!kAnyHit || h.tri < 0)) {
                    h.t = b.t;
                    h.tri = b.tri;
                }
                if constexpr (kAnyHit) {
                    if (h.tri >= 0) {
                        held.n = 0;
                        walking = false;
                    }
                }
            }
            __syncwarp();   // s.out is rewritten by the next group
        }
        if (!__any_sync(kFullMask, walking)) break;
    }
    if (in_range) {
        out_tri[ray] = h.tri;
        out_t[ray] = h.t;
    }
}

// The launch of one form: the persistent kernel with the warps' ray tables
// in dynamic shared memory; for the vmem f32 frame forms at cursors = 1,
// also the first version (one ray per thread, the product tables).
struct MxuLaunch {
    template <typename A, typename U, typename C, typename B, typename SN, typename ST>
    cudaError_t operator()(A, U, C, B, SN, ST, const TraceArgs& args, const LaunchCtx& ctx) const {
        constexpr bool kFrameVmem = !U::value && !C::value && !B::value && !SN::value &&
                                    !ST::value;
        if (args.counter == nullptr) return cudaErrorInvalidValue;
        if (ctx.design == kPersistent) {
            return launch_persistent(
                flat_trace_mxu_kernel<A::value, U::value, C::value, B::value, SN::value,
                                      ST::value>,
                args.n_rays, kWarps * sizeof(MxuRays), args.counter, ctx, args);
        }
        if constexpr (kFrameVmem) {
            if (ctx.design == kFirst && args.cursors == 1) {
                return launch_per_ray(flat_mxu_first_kernel<A::value>, args.n_rays,
                                      kWarps * sizeof(MxuWarp), ctx, args.nodes, args.n_nodes,
                                      args.woop, args.leaf_counts, args.n_counts, args.origin,
                                      args.dirn, args.tmin, args.tmax, args.out_tri, args.out_t,
                                      args.n_rays);
            }
        }
        return cudaErrorInvalidValue;
    }
};

}  // namespace

// C ABI as flat_trace_launch (flat_trace.cuh), 1 <= cursors <= kMaxCursors;
// design kPersistent, or kFirst for the vmem f32 frame forms at
// cursors = 1.
extern "C" int flat_trace_mxu_launch(FLAT_LAUNCH_ARGS) {
    return flat_dispatch(MxuLaunch{}, cursors >= 1 && cursors <= tpu_rt_torch::kMaxCursors,
                         FLAT_LAUNCH_CALL);
}
