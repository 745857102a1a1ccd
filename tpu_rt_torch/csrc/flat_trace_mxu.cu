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
struct MxuLane : FlatLane<kAnyHit, kWantUv, kStats, kBf16Nodes, kStreamNodes, kStreamTris, true> {
    using Base = FlatLane<kAnyHit, kWantUv, kStats, kBf16Nodes, kStreamNodes, kStreamTris, true>;

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

// The launch of one form: the persistent kernel with the warps' ray tables
// in dynamic shared memory.
struct MxuLaunch {
    template <typename A, typename U, typename C, typename B, typename SN, typename ST>
    cudaError_t operator()(A, U, C, B, SN, ST, const TraceArgs& args, const LaunchCtx& ctx) const {
        if (args.counter == nullptr) return cudaErrorInvalidValue;
        return launch_persistent(
            flat_trace_mxu_kernel<A::value, U::value, C::value, B::value, SN::value, ST::value>,
            args.n_rays, kWarps * sizeof(MxuRays), args.counter, ctx, args);
    }
};

}  // namespace

// C ABI as flat_trace_launch (flat_trace.cuh), 1 <= cursors <= kMaxCursors.
extern "C" int flat_trace_mxu_launch(FLAT_LAUNCH_ARGS) {
    return flat_dispatch(MxuLaunch{}, cursors >= 1 && cursors <= tpu_rt_torch::kMaxCursors,
                         FLAT_LAUNCH_CALL);
}
