// The binary traversal kernel with a tensor-core leaf phase, for NVIDIA
// Hopper: closest hit and any hit, each with or without u, v and the
// per-ray counters, on f32 or bf16 node records in any residency.
//
// Replaces: tpu_rt/trace/packet2.py `_kernel2` in its MXU triangle-unit
// form (mxu=True, :792-862, ray matrix :978-993; trace_packet2 :1052-1114
// with U = MAX_LEAF = 8, :1110-1111), composed with its C leaf cursors
// (:72-77) as tpu_rt composes them.  trace_packet4 never takes it (:1187).
//
// What it computes: the walk of flat_trace.cuh (visit_inner, the oracle's
// order), but a leaf is tested whole, as one candidate group of up to 8
// triangles (mxu_leaf.cuh): the six Woop dot products by FP64 mma, rounded
// once to f32, t = Oz / Dz, the leaf's winner the smallest t with ties to
// the largest triangle id, merged with a strict t < hit_t.  So t is
// "f32-class": within an ulp or so of the oracle's, which multiplies by
// 1 / Dz; tri equals the oracle's but on rays that graze an edge or tie.
// The plain version, tpu_rt_torch/trace/flat_kernel.py with mxu=True, takes
// the same dot products in float64 and rounds them once.
//
// Design (while-while, Aila-Laine; SURVEY.md): an mma needs all 32 lanes
// of a warp with the same L, so the triangle phase is a warp's, not a
// lane's.
//   - Walk: each lane walks in the oracle's order, holding the leaves it
//     reaches (trace_common.cuh `Postponed`), until it holds `cursors`
//     (1..kMaxCursors) or its stack is empty.
//   - Leaf phase, while any lane holds a leaf (__ballot_sync): the first
//     such lane's oldest leaf is broadcast, the lanes whose oldest leaf it
//     is form the group, every lane loads its A element of that leaf's L
//     from the Woop rows, the warp runs 6 products x (the n8 tiles that
//     hold a lane of the group) mma, and the group's lanes read their
//     columns, pick the leaf's winner and drop the leaf.  Each lane's leaves
//     are drained in the order it found them, so the result does not depend
//     on which lanes share a warp.
//   - Lanes past n_rays, rays with tmax < 0 and lanes whose any-hit ray is
//     done stay in the loop, idle, until the warp is done.
// Leaves must hold at most 8 triangles: upload_flat records the widest and
// trace_flat(mxu=True) refuses wider ones, as pack_tables2 does (:170).
//
// What bounds it: the walk is flat_trace.cuh's (dependent node loads,
// divergence); the leaf phase serialises the warp over its distinct
// leaves, and its 24 DMMA per leaf group do 8 x 32 candidate-ray pairs
// where a lane needs count (about 3) of them.  PERF.md gives its times
// against the scalar drain and its ablation (mxu_ablate.cu).

#include "flat_trace.cuh"
#include "mxu_leaf.cuh"

namespace {

template <bool kAnyHit, bool kWantUv, bool kStats, bool kBf16Nodes, bool kStreamNodes,
          bool kStreamTris>
__global__ void __launch_bounds__(kBlock)
flat_trace_mxu_kernel(const float4* __restrict__ nodes, int n_nodes,
                      const float4* __restrict__ woop,
                      const int* __restrict__ leaf_counts, int n_counts,
                      const float* __restrict__ origin, const float* __restrict__ dirn,
                      const float* __restrict__ tmin, const float* __restrict__ tmax,
                      int* __restrict__ out_tri, float* __restrict__ out_t,
                      float* __restrict__ out_u, float* __restrict__ out_v,
                      int* __restrict__ out_node_tests, int* __restrict__ out_tri_tests,
                      int n_rays, int cursors) {
    __shared__ MxuWarp warps[kBlock / 32];
    const int lane = threadIdx.x & 31;
    MxuWarp& s = warps[threadIdx.x >> 5];
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
                if (visit_inner<kStats, kBf16Nodes, kStreamNodes>(nodes, r, h, node, stack, sp)) {
                    continue;
                }
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
            const int count = min(load<kStreamTris>(leaf_counts + min(first, n_counts - 1)),
                                  kMxuLeaf);
            leaf_products(leaf_a<kStreamTris>(woop, first, count, lane), group, s, lane);
            if (group & (1u << lane)) {
                held.pop();
                const LeafHit b = leaf_best<kStreamTris>(s, lane, woop, first, count, r.t_min,
                                                         t_max);
                if (b.t < h.t && (!kAnyHit || h.tri < 0)) {
                    h.t = b.t;
                    h.tri = b.tri;
                    if constexpr (kWantUv) {
                        h.u = b.u;
                        h.v = b.v;
                    }
                }
                if constexpr (kStats) h.tri_tests += count;
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
        store_hit<kWantUv, kStats>(h, ray, out_tri, out_t, out_u, out_v, out_node_tests,
                                   out_tri_tests);
    }
}

// The launch of one form: one ray per thread (the kernel's own loop), as
// flat_trace.cuh's first versions are launched.
struct MxuLaunch {
    template <typename A, typename U, typename C, typename B, typename SN, typename ST>
    cudaError_t operator()(A, U, C, B, SN, ST, const TraceArgs& args, const LaunchCtx& ctx) const {
        if (ctx.design != kPersistent) return cudaErrorInvalidValue;
        return launch_per_ray(
            flat_trace_mxu_kernel<A::value, U::value, C::value, B::value, SN::value, ST::value>,
            args.n_rays, ctx, args.nodes, args.n_nodes, args.woop, args.leaf_counts,
            args.n_counts, args.origin, args.dirn, args.tmin, args.tmax, args.out_tri, args.out_t,
            args.out_u, args.out_v, args.out_node_tests, args.out_tri_tests, args.n_rays,
            args.cursors);
    }
};

}  // namespace

// C ABI as flat_trace_launch (flat_trace.cuh), 1 <= cursors <= kMaxCursors,
// design 0 only; `counter` is not used.
extern "C" int flat_trace_mxu_launch(FLAT_LAUNCH_ARGS) {
    return flat_dispatch(MxuLaunch{}, cursors >= 1 && cursors <= tpu_rt_torch::kMaxCursors,
                         FLAT_LAUNCH_CALL);
}
