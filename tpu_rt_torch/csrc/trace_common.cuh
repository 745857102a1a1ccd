// Device code shared by the traversal kernels (quad_trace.cu, flat_trace.cu):
// the ray set-up, the slab test and the Woop-triangle drain, each the host
// oracles' float32 ops in their order (trace_quad_scalar in
// tpu_rt_torch/bvh/collapse.py, trace_flat_scalar in
// tpu_rt_torch/trace/cpu_reference.py).  Built with -fmad=false and no fast
// math, so every result below equals the oracles' bit for bit.
//
// The forms of a kernel are template flags with one instantiation each:
//   kAnyHit  stop at the first accepted triangle (AO occlusion);
//   kWantUv  keep the barycentrics u, v of the accepted hit;
//   kStats   count node visits and triangle tests per ray, and the most
//            entries its traversal stack held in local memory at once.
// A flag that is false compiles to nothing, so the frame forms (kWantUv =
// kStats = false) carry no uv or counter code.
//
// The tables' residency (tpu_rt's names; tpu_rt_torch/trace/tables.py) is
// two more flags, the cache policy of the loads:
//   kStreamNodes  node records read with the streaming hint (ld.global.cs,
//                 evict first);
//   kStreamTris   Woop rows (and leaf counts) read with the streaming hint.
// "vmem" is (false, false): loads through the read-only path (ldg).
// "mixed" is (false, true), launched with an L2 access-policy window over
// the node table (persisting on hit, streaming on miss; launch_window
// below); "hbm" is (true, true), no window.  Node fetches are the
// traversal's chain of dependent loads, so the node table is what the L2
// should keep; a triangle row is read once per leaf visit and should not
// evict it.
//
// Postponed leaves (kPostpone, the counterpart of tpu_rt's C > 1 leaf
// cursors, packet2.py:72-77): a ray that reaches a leaf keeps its link in
// `Postponed` below and walks on in the oracle's order; it drains the leaves
// it holds, in the order it found them, when it holds `cursors` of them
// (2 <= cursors <= kMaxCursors, read at run time) or its stack is empty.
// Each triangle is tested with the same f32 ops, so t stays the oracle's
// bit for bit; only the drain order (tri at exact-t ties, the any-hit
// occluder) and the culling distance (more node tests) change.
//
// The schedule (every form of quad_trace.cuh and flat_trace.cuh; the
// reference's kepler_dynamic_fetch.cu:66-411 without its speculation):
//   - Persistent warps: the grid is the card's SMs x the blocks of the
//     launched form that fit on one (cudaOccupancyMaxActiveBlocksPerMulti-
//     processor), clipped to the blocks the batch needs (launch_persistent).
//   - Dynamic ray fetch: the lanes of a warp that hold no ray take the next
//     indices from a global counter, one atomicAdd per warp handed out by a
//     ballot prefix (fetch_rays; :100-119), when fewer than kRefill of its
//     32 lanes still hold one (:48, :398-401).  Each ray's results are
//     written at its own index.  The counter is a 4-byte scratch the wrapper
//     allocates; the launch zeroes it on the stream.
//   - While-while (persistent_warps): a node phase runs while any lane
//     stands on an inner node; a lane that reaches leaf work waits for it,
//     and then the warp drains, each lane its queued (leaf, triangle) pairs
//     in one loop (woop_test), so every lane runs one Woop code path.  A
//     lane drains its leaves exactly where the oracle does, before its next
//     node test: nothing is speculated, so each ray's ops, and with them its
//     results, are the oracle's.
//   - The traversal stack keeps its top in a register above a sentinel
//     (kEmpty; :70-71) and the rest in local memory (TraversalStack).  The
//     lane's other state (LeanRay: the ray without o * (1 / d), which a slab
//     test takes again) stays in registers.
//   - Node records and Woop rows are read through the read-only path (ldg),
//     or with the streaming hint in the mixed / hbm forms.
// This is the one design of every traversal library.  A kernel of one ray
// per thread, and this one with the stack in shared memory, were timed
// against it on the H100 and lost (PERF.md).

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

namespace tpu_rt_torch {

constexpr float kOoeps = 0x1p-80f;
constexpr int kBlock = 128;
constexpr unsigned kFullMask = 0xffffffffu;
// A warp refills its free lanes when fewer than kRefill of its 32 hold a
// ray: the reference's 20 (kepler_dynamic_fetch.cu:48).  On the H100 every
// threshold from 8 to 32 ran within the noise between calls (PERF.md).
constexpr int kRefill = 20;
// The stack's bottom sentinel and "no next node": no node row, leaf link or
// pushed child has these bits (the quad tree's empty-slot link has them and
// is never pushed).
constexpr int kEmpty = 0x7FFFFFFF;

// numpy/torch minimum and maximum propagate NaN; fminf/fmaxf drop it.  These
// keep every NaN (a degenerate or empty box) a miss as in the oracles.
__device__ __forceinline__ float min_nan(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
    return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// One load of a table element, with the streaming hint when kStream.
template <bool kStream, typename T>
__device__ __forceinline__ T load(const T* p) {
    if constexpr (kStream) {
        return __ldcs(p);
    } else {
        return *p;
    }
}

// One load of a table element through the read-only path, or with the
// streaming hint when kStream (the persistent kernels' loads).
template <bool kStream, typename T>
__device__ __forceinline__ T ldg(const T* p) {
    if constexpr (kStream) {
        return __ldcs(p);
    } else {
        return __ldg(p);
    }
}

struct Ray {
    float ox, oy, oz;
    float dx, dy, dz;
    float ix, iy, iz;        // 1 / d, tiny components clamped to +-2^-80
    float oix, oiy, oiz;     // o * (1 / d)
    float t_min;
};

__device__ __forceinline__ float safe_inv(float d) {
    return 1.0f / (fabsf(d) > kOoeps ? d : copysignf(kOoeps, d));
}

// A ray without o * (1 / d): the persistent kernels take the product again
// in each slab test (the same f32 multiply of the same operands, so the same
// bits) rather than hold three more registers.
struct LeanRay {
    float ox, oy, oz;
    float dx, dy, dz;
    float ix, iy, iz;
    float t_min;
};

// o * (1 / d) of a ray, as a slab test reads it.
struct Oi {
    float x, y, z;
};
__device__ __forceinline__ Oi ray_oi(const Ray& r) { return Oi{r.oix, r.oiy, r.oiz}; }
__device__ __forceinline__ Oi ray_oi(const LeanRay& r) {
    return Oi{r.ox * r.ix, r.oy * r.iy, r.oz * r.iz};
}

__device__ __forceinline__ LeanRay load_lean_ray(const float* __restrict__ origin,
                                                 const float* __restrict__ dirn,
                                                 const float* __restrict__ tmin, int ray) {
    LeanRay r;
    r.ox = origin[3 * ray + 0];
    r.oy = origin[3 * ray + 1];
    r.oz = origin[3 * ray + 2];
    r.dx = dirn[3 * ray + 0];
    r.dy = dirn[3 * ray + 1];
    r.dz = dirn[3 * ray + 2];
    r.ix = safe_inv(r.dx);
    r.iy = safe_inv(r.dy);
    r.iz = safe_inv(r.dz);
    r.t_min = tmin[ray];
    return r;
}

__device__ __forceinline__ Ray load_ray(const float* __restrict__ origin,
                                        const float* __restrict__ dirn,
                                        const float* __restrict__ tmin, int ray) {
    Ray r;
    r.ox = origin[3 * ray + 0];
    r.oy = origin[3 * ray + 1];
    r.oz = origin[3 * ray + 2];
    r.dx = dirn[3 * ray + 0];
    r.dy = dirn[3 * ray + 1];
    r.dz = dirn[3 * ray + 2];
    r.ix = safe_inv(r.dx);
    r.iy = safe_inv(r.dy);
    r.iz = safe_inv(r.dz);
    r.oix = r.ox * r.ix;
    r.oiy = r.oy * r.iy;
    r.oiz = r.oz * r.iz;
    r.t_min = tmin[ray];
    return r;
}

// The accepted hit of one ray and, in the counter form, the work it took.
struct Hit {
    float t;
    int tri;
    float u, v;
    int node_tests, tri_tests;
};

// Slab test of one child box, as the oracles: near = max(max over axes of
// min(lo, hi), tmin), far = min(min over axes of max(lo, hi), t).  `near`
// is the entry distance the binary kernel orders its two children by.
template <typename R>
__device__ __forceinline__ bool slab_near(const R& r, float hit_t,
                                          float lox, float hix, float loy,
                                          float hiy, float loz, float hiz, float& near) {
    const Oi oi = ray_oi(r);
    const float ax = lox * r.ix - oi.x;
    const float bx = hix * r.ix - oi.x;
    const float ay = loy * r.iy - oi.y;
    const float by = hiy * r.iy - oi.y;
    const float az = loz * r.iz - oi.z;
    const float bz = hiz * r.iz - oi.z;
    const float near3 = max_nan(max_nan(min_nan(ax, bx), min_nan(ay, by)), min_nan(az, bz));
    const float far3 = min_nan(min_nan(max_nan(ax, bx), max_nan(ay, by)), max_nan(az, bz));
    // Python's max(a, b) / min(a, b) keep `a` unless `b` compares greater /
    // smaller, which decides the NaN cases the same way.
    near = r.t_min > near3 ? r.t_min : near3;
    const float far = hit_t < far3 ? hit_t : far3;
    return far >= near;
}

template <typename R>
__device__ __forceinline__ bool slab(const R& r, float hit_t,
                                     float lox, float hix, float loy,
                                     float hiy, float loz, float hiz) {
    float near;
    return slab_near(r, hit_t, lox, hix, loy, hiy, loz, hiz, near);
}

// Test the Woop rows first .. first + count - 1 in order; a hit must be
// strictly nearer.  Each row is 16 floats: the z, u, v rows (4 floats each)
// and the original triangle id as int32 bits in slot 12.  The any-hit form
// returns true at the first accepted triangle; the closest-hit form tests
// them all and returns false.
template <bool kAnyHit, bool kWantUv, bool kStats, bool kStreamTris>
__device__ __forceinline__ bool drain(const float4* __restrict__ woop, int first, int count,
                                      const Ray& r, Hit& h) {
    for (int i = first; i < first + count; ++i) {
        if constexpr (kStats) ++h.tri_tests;
        const float4* w = woop + static_cast<size_t>(i) * 4;
        const float4 wz = load<kStreamTris>(w);
        const float Oz = wz.w - r.ox * wz.x - r.oy * wz.y - r.oz * wz.z;
        const float Dz = r.dx * wz.x + r.dy * wz.y + r.dz * wz.z;
        const float inv_dz = 1.0f / Dz;
        const float t = Oz * inv_dz;
        if (t > r.t_min && t < h.t) {
            const float4 wu = load<kStreamTris>(w + 1);
            const float Ox = wu.w + r.ox * wu.x + r.oy * wu.y + r.oz * wu.z;
            const float Dx = r.dx * wu.x + r.dy * wu.y + r.dz * wu.z;
            const float u = Ox + t * Dx;
            if (u >= 0.0f) {
                const float4 wv = load<kStreamTris>(w + 2);
                const float Oy = wv.w + r.ox * wv.x + r.oy * wv.y + r.oz * wv.z;
                const float Dy = r.dx * wv.x + r.dy * wv.y + r.dz * wv.z;
                const float v = Oy + t * Dy;
                if (v >= 0.0f && u + v <= 1.0f) {
                    h.t = t;
                    h.tri = __float_as_int(load<kStreamTris>(&w[3].x));
                    if constexpr (kWantUv) {
                        h.u = u;
                        h.v = v;
                    }
                    if constexpr (kAnyHit) return true;
                }
            }
        }
    }
    return false;
}

// The distance t along ray r to the plane of Woop row i, as `drain` takes
// it, from the row's z part read through ldg.
template <bool kStreamTris, typename R>
__device__ __forceinline__ float woop_t(const float4* __restrict__ woop, int i, const R& r) {
    const float4 wz = ldg<kStreamTris>(woop + static_cast<size_t>(i) * 4);
    const float Oz = wz.w - r.ox * wz.x - r.oy * wz.y - r.oz * wz.z;
    const float Dz = r.dx * wz.x + r.dy * wz.y + r.dz * wz.z;
    const float inv_dz = 1.0f / Dz;
    return Oz * inv_dz;
}

// The rest of `drain`'s test of Woop row i at the distance t = woop_t(..):
// true when the triangle is accepted (h updated).
template <bool kWantUv, bool kStreamTris, typename R>
__device__ __forceinline__ bool woop_accept(const float4* __restrict__ woop, int i, float t,
                                            const R& r, Hit& h) {
    const float4* w = woop + static_cast<size_t>(i) * 4;
    if (!(t > r.t_min && t < h.t)) return false;
    const float4 wu = ldg<kStreamTris>(w + 1);
    const float Ox = wu.w + r.ox * wu.x + r.oy * wu.y + r.oz * wu.z;
    const float Dx = r.dx * wu.x + r.dy * wu.y + r.dz * wu.z;
    const float u = Ox + t * Dx;
    if (!(u >= 0.0f)) return false;
    const float4 wv = ldg<kStreamTris>(w + 2);
    const float Oy = wv.w + r.ox * wv.x + r.oy * wv.y + r.oz * wv.z;
    const float Dy = r.dx * wv.x + r.dy * wv.y + r.dz * wv.z;
    const float v = Oy + t * Dy;
    if (!(v >= 0.0f && u + v <= 1.0f)) return false;
    h.t = t;
    h.tri = __float_as_int(ldg<kStreamTris>(&w[3].x));
    if constexpr (kWantUv) {
        h.u = u;
        h.v = v;
    }
    return true;
}

// One Woop row, i, as `drain` tests it (the same f32 ops in the same
// order), read through ldg: true when the triangle is accepted (h updated).
template <bool kWantUv, bool kStreamTris, typename R>
__device__ __forceinline__ bool woop_test(const float4* __restrict__ woop, int i, const R& r,
                                          Hit& h) {
    return woop_accept<kWantUv, kStreamTris>(woop, i, woop_t<kStreamTris>(woop, i, r), r, h);
}

// The most Woop rows a slot of the slot forms loads at once (`units`,
// tpu_rt's U): the widest quad leaf.
constexpr int kMaxUnits = 32;

// Test the Woop rows first .. end - 1 of one leaf, in order, as woop_test
// does, `units` rows at a time: the z parts of up to `units` rows are read
// and their t taken, and then each row is tested in the leaf's order
// against the hit distance so far.  t does not depend on the hit, so every
// result (t, tri, u, v, the any-hit occluder, the counter) is woop_test's
// in a loop; only the loads are issued ahead.  No row past `end` is read.
// U = 1 is the default forms' loop, which keeps no t in local memory (the
// staged loop was slower at U = 1 on the card).
// True at the first accepted triangle of the any-hit form.
template <bool kAnyHit, bool kWantUv, bool kStats, bool kStreamTris, typename R>
__device__ __forceinline__ bool test_rows(const float4* __restrict__ woop, int first, int end,
                                          int units, const R& r, Hit& h) {
    if (units == 1) {
        for (int i = first; i < end; ++i) {
            if constexpr (kStats) ++h.tri_tests;
            if (woop_test<kWantUv, kStreamTris>(woop, i, r, h) && kAnyHit) return true;
        }
        return false;
    }
    for (int i = first; i < end; i += units) {
        const int n = end - i < units ? end - i : units;
        // Unrolled by 4, not by kMaxUnits: fully unrolled, the K = 8
        // libraries did not build within the build's time limit.
        float t[kMaxUnits];
#pragma unroll 4
        for (int j = 0; j < n; ++j) t[j] = woop_t<kStreamTris>(woop, i + j, r);
        for (int j = 0; j < n; ++j) {
            if constexpr (kStats) ++h.tri_tests;
            if (woop_accept<kWantUv, kStreamTris>(woop, i + j, t[j], r, h) && kAnyHit) {
                return true;
            }
        }
    }
    return false;
}

constexpr int kMaxCursors = 4;

// The leaf links a ray holds, oldest first.  Indexed only with constants
// (unrolled loops), so the array stays in registers.
struct Postponed {
    int link[kMaxCursors] = {};
    int n = 0;

    // Keep one more leaf; returns how many are held.
    __device__ __forceinline__ int add(int l) {
#pragma unroll
        for (int i = 0; i < kMaxCursors; ++i) {
            if (i == n) link[i] = l;
        }
        return ++n;
    }

    // Drop the oldest leaf.
    __device__ __forceinline__ void pop() {
#pragma unroll
        for (int i = 0; i + 1 < kMaxCursors; ++i) link[i] = link[i + 1];
        --n;
    }
};

// Outputs of one ray: (tri, t) always, u and v and the three counters (the
// hit's two and the stack's high-water, `stack`) only in the forms that
// keep them.
template <bool kWantUv, bool kStats>
__device__ __forceinline__ void store_hit(const Hit& h, int stack, int ray,
                                          int* __restrict__ out_tri,
                                          float* __restrict__ out_t, float* __restrict__ out_u,
                                          float* __restrict__ out_v,
                                          int* __restrict__ out_node_tests,
                                          int* __restrict__ out_tri_tests,
                                          int* __restrict__ out_stack) {
    out_tri[ray] = h.tri;
    out_t[ray] = h.t;
    if constexpr (kWantUv) {
        out_u[ray] = h.u;
        out_v[ray] = h.v;
    }
    if constexpr (kStats) {
        out_node_tests[ray] = h.node_tests;
        out_tri_tests[ray] = h.tri_tests;
        out_stack[ray] = stack;
    }
}

// The arguments of one traversal launch, as the C ABI gives them
// (leaf_counts and n_counts only for the binary kernel).  The persistent
// kernels take it whole, as a __grid_constant__ parameter.  out_stack, the
// counter forms' third output, comes last, so that every other member has
// the offset it had before that output.
struct TraceArgs {
    const float4* nodes;
    int n_nodes;
    const float4* woop;
    const int* leaf_counts;
    int n_counts;
    const float* origin;
    const float* dirn;
    const float* tmin;
    const float* tmax;
    int* out_tri;
    float* out_t;
    float* out_u;
    float* out_v;
    int* out_node_tests;
    int* out_tri_tests;
    int n_rays;
    int cursors;
    unsigned* counter;   // the ray pool: zeroed by the launch
    int* out_stack;
};

// The traversal stack of one lane: the top in a register, above the
// sentinel kEmpty, and the entries below it in local memory (the kernel's
// own array of STACK_SIZE entries, which bind() takes, so that the lane's
// other state can live in registers).  pop() on an empty stack returns
// kEmpty.
struct TraversalStack {
    int top;
    int sp;
    int* mem;

    __device__ __forceinline__ void bind(int* local) { mem = local; }
    __device__ __forceinline__ void clear() {
        top = kEmpty;
        sp = 0;
    }
    __device__ __forceinline__ void push(int x) {
        mem[sp++] = top;
        top = x;
    }
    __device__ __forceinline__ int pop() {
        const int x = top;
        if (x != kEmpty) top = mem[--sp];
        return x;
    }
};

// A lane's pushes onto its stack and, in the counter forms, their
// high-water: the most entries the stack held in local memory at once (the
// largest sp).  The lanes derive from it; in the other forms it is an empty
// base, so that their state keeps its layout and their code is unchanged.
template <bool kStats>
struct StackHigh {
    __device__ __forceinline__ void clear_high() {}
    __device__ __forceinline__ void push(TraversalStack& stack, int x) { stack.push(x); }
    __device__ __forceinline__ int high() const { return 0; }
};
template <>
struct StackHigh<true> {
    int entries;

    __device__ __forceinline__ void clear_high() { entries = 0; }
    __device__ __forceinline__ void push(TraversalStack& stack, int x) {
        stack.push(x);
        entries = stack.sp > entries ? stack.sp : entries;
    }
    __device__ __forceinline__ int high() const { return entries; }
};

// Dynamic ray fetch (kepler_dynamic_fetch.cu:100-119): the lanes with
// `need` take the next ray indices from *counter, one atomicAdd by the first
// of them, handed out in lane order by a ballot prefix.  Returns this lane's
// index (n_rays or more: none left) and sets `exhausted`, warp-uniform, once
// the counter has passed n_rays.  Every lane of the warp calls it, and at
// least one has `need`.
__device__ __forceinline__ unsigned fetch_rays(unsigned* counter, bool need, int n_rays,
                                               bool& exhausted) {
    const unsigned want = __ballot_sync(kFullMask, need);
    const unsigned lane = threadIdx.x & 31u;
    const int leader = __ffs(want) - 1;
    unsigned base = 0;
    if (lane == static_cast<unsigned>(leader)) base = atomicAdd(counter, __popc(want));
    base = __shfl_sync(kFullMask, base, leader);
    exhausted = base + __popc(want) >= static_cast<unsigned>(n_rays);
    return base + __popc(want & ((1u << lane) - 1u));
}

// The persistent warp loop of both kernels.  `lane` is one lane's state:
//   active()  it holds a ray;
//   walking() it holds a ray and no leaf work: it stands on an inner node;
//   start(a, i) takes ray i (writing it at once when it has nothing to
//     trace); node_step(a) tests one node; drain(a) tests every queued
//     (leaf, triangle) pair, one loop and one Woop code path for all lanes
//     (nothing for a lane without leaf work); both write the ray's results
//     and free the lane when it ends.
// Each round: refill the free lanes (while any is free and the pool lasts),
// then node phases and leaf phases in turn until fewer than kRefill lanes
// hold a ray (or none, once the pool is empty).  A phase is a loop of each
// lane's own; the warp leaves it together, when its last lane does, so a
// lane that reaches leaf work waits for the others' node steps, and the
// other way round.
template <typename Lane>
__device__ __forceinline__ void persistent_warps(Lane& lane, const TraceArgs& a) {
    bool exhausted = false;
    for (;;) {
        while (!exhausted) {
            const bool need = !lane.active();
            if (!__any_sync(kFullMask, need)) break;
            const unsigned i = fetch_rays(a.counter, need, a.n_rays, exhausted);
            if (need && i < static_cast<unsigned>(a.n_rays)) lane.start(a, static_cast<int>(i));
        }
        if (!__any_sync(kFullMask, lane.active())) return;
        for (;;) {
            while (lane.walking()) lane.node_step(a);
            lane.drain(a);
            const int held = __popc(__ballot_sync(kFullMask, lane.active()));
            if (held == 0 || (!exhausted && held < kRefill)) break;
        }
    }
}

// ---------------------------------------------------------------------------
// The slot forms (flat_trace_k*.cu, quad_trace_k*.cu): the counterparts of
// `_kernel2`'s last three settings (packet2.py:404-405), each what the
// setting does there, not a copy of the TPU's machinery.
//   K (kSlots, 1, 2, 4 or 8; packet2.py:521-535 interleaves K packets so
//     that their dependent fetch chains overlap): each lane holds kSlots
//     rays, each in a lane state of its own with its own stack.  One node
//     phase iteration gives every walking slot one node step, and issues
//     the slots' node-record loads before any of their slab tests.
//   U (`units`, 1..kMaxUnits, read at run time; U triangle tests per
//     packet per iteration): a slot reads the z parts of up to `units` Woop
//     rows of its leaf at once, then tests them in the leaf's order
//     (test_rows).
//   S (`tile`, a multiple of kBlock, or 0; the S x 128 rays of one grid
//     step, _trace2_jit :950-957): a block claims `tile` rays of the global
//     pool at once, into a pool of its own in shared memory (TilePool), from
//     which its warps draw as fetch_rays draws from the global one.  0: the
//     warps draw from the global pool themselves.
// Each ray is traced by the same ops as in the default forms, whatever slot,
// warp or block takes it, so every result and counter is theirs bit for bit.

// The rays a block has claimed and not yet handed out: [next, end), and the
// lock that one warp's leader holds while it draws (and refills).
struct TilePool {
    unsigned next, end;
    int lock;
};
__shared__ TilePool tile_pool;

// A warp's draw of `want` ray indices (claim_rays): rank q < n0 takes
// base0 + q, rank n0 <= q < got takes base1 + q - n0; ranks from `got` on
// take nothing this time.
struct Claim {
    unsigned base0, n0, base1, got;
};

// One draw of `want` (>= 1) ray indices, by one lane of the warp: from the
// global counter at once (tile 0), or from the block's pool, which, when it
// holds fewer than `want`, hands out what it holds and is refilled with the
// next `tile` rays of the global counter.  A draw takes at most one new
// tile, so `got` < `want` only when `want` > `tile`.
__device__ __forceinline__ Claim claim_rays(unsigned* counter, unsigned want, unsigned tile) {
    Claim c{0, want, 0, want};
    if (tile == 0) {
        c.base0 = atomicAdd(counter, want);
        return c;
    }
    while (atomicCAS(&tile_pool.lock, 0, 1) != 0) {
    }
    __threadfence_block();
    volatile TilePool& pool = tile_pool;
    const unsigned next = pool.next, end = pool.end;
    c.base0 = next;
    if (end - next >= want) {
        pool.next = next + want;
    } else {
        c.n0 = end - next;
        c.got = want - c.n0 < tile ? want : c.n0 + tile;
        c.base1 = atomicAdd(counter, tile);
        pool.next = c.base1 + (c.got - c.n0);
        pool.end = c.base1 + tile;
    }
    __threadfence_block();
    atomicExch(&tile_pool.lock, 0);
    return c;
}

// The sum of `x` over the warp.
__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFullMask, x, d);
    return x;
}

// The persistent warp loop of the slot forms: persistent_warps with kSlots
// lane states per lane.  `slot[s]` offers persistent_warps' calls, with the
// node step also in two parts, fetch(a, walk) (the record loads: of its node
// when it walks, else of row 0) and step(a, rec), and drain_units(a, units)
// for drain(a).
// Each round: refill the free slots (one draw per warp, each lane's free
// slots handed consecutive ranks by a warp prefix sum of their counts),
// then node phases and leaf phases in turn until fewer than kRefill x
// kSlots of the warp's 32 x kSlots slots hold a ray (or none, once the pool
// is empty).  An any-hit ray ends in its own slot at its first accepted
// triangle.
template <int kSlots, typename Lane>
__device__ __forceinline__ void persistent_slots(Lane (&slot)[kSlots], const TraceArgs& a,
                                                 int units, unsigned tile) {
    if (threadIdx.x == 0) {
        tile_pool.next = 0;
        tile_pool.end = 0;
        tile_pool.lock = 0;
    }
    __syncthreads();
    const int lane = static_cast<int>(threadIdx.x & 31u);
    const unsigned n_rays = static_cast<unsigned>(a.n_rays);
    bool exhausted = false;
    for (;;) {
        while (!exhausted) {
            unsigned free_mask = 0;
#pragma unroll
            for (int s = 0; s < kSlots; ++s) {
                if (!slot[s].active()) free_mask |= 1u << s;
            }
            // This lane's free slots take ranks [rank, rank + free) of the draw.
            const int free = __popc(free_mask);
            int incl = free;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(kFullMask, incl, d);
                if (lane >= d) incl += y;
            }
            const unsigned want = static_cast<unsigned>(__shfl_sync(kFullMask, incl, 31));
            if (want == 0) break;
            Claim c{};
            if (lane == 0) c = claim_rays(a.counter, want, tile);
            c.base0 = __shfl_sync(kFullMask, c.base0, 0);
            c.n0 = __shfl_sync(kFullMask, c.n0, 0);
            c.base1 = __shfl_sync(kFullMask, c.base1, 0);
            c.got = __shfl_sync(kFullMask, c.got, 0);
            // Past the last index drawn: every later draw lies beyond n_rays.
            const unsigned past = c.got > c.n0 ? c.base1 + (c.got - c.n0) : c.base0 + c.got;
            exhausted = past >= n_rays;
            unsigned rank = static_cast<unsigned>(incl - free);
#pragma unroll
            for (int s = 0; s < kSlots; ++s) {
                if (free_mask & (1u << s)) {
                    if (rank < c.got) {
                        const unsigned i = rank < c.n0 ? c.base0 + rank : c.base1 + (rank - c.n0);
                        if (i < n_rays) slot[s].start(a, static_cast<int>(i));
                    }
                    ++rank;
                }
            }
        }
        int held = 0;
#pragma unroll
        for (int s = 0; s < kSlots; ++s) held += slot[s].active() ? 1 : 0;
        if (warp_sum(held) == 0) return;
        for (;;) {
            if constexpr (kSlots == 1) {
                // One slot has nothing to interleave: persistent_warps' node
                // phase (the split loop below was slower at K = 1 on the
                // card).
                while (slot[0].walking()) slot[0].node_step(a);
            } else {
                for (;;) {
                    unsigned walk = 0;
#pragma unroll
                    for (int s = 0; s < kSlots; ++s) {
                        if (slot[s].walking()) walk |= 1u << s;
                    }
                    if (walk == 0) break;
                    // Every slot's record load before any slab test; a slot
                    // that does not walk reads row 0 (a slot walks only on
                    // a tree with nodes), so that no load waits on a branch.
                    typename Lane::Rec rec[kSlots];
#pragma unroll
                    for (int s = 0; s < kSlots; ++s) rec[s] = slot[s].fetch(a, (walk >> s) & 1u);
#pragma unroll
                    for (int s = 0; s < kSlots; ++s) {
                        if (walk & (1u << s)) slot[s].step(a, rec[s]);
                    }
                }
            }
            held = 0;
#pragma unroll
            for (int s = 0; s < kSlots; ++s) {
                slot[s].drain_units(a, units);
                held += slot[s].active() ? 1 : 0;
            }
            held = warp_sum(held);
            if (held == 0 || (!exhausted && held < kRefill * kSlots)) break;
        }
    }
}

// The arguments the slot libraries' C entry points take before the
// traversal's: U and S (`tile`; 0 for none).  True when they are in range.
inline bool slots_ok(int units, int tile) {
    return units >= 1 && units <= kMaxUnits && tile >= 0 && tile % kBlock == 0;
}

// Picks the instantiation from three host flags: calls f(any_hit, want_uv,
// stats) with each flag as a std::integral_constant, so a generic lambda
// reads them as `decltype(flag)::value` template arguments.
template <typename F>
void dispatch_form(bool any_hit, bool want_uv, bool stats, F&& f) {
    using T = std::true_type;
    using N = std::false_type;
    if (any_hit) {
        if (want_uv) {
            if (stats) f(T{}, T{}, T{}); else f(T{}, T{}, N{});
        } else {
            if (stats) f(T{}, N{}, T{}); else f(T{}, N{}, N{});
        }
    } else {
        if (want_uv) {
            if (stats) f(N{}, T{}, T{}); else f(N{}, T{}, N{});
        } else {
            if (stats) f(N{}, N{}, T{}); else f(N{}, N{}, N{});
        }
    }
}

// Picks the residency's instantiation: calls f(stream_nodes, stream_tris)
// as std::integral_constants for "vmem", "mixed" and "hbm"; false for the
// one pair that is no residency (nodes streamed, triangles not).
template <typename F>
bool dispatch_residency(bool stream_nodes, bool stream_tris, F&& f) {
    using T = std::true_type;
    using N = std::false_type;
    if (!stream_nodes && !stream_tris) {
        f(N{}, N{});
    } else if (!stream_nodes) {
        f(N{}, T{});
    } else if (stream_tris) {
        f(T{}, T{});
    } else {
        return false;
    }
    return true;
}

// Launches kernel<<<grid, kBlock, smem, stream>>>(args...) through
// cudaLaunchKernelEx.  With window_bytes > 0 (the mixed residency) the
// launch carries an L2 access-policy window over [window_base,
// window_base + window_bytes): persisting on hit, streaming on miss,
// hitRatio = min(1, set_aside / window_bytes).  The device's persisting
// set-aside is set to set_aside first when it differs; it stays set until
// trace_l2_release.  The caller clips window_bytes to
// cudaDevAttrMaxAccessPolicyWindowSize.  Every CUDA error is returned:
// there is no launch without the window it asked for.
template <typename... Params, typename... Args>
cudaError_t launch_window(void (*kernel)(Params...), int grid, size_t smem, cudaStream_t stream,
                          const void* window_base, size_t window_bytes, size_t set_aside,
                          Args... args) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(grid);
    config.blockDim = dim3(kBlock);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    cudaLaunchAttribute attr[1];
    if (window_bytes > 0) {
        size_t current = 0;
        cudaError_t err = cudaDeviceGetLimit(&current, cudaLimitPersistingL2CacheSize);
        if (err == cudaSuccess && current != set_aside) {
            err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, set_aside);
        }
        if (err != cudaSuccess) {
            cudaGetLastError();  // clear it: the error is returned here
            return err;
        }
        attr[0].id = cudaLaunchAttributeAccessPolicyWindow;
        attr[0].val.accessPolicyWindow.base_ptr = const_cast<void*>(window_base);
        attr[0].val.accessPolicyWindow.num_bytes = window_bytes;
        const float ratio = static_cast<float>(static_cast<double>(set_aside) /
                                               static_cast<double>(window_bytes));
        attr[0].val.accessPolicyWindow.hitRatio = ratio < 1.0f ? ratio : 1.0f;
        attr[0].val.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
        attr[0].val.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
        config.attrs = attr;
        config.numAttrs = 1;
    }
    const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
    const cudaError_t last = cudaGetLastError();
    return err != cudaSuccess ? err : last;
}

// What the card makes of `kernel` at `threads` threads a block and no
// dynamic shared memory: out[0] its resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] registers a
// thread, out[2] local-memory bytes a thread and out[3] static shared
// memory bytes a block (cudaFuncGetAttributes).  The probes report it
// beside their times.
template <typename... Params>
cudaError_t kernel_occupancy(void (*kernel)(Params...), int threads, int out[4]) {
    cudaFuncAttributes attr{};
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, threads, 0);
    }
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
    }
    out[1] = attr.numRegs;
    out[2] = static_cast<int>(attr.localSizeBytes);
    out[3] = static_cast<int>(attr.sharedSizeBytes);
    return cudaSuccess;
}

// The launch settings of one traversal call that are not kernel arguments.
struct LaunchCtx {
    cudaStream_t stream;
    const void* window_base;
    size_t window_bytes;
    size_t set_aside;
    int* shape;       // host int[4] (grid, blocks per SM, dynamic smem bytes,
                      // SMs), or null
    int slots = 1;    // rays a thread holds (the slot forms' kSlots)
};

// Shared memory the runtime reserves per block (sm_90).
constexpr size_t kSmemReserved = 1024;

// The grid of a persistent launch of `kernel` with `smem` bytes of dynamic
// shared memory: the device's SMs x the blocks that fit on one, clipped to
// the blocks n_rays need at `slots` rays per thread.  The L1 / shared
// carveout is the shared memory of the blocks the registers allow, and no
// more: the rest is L1, where the local-memory stack lives.  The carveout
// is an attribute of the kernel, not of the launch, so it is set again
// before every launch; the occupancy and carveout of each (device, kernel,
// smem) are computed once.
template <typename... Params>
cudaError_t persistent_grid(void (*kernel)(Params...), int n_rays, size_t smem, int out[4],
                            int slots = 1) {
    struct Known {
        int sms, per_sm, carveout;
    };
    static std::mutex mu;
    static std::map<std::tuple<int, const void*, size_t>, Known> known;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const auto key = std::make_tuple(dev, reinterpret_cast<const void*>(kernel), smem);
    Known got{0, 0, 0};
    {
        std::lock_guard<std::mutex> lock(mu);
        const auto it = known.find(key);
        if (it != known.end()) got = it->second;
    }
    if (got.sms == 0) {
        // The blocks the registers and threads allow (with the whole shared
        // memory), then the carveout that holds their shared memory (static
        // and dynamic) and the runtime's reserve of each, the rest left to
        // L1.
        int by_regs = 0, smem_sm = 0;
        cudaFuncAttributes attr{};
        err = cudaFuncGetAttributes(&attr, kernel);
        if (err == cudaSuccess) {
            err = cudaDeviceGetAttribute(&got.sms, cudaDevAttrMultiProcessorCount, dev);
        }
        if (err == cudaSuccess) {
            err = cudaDeviceGetAttribute(&smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
        }
        if (err == cudaSuccess) {
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
        }
        if (err == cudaSuccess) {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&by_regs, kernel, kBlock, 0);
        }
        if (err == cudaSuccess) {
            const size_t want =
                static_cast<size_t>(by_regs) * (smem + attr.sharedSizeBytes + kSmemReserved) * 100;
            const size_t denom = smem_sm > 0 ? static_cast<size_t>(smem_sm) : 1;
            const int carveout = static_cast<int>((want + denom - 1) / denom);
            got.carveout = carveout < 100 ? carveout : 100;
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       got.carveout);
        }
        if (err == cudaSuccess) {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&got.per_sm, kernel, kBlock, smem);
        }
        if (err == cudaSuccess && got.per_sm < 1) err = cudaErrorInvalidConfiguration;
        if (err != cudaSuccess) {
            cudaGetLastError();
            return err;
        }
        std::lock_guard<std::mutex> lock(mu);
        known[key] = got;
    } else {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   got.carveout);
        if (err != cudaSuccess) {
            cudaGetLastError();
            return err;
        }
    }
    const long long per_block = static_cast<long long>(kBlock) * slots;
    const long long need = (static_cast<long long>(n_rays) + per_block - 1) / per_block;
    const long long full = static_cast<long long>(got.sms) * got.per_sm;
    out[0] = static_cast<int>(need < full ? need : full);
    out[1] = got.per_sm;
    out[2] = static_cast<int>(smem);
    out[3] = got.sms;
    return cudaSuccess;
}

// A persistent launch: the grid of persistent_grid, the ray pool zeroed on
// the stream, then the kernel (with the mixed residency's window).
template <typename... Params, typename... Args>
cudaError_t launch_persistent(void (*kernel)(Params...), int n_rays, size_t smem, void* counter,
                              const LaunchCtx& ctx, Args... args) {
    int shape[4];
    cudaError_t err = persistent_grid(kernel, n_rays, smem, shape, ctx.slots);
    if (err == cudaSuccess) err = cudaMemsetAsync(counter, 0, sizeof(unsigned), ctx.stream);
    if (err != cudaSuccess) {
        cudaGetLastError();
        return err;
    }
    if (ctx.shape != nullptr) {
        for (int i = 0; i < 4; ++i) ctx.shape[i] = shape[i];
    }
    return launch_window(kernel, shape[0], smem, ctx.stream, ctx.window_base, ctx.window_bytes,
                         ctx.set_aside, args...);
}

}  // namespace tpu_rt_torch

// The card's L2 attributes for the placement policy (tpu_rt_torch/trace/
// common.py): out[0] the L2 size, out[1] the largest persisting set-aside,
// out[2] the largest access-policy window, in bytes.  Each kernel library
// is one translation unit and defines these once.
extern "C" int trace_l2_info(int device, long long* out) {
    int v[3] = {0, 0, 0};
    const cudaDeviceAttr attrs[3] = {cudaDevAttrL2CacheSize, cudaDevAttrMaxPersistingL2CacheSize,
                                     cudaDevAttrMaxAccessPolicyWindowSize};
    for (int i = 0; i < 3; ++i) {
        const cudaError_t err = cudaDeviceGetAttribute(&v[i], attrs[i], device);
        if (err != cudaSuccess) return static_cast<int>(err);
        out[i] = v[i];
    }
    return 0;
}

// After a frame: drop the persisting lines and give the set-aside back to
// the normal L2 (tpu_rt_torch.trace.common.release_persisting_l2).
extern "C" int trace_l2_release() {
    cudaError_t err = cudaCtxResetPersistingL2Cache();
    if (err == cudaSuccess) err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0);
    return static_cast<int>(err);
}
