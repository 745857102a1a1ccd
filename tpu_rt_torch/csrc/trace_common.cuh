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
//   kStats   count node visits and triangle tests per ray.
// A flag that is false compiles to nothing, so the frame forms (kWantUv =
// kStats = false) carry no uv or counter code.
//
// The tables' residency (tpu_rt's names; tpu_rt_torch/trace/tables.py) is
// two more flags, the cache policy of the loads:
//   kStreamNodes  node records read with the streaming hint (ld.global.cs,
//                 evict first);
//   kStreamTris   Woop rows (and leaf counts) read with the streaming hint.
// "vmem" is (false, false): plain loads, the code of the first versions.
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
//     results, are the first versions'.
//   - The traversal stack keeps its top in a register above a sentinel
//     (kEmpty; :70-71) and the rest in local memory (TraversalStack).  The
//     lane's other state (LeanRay: the ray without o * (1 / d), which a slab
//     test takes again) stays in registers.
//   - Node records and Woop rows are read through the read-only path (ldg),
//     or with the streaming hint in the mixed / hbm forms.
// Two other designs stay compiled for the vmem f32 frame forms (closest and
// any hit, cursors = 1) as the other sides of the A/B that chip_smoke.py
// times, and no entry point reaches them: the first versions (one ray per
// thread, a per-thread stack in local memory, drains as the oracle walks)
// and the persistent kernel with the stack below its top in dynamic shared
// memory, sized from the tree's stack need (TraversalStack<true>).

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

// One Woop row, i, as `drain` tests it (the same f32 ops in the same
// order), read through ldg: true when the triangle is accepted (h updated).
template <bool kWantUv, bool kStreamTris, typename R>
__device__ __forceinline__ bool woop_test(const float4* __restrict__ woop, int i, const R& r,
                                          Hit& h) {
    const float4* w = woop + static_cast<size_t>(i) * 4;
    const float4 wz = ldg<kStreamTris>(w);
    const float Oz = wz.w - r.ox * wz.x - r.oy * wz.y - r.oz * wz.z;
    const float Dz = r.dx * wz.x + r.dy * wz.y + r.dz * wz.z;
    const float inv_dz = 1.0f / Dz;
    const float t = Oz * inv_dz;
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

// Outputs of one ray: (tri, t) always, u and v and the two counters only in
// the forms that keep them.
template <bool kWantUv, bool kStats>
__device__ __forceinline__ void store_hit(const Hit& h, int ray, int* __restrict__ out_tri,
                                          float* __restrict__ out_t, float* __restrict__ out_u,
                                          float* __restrict__ out_v,
                                          int* __restrict__ out_node_tests,
                                          int* __restrict__ out_tri_tests) {
    out_tri[ray] = h.tri;
    out_t[ray] = h.t;
    if constexpr (kWantUv) {
        out_u[ray] = h.u;
        out_v[ray] = h.v;
    }
    if constexpr (kStats) {
        out_node_tests[ray] = h.node_tests;
        out_tri_tests[ray] = h.tri_tests;
    }
}

// The arguments of one traversal launch, as the C ABI gives them
// (leaf_counts and n_counts only for the binary kernel).  The persistent
// kernels take it whole, as a __grid_constant__ parameter.
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
};

// The dynamic shared memory of the shared-memory stacks: entry i of thread
// x at [i * kBlock + x], so a warp's 32 entries of one depth sit in 32
// banks.
extern __shared__ int trace_stack_smem[];

// The traversal stack of one lane: the top in a register, above the
// sentinel kEmpty, and the entries below it in local memory (kShared
// false: the kernel's own array of STACK_SIZE entries, which bind() takes,
// so that the lane's other state can live in registers) or in
// trace_stack_smem (the launch sizes it to the tree's need).  pop() on an
// empty stack returns kEmpty.
template <bool kShared>
struct TraversalStack;

template <>
struct TraversalStack<false> {
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

template <>
struct TraversalStack<true> {
    int top;
    int off;   // the next free entry's index in trace_stack_smem

    __device__ __forceinline__ void bind(int*) {}
    __device__ __forceinline__ void clear() {
        top = kEmpty;
        off = threadIdx.x;
    }
    __device__ __forceinline__ void push(int x) {
        trace_stack_smem[off] = top;
        off += kBlock;
        top = x;
    }
    __device__ __forceinline__ int pop() {
        const int x = top;
        if (x != kEmpty) {
            off -= kBlock;
            top = trace_stack_smem[off];
        }
        return x;
    }
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

// The launch settings of one traversal call that are not kernel arguments.
struct LaunchCtx {
    cudaStream_t stream;
    const void* window_base;
    size_t window_bytes;
    size_t set_aside;
    int design;       // kPersistent, kFirst or kSharedStack
    int stack_need;   // stack entries the tree needs (0 <= need <= STACK_SIZE)
    int* shape;       // host int[4] (grid, blocks per SM, dynamic smem bytes,
                      // SMs), or null
};

// The `design` argument of the C ABI.  The designs but the persistent
// kernel exist only for the vmem f32 frame forms at cursors = 1, and each
// only in the libraries that keep it.
constexpr int kPersistent = 0;   // the persistent kernel, stack in local memory
constexpr int kFirst = 1;        // the first versions: one ray per thread
constexpr int kSharedStack = 2;  // the persistent kernel, stack in shared memory

// Shared memory the runtime reserves per block (sm_90).
constexpr size_t kSmemReserved = 1024;

// The grid of a persistent launch of `kernel` with `smem` bytes of dynamic
// shared memory: the device's SMs x the blocks that fit on one, clipped to
// the blocks n_rays need.  The L1 / shared carveout is the shared memory of
// the blocks the registers allow, and no more: the rest is L1, where the
// local-memory stack lives.  The carveout is an attribute of the kernel,
// not of the launch, and one kernel is launched with a different `smem` for
// each tree, so it is set again before every launch; the occupancy and
// carveout of each (device, kernel, smem) are computed once.
template <typename... Params>
cudaError_t persistent_grid(void (*kernel)(Params...), int n_rays, size_t smem, int out[4]) {
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
        // memory), then the carveout that holds their shared memory and the
        // runtime's reserve of each, the rest left to L1.
        int by_regs = 0, smem_sm = 0;
        err = cudaDeviceGetAttribute(&got.sms, cudaDevAttrMultiProcessorCount, dev);
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
            const size_t want = static_cast<size_t>(by_regs) * (smem + kSmemReserved) * 100;
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
    const long long need = (static_cast<long long>(n_rays) + kBlock - 1) / kBlock;
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
    cudaError_t err = persistent_grid(kernel, n_rays, smem, shape);
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

// A launch of one ray per thread (the first versions) with `smem` bytes of
// dynamic shared memory: ceil(n_rays / kBlock) blocks; shape gets (grid, 0,
// smem, SMs).
template <typename... Params, typename... Args>
cudaError_t launch_per_ray(void (*kernel)(Params...), int n_rays, size_t smem,
                           const LaunchCtx& ctx, Args... args) {
    const int grid = (n_rays + kBlock - 1) / kBlock;
    if (ctx.shape != nullptr) {
        int dev = 0, sms = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return err;
        ctx.shape[0] = grid;
        ctx.shape[1] = 0;
        ctx.shape[2] = static_cast<int>(smem);
        ctx.shape[3] = sms;
    }
    return launch_window(kernel, grid, smem, ctx.stream, ctx.window_base, ctx.window_bytes,
                         ctx.set_aside, args...);
}

// Dynamic shared memory of a shared-memory stack of `need` entries per
// thread (at least one, so that the launch always has the table).  At most
// STACK_SIZE entries: within the 48 KB a launch may take without opting in.
static_assert(STACK_SIZE * kBlock * sizeof(int) <= 48 * 1024, "shared stack above 48 KB");
inline size_t stack_smem(int need) {
    return static_cast<size_t>(need > 0 ? need : 1) * kBlock * sizeof(int);
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
