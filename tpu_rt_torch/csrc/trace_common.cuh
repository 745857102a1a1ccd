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
// occluder) and the culling distance (more node tests) change.  The forms
// without the flag are the code of the first versions.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

namespace tpu_rt_torch {

constexpr float kOoeps = 0x1p-80f;
constexpr int kBlock = 128;

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
__device__ __forceinline__ bool slab_near(const Ray& r, float hit_t,
                                          float lox, float hix, float loy,
                                          float hiy, float loz, float hiz, float& near) {
    const float ax = lox * r.ix - r.oix;
    const float bx = hix * r.ix - r.oix;
    const float ay = loy * r.iy - r.oiy;
    const float by = hiy * r.iy - r.oiy;
    const float az = loz * r.iz - r.oiz;
    const float bz = hiz * r.iz - r.oiz;
    const float near3 = max_nan(max_nan(min_nan(ax, bx), min_nan(ay, by)), min_nan(az, bz));
    const float far3 = min_nan(min_nan(max_nan(ax, bx), max_nan(ay, by)), max_nan(az, bz));
    // Python's max(a, b) / min(a, b) keep `a` unless `b` compares greater /
    // smaller, which decides the NaN cases the same way.
    near = r.t_min > near3 ? r.t_min : near3;
    const float far = hit_t < far3 ? hit_t : far3;
    return far >= near;
}

__device__ __forceinline__ bool slab(const Ray& r, float hit_t,
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

    // Drain the held leaves in the order they were found with
    // drain_link(link), which returns true at an accepted any-hit
    // triangle; then the rest are dropped and this returns true.
    template <typename F>
    __device__ __forceinline__ bool drain(F&& drain_link) {
        while (n > 0) {
            const int l = link[0];
            pop();
            if (drain_link(l)) {
                n = 0;
                return true;
            }
        }
        return false;
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

// Launches kernel<<<grid, kBlock, 0, stream>>>(args...) through
// cudaLaunchKernelEx.  With window_bytes > 0 (the mixed residency) the
// launch carries an L2 access-policy window over [window_base,
// window_base + window_bytes): persisting on hit, streaming on miss,
// hitRatio = min(1, set_aside / window_bytes).  The device's persisting
// set-aside is set to set_aside first when it differs; it stays set until
// trace_l2_release.  The caller clips window_bytes to
// cudaDevAttrMaxAccessPolicyWindowSize.  Every CUDA error is returned:
// there is no launch without the window it asked for.
template <typename... Params, typename... Args>
cudaError_t launch_window(void (*kernel)(Params...), int grid, cudaStream_t stream,
                          const void* window_base, size_t window_bytes, size_t set_aside,
                          Args... args) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(grid);
    config.blockDim = dim3(kBlock);
    config.dynamicSmemBytes = 0;
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
