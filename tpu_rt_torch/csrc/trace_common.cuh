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
template <bool kAnyHit, bool kWantUv, bool kStats>
__device__ __forceinline__ bool drain(const float4* __restrict__ woop, int first, int count,
                                      const Ray& r, Hit& h) {
    for (int i = first; i < first + count; ++i) {
        if constexpr (kStats) ++h.tri_tests;
        const float4* w = woop + static_cast<size_t>(i) * 4;
        const float4 wz = w[0];
        const float Oz = wz.w - r.ox * wz.x - r.oy * wz.y - r.oz * wz.z;
        const float Dz = r.dx * wz.x + r.dy * wz.y + r.dz * wz.z;
        const float inv_dz = 1.0f / Dz;
        const float t = Oz * inv_dz;
        if (t > r.t_min && t < h.t) {
            const float4 wu = w[1];
            const float Ox = wu.w + r.ox * wu.x + r.oy * wu.y + r.oz * wu.z;
            const float Dx = r.dx * wu.x + r.dy * wu.y + r.dz * wu.z;
            const float u = Ox + t * Dx;
            if (u >= 0.0f) {
                const float4 wv = w[2];
                const float Oy = wv.w + r.ox * wv.x + r.oy * wv.y + r.oz * wv.z;
                const float Dy = r.dx * wv.x + r.dy * wv.y + r.dz * wv.z;
                const float v = Oy + t * Dy;
                if (v >= 0.0f && u + v <= 1.0f) {
                    h.t = t;
                    h.tri = __float_as_int(w[3].x);
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

}  // namespace tpu_rt_torch
