// Traversal of the 4-wide BVH (QuadBVH) for NVIDIA Hopper, closest hit and
// any hit.
//
// Replaces: tpu_rt/trace/packet2.py `_kernel2` in its 4-wide (`w4`) node-unit
// form with the VPU Woop-triangle drain, want_uv=False -- the Pallas kernel
// behind `trace_packet4` and the `packet4` routing tracer -- in its
// closest-hit form and its any_hit=True form (packet2.py:552-567, :881-883).
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
//   - any hit: the ray writes (tri, t) and returns at its first accepted
//     hit, as the oracle's `done` flag and the reference's per-lane anyHit
//     abort (kepler_dynamic_fetch.cu:376-381) do.  The Pallas kernel keeps
//     the ray in its packet and refuses later hits instead, and orders
//     children by a packet vote, so its occluder may differ; hit vs miss
//     cannot.
// The form is a template parameter with one instantiation each, so the
// closest-hit code carries no any-hit branch.
// With -fmad=false and no fast math, every float op below is the oracle's
// op in the oracle's order, so (tri, t) equal the plain PyTorch version's
// (tpu_rt_torch/trace/quad_kernel.py) bit for bit.
//
// What bounds it: a data-dependent walk.  Each node is one 128-byte record
// (8 float4 loads, one cache line) and each triangle one 64-byte Woop row
// (up to 4 float4 loads); for the bunny both tables (0.8 MB + 9 MB) sit in
// the 50 MB L2, so the bound is load latency and warp divergence, not
// device-memory bandwidth (conference: 2.1 MB + 23.6 MB, in L2 too).  Any
// hit ends a ray at its first occluder, so short AO rays visit few nodes;
// an AO batch's cost is its unoccluded rays, which walk every node their
// segment crosses.  This first version is simple and exact: one ray per
// thread, a per-thread stack in local memory, no packet or
// persistent-thread scheduling yet.
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
// Outputs: tri [N] i32 (-1 miss), t [N] f32 (tmax where missed).

#include <cuda_runtime.h>

#ifndef STACK_SIZE
#error "STACK_SIZE must be defined by the build (tpu_rt_torch/trace/quad_kernel.py)"
#endif

namespace {

constexpr int kSent = 0x7FFFFFFF;
constexpr int kCountShift = 24;
constexpr int kFirstMask = (1 << kCountShift) - 1;
constexpr float kOoeps = 0x1p-80f;
constexpr int kBlock = 128;

// numpy/torch minimum and maximum propagate NaN; fminf/fmaxf drop it.  The
// SENT check already skips the NaN boxes of empty slots; these keep every
// other NaN (a degenerate box) a miss as in the oracle.
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

// Slab test of one child box, as trace_quad_scalar: near = max(max over
// axes of min(lo, hi), tmin), far = min(min over axes of max(lo, hi), t).
__device__ __forceinline__ bool slab(const Ray& r, float hit_t,
                                     float lox, float hix, float loy,
                                     float hiy, float loz, float hiz) {
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
    const float near = r.t_min > near3 ? r.t_min : near3;
    const float far = hit_t < far3 ? hit_t : far3;
    return far >= near;
}

// Test every triangle of one leaf in order; a hit must be strictly nearer.
// The any-hit form returns true at the first accepted triangle; the
// closest-hit form tests them all and returns false.
template <bool kAnyHit>
__device__ __forceinline__ bool drain(const float4* __restrict__ woop, int link,
                                      const Ray& r, float& hit_t, int& hit_tri) {
    const int c = ~link;
    const int first = c & kFirstMask;
    const int count = (c >> kCountShift) & 0xFF;
    for (int i = first; i < first + count; ++i) {
        const float4* w = woop + static_cast<size_t>(i) * 4;
        const float4 wz = w[0];
        const float Oz = wz.w - r.ox * wz.x - r.oy * wz.y - r.oz * wz.z;
        const float Dz = r.dx * wz.x + r.dy * wz.y + r.dz * wz.z;
        const float inv_dz = 1.0f / Dz;
        const float t = Oz * inv_dz;
        if (t > r.t_min && t < hit_t) {
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
                    hit_t = t;
                    hit_tri = __float_as_int(w[3].x);
                    if constexpr (kAnyHit) return true;
                }
            }
        }
    }
    return false;
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kBlock)
quad_trace_kernel(const float4* __restrict__ nodes, int n_nodes,
                  const float4* __restrict__ woop,
                  const float* __restrict__ origin, const float* __restrict__ dirn,
                  const float* __restrict__ tmin, const float* __restrict__ tmax,
                  int* __restrict__ out_tri, float* __restrict__ out_t, int n_rays) {
    const int ray = blockIdx.x * blockDim.x + threadIdx.x;
    if (ray >= n_rays) return;

    float hit_t = tmax[ray];
    int hit_tri = -1;
    if (!(hit_t < 0.0f) && n_nodes > 0) {
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

            // All four slab tests use the hit distance from before this
            // node's leaves are drained, as the oracle does.
            const bool h0 = l0 != kSent && slab(r, hit_t, q0.x, q0.y, q0.z, q0.w, q1.x, q1.y);
            const bool h1 = l1 != kSent && slab(r, hit_t, q1.z, q1.w, q2.x, q2.y, q2.z, q2.w);
            const bool h2 = l2 != kSent && slab(r, hit_t, q3.x, q3.y, q3.z, q3.w, q4.x, q4.y);
            const bool h3 = l3 != kSent && slab(r, hit_t, q4.z, q4.w, q5.x, q5.y, q5.z, q5.w);

            // Visit order: stored order if this ray's direction along the
            // hint axis is >= 0, reversed otherwise.
            const float dh = hint == 0 ? r.dx : (hint == 1 ? r.dy : r.dz);
            const bool fwd = dh >= 0.0f;
            const bool v0 = fwd ? h0 : h3, v1 = fwd ? h1 : h2;
            const bool v2 = fwd ? h2 : h1, v3 = fwd ? h3 : h0;
            const int k0 = fwd ? l0 : l3, k1 = fwd ? l1 : l2;
            const int k2 = fwd ? l2 : l1, k3 = fwd ? l3 : l0;

            if constexpr (kAnyHit) {
                // Stop at the first accepted hit: write it and return.
                if ((v0 && k0 < 0 && drain<true>(woop, k0, r, hit_t, hit_tri)) ||
                    (v1 && k1 < 0 && drain<true>(woop, k1, r, hit_t, hit_tri)) ||
                    (v2 && k2 < 0 && drain<true>(woop, k2, r, hit_t, hit_tri)) ||
                    (v3 && k3 < 0 && drain<true>(woop, k3, r, hit_t, hit_tri))) {
                    break;
                }
            } else {
                if (v0 && k0 < 0) drain<false>(woop, k0, r, hit_t, hit_tri);
                if (v1 && k1 < 0) drain<false>(woop, k1, r, hit_t, hit_tri);
                if (v2 && k2 < 0) drain<false>(woop, k2, r, hit_t, hit_tri);
                if (v3 && k3 < 0) drain<false>(woop, k3, r, hit_t, hit_tri);
            }

            // Inner children: continue with the first in visit order; push
            // the others last-first so the second pops next.  The host
            // (upload_quad) guarantees 3 * tree depth <= STACK_SIZE.
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
    out_tri[ray] = hit_tri;
    out_t[ray] = hit_t;
}

template <bool kAnyHit>
void launch(const void* nodes, int n_nodes, const void* woop, const void* origin,
            const void* dirn, const void* tmin, const void* tmax, void* out_tri,
            void* out_t, int n_rays, cudaStream_t stream) {
    const int grid = (n_rays + kBlock - 1) / kBlock;
    quad_trace_kernel<kAnyHit><<<grid, kBlock, 0, stream>>>(
        static_cast<const float4*>(nodes), n_nodes, static_cast<const float4*>(woop),
        static_cast<const float*>(origin), static_cast<const float*>(dirn),
        static_cast<const float*>(tmin), static_cast<const float*>(tmax),
        static_cast<int*>(out_tri), static_cast<float*>(out_t), n_rays);
}

}  // namespace

// C ABI for ctypes.  `any_hit` picks the instantiation on the host.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int quad_trace_launch(const void* nodes, int n_nodes, const void* woop,
                                 const void* origin, const void* dirn,
                                 const void* tmin, const void* tmax,
                                 void* out_tri, void* out_t, int n_rays,
                                 int any_hit, void* stream) {
    if (n_rays > 0) {
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        if (any_hit) {
            launch<true>(nodes, n_nodes, woop, origin, dirn, tmin, tmax, out_tri, out_t, n_rays, s);
        } else {
            launch<false>(nodes, n_nodes, woop, origin, dirn, tmin, tmax, out_tri, out_t, n_rays, s);
        }
    }
    return static_cast<int>(cudaGetLastError());
}
