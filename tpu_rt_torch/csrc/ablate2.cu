// Fixed-trip ablation of the binary traversal step, for NVIDIA Hopper.
//
// Replaces: tools/ablate2.py `make_kernel(level)` (:38-170, timed :185-208),
// the probe that timed tpu_rt's packet2 step on a TPU v5e one component at a
// time.  Same method: every level runs a fixed number of iterations over real
// tables, whatever its results, and the time per iteration is
// (t(5N) - t(N)) / 4N from two trip counts (tools/ablate2.py:210-216), so
// launch and set-up cost cancel.
//
// Layout on the card: one ray per thread and packet.  A packet is the 32
// rays of a warp, which share one node cursor, and each warp holds kK
// packets (the tool's K: a thread holds one ray of each, as a TPU core holds
// K packets in one loop body).  Packet k of warp w owns rays
// 32 (kK w + k) .. + 31, each a row of 8 floats (origin, direction, the
// accumulator's start, unused), and its cursor starts at k, as in the tool.
// The node record is four float4 loads from a row-major [n, 16] table, the
// Woop rows come from a row-major [m, 16] table; the per-packet stack and
// queue (64 entries each, warp-uniform indices: local memory, as the binary
// kernel's stack) and the per-ray ctx (6 floats, registers) are per-thread
// state that starts at zero.
//
// Levels (cumulative; the tool's :5-9, :50-166):
//   0 the loop alone: acc, and the cursor node; nxt = node + 1
//   1 the record load (the tool's roll): the quad of links 0-1 and slot 14
//   2 the 12 bounds (the tool's jnp.repeat broadcast): three more quads,
//     held in registers; it has no other counterpart here
//   3 the span math of both children against ctx; acc += c0min of the
//     packet's first ray * 0
//   4 the packet votes any0, any1 (__any_sync) and the order bit of slot 14
//   5 the stack and queue: write link0 / link1 where voted, pop, read
//   6 the Woop row load at ti = 7 node mod m (slot 12)
//   7 U Woop tests against rows ti + u, wrapping inside their aligned group
//     of 128 rows as the roll does (a last group of fewer rows wraps at its
//     end); t = Oz / Dz is a true division; an accepted t replaces acc
//   8 the hit writes: ctx 0 (hit t) and ctx 1 (a hit count in its bits)
//   9 level 8 in a loop that runs while any of the warp's packets has its
//     node below niter (the tool's while_loop), not a counted one
// The output is acc + node per ray, and each packet's final node.
//
// Keeping the work live.  The tool adds x - x to the cursor (nxt +
// (link0 % 3) - (link0 % 3)) and x * 0 to acc so that every component feeds
// the result.  nvcc folds x - x, drops the loads behind it, and turns a
// counted loop with nothing live into its closed form, so here each such
// term is (x & zero), where `zero` is a kernel argument that is 0 at run
// time: the compiler cannot drop x, and nxt stays node + 1, a chain of
// dependent loads as in the traversal.  Values that the tool computes at a
// level and reads only at the next (the bounds at 2, three of the four span
// ends at 3) enter the same term at that level only.  x * 0.0f stays as it
// is (no fast math).  chip_smoke.py counts each form's global and local
// loads, votes, shuffles and FP32 instructions in the SASS and checks that
// they grow level by level.
//
// What bounds it: per iteration and ray, the full step (level 8) is 186 f32
// operations (two span tests of 24, U = 3 Woop tests of 44 with a division
// each, the votes' compares and the hit write), against kK records and kK U
// Woop rows of 64 B per iteration (every warp walks the same cursors):
// operations, at 67 TFLOP/s.  The loop is a chain of dependent loads and
// local-memory read-modify-writes per packet, so it runs far from that
// bound; the ablation says which component costs what.

#include "trace_common.cuh"

namespace {

using tpu_rt_torch::kBlock;
using tpu_rt_torch::max_nan;
using tpu_rt_torch::min_nan;

constexpr int kWarp = 32;
constexpr int kK = 4;             // packets per warp (tools/ablate2.py K)
constexpr int kU = 3;             // Woop rows tested per iteration (U)
constexpr int kStackDepth = 64;   // STACK_DEPTH
constexpr int kQueueDepth = 64;   // QUEUE_DEPTH
constexpr int kGroup = 128;       // the roll's aligned group of rows
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int bits(float x) { return __float_as_int(x); }

// near and far of one child's slab span against the packet context: the
// tool's `span` (:75-90), NaN-propagating as jnp.minimum / jnp.maximum.
struct Span {
    float near, far;
};

__device__ __forceinline__ Span span(float lox, float hix, float loy, float hiy, float loz,
                                     float hiz, const float* ctx) {
    const float idirx = ctx[0], idiry = ctx[1], idirz = ctx[2];
    const float oodx = ctx[3], oody = ctx[4], oodz = ctx[5];
    const float hit_t = ctx[0];   // the tool reuses ctx row 0 as hit_t
    const float tx0 = lox * idirx - oodx;
    const float tx1 = hix * idirx - oodx;
    const float ty0 = loy * idiry - oody;
    const float ty1 = hiy * idiry - oody;
    const float tz0 = loz * idirz - oodz;
    const float tz1 = hiz * idirz - oodz;
    const float near = max_nan(max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)),
                               max_nan(min_nan(tz0, tz1), 0.0f));
    const float far = min_nan(min_nan(max_nan(tx0, tx1), max_nan(ty0, ty1)),
                              min_nan(max_nan(tz0, tz1), hit_t));
    return {near, far};
}

template <int kLevel>
__global__ void __launch_bounds__(kBlock)
ablate2_kernel(const float4* __restrict__ nodes, int n_nodes, const float4* __restrict__ rows,
               int n_rows, const float4* __restrict__ rays, int niter, int zero,
               float* __restrict__ out, int* __restrict__ out_node) {
    const int lane = threadIdx.x & (kWarp - 1);
    const int warp = (blockIdx.x * kBlock + threadIdx.x) / kWarp;
    const float z = __int_as_float(zero);   // 0.0f that the compiler cannot see

    float ox[kK], oy[kK], oz[kK], dx[kK], dy[kK], dz[kK], acc[kK];
    float ctx[kK][6];
    int node[kK];
    int stack[kK][kStackDepth], queue[kK][kQueueDepth];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
        const int ray = (warp * kK + k) * kWarp + lane;
        const float4 a = rays[2 * ray], b = rays[2 * ray + 1];
        ox[k] = a.x, oy[k] = a.y, oz[k] = a.z, dx[k] = a.w, dy[k] = b.x, dz[k] = b.y;
        acc[k] = b.z;
        node[k] = k;
#pragma unroll
        for (int j = 0; j < 6; ++j) ctx[k][j] = z;
        if constexpr (kLevel >= 5) {
            for (int j = 0; j < kStackDepth; ++j) stack[k][j] = 0;
            for (int j = 0; j < kQueueDepth; ++j) queue[k][j] = 0;
        }
    }

    const auto step = [&](int k) {
        const int n = node[k];
        int nxt = n + 1;
        if constexpr (kLevel == 0) nxt += n & zero;   // no closed form for the loop
        float4 q0, q1, q2, q3;
        int link0 = 0, link1 = 0;
        if constexpr (kLevel >= 1) {
            const float4* rec = nodes + 4 * (n % n_nodes);
            q3 = rec[3];
            link0 = bits(q3.x);
            link1 = bits(q3.y);
            nxt += (link0 % 3) & zero;
            if constexpr (kLevel >= 2) {
                q0 = rec[0], q1 = rec[1], q2 = rec[2];
            }
            if constexpr (kLevel == 2) {
                nxt += (bits(q0.x) ^ bits(q0.y) ^ bits(q0.z) ^ bits(q0.w) ^ bits(q1.x) ^
                        bits(q1.y) ^ bits(q1.z) ^ bits(q1.w) ^ bits(q2.x) ^ bits(q2.y) ^
                        bits(q2.z) ^ bits(q2.w)) & zero;
            }
        }
        Span c0{}, c1{};
        bool any0 = false, any1 = false;
        if constexpr (kLevel >= 3) {
            // Bounds b0..b11: c0 lo/hi x, y in q0; c1 lo/hi x, y in q1; z of
            // c0 then c1 in q2 (the FlatBVH record).
            c0 = span(q0.x, q0.y, q0.z, q0.w, q2.x, q2.y, ctx[k]);
            c1 = span(q1.x, q1.y, q1.z, q1.w, q2.z, q2.w, ctx[k]);
            acc[k] = acc[k] + __shfl_sync(kFull, c0.near, 0) * 0.0f;
            if constexpr (kLevel == 3) {
                nxt += (bits(c0.far) ^ bits(c1.near) ^ bits(c1.far)) & zero;
            }
        }
        if constexpr (kLevel >= 4) {
            any0 = __any_sync(kFull, c0.far >= c0.near);
            any1 = __any_sync(kFull, c1.far >= c1.near);
            const int enc = bits(q3.z);
            const int swap = ((enc >> 2) ^ enc) & 1;
            nxt += static_cast<int>(any0 && any1 && swap != 0) & zero;
        }
        if constexpr (kLevel >= 5) {
            const int sp = n % (kStackDepth - 1);
            stack[k][sp] = any0 ? link0 : stack[k][sp];
            const int popped = stack[k][max(sp - 1, 0)];
            const int qw = n % kQueueDepth;
            queue[k][qw] = any1 ? link1 : queue[k][qw];
            const int qr = queue[k][(n + 1) % kQueueDepth];
            const int pq = static_cast<int>(static_cast<unsigned>(popped) +
                                            static_cast<unsigned>(qr));
            nxt += (pq % 3) & zero;
        }
        if constexpr (kLevel >= 6) {
            const int ti = (n * 7) % n_rows;
            const int tw = bits(rows[4 * ti + 3].x);
            nxt += (tw % 3) & zero;
            if constexpr (kLevel >= 7) {
                const int group = ti & ~(kGroup - 1);
                const int width = min(kGroup, n_rows - group);
                float hh = acc[k];
#pragma unroll
                for (int u = 0; u < kU; ++u) {
                    const float4* w = rows + 4 * (group + (ti - group + u) % width);
                    const float4 a = w[0], b = w[1], c = w[2];
                    const float oz_t = a.w - ox[k] * a.x - oy[k] * a.y - oz[k] * a.z;
                    const float dz_t = dx[k] * a.x + dy[k] * a.y + dz[k] * a.z;
                    const float t = oz_t / dz_t;
                    const float uu = (b.w + ox[k] * b.x + oy[k] * b.y + oz[k] * b.z) +
                                     t * (dx[k] * b.x + dy[k] * b.y + dz[k] * b.z);
                    const float vv = (c.w + ox[k] * c.x + oy[k] * c.y + oz[k] * c.z) +
                                     t * (dx[k] * c.x + dy[k] * c.y + dz[k] * c.z);
                    const bool ok = (t > 0.0f) & (uu >= 0.0f) & (vv >= 0.0f) & (uu + vv <= 1.0f);
                    hh = ok ? t : hh;
                }
                acc[k] = hh;
            }
        }
        if constexpr (kLevel >= 8) {
            const float ht = ctx[k][0];
            const int htri = bits(ctx[k][1]);
            const bool ok2 = acc[k] > 0.5f;
            ctx[k][0] = ok2 ? acc[k] : ht;
            ctx[k][1] = __int_as_float(ok2 ? htri + 1 : htri);
        }
        node[k] = nxt;
    };

    if constexpr (kLevel >= 9) {
#pragma unroll 1
        for (;;) {
            bool alive = false;
#pragma unroll
            for (int k = 0; k < kK; ++k) alive |= node[k] < niter;
            if (!alive) break;
#pragma unroll
            for (int k = 0; k < kK; ++k) step(k);
        }
    } else {
#pragma unroll 1
        for (int i = 0; i < niter; ++i) {
#pragma unroll
            for (int k = 0; k < kK; ++k) step(k);
        }
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
        const int packet = warp * kK + k;
        out[packet * kWarp + lane] = acc[k] + static_cast<float>(node[k]);
        if (lane == 0) out_node[packet] = node[k];
    }
}

}  // namespace

// C ABI for ctypes (tpu_rt_torch/probes/ablate2.py): n_nodes >= 1 node
// records and n_rows >= 1 Woop rows of 16 floats, n_rays rays of 8 floats (a
// multiple of kBlock kK = 512), 0 <= niter with 7 (niter + kK) < 2^31.
// Launches the level on `stream`; returns the first CUDA error.
extern "C" int ablate2_launch(int level, const void* nodes, int n_nodes, const void* rows,
                              int n_rows, const void* rays, int n_rays, int niter, void* out,
                              void* out_node, void* stream) {
    if (n_nodes < 1 || n_rows < 1 || n_rays <= 0 || n_rays % (kBlock * kK) != 0 || niter < 0 ||
        niter > (0x7fffffff / 7) - kK) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int grid = n_rays / (kBlock * kK);
    const auto launch = [&](auto kernel) {
        kernel<<<grid, kBlock, 0, s>>>(static_cast<const float4*>(nodes), n_nodes,
                                       static_cast<const float4*>(rows), n_rows,
                                       static_cast<const float4*>(rays), niter, 0,
                                       static_cast<float*>(out), static_cast<int*>(out_node));
    };
    switch (level) {
        case 0: launch(ablate2_kernel<0>); break;
        case 1: launch(ablate2_kernel<1>); break;
        case 2: launch(ablate2_kernel<2>); break;
        case 3: launch(ablate2_kernel<3>); break;
        case 4: launch(ablate2_kernel<4>); break;
        case 5: launch(ablate2_kernel<5>); break;
        case 6: launch(ablate2_kernel<6>); break;
        case 7: launch(ablate2_kernel<7>); break;
        case 8: launch(ablate2_kernel<8>); break;
        case 9: launch(ablate2_kernel<9>); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
