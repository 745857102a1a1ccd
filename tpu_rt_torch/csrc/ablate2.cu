// Fixed-trip ablation of the binary traversal step, for NVIDIA Hopper.
//
// Replaces: tools/ablate2.py `make_kernel(level)` (:38-170, timed :185-208),
// the probe that timed tpu_rt's packet2 step on a TPU v5e one component at a
// time.  Same method: every level runs a fixed number of iterations over real
// tables, whatever its results, and the time per iteration is
// (t(5N) - t(N)) / 4N from two trip counts (tools/ablate2.py:210-216), so
// launch and set-up cost cancel.
//
// Layout on the card.  A packet is the 32 rays of a warp, which share one
// node cursor, and each warp holds kK packets (the tool's K, as a TPU core
// holds K packets in one loop body).  Packet k of warp w owns rays
// 32 (kK w + k) .. + 31, each a row of 8 floats (origin, direction, the
// accumulator's start, unused), and its cursor starts at k, as in the tool.
// What is per ray stays in the lane's registers: its ray, acc and the two
// ctx rows that level 8 writes (the other four are the run-time zero).  What
// is per packet is held once per warp: the packet's stack and queue (64
// entries each) live in shared memory, one copy per warp (2 KB a warp, 8 KB
// a block; `packet_lists`), where every index is warp-uniform, so a read is
// one broadcast LDS and lane 0 writes, a __syncwarp between.  The tool
// holds this state once per packet too.  (The other way to hold it once per
// warp, lane j keeping slots j and j + 32 in registers read by __shfl_sync,
// took 96 registers at level 8 against 80 and ran 3-4% slower on an H100;
// PERF.md.)  Every form runs without local memory; a minimum of 8 blocks a
// SM (64 registers) spilled at levels 7-8 and ran no faster.
//
// Node records are four float4 loads from a row-major [n, 16] table, Woop
// rows come from a row-major [m, 16] table, both through the read-only path
// (ldg, as the traversal kernels read them); each address is warp-uniform.
// The cursor's record is n mod n_nodes and its Woop row 7 n mod m, for
// run-time table sizes: both remainders divide by an invariant integer
// (int_div.cuh: a multiplier and shift from the host, IMAD.HI and a
// multiply-subtract here), and the in-group wrap of the U Woop rows is a
// conditional reset, so levels 0-6 issue no division or conversion.
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
// is (no fast math).  chip_smoke.py counts each form's global and shared
// loads and stores, votes, shuffles, conversions and FP32 instructions in
// the SASS and checks that they grow level by level, that levels 0-6 hold
// no MUFU.RCP, I2F or F2I and that no form touches local memory.
//
// What bounds it: per iteration and ray, the full step (level 8) is 186 f32
// operations (two span tests of 24, U = 3 Woop tests of 44 with a division
// each, the votes' compares and the hit write), against kK records and kK U
// Woop rows of 64 B per iteration (every warp walks the same cursors):
// operations, at 67 TFLOP/s.  The loop is a chain of dependent loads per
// packet and issues several instructions per f32 operation (the true
// division's correction, the cursor's remainders, the selects), so it runs
// below that bound; the ablation says which component costs what.

#include "int_div.cuh"
#include "trace_common.cuh"

namespace {

using tpu_rt_torch::InvariantDivisor;
using tpu_rt_torch::kBlock;
using tpu_rt_torch::ldg;
using tpu_rt_torch::max_nan;
using tpu_rt_torch::min_nan;

constexpr int kWarp = 32;
constexpr int kWarps = kBlock / kWarp;  // warps of a block
constexpr int kK = 4;                   // packets per warp (tools/ablate2.py K)
constexpr int kU = 3;                   // Woop rows tested per iteration (U)
constexpr int kStackDepth = 64;         // STACK_DEPTH
constexpr int kQueueDepth = 64;         // QUEUE_DEPTH
constexpr int kGroup = 128;             // the roll's aligned group of rows
constexpr unsigned kFull = 0xffffffffu;

// One packet's stack and queue, held once for its warp.
struct PacketLists {
    int stack[kStackDepth];
    int queue[kQueueDepth];
};
__shared__ PacketLists packet_lists[kWarps][kK];

__device__ __forceinline__ int bits(float x) { return __float_as_int(x); }

// float(n) for 0 <= n < 2^31, rounded to nearest as a conversion rounds it:
// the two 16-bit halves are exact floats (2^23 + h - 2^23), the product by
// 2^16 is exact, and the sum rounds once.  No I2F, so that the levels below
// the Woop tests keep their SASS free of conversions.
__device__ __forceinline__ float to_float(int n) {
    const float hi = __int_as_float(0x4B000000 | (n >> 16)) - 8388608.0f;
    const float lo = __int_as_float(0x4B000000 | (n & 0xFFFF)) - 8388608.0f;
    return hi * 65536.0f + lo;
}

// near and far of one child's slab span against the ray's context: the
// tool's `span` (:75-90), NaN-propagating as jnp.minimum / jnp.maximum.  ctx
// rows 0 and 1 are c0 and c1, rows 2-5 are z; the tool reuses row 0 as hit_t.
struct Span {
    float near, far;
};

__device__ __forceinline__ Span span(float lox, float hix, float loy, float hiy, float loz,
                                     float hiz, float c0, float c1, float z) {
    const float idirx = c0, idiry = c1, idirz = z;
    const float oodx = z, oody = z, oodz = z;
    const float hit_t = c0;
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

// One ray of one packet, in its lane's registers: the ray, acc, the ctx rows
// 0 and 1 that level 8 writes (rows 2-5 are the run-time zero) and the
// packet's cursor, uniform over the warp.
struct Lane {
    float ox, oy, oz, dx, dy, dz, acc, ctx0, ctx1;
    int node;
};

// What every step reads: the tables, their sizes as invariant divisors, and
// the run-time zero.
struct Tables {
    const float4* nodes;
    InvariantDivisor node_div;
    const float4* rows;
    InvariantDivisor row_div;
    int zero;
};

// One iteration of level kLevel for packet p, whose stack and queue are
// `lists`.  A function, always inlined, so that the kK packets' state stays
// in registers whatever loop calls it.
template <int kLevel>
__device__ __forceinline__ void step(Lane& p, PacketLists& lists, const Tables& tb, int lane) {
    const int zero = tb.zero;
    const float z = __int_as_float(zero);   // 0.0f that the compiler cannot see
    const int n = p.node;
    int nxt = n + 1;
    if constexpr (kLevel == 0) nxt += n & zero;   // no closed form for the loop
    float4 q0, q1, q2, q3;
    int link0 = 0, link1 = 0;
    if constexpr (kLevel >= 1) {
        const float4* rec = tb.nodes + 4 * tb.node_div.mod(n);
        q3 = ldg<false>(rec + 3);
        link0 = bits(q3.x);
        link1 = bits(q3.y);
        nxt += (link0 % 3) & zero;
        if constexpr (kLevel >= 2) {
            q0 = ldg<false>(rec), q1 = ldg<false>(rec + 1), q2 = ldg<false>(rec + 2);
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
        c0 = span(q0.x, q0.y, q0.z, q0.w, q2.x, q2.y, p.ctx0, p.ctx1, z);
        c1 = span(q1.x, q1.y, q1.z, q1.w, q2.z, q2.w, p.ctx0, p.ctx1, z);
        p.acc = p.acc + __shfl_sync(kFull, c0.near, 0) * 0.0f;
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
        // n >= 0: unsigned remainders by constants are the cheapest.
        const unsigned un = static_cast<unsigned>(n);
        const int sp = static_cast<int>(un % (kStackDepth - 1));
        const int qw = static_cast<int>(un % kQueueDepth);
        if (lane == 0) {
            if (any0) lists.stack[sp] = link0;
            if (any1) lists.queue[qw] = link1;
        }
        __syncwarp();
        const int popped = lists.stack[max(sp - 1, 0)];
        const int qr = lists.queue[(un + 1) % kQueueDepth];
        const int pq = static_cast<int>(static_cast<unsigned>(popped) + static_cast<unsigned>(qr));
        nxt += (pq % 3) & zero;
    }
    if constexpr (kLevel >= 6) {
        const int ti = tb.row_div.mod(7 * n);
        const int tw = bits(ldg<false>(tb.rows + 4 * ti + 3).x);
        nxt += (tw % 3) & zero;
        if constexpr (kLevel >= 7) {
            const int group = ti & ~(kGroup - 1);
            const int width = min(kGroup, tb.row_div.d - group);
            int j = ti - group;   // (ti - group + u) mod width, u = 0, 1, ...
            float hh = p.acc;
#pragma unroll
            for (int u = 0; u < kU; ++u) {
                const float4* w = tb.rows + 4 * (group + j);
                const float4 a = ldg<false>(w), b = ldg<false>(w + 1), c = ldg<false>(w + 2);
                const float oz_t = a.w - p.ox * a.x - p.oy * a.y - p.oz * a.z;
                const float dz_t = p.dx * a.x + p.dy * a.y + p.dz * a.z;
                const float t = oz_t / dz_t;
                const float uu = (b.w + p.ox * b.x + p.oy * b.y + p.oz * b.z) +
                                 t * (p.dx * b.x + p.dy * b.y + p.dz * b.z);
                const float vv = (c.w + p.ox * c.x + p.oy * c.y + p.oz * c.z) +
                                 t * (p.dx * c.x + p.dy * c.y + p.dz * c.z);
                const bool ok = (t > 0.0f) & (uu >= 0.0f) & (vv >= 0.0f) & (uu + vv <= 1.0f);
                hh = ok ? t : hh;
                j = j + 1 == width ? 0 : j + 1;
            }
            p.acc = hh;
        }
    }
    if constexpr (kLevel >= 8) {
        const int htri = bits(p.ctx1);
        const bool ok2 = p.acc > 0.5f;
        p.ctx0 = ok2 ? p.acc : p.ctx0;
        p.ctx1 = __int_as_float(ok2 ? htri + 1 : htri);
    }
    p.node = nxt;
}

// One iteration of every packet of the warp: packet k's step, k = 0..kK-1,
// expanded by the template, so that p[k] stays in registers (under a
// `#pragma unroll` loop over k, level 9's while loop kept p in local
// memory, 160 B a thread).
template <int kLevel, int k = 0>
__device__ __forceinline__ void step_all(Lane (&p)[kK], PacketLists (&lists)[kK], const Tables& tb,
                                         int lane) {
    step<kLevel>(p[k], lists[k], tb, lane);
    if constexpr (k + 1 < kK) step_all<kLevel, k + 1>(p, lists, tb, lane);
}

// Whether any packet of the warp has its cursor below niter (level 9).
template <int k = 0>
__device__ __forceinline__ bool any_below(const Lane (&p)[kK], int niter) {
    if constexpr (k + 1 < kK) {
        return (p[k].node < niter) | any_below<k + 1>(p, niter);
    } else {
        return p[k].node < niter;
    }
}

template <int kLevel>
__global__ void __launch_bounds__(kBlock)
ablate2_kernel(const float4* __restrict__ nodes, InvariantDivisor node_div,
               const float4* __restrict__ rows, InvariantDivisor row_div,
               const float4* __restrict__ rays, int niter, int zero, float* __restrict__ out,
               int* __restrict__ out_node) {
    const int lane = threadIdx.x & (kWarp - 1);
    const int slot = threadIdx.x / kWarp;   // the warp's place in its block
    const int warp = blockIdx.x * kWarps + slot;
    const float z = __int_as_float(zero);
    const Tables tb{nodes, node_div, rows, row_div, zero};
    PacketLists (&lists)[kK] = packet_lists[slot];

    Lane p[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) {
        const int ray = (warp * kK + k) * kWarp + lane;
        const float4 a = rays[2 * ray], b = rays[2 * ray + 1];
        p[k] = Lane{a.x, a.y, a.z, a.w, b.x, b.y, b.z, z, z, k};
        if constexpr (kLevel >= 5) {
            lists[k].stack[lane] = lists[k].stack[lane + kWarp] = 0;
            lists[k].queue[lane] = lists[k].queue[lane + kWarp] = 0;
        }
    }
    if constexpr (kLevel >= 5) __syncwarp();

    if constexpr (kLevel >= 9) {
#pragma unroll 1
        while (any_below(p, niter)) step_all<kLevel>(p, lists, tb, lane);
    } else {
#pragma unroll 1
        for (int i = 0; i < niter; ++i) step_all<kLevel>(p, lists, tb, lane);
    }
#pragma unroll
    for (int k = 0; k < kK; ++k) {
        const int packet = warp * kK + k;
        out[packet * kWarp + lane] = p[k].acc + to_float(p[k].node);
        if (lane == 0) out_node[packet] = p[k].node;
    }
}

// Calls f with the kernel of `level`; false for a level that is not one.
template <typename F>
bool with_level(int level, F&& f) {
    switch (level) {
        case 0: f(ablate2_kernel<0>); return true;
        case 1: f(ablate2_kernel<1>); return true;
        case 2: f(ablate2_kernel<2>); return true;
        case 3: f(ablate2_kernel<3>); return true;
        case 4: f(ablate2_kernel<4>); return true;
        case 5: f(ablate2_kernel<5>); return true;
        case 6: f(ablate2_kernel<6>); return true;
        case 7: f(ablate2_kernel<7>); return true;
        case 8: f(ablate2_kernel<8>); return true;
        case 9: f(ablate2_kernel<9>); return true;
        default: return false;
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
    const InvariantDivisor node_div = tpu_rt_torch::make_divisor(n_nodes);
    const InvariantDivisor row_div = tpu_rt_torch::make_divisor(n_rows);
    cudaError_t err = cudaErrorInvalidValue;
    with_level(level, [&](auto kernel) {
        err = tpu_rt_torch::launch_window(
            kernel, n_rays / (kBlock * kK), 0, static_cast<cudaStream_t>(stream), nullptr, 0, 0,
            static_cast<const float4*>(nodes), node_div, static_cast<const float4*>(rows), row_div,
            static_cast<const float4*>(rays), niter, 0, static_cast<float*>(out),
            static_cast<int*>(out_node));
    });
    return static_cast<int>(err);
}

// The level's kernel on the current device: out[4] = resident blocks per
// SM, registers, local bytes a thread, static shared bytes a block
// (kernel_occupancy); returns the first CUDA error.
extern "C" int ablate2_occupancy(int level, int* out) {
    cudaError_t err = cudaErrorInvalidValue;
    with_level(level, [&](auto kernel) { err = tpu_rt_torch::kernel_occupancy(kernel, kBlock, out); });
    return static_cast<int>(err);
}
