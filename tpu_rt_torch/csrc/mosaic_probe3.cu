// The primitives of a row-cursor (packet) traversal schedule, for NVIDIA
// Hopper.
//
// Replaces: tools/mosaic_probe3.py `make_kernel(mode, iters)` (:37-177,
// called in `run` :180-217), the probe that timed on a TPU v5e the pieces of
// a design where one (16, 128) packet holds 16 traversals, one per row of
// 128 rays.  Same method: each mode runs a fixed number of iterations and the
// time per iteration is (t(5 iters) - t(iters)) / 4 iters (:215-217).
//
// Layout on the card: a packet is one block of 16 warps.  Warp r is row r,
// with its own node cursor (warp-uniform, starting at 7 r + 1 as in the
// tool), and lane l holds the row's columns l, l + 32, l + 64 and l + 96 of
// the (16, 128) block x.  The table is the tool's (64, 16, 128) one as a
// row-major [8192, 16] table: node n's record is row n.  The tool's scratch,
// the (2, 16, 64) stack block and the row's stack pointer, is per row: 64
// slots of shared memory and a float in a register, both starting at zero.
// Each packet computes the tool's (16, 128) output acc + float(node of row 0)
// from its own block of x; every packet walks the same table.
//
// Modes (the tool's :45-170):
//   empty         acc + 1, node + 1
//   x16           the 16 rows' acc[r, 0] to int, summed: 16 cross-warp
//                 reads through shared memory (one barrier per iteration)
//   fetch16       each warp loads its row's record, lane l its slot l mod 16;
//                 acc += M[0, 0] (row 0's slot 0, through shared memory) 1e-9
//   fetch16T      fetch16, then the transpose: the row's 16 slots to every
//                 lane of its warp by __shfl_sync (row r's column of M is in
//                 warp r already, so the 16 x 16 transpose is this spread)
//   onehot_stack  push acc[r, 0] into the row's stack (the lane that owns
//                 the slot writes), pop the slot below: the tool's one-hot
//                 max, -3e38 where no slot matches
//   rowstep       the full row step: fetch and spread, both children's spans
//                 of the row against its 128 rays, the row's any as
//                 __any_sync, push and pop, and the next cursor
//   div8 / mul8 / divmul  8 chained f32 divisions / multiplications /
//                 alternating, on each element (-fmad=false: no contraction)
//
// Keeping the work live: fetch16 reads only row 0's M[0, 0], and fetch16T
// only T[0, 0], so every lane folds what it loaded (and spread) into a word
// that enters the output as (word & zero), where `zero` is a kernel
// argument that is 0 at run time; node + 1 without a modulo takes (node &
// zero) so that the loop keeps its increments.  chip_smoke.py counts each
// mode's global loads, shuffles, shared-memory accesses, votes, MUFU.RCP and
// FP32 instructions in the SASS and checks each mode's own work is there.
//
// What bounds it: rowstep per packet and iteration is 21,280 f32
// operations (49 per row on the row's scalars, 10 per element) against 16
// records of 64 B: operations, at 67 TFLOP/s.  The modes that read across
// rows pay a block barrier per iteration; the rest are chains of dependent
// operations per warp.

#include "trace_common.cuh"

namespace {

using tpu_rt_torch::max_nan;
using tpu_rt_torch::min_nan;

constexpr int kRows = 16;                // R
constexpr int kCols = 128;
constexpr int kWarp = 32;
constexpr int kPerLane = kCols / kWarp;  // 4
constexpr int kSlots = 64;               // the stack block's width
constexpr int kTableRows = 64 * 128;     // NB * 128
constexpr int kRecord = 16;
constexpr int kThreads = kRows * kWarp;  // 512
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNoSlot = -3e38f;        // the tool's fill of the one-hot max

enum Mode {
    kEmpty = 0, kX16 = 1, kFetch16 = 2, kFetch16T = 3, kOnehotStack = 4, kRowstep = 5,
    kDiv8 = 6, kMul8 = 7, kDivmul = 8
};

__device__ __forceinline__ int bits(float x) { return __float_as_int(x); }

// The tool's pop: max over the slots of where(iota == j, st, -3e38), i.e.
// slot j when it exists (NaN kept, anything below -3e38 raised to it).
__device__ __forceinline__ float pop_slot(const float* st, int j) {
    if (j < 0 || j >= kSlots) return kNoSlot;
    const float v = st[j];
    return v != v ? v : fmaxf(v, kNoSlot);
}

// One child's span for the row (the tool's rowstep `span` :108-121, before
// its product with acc).
__device__ __forceinline__ void row_span(float lo, float hi, float lo2, float hi2, float lo3,
                                         float hi3, float idir, float ood, float& near,
                                         float& far) {
    const float t0 = lo * idir - ood, t1 = hi * idir - ood;
    const float u0 = lo2 * idir - ood, u1 = hi2 * idir - ood;
    const float v0 = lo3 * idir - ood, v1 = hi3 * idir - ood;
    near = max_nan(max_nan(min_nan(t0, t1), min_nan(u0, u1)), min_nan(v0, v1));
    far = min_nan(min_nan(max_nan(t0, t1), max_nan(u0, u1)), max_nan(v0, v1));
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
mosaic_probe3_kernel(const float* __restrict__ tab, const float* __restrict__ x, int iters,
                     int zero, float* __restrict__ out, int* __restrict__ out_node) {
    __shared__ float stack[kRows][kSlots];
    __shared__ float cross[2][kRows];
    __shared__ int node0;
    const int lane = threadIdx.x & (kWarp - 1);
    const int r = threadIdx.x / kWarp;
    const size_t base = (static_cast<size_t>(blockIdx.x) * kRows + r) * kCols + lane;
    float acc[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[j] = x[base + kWarp * j];
    for (int s = threadIdx.x; s < kRows * kSlots; s += kThreads) stack[s / kSlots][s % kSlots] = 0.0f;
    float spv = 0.0f;     // the row's stack pointer, stack_ref[1][r, 0]
    int node = r * 7 + 1;
    int hold = 0;         // what a lane loaded and nothing else reads
    __syncthreads();

#pragma unroll 1
    for (int i = 0; i < iters; ++i) {
        if constexpr (kMode == kEmpty) {
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) acc[j] = acc[j] + 1.0f;
            node += 1 + (node & zero);
        } else if constexpr (kMode == kX16) {
            if (lane == 0) cross[i & 1][r] = acc[0];
            __syncthreads();
            int s = 0;
#pragma unroll
            for (int q = 0; q < kRows; ++q) s += __float2int_rz(cross[i & 1][q]);
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) acc[j] = acc[j] + 1e-9f;
            node = (node + (s & zero) + 1) % kTableRows;
        } else if constexpr (kMode == kFetch16 || kMode == kFetch16T) {
            const float v = tab[node * kRecord + (lane & (kRecord - 1))];
            float m00 = v;
            if constexpr (kMode == kFetch16T) {
                float t[kRecord];
#pragma unroll
                for (int q = 0; q < kRecord; ++q) t[q] = __shfl_sync(kFull, v, q);
#pragma unroll
                for (int q = 0; q < kRecord; ++q) hold ^= bits(t[q]);
                m00 = t[0];
            } else {
                hold ^= bits(v);
            }
            if (r == 0 && lane == 0) cross[i & 1][0] = m00;
            __syncthreads();
            const float m = cross[i & 1][0];
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) acc[j] = acc[j] + m * 1e-9f;
            node = (node + 1) % kTableRows;
        } else if constexpr (kMode == kOnehotStack) {
            const int spi = __float2int_rz(spv);
            const float a0 = __shfl_sync(kFull, acc[0], 0);
            if (spi >= 0 && spi < kSlots && lane == (spi & (kWarp - 1))) stack[r][spi] = a0;
            __syncwarp();
            const float popped = pop_slot(stack[r], spi - 1);
            spv = fmodf(spv + 1.0f, 60.0f);
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) acc[j] = acc[j] + popped * 1e-12f;
            node += 1 + (node & zero);
            __syncwarp();
        } else if constexpr (kMode == kRowstep) {
            const float v = tab[node * kRecord + (lane & (kRecord - 1))];
            float b[kRecord];
#pragma unroll
            for (int q = 0; q < kRecord; ++q) b[q] = __shfl_sync(kFull, v, q);
            const float idir = __shfl_sync(kFull, acc[0], 0) + 1.0f;   // acc[r, 0] + 1
            const float ood = __shfl_sync(kFull, acc[0], 1);           // acc[r, 1]
            float near0, far0, near1, far1;
            row_span(b[0], b[1], b[2], b[3], b[8], b[9], idir, ood, near0, far0);
            row_span(b[4], b[5], b[6], b[7], b[10], b[11], idir, ood, near1, far1);
            float f0[kPerLane], f1[kPerLane];
            bool h0 = false, h1 = false;
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) {
                const float n0 = near0 * acc[j], n1 = near1 * acc[j];
                f0[j] = far0 * acc[j];
                f1[j] = far1 * acc[j];
                h0 |= f0[j] >= n0;
                h1 |= f1[j] >= n1;
            }
            const bool hit0 = __any_sync(kFull, h0), hit1 = __any_sync(kFull, h1);
            const int link0 = bits(b[12]), link1 = bits(b[13]);
            const int first = hit0 ? link0 : link1;
            const bool push = hit0 && hit1;
            const int spi = __float2int_rz(spv);
            if (push && spi >= 0 && spi < kSlots && lane == (spi & (kWarp - 1))) {
                stack[r][spi] = static_cast<float>(link1);
            }
            __syncwarp();
            const int spi2 = spi + (push ? 1 : 0);
            const float popped = pop_slot(stack[r], spi2 - 1);
            const int nxt = (hit0 || hit1) ? first : __float2int_rz(popped);
            spv = static_cast<float>(((spi2 % 60) + 60) % 60);
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) acc[j] = acc[j] + f0[j] * 1e-12f + f1[j] * 1e-12f;
            const unsigned mag = nxt < 0 ? 0u - static_cast<unsigned>(nxt) : static_cast<unsigned>(nxt);
            node = static_cast<int>(mag % kTableRows);
            __syncwarp();
        } else {
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) {
                float v = acc[j];
#pragma unroll
                for (int q = 0; q < 8; ++q) {
                    const bool div = kMode == kDiv8 || (kMode == kDivmul && q % 2 == 0);
                    v = div ? v / (v + 1.5f) : v * (v + 1.5f);
                }
                acc[j] = v * 1e-6f + acc[j] * 0.5f;
            }
            node += 1 + (node & zero);
        }
    }

    if (threadIdx.x == 0) node0 = node;
    if (lane == 0) out_node[blockIdx.x * kRows + r] = node;
    __syncthreads();
    const float nf = static_cast<float>(node0);
    // x - (+0.0f) is x for every x, -0 and NaN included.
    const float keep = __int_as_float(hold & zero);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) out[base + kWarp * j] = (acc[j] + nf) - keep;
}

}  // namespace

// C ABI for ctypes (tpu_rt_torch/probes/mosaic_probe3.py): the [8192, 16]
// table, x and out [packets, 16, 128], out_node [packets, 16], iters >= 0.
// Launches the mode on `stream`, one block of 16 warps per packet; returns
// the first CUDA error.
extern "C" int mosaic_probe3_launch(int mode, const void* tab, const void* x, int packets,
                                    int iters, void* out, void* out_node, void* stream) {
    if (packets <= 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto launch = [&](auto kernel) {
        kernel<<<packets, kThreads, 0, s>>>(static_cast<const float*>(tab),
                                            static_cast<const float*>(x), iters, 0,
                                            static_cast<float*>(out), static_cast<int*>(out_node));
    };
    switch (mode) {
        case kEmpty: launch(mosaic_probe3_kernel<kEmpty>); break;
        case kX16: launch(mosaic_probe3_kernel<kX16>); break;
        case kFetch16: launch(mosaic_probe3_kernel<kFetch16>); break;
        case kFetch16T: launch(mosaic_probe3_kernel<kFetch16T>); break;
        case kOnehotStack: launch(mosaic_probe3_kernel<kOnehotStack>); break;
        case kRowstep: launch(mosaic_probe3_kernel<kRowstep>); break;
        case kDiv8: launch(mosaic_probe3_kernel<kDiv8>); break;
        case kMul8: launch(mosaic_probe3_kernel<kMul8>); break;
        case kDivmul: launch(mosaic_probe3_kernel<kDivmul>); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
