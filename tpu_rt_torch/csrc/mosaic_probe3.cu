// The primitives of a row-cursor (packet) traversal schedule, for NVIDIA
// Hopper.
//
// Replaces: tools/mosaic_probe3.py `make_kernel(mode, iters)` (:37-177,
// called in `run` :180-217), the probe that timed on a TPU v5e the pieces of
// a design where one (16, 128) packet holds 16 traversals, one per row of
// 128 rays.  Same method: each mode runs a fixed number of iterations and the
// time per iteration is (t(5 iters) - t(iters)) / 4 iters (:215-217).
//
// Layout on the card: a packet is one block of 4 warps, and each warp holds
// kRowsPerWarp = 4 rows, 8 lanes a row.  Row r has its own node cursor
// (uniform over its 8 lanes, starting at 7 r + 1 as in the tool), and lane s
// of the row holds its columns 32 v + 4 s .. + 3 for v = 0..3 (four float4
// of the (16, 128) block x).  So one warp instruction of a row's scalar work
// (the record, the slab spans, the stack) serves 4 rows, as the TPU's (16, 1)
// column op serves all 16.  The table is the tool's (64, 16, 128) one as a
// row-major [8192, 16] table: node n's record is row n.  The tool's scratch,
// the (2, 16, 64) stack block and the row's stack pointer, is per row: 64
// slots of shared memory (`row_stack`), which the row's owning lane writes,
// and a float in a register, both starting at zero.  Each packet computes
// the tool's (16, 128) output acc + float(node of row 0) from its own block
// of x; every packet walks the same table.  (Two rows a warp, 16 lanes a
// row and 8 warps a packet, ran rowstep 1.38x slower on an H100; PERF.md.)
//
// Modes (the tool's :45-170):
//   empty         acc + 1, node + 1
//   x16           the 16 rows' acc[r, 0] to int, summed: 16 cross-row reads
//                 through shared memory (one barrier of the 4 warps per
//                 iteration)
//   fetch16       each row's 8 lanes load its record, lane s its slots 2 s
//                 and 2 s + 1; acc += M[0, 0] (row 0's slot 0, through shared
//                 memory) 1e-9
//   fetch16T      fetch16, then the transpose: the row's 16 slots to every
//                 lane of the row by 16 __shfl_sync (row r's column of M is
//                 in its lanes already, so the 16 x 16 transpose is this
//                 spread)
//   onehot_stack  push acc[r, 0] into the row's stack (the row's lane that
//                 owns the slot writes), pop the slot below: the tool's
//                 one-hot max, -3e38 where no slot matches
//   rowstep       the full row step: the record as four float4 loads that
//                 the row's lanes share, both children's spans of the row
//                 against its 128 rays, the row's any as its 8 bits of a
//                 __ballot_sync, push and pop, and the next cursor
//   div8 / mul8 / divmul  8 chained f32 divisions / multiplications /
//                 alternating, on each element (-fmad=false: no contraction)
//
// Keeping the work live: fetch16 reads only row 0's M[0, 0], and fetch16T
// only T[0, 0], so every lane folds what it loaded (and spread) into a word
// that enters the output as (word & zero), where `zero` is a kernel
// argument that is 0 at run time; node + 1 without a modulo takes (node &
// zero) so that the loop keeps its increments.  chip_smoke.py counts each
// mode's global loads, shuffles, shared-memory accesses, votes, barriers,
// MUFU.RCP and FP32 instructions in the SASS and checks each mode's own work
// is there.
//
// What bounds it: rowstep per packet and iteration is 21,280 f32
// operations (49 per row on the row's scalars, 10 per element) against 16
// records of 64 B: operations, at 67 TFLOP/s.  The modes that read across
// rows pay a barrier of the packet's 4 warps per iteration; the rest are
// chains of dependent operations per warp.  So the division modes' times
// depend on the layout, through the elements each lane chains: on an H100
// div8 took 5.65 / 9.69 / 17.9 us per iteration on one packet and 15.5 /
// 16.5 / 22.0 us on 528 at 1 / 2 / 4 rows a warp (4 / 8 / 16 elements a
// lane; PERF.md).  Its ratio to mul8 describes this layout, not the card.

#include "trace_common.cuh"

namespace {

using tpu_rt_torch::ldg;
using tpu_rt_torch::max_nan;
using tpu_rt_torch::min_nan;

constexpr int kRows = 16;                             // R
constexpr int kCols = 128;
constexpr int kWarp = 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowLanes = kWarp / kRowsPerWarp;       // 8
constexpr int kVecs = kCols / (4 * kRowLanes);        // float4 of a lane: 4
constexpr int kPerLane = 4 * kVecs;                   // columns of a lane: 16
constexpr int kThreads = kRows * kRowLanes;           // 128, 4 warps
constexpr unsigned kRowBits = (1u << kRowLanes) - 1;  // a row's lanes in a ballot
constexpr int kSlots = 64;                            // the stack block's width
constexpr int kTableRows = 64 * 128;                  // NB * 128
constexpr int kRecord = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNoSlot = -3e38f;                     // the tool's fill of the one-hot max

enum Mode {
    kEmpty = 0, kX16 = 1, kFetch16 = 2, kFetch16T = 3, kOnehotStack = 4, kRowstep = 5,
    kDiv8 = 6, kMul8 = 7, kDivmul = 8
};

// The packet's shared state: the rows' stacks, the cross-row words (double
// buffered, so one barrier an iteration) and row 0's final node.
__shared__ float row_stack[kRows][kSlots];
__shared__ float cross[2][kRows];
__shared__ int node0;

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
    const int lane = threadIdx.x & (kWarp - 1);
    const int sub = lane % kRowLanes;        // the lane's place in its row
    const int lead = lane - sub;             // the row's first lane
    const int r = threadIdx.x / kRowLanes;   // the row
    const unsigned row_bits = kRowBits << lead;
    // Lane s's float4 v holds columns 32 v + 4 s .. + 3: acc[4 v + c].
    const size_t base = (static_cast<size_t>(blockIdx.x) * kRows + r) * kCols + 4 * sub;
    const float4* x4 = reinterpret_cast<const float4*>(x + base);
    float acc[kPerLane];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
        const float4 a = x4[v * kRowLanes];
        acc[4 * v] = a.x, acc[4 * v + 1] = a.y, acc[4 * v + 2] = a.z, acc[4 * v + 3] = a.w;
    }
    for (int s = threadIdx.x; s < kRows * kSlots; s += kThreads) {
        row_stack[s / kSlots][s % kSlots] = 0.0f;
    }
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
            if (sub == 0) cross[i & 1][r] = acc[0];
            __syncthreads();
            int s = 0;
#pragma unroll
            for (int q = 0; q < kRows; ++q) s += __float2int_rz(cross[i & 1][q]);
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) acc[j] = acc[j] + 1e-9f;
            node = (node + (s & zero) + 1) % kTableRows;
        } else if constexpr (kMode == kFetch16 || kMode == kFetch16T) {
            const float2 v = ldg<false>(reinterpret_cast<const float2*>(tab + node * kRecord) + sub);
            float m00 = v.x;
            if constexpr (kMode == kFetch16T) {
                float t[kRecord];
#pragma unroll
                for (int q = 0; q < kRecord; ++q) {
                    t[q] = __shfl_sync(kFull, q % 2 ? v.y : v.x, lead + q / 2);
                }
#pragma unroll
                for (int q = 0; q < kRecord; ++q) hold ^= bits(t[q]);
                m00 = t[0];
            } else {
                hold ^= bits(v.x) ^ bits(v.y);
            }
            if (threadIdx.x == 0) cross[i & 1][0] = m00;
            __syncthreads();
            const float m = cross[i & 1][0];
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) acc[j] = acc[j] + m * 1e-9f;
            node = (node + 1) % kTableRows;
        } else if constexpr (kMode == kOnehotStack) {
            const int spi = __float2int_rz(spv);
            const float a0 = __shfl_sync(kFull, acc[0], lead);
            if (spi >= 0 && spi < kSlots && sub == spi % kRowLanes) row_stack[r][spi] = a0;
            __syncwarp();
            const float popped = pop_slot(row_stack[r], spi - 1);
            spv = fmodf(spv + 1.0f, 60.0f);
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) acc[j] = acc[j] + popped * 1e-12f;
            node += 1 + (node & zero);
            __syncwarp();
        } else if constexpr (kMode == kRowstep) {
            const float4* rec = reinterpret_cast<const float4*>(tab + node * kRecord);
            const float4 q0 = ldg<false>(rec), q1 = ldg<false>(rec + 1);
            const float4 q2 = ldg<false>(rec + 2), q3 = ldg<false>(rec + 3);
            const float idir = __shfl_sync(kFull, acc[0], lead) + 1.0f;   // acc[r, 0] + 1
            const float ood = __shfl_sync(kFull, acc[1], lead);           // acc[r, 1]
            float near0, far0, near1, far1;
            row_span(q0.x, q0.y, q0.z, q0.w, q2.x, q2.y, idir, ood, near0, far0);
            row_span(q1.x, q1.y, q1.z, q1.w, q2.z, q2.w, idir, ood, near1, far1);
            bool h0 = false, h1 = false;
#pragma unroll
            for (int j = 0; j < kPerLane; ++j) {
                const float n0 = near0 * acc[j], n1 = near1 * acc[j];
                const float f0 = far0 * acc[j], f1 = far1 * acc[j];
                h0 |= f0 >= n0;
                h1 |= f1 >= n1;
                acc[j] = acc[j] + f0 * 1e-12f + f1 * 1e-12f;
            }
            const bool hit0 = (__ballot_sync(kFull, h0) & row_bits) != 0;
            const bool hit1 = (__ballot_sync(kFull, h1) & row_bits) != 0;
            const int link0 = bits(q3.x), link1 = bits(q3.y);
            const int first = hit0 ? link0 : link1;
            const bool push = hit0 && hit1;
            const int spi = __float2int_rz(spv);
            if (push && spi >= 0 && spi < kSlots && sub == spi % kRowLanes) {
                row_stack[r][spi] = static_cast<float>(link1);
            }
            __syncwarp();
            const int spi2 = spi + (push ? 1 : 0);
            const float popped = pop_slot(row_stack[r], spi2 - 1);
            const int nxt = (hit0 || hit1) ? first : __float2int_rz(popped);
            spv = static_cast<float>(((spi2 % 60) + 60) % 60);
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
    if (sub == 0) out_node[blockIdx.x * kRows + r] = node;
    __syncthreads();
    const float nf = static_cast<float>(node0);
    // x - (+0.0f) is x for every x, -0 and NaN included.
    const float keep = __int_as_float(hold & zero);
    float4* o4 = reinterpret_cast<float4*>(out + base);
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
        o4[v * kRowLanes] = make_float4((acc[4 * v] + nf) - keep, (acc[4 * v + 1] + nf) - keep,
                                        (acc[4 * v + 2] + nf) - keep, (acc[4 * v + 3] + nf) - keep);
    }
}

// Calls f with the kernel of `mode`; false for a mode that is not one.
template <typename F>
bool with_mode(int mode, F&& f) {
    switch (mode) {
        case kEmpty: f(mosaic_probe3_kernel<kEmpty>); return true;
        case kX16: f(mosaic_probe3_kernel<kX16>); return true;
        case kFetch16: f(mosaic_probe3_kernel<kFetch16>); return true;
        case kFetch16T: f(mosaic_probe3_kernel<kFetch16T>); return true;
        case kOnehotStack: f(mosaic_probe3_kernel<kOnehotStack>); return true;
        case kRowstep: f(mosaic_probe3_kernel<kRowstep>); return true;
        case kDiv8: f(mosaic_probe3_kernel<kDiv8>); return true;
        case kMul8: f(mosaic_probe3_kernel<kMul8>); return true;
        case kDivmul: f(mosaic_probe3_kernel<kDivmul>); return true;
        default: return false;
    }
}

}  // namespace

// C ABI for ctypes (tpu_rt_torch/probes/mosaic_probe3.py): the [8192, 16]
// table, x and out [packets, 16, 128], out_node [packets, 16], iters >= 0;
// tab, x and out 16-byte aligned.  Launches the mode on `stream`, one block
// of 4 warps per packet; returns the first CUDA error.
extern "C" int mosaic_probe3_launch(int mode, const void* tab, const void* x, int packets,
                                    int iters, void* out, void* out_node, void* stream) {
    if (packets <= 0 || iters < 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(packets);
    config.blockDim = dim3(kThreads);
    config.stream = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaErrorInvalidValue;
    with_mode(mode, [&](auto kernel) {
        err = cudaLaunchKernelEx(&config, kernel, static_cast<const float*>(tab),
                                 static_cast<const float*>(x), iters, 0, static_cast<float*>(out),
                                 static_cast<int*>(out_node));
        const cudaError_t last = cudaGetLastError();
        if (err == cudaSuccess) err = last;
    });
    return static_cast<int>(err);
}

// The mode's kernel on the current device: out[4] = resident blocks
// (packets) per SM, registers, local bytes a thread, static shared bytes a
// block (kernel_occupancy); returns the first CUDA error.
extern "C" int mosaic_probe3_occupancy(int mode, int* out) {
    cudaError_t err = cudaErrorInvalidValue;
    with_mode(mode, [&](auto kernel) { err = tpu_rt_torch::kernel_occupancy(kernel, kThreads, out); });
    return static_cast<int>(err);
}
