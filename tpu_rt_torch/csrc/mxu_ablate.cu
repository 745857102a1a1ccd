// Fixed-trip ablation of the tensor-core leaf test, for NVIDIA Hopper.
//
// Replaces: tools/mxu_ablate.py `make_kernel` (:48-170, timed :174-197),
// the probe that decided on a TPU v5e whether tpu_rt's MXU triangle unit
// pays (packet2.py:78-87).  Same method: every variant runs a fixed number
// of iterations over real Woop rows, whatever its results, and the time per
// iteration is (t(hi) - t(lo)) / (hi - lo) from two trip counts
// (tools/mxu_ablate.py:211-217), so launch and set-up cost cancel.
//
// Each thread holds one ray; iteration i of warp w tests the 8 Woop rows
// starting at (7 i + w) mod (rows - 7) against each of the warp's rays, as
// a fresh closest-hit query (hit distance tmax, no hit), and adds the
// winner's t and tri + 1 to the ray's accumulators, so every variant
// returns a deterministic result its plain version
// (tpu_rt_torch/probes/mxu_ablate.py) checks at a small trip count.
// Variants:
//   scalar  the f32 drain of trace_common.cuh (`drain`) on the 8 rows: the
//           scalar kernels' triangle test (tpu_rt's `vpu`);
//   full    the MXU form's leaf phase (mxu_leaf.cuh): A loaded from the
//           rows, 24 DMMA, the products through shared memory, the
//           epilogue and the leaf's winner;
//   noL     full with A taken from shared memory, built once from rows
//           0..7 (which the epilogue reads too): the cost of loading L;
//   noM     full with each mma replaced by one f64 add and subtract of the
//           lane's own operands: the cost of the tensor-core products;
//   epi0    A loaded and the 24 DMMA run, their results summed in f64:
//           no shared memory, no epilogue.
// tpu_rt's `noT` (the in-loop (16,8) transpose) and `noR` (the
// flat-to-rows relayout) time TPU relayouts that have no counterpart here:
// lane l loads its own A element from the row, and the products reach
// their ray's lane through shared memory in `full` already.
//
// What bounds it: per iteration and warp, 8 rows (512 B, L2-resident for
// bunny) and 24 DMMA of 512 f64 operations each (FP64 tensor peak 67
// TFLOP/s on an H100 SXM), against the scalar drain's 8 x 32 f32 tests.

#include "mxu_leaf.cuh"

namespace {

using namespace tpu_rt_torch;

enum Variant { kScalar = 0, kFull = 1, kNoL = 2, kNoM = 3, kEpi0 = 4 };

template <int kVariant>
__global__ void __launch_bounds__(kBlock)
mxu_ablate_kernel(const float4* __restrict__ woop, int n_rows, const float* __restrict__ origin,
                  const float* __restrict__ dirn, const float* __restrict__ tmin,
                  const float* __restrict__ tmax, int niter, float* __restrict__ out_t,
                  int* __restrict__ out_tri) {
    __shared__ MxuWarp warps[kBlock / 32];
    __shared__ double fixed_a[kBlock / 32][6][32];
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    MxuWarp& s = warps[w];
    const int ray = blockIdx.x * blockDim.x + threadIdx.x;   // n_rays = grid * kBlock
    const int warp = ray >> 5;
    const Ray r = load_ray(origin, dirn, tmin, ray);
    const float t_max = tmax[ray];
    put_ray(s, lane, r, true);
    if constexpr (kVariant == kNoL) {
        const LeafA A = leaf_a<false>(woop, 0, kMxuLeaf, lane);
#pragma unroll
        for (int p = 0; p < 6; ++p) fixed_a[w][p][lane] = A.a[p];
    }
    __syncwarp();

    const int span = n_rows - kMxuLeaf + 1;
    float acc_t = 0.0f;
    int acc_tri = 0;
    double acc_d = 0.0;
    for (int i = 0; i < niter; ++i) {
        const int first = kVariant == kNoL ? 0 : (i * 7 + warp) % span;
        if constexpr (kVariant == kScalar) {
            Hit h{t_max, -1, 0.0f, 0.0f, 0, 0};
            drain<false, false, false, false>(woop, first, kMxuLeaf, r, h);
            acc_t += h.t;
            acc_tri += h.tri + 1;
        } else {
            LeafA A;
            if constexpr (kVariant == kNoL) {
#pragma unroll
                for (int p = 0; p < 6; ++p) A.a[p] = fixed_a[w][p][lane];
            } else {
                A = leaf_a<false>(woop, first, kMxuLeaf, lane);
            }
            if constexpr (kVariant == kEpi0) {
                const int k = lane & 3, n = lane >> 2;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const double bo = k < 3 ? static_cast<double>(s.ray[k][8 * j + n]) : 1.0;
                    const double bd = k < 3 ? static_cast<double>(s.ray[3 + k][8 * j + n]) : 0.0;
#pragma unroll
                    for (int p = 0; p < 6; ++p) {
                        double d0, d1;
                        dmma(A.a[p], (p & 1) ? bd : bo, d0, d1);
                        acc_d += d0 + d1;
                    }
                }
            } else {
                leaf_products<kVariant == kNoM ? Product::kNoMma : Product::kMma>(A, kFullMask, s,
                                                                                  lane);
                const LeafHit b = leaf_best<false>(s, lane, woop, first, kMxuLeaf, r.t_min, t_max);
                const bool take = b.t < t_max;
                acc_t += take ? b.t : t_max;
                acc_tri += take ? b.tri + 1 : 0;
                __syncwarp();   // s.out is rewritten next iteration
            }
        }
    }
    out_t[ray] = kVariant == kEpi0 ? static_cast<float>(acc_d) : acc_t;
    out_tri[ray] = acc_tri;
}

}  // namespace

// C ABI for ctypes (tpu_rt_torch/probes/mxu_ablate.py): n_rays a multiple
// of the block (128), n_rows >= 8 Woop rows of 16 floats.  Launches the
// variant on `stream`; returns the first CUDA error.
extern "C" int mxu_ablate_launch(int variant, const void* woop, int n_rows, const void* origin,
                                 const void* dirn, const void* tmin, const void* tmax,
                                 int n_rays, int niter, void* out_t, void* out_tri,
                                 void* stream) {
    if (n_rays <= 0 || n_rays % kBlock != 0 || n_rows < kMxuLeaf || niter < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int grid = n_rays / kBlock;
    const auto launch = [&](auto kernel) {
        kernel<<<grid, kBlock, 0, s>>>(
            static_cast<const float4*>(woop), n_rows, static_cast<const float*>(origin),
            static_cast<const float*>(dirn), static_cast<const float*>(tmin),
            static_cast<const float*>(tmax), niter, static_cast<float*>(out_t),
            static_cast<int*>(out_tri));
    };
    switch (variant) {
        case kScalar: launch(mxu_ablate_kernel<kScalar>); break;
        case kFull: launch(mxu_ablate_kernel<kFull>); break;
        case kNoL: launch(mxu_ablate_kernel<kNoL>); break;
        case kNoM: launch(mxu_ablate_kernel<kNoM>); break;
        case kEpi0: launch(mxu_ablate_kernel<kEpi0>); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
