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
//   full    the MXU form's tile phase (mxu_leaf.cuh): A loaded from the
//           rows, then for each of the 4 tiles 6 DMMA against the tile's
//           rays from the warp's ray table, the epilogue in the D fragments,
//           the butterfly over each column's candidates and the winner's
//           shuffle to its ray's lane;
//   noL     full with A taken from shared memory, built once from rows
//           0..7 (which the epilogue reads too): the cost of loading L;
//   noM     full with each mma replaced by one f64 add and subtract of the
//           lane's own operands: the cost of the tensor-core products;
//   epi0    A loaded and all 24 DMMA run, their results summed in f64:
//           no epilogue, no butterfly.  full skips a tile's 4 u, v products
//           when none of its t is in range, and epi0 never does, so epi0
//           issues at least as many DMMA as full: full - epi0 is a lower
//           bound on the epilogue's cost, not the cost itself;
//   smem    the first version's product-table phase (leaf_products,
//           leaf_best): the 24 DMMA's products through the 7,104-byte table
//           in shared memory, each lane's winner read back from it: what
//           the table costs against full.
// In the probe every lane of a warp tests the same leaf, so each of the 4
// tiles runs it, as a warp whose 4 tiles hold 4 different leaves would:
// the probe isolates the tile phase's products and epilogue, not the
// per-tile choice of leaves (which the MXU form's times show).
// tpu_rt's `noT` (the in-loop (16,8) transpose) and `noR` (the
// flat-to-rows relayout) time TPU relayouts that have no counterpart here:
// lane l loads its own A element from the row, and the epilogue reads the
// products where the mma leaves them.
//
// What bounds it: per iteration and warp, 8 rows (512 B, L2-resident for
// bunny) and 24 DMMA of 512 f64 operations each (FP64 tensor peak 67
// TFLOP/s on an H100 SXM), against the scalar drain's 8 x 32 f32 tests.

#include "mxu_leaf.cuh"

namespace {

using namespace tpu_rt_torch;

enum Variant { kScalar = 0, kFull = 1, kNoL = 2, kNoM = 3, kEpi0 = 4, kSmem = 5 };

// The fixed A of noL, after the warps' ray tables.
__device__ __forceinline__ double (&fixed_a(int warp))[6][32] {
    MxuRays* tables = reinterpret_cast<MxuRays*>(mxu_smem);
    return reinterpret_cast<double (*)[6][32]>(tables + kWarps)[warp];
}

template <int kVariant>
__global__ void __launch_bounds__(kBlock)
mxu_ablate_kernel(const float4* __restrict__ woop, int n_rows, const float* __restrict__ origin,
                  const float* __restrict__ dirn, const float* __restrict__ tmin,
                  const float* __restrict__ tmax, int niter, float* __restrict__ out_t,
                  int* __restrict__ out_tri) {
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int ray = blockIdx.x * blockDim.x + threadIdx.x;   // n_rays = grid * kBlock
    const int warp = ray >> 5;
    const Ray r = load_ray(origin, dirn, tmin, ray);
    const float t_max = tmax[ray];
    if constexpr (kVariant == kSmem) {
        put_ray(mxu_warp(w), lane, r, true);
    } else if constexpr (kVariant != kScalar) {
        put_ray(mxu_rays(w), lane, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, r.t_min, t_max);
    }
    if constexpr (kVariant == kNoL) {
        const LeafA A = tile_b(tile_leaf<false>(woop, 0, n_rows - 1, kMxuLeaf, lane), lane);
#pragma unroll
        for (int p = 0; p < 6; ++p) fixed_a(w)[p][lane] = A.a[p];
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
        } else if constexpr (kVariant == kEpi0) {
            const MxuRays& s = mxu_rays(w);
            const LeafA A =
                tile_b(tile_leaf<false>(woop, first, n_rows - 1, kMxuLeaf, lane), lane);
            const int k = lane & 3, r8 = lane >> 2;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const double ao = reinterpret_cast<const float*>(&s.o[8 * j + r8])[k];
                const double ad = reinterpret_cast<const float*>(&s.d[8 * j + r8])[k];
#pragma unroll
                for (int p = 0; p < 6; ++p) {
                    double d0, d1;
                    dmma((p & 1) ? ad : ao, A.a[p], d0, d1);
                    acc_d += d0 + d1;
                }
            }
        } else {
            LeafHit b = no_hit();
            if constexpr (kVariant == kSmem) {
                MxuWarp& s = mxu_warp(w);
                leaf_products(leaf_a<false>(woop, first, kMxuLeaf, lane), kFullMask, s, lane);
                b = leaf_best<false>(s, lane, woop, first, kMxuLeaf, r.t_min, t_max);
                __syncwarp();   // s.out is rewritten next iteration
            } else {
                const MxuRays& s = mxu_rays(w);
                const TileLeaf L = tile_leaf<false>(woop, first, n_rows - 1, kMxuLeaf, lane);
                LeafA A;
                if constexpr (kVariant == kNoL) {
#pragma unroll
                    for (int p = 0; p < 6; ++p) A.a[p] = fixed_a(w)[p][lane];
                } else {
                    A = tile_b(L, lane);
                }
                constexpr Product kHow = kVariant == kNoM ? Product::kNoMma : Product::kMma;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const TileRay R = tile_ray(s, 8 * j + (lane >> 2), lane);
                    const LeafHit best = tile_best<false, kHow>(A, R, true, L.id, kMxuLeaf, lane);
                    const LeafHit g = row_winner<false>(best, lane & 7);
                    if ((lane >> 3) == j) b = g;
                }
            }
            const bool take = b.t < t_max;
            acc_t += take ? b.t : t_max;
            acc_tri += take ? b.tri + 1 : 0;
        }
    }
    out_t[ray] = kVariant == kEpi0 ? static_cast<float>(acc_d) : acc_t;
    out_tri[ray] = acc_tri;
}

// Dynamic shared memory of a variant's block: the warps' ray tables (or,
// for smem, product tables), and noL's fixed A.
size_t variant_smem(int variant) {
    switch (variant) {
        case kScalar: return 0;
        case kSmem: return kWarps * sizeof(MxuWarp);
        case kNoL: return kWarps * (sizeof(MxuRays) + 6 * 32 * sizeof(double));
        default: return kWarps * sizeof(MxuRays);
    }
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
    const auto launch = [&](auto kernel) {
        return launch_window(kernel, n_rays / kBlock, variant_smem(variant),
                             static_cast<cudaStream_t>(stream), nullptr, 0, 0,
                             static_cast<const float4*>(woop), n_rows,
                             static_cast<const float*>(origin), static_cast<const float*>(dirn),
                             static_cast<const float*>(tmin), static_cast<const float*>(tmax),
                             niter, static_cast<float*>(out_t), static_cast<int*>(out_tri));
    };
    cudaError_t err;
    switch (variant) {
        case kScalar: err = launch(mxu_ablate_kernel<kScalar>); break;
        case kFull: err = launch(mxu_ablate_kernel<kFull>); break;
        case kNoL: err = launch(mxu_ablate_kernel<kNoL>); break;
        case kNoM: err = launch(mxu_ablate_kernel<kNoM>); break;
        case kEpi0: err = launch(mxu_ablate_kernel<kEpi0>); break;
        case kSmem: err = launch(mxu_ablate_kernel<kSmem>); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(err);
}
