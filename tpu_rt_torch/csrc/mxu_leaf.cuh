// The tensor-core leaf test: the counterpart of tpu_rt's MXU triangle unit
// (tpu_rt/trace/packet2.py:792-862, ray matrix :978-993), shared by the
// binary kernel's MXU form (flat_trace_mxu.cu) and its ablation probe
// (mxu_ablate.cu).
//
// What it computes, for one leaf of up to kMxuLeaf = 8 Woop rows and the
// rays that hold it: the six Woop dot products of every (candidate, ray)
// pair,
//   Oz = w3 - o.w[0:3]   Dz = d.w[0:3]
//   Ox = w7 + o.w[4:7]   Dx = d.w[4:7]
//   Oy = w11 + o.w[8:11] Dy = d.w[8:11]
// each the dot product of a candidate's row vector L ([-w0, -w1, -w2, w3]
// for Oz, [w0, w1, w2, 0] for Dz, ...) with a ray's [ox, oy, oz, 1]
// (origin side) or [dx, dy, dz, 0] (direction side).  tpu_rt builds one
// block-diagonal L(6U x 10) against R = [ox, oy, oz, 1, dx, dy, dz, tmin,
// tmax, 0]; splitting it by side makes each product one k4 step.
//
// Precision: FP64 mma (mma.sync.aligned.m8n8k4.row.col.f64, the DMMA
// instruction).  A product of two f32 values is exact in f64, so each dot
// product is the exact products summed in f64, then rounded once to f32
// (__double2float_rn); the plain version (tpu_rt_torch/trace/common.py
// mxu_products) sums the same products in the same order.  tpu_rt's MXU
// unit is "f32-class, not bit-identical"; TF32 keeps about three digits and
// would flip hits on rays that graze an edge.  The epilogue is f32, built
// with -fmad=false, as tpu_rt's (:824-842): t = Oz / Dz (a true division),
// u = Ox + t Dx, v = Oy + t Dy; a candidate counts if tmin < t < tmax (the
// ray's tmax, not its shrinking hit distance, :831-835) and u, v >= 0,
// u + v <= 1; the leaf's winner is the smallest t, ties to the largest
// triangle id, with u, v from that same candidate (:836-862).  The caller
// merges it with a strict t < hit_t (any hit: only into a ray that holds no
// hit yet).
//
// Fragment layouts (PTX ISA, mma.m8n8k4 with .f64): lane l holds A[l >> 2]
// [l & 3], B[l & 3][l >> 2] and D[l >> 2][2 (l & 3)], D[l >> 2][2 (l & 3)
// + 1].  An mma needs all 32 lanes: a warp runs the leaf phase together,
// lanes with no ray or no pending leaf included.
//
// Two leaf phases (PERF.md section 6, rows 6c and 8):
//   - The tile phase (MxuRays, tile_leaf, tile_best): an mma per tile of 8
//     rays (A, one row each, from the warp's ray table in shared memory)
//     against a leaf's 8 candidates (B), so lane l holds row l >> 2 against
//     candidates 2 (l & 3) and 2 (l & 3) + 1, and the epilogue runs in the
//     D fragments: t from the Oz and Dz products first, the other four
//     products only when some row has a candidate with t in range; a lane
//     keeps the better of its two candidates, and the 4 lanes of a row
//     reduce to its winner (__shfl_xor_sync 1, 2).  The order (smaller t,
//     larger id, lower candidate) is total on the candidates that count (a
//     NaN t never counts), so the winner does not depend on the
//     reduction's order, and it equals the plain version's first-best scan.
//     The persistent MXU form (4 tiles, each its own leaf, per round) and
//     the probe's full, noL, noM and epi0 run it.
//   - The product-table phase (MxuWarp, leaf_products, leaf_best): one leaf
//     per warp round, the candidates as A against the warp's 32 rays, the
//     six products through a 7,104-byte table in shared memory, each lane's
//     winner read back from it.  Only the probe's smem variant runs it: no
//     trace library keeps it, and it lost to the tile phase (PERF.md).
// Both phases keep their tables in the dynamic shared memory `mxu_smem`,
// which the launch sizes.

#pragma once

#include "trace_common.cuh"

namespace tpu_rt_torch {

constexpr int kMxuLeaf = 8;   // candidates per leaf: the m8 of the mma
constexpr int kWarps = kBlock / 32;

// The dynamic shared memory of the MXU kernels: a table per warp (MxuRays or
// MxuWarp), then what a probe variant adds.
extern __shared__ float4 mxu_smem[];

// D = A B for one m8n8k4 tile in f64 (C = 0).  The host emulation of the
// kernels (tests/cuda_emulation/cuda_runtime.h) defines SIM_DMMA and runs
// the same warp-collective product on the CPU.
__device__ __forceinline__ void dmma(double a, double b, double& d0, double& d1) {
#ifdef SIM_DMMA
    sim_dmma(a, b, d0, d1);
#else
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%4, %5};\n"
                 : "=d"(d0), "=d"(d1)
                 : "d"(a), "d"(b), "d"(0.0), "d"(0.0));
#endif
}

// This lane's A elements of the six products of the leaf whose rows are
// first .. first + count - 1 (rows past count are zero): candidate
// m = lane >> 2, column k = lane & 3.
struct LeafA {
    double a[6];   // Oz, Dz, Ox, Dx, Oy, Dy
};

// The A elements from column k of the candidate's z, u, v rows.
__device__ __forceinline__ LeafA make_a(float wz, float wx, float wy, int k) {
    const bool side = k < 3;   // a direction component; k = 3 is the constant term
    LeafA A;
    A.a[0] = side ? -static_cast<double>(wz) : static_cast<double>(wz);
    A.a[1] = side ? static_cast<double>(wz) : 0.0;
    A.a[2] = wx;
    A.a[3] = side ? static_cast<double>(wx) : 0.0;
    A.a[4] = wy;
    A.a[5] = side ? static_cast<double>(wy) : 0.0;
    return A;
}

template <bool kStream>
__device__ __forceinline__ LeafA leaf_a(const float4* __restrict__ woop, int first, int count,
                                        int lane) {
    const int m = lane >> 2, k = lane & 3;
    float wz = 0.0f, wx = 0.0f, wy = 0.0f;
    if (m < count) {
        const float* w = reinterpret_cast<const float*>(woop + static_cast<size_t>(first + m) * 4);
        wz = load<kStream>(w + k);
        wx = load<kStream>(w + 4 + k);
        wy = load<kStream>(w + 8 + k);
    }
    return make_a(wz, wx, wy, k);
}

// How the six products are formed: by the tensor cores, or (the probe's
// noM) by one f64 add and subtract of the lane's own A and B elements in
// place of each mma.
enum class Product { kMma, kNoMma };

// One (candidate, ray) pair's D elements: the six products (mma) or the
// lane's own sum and difference (noM), of A element a and B element b.
template <Product kHow>
__device__ __forceinline__ void product(double a, double b, double& d0, double& d1) {
    if constexpr (kHow == Product::kMma) {
        dmma(a, b, d0, d1);
    } else {
        d0 = a + b;
        d1 = a - b;
    }
}

// The winner of a leaf for one ray (t = +inf, tri = -1 when no candidate
// counts).
struct LeafHit {
    float t;
    int tri;
    float u, v;
};

__device__ __forceinline__ LeafHit no_hit() {
    return LeafHit{__int_as_float(0x7f800000), -1, 0.0f, 0.0f};
}

// ---------------------------------------------------------------------------
// The tile phase: one leaf per 8-lane tile, the epilogue in the D fragments
// ---------------------------------------------------------------------------
// Here the mma takes the tile's 8 rays as A (rows) and the leaf's 8
// candidates as B (columns): D[r][c] = sum over k of ray r's [o, 1] or
// [d, 0] element k times candidate c's row element k, the same four exact
// products summed in the same order as L @ R.  So lane l holds ray
// r = l >> 2 of the tile against candidates 2 (l & 3) and 2 (l & 3) + 1:
// a ray's 8 candidates sit in its 4 lanes, two in each.

// A warp's rays, one entry per lane: the A rows (o, 1) and (d, 0), and
// (tmin, tmax).  Lane l reads A[r][k] at o[8 j + r][k] (32 banks for the 32
// lanes).
struct MxuRays {
    float4 o[32];
    float4 d[32];
    float2 range[32];
    int row_lane[4][8];   // the MXU form: the lane of each row of a round's tiles
};

__device__ __forceinline__ MxuRays& mxu_rays(int warp) {
    return reinterpret_cast<MxuRays*>(mxu_smem)[warp];
}

// Writes this lane's ray to the warp's table.
__device__ __forceinline__ void put_ray(MxuRays& s, int lane, float ox, float oy, float oz,
                                        float dx, float dy, float dz, float t_min, float t_max) {
    s.o[lane] = float4{ox, oy, oz, 1.0f};
    s.d[lane] = float4{dx, dy, dz, 0.0f};
    s.range[lane] = float2{t_min, t_max};
}

// One tile's leaf as this lane holds it: the leaf's triangle count (at
// most kMxuLeaf), and candidate m = l >> 2's column k = l & 3 of its z, u,
// v rows (this lane's B elements) and its triangle id.  Row first + m is
// read whatever the count, clamped to the table's last row `last`, so that
// the count's load and the rows' go out together; tile_b and tile_best mask
// the candidates past count.
struct TileLeaf {
    int count, id;
    float wz, wx, wy;
};

template <bool kStream>
__device__ __forceinline__ TileLeaf tile_leaf(const float4* __restrict__ woop, int first, int last,
                                              int count, int lane) {
    const int row = max(0, min(first + (lane >> 2), last)), k = lane & 3;
    const float* w = reinterpret_cast<const float*>(woop + static_cast<size_t>(row) * 4);
    return TileLeaf{count, __float_as_int(ldg<kStream>(w + 12)), ldg<kStream>(w + k),
                    ldg<kStream>(w + 4 + k), ldg<kStream>(w + 8 + k)};
}

// This lane's B elements of a tile's leaf (zero past count).
__device__ __forceinline__ LeafA tile_b(const TileLeaf& L, int lane) {
    const bool valid = (lane >> 2) < L.count;
    return make_a(valid ? L.wz : 0.0f, valid ? L.wx : 0.0f, valid ? L.wy : 0.0f, lane & 3);
}

// The lane of the (n + 1)-th set bit of g (n < popc(g)).
__device__ __forceinline__ int nth_lane(unsigned g, int n) {
#pragma unroll
    for (int i = 0; i < kMxuLeaf - 1; ++i) {
        if (i < n) g &= g - 1u;
    }
    return __ffs(static_cast<int>(g)) - 1;
}

// This lane's A elements (row r = lane >> 2 of the mma, column k = lane &
// 3): ray `src`'s [o, 1] and [d, 0] element k in f64, and that ray's range.
struct TileRay {
    double o, d;
    float t_min, t_max;
};

__device__ __forceinline__ TileRay tile_ray(const MxuRays& s, int src, int lane) {
    const int k = lane & 3;
    const float2 rg = s.range[src];
    return TileRay{reinterpret_cast<const float*>(&s.o[src])[k],
                   reinterpret_cast<const float*>(&s.d[src])[k], rg.x, rg.y};
}

// Products kP0 .. kP1 - 1 of the lane's ray row against the leaf's
// candidates (B, as make_a gives a lane its elements), rounded to f32:
// this lane's D elements, the row against candidates 2 (lane & 3) (c0) and
// 2 (lane & 3) + 1 (c1).  Every lane of the warp calls it.
template <int kP0, int kP1, Product kHow>
__device__ __forceinline__ void tile_products(const LeafA& B, const TileRay& R, float (&c0)[6],
                                              float (&c1)[6]) {
#pragma unroll
    for (int p = kP0; p < kP1; ++p) {
        double d0, d1;
        product<kHow>((p & 1) ? R.d : R.o, B.a[p], d0, d1);
        c0[p] = __double2float_rn(d0);
        c1[p] = __double2float_rn(d1);
    }
}

// t = Oz / Dz of a candidate (`valid`: of the leaf, on a row that holds a
// ray).  One that is not divides 0 by 1, not 0 by 0: a division with a
// special operand takes the slow path of the IEEE division, and the whole
// warp with it.
__device__ __forceinline__ float cand_t(const float (&d)[6], bool valid) {
    return (valid ? d[0] : 0.0f) / (valid ? d[1] : 1.0f);
}

// A candidate whose t is in range (`in`: valid, tmin < t < tmax) counts if
// u = Ox + t Dx and v = Oy + t Dy satisfy u, v >= 0 and u + v <= 1 (else
// no_hit()).
__device__ __forceinline__ LeafHit candidate(const float (&d)[6], float t, int id, bool in) {
    const float u = d[2] + t * d[3];
    const float v = d[4] + t * d[5];
    if (in && u >= 0.0f && v >= 0.0f && u + v <= 1.0f) return LeafHit{t, id, u, v};
    return no_hit();
}

// `o` beats `c`: a smaller t, or the same t and a larger id; with
// `first`, also the same t and id (o is the lower candidate).  Bitwise, so
// that it compiles to predicate logic, not branches.
__device__ __forceinline__ bool beats(const LeafHit& o, const LeafHit& c, bool first = false) {
    return (o.t < c.t) | ((o.t == c.t) & ((o.tri > c.tri) | ((o.tri == c.tri) & first)));
}

// One butterfly step over a row's lanes: keeps the better of this lane's
// winner and lane ^ mask's (beats; with the same t and id, the lower
// candidates', which are the partner's when this lane's bit is set).
template <bool kWantUv>
__device__ __forceinline__ void keep_better(LeafHit& c, int lane, int mask) {
    LeafHit o = c;
    o.t = __shfl_xor_sync(kFullMask, c.t, mask);
    o.tri = __shfl_xor_sync(kFullMask, c.tri, mask);
    if constexpr (kWantUv) {
        o.u = __shfl_xor_sync(kFullMask, c.u, mask);
        o.v = __shfl_xor_sync(kFullMask, c.v, mask);
    }
    if (beats(o, c, (lane & mask) != 0)) c = o;
}

// The leaf's winner for the lane's row (R: its ray; `row`: the row holds a
// ray of the group), from the lane's B elements (and the candidate ids the
// lanes loaded with them: tile_leaf) and the leaf's count; no_hit() when
// none counts.  Every lane
// of the warp calls it; each of a row's 4 lanes ends with the row's
// winner.  The Oz and Dz products come first: u and v (4 more mma) only
// when some row has a candidate with t in range.  A lane keeps the better
// of its two candidates (the lower on a tie), and the 4 lanes of a row
// (lane ^ 1, ^ 2) reduce to its winner.  The order (smaller t, larger id,
// lower candidate) is total on the candidates that count, so this is the
// plain version's first-best scan.
template <bool kWantUv, Product kHow = Product::kMma>
__device__ __forceinline__ LeafHit tile_best(const LeafA& B, const TileRay& R, bool row, int id,
                                             int count, int lane) {
    float c0[6], c1[6];
    tile_products<0, 2, kHow>(B, R, c0, c1);
    const int c = 2 * (lane & 3);
    // The ids of the lane's candidates c and c + 1, from lanes 4 c and
    // 4 c + 4, which loaded them with their B elements.
    const int id0 = __shfl_sync(kFullMask, id, 4 * c);
    const int id1 = __shfl_sync(kFullMask, id, 4 * c + 4);
    const bool v0 = row && c < count, v1 = row && c + 1 < count;
    const float t0 = cand_t(c0, v0), t1 = cand_t(c1, v1);
    const bool in0 = v0 && t0 > R.t_min && t0 < R.t_max;
    const bool in1 = v1 && t1 > R.t_min && t1 < R.t_max;
    LeafHit b = no_hit();
    if (__any_sync(kFullMask, in0 || in1)) {
        tile_products<2, 6, kHow>(B, R, c0, c1);
        b = candidate(c0, t0, id0, in0);
        const LeafHit b1 = candidate(c1, t1, id1, in1);
        if (beats(b1, b)) b = b1;
        keep_better<kWantUv>(b, lane, 1);
        keep_better<kWantUv>(b, lane, 2);
    }
    return b;
}

// The winner of row `row_of_lane` as a lane reads it from the row's first
// lane.  Every lane of the warp calls it.
template <bool kWantUv>
__device__ __forceinline__ LeafHit row_winner(const LeafHit& b, int row_of_lane) {
    const int src = 4 * row_of_lane;
    LeafHit got = no_hit();
    got.t = __shfl_sync(kFullMask, b.t, src);
    got.tri = __shfl_sync(kFullMask, b.tri, src);
    if constexpr (kWantUv) {
        got.u = __shfl_sync(kFullMask, b.u, src);
        got.v = __shfl_sync(kFullMask, b.v, src);
    }
    return got;
}

// ---------------------------------------------------------------------------
// The product-table phase: one leaf per warp round (the probe's smem)
// ---------------------------------------------------------------------------

// A warp's shared memory: its rays (for the B fragments) and the six
// products per candidate and ray, rounded to f32.  The row stride 33 keeps
// the D stores from meeting in one bank.
struct MxuWarp {
    float ray[6][32];                    // ox, oy, oz, dx, dy, dz per lane
    float out[6][kMxuLeaf][33];          // Oz, Dz, Ox, Dx, Oy, Dy [candidate][ray lane]
};

__device__ __forceinline__ MxuWarp& mxu_warp(int warp) {
    return reinterpret_cast<MxuWarp*>(mxu_smem)[warp];
}

// Writes this lane's ray (zeros for a lane without one) to the warp's table.
__device__ __forceinline__ void put_ray(MxuWarp& s, int lane, const Ray& r, bool have) {
    s.ray[0][lane] = have ? r.ox : 0.0f;
    s.ray[1][lane] = have ? r.oy : 0.0f;
    s.ray[2][lane] = have ? r.oz : 0.0f;
    s.ray[3][lane] = have ? r.dx : 0.0f;
    s.ray[4][lane] = have ? r.dy : 0.0f;
    s.ray[5][lane] = have ? r.dz : 0.0f;
}

// The products of a leaf's A with the rays of the warp's n8 tiles that hold
// a lane of `group`, into s.out; ends with __syncwarp.  Every lane of the
// warp calls it.
template <Product kHow = Product::kMma>
__device__ __forceinline__ void leaf_products(const LeafA& A, unsigned group, MxuWarp& s,
                                              int lane) {
    const int k = lane & 3, n = lane >> 2;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        if (((group >> (8 * j)) & 0xFFu) == 0) continue;   // the same on every lane
        const int rl = 8 * j + n;
        const double bo = k < 3 ? static_cast<double>(s.ray[k][rl]) : 1.0;
        const double bd = k < 3 ? static_cast<double>(s.ray[3 + k][rl]) : 0.0;
        const int col = 8 * j + 2 * k;
#pragma unroll
        for (int p = 0; p < 6; ++p) {
            double d0, d1;
            product<kHow>(A.a[p], (p & 1) ? bd : bo, d0, d1);
            s.out[p][n][col] = __double2float_rn(d0);
            s.out[p][n][col + 1] = __double2float_rn(d1);
        }
    }
    __syncwarp();
}

// The leaf's winner for this lane's ray from the product table.
template <bool kStream>
__device__ __forceinline__ LeafHit leaf_best(const MxuWarp& s, int lane,
                                             const float4* __restrict__ woop, int first,
                                             int count, float t_min, float t_max) {
    LeafHit b = no_hit();
#pragma unroll
    for (int m = 0; m < kMxuLeaf; ++m) {
        if (m < count) {
            const float t = s.out[0][m][lane] / s.out[1][m][lane];
            const float u = s.out[2][m][lane] + t * s.out[3][m][lane];
            const float v = s.out[4][m][lane] + t * s.out[5][m][lane];
            if (t > t_min && t < t_max && u >= 0.0f && v >= 0.0f && u + v <= 1.0f) {
                const int id = __float_as_int(
                    load<kStream>(&woop[static_cast<size_t>(first + m) * 4 + 3].x));
                if (t < b.t || (t == b.t && id > b.tri)) b = LeafHit{t, id, u, v};
            }
        }
    }
    return b;
}

}  // namespace tpu_rt_torch
