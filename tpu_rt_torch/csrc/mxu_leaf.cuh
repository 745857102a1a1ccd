// The tensor-core leaf test: the counterpart of tpu_rt's MXU triangle unit
// (tpu_rt/trace/packet2.py:792-862, ray matrix :978-993), shared by the
// binary kernel's MXU form (flat_trace_mxu.cu) and its ablation probe
// (mxu_ablate.cu).
//
// What it computes, for one leaf of up to kMxuLeaf = 8 Woop rows and the 32
// rays of a warp: the six Woop dot products of every (candidate, ray) pair,
//   Oz = w3 - o.w[0:3]   Dz = d.w[0:3]
//   Ox = w7 + o.w[4:7]   Dx = d.w[4:7]
//   Oy = w11 + o.w[8:11] Dy = d.w[8:11]
// as six products L(8 x 4) @ R(4 x 32), where L's rows are the candidates'
// [-w0, -w1, -w2, w3] (Oz), [w0, w1, w2, 0] (Dz), ... and R's columns are
// the rays' [ox, oy, oz, 1] (origin side) or [dx, dy, dz, 0] (direction
// side).  tpu_rt builds one block-diagonal L(6U x 10) against R = [ox, oy,
// oz, 1, dx, dy, dz, tmin, tmax, 0]; splitting it by side makes each
// product one k4 step.
//
// Precision: FP64 mma (mma.sync.aligned.m8n8k4.row.col.f64, the DMMA
// instruction).  A product of two f32 values is exact in f64, so each dot
// product is the exact sum rounded in f64, then rounded once to f32
// (__double2float_rn): the f32 sum the host would get with exact
// arithmetic, except where the f64 rounding of the sum straddles an f32
// rounding boundary.  tpu_rt's MXU unit is "f32-class, not bit-identical";
// TF32 keeps about three digits and would flip hits on rays that graze an
// edge.  The epilogue is f32, built with -fmad=false, as tpu_rt's
// (:824-842): t = Oz / Dz (a true division), u = Ox + t Dx, v = Oy + t Dy;
// a candidate counts if tmin < t < tmax (the ray's tmax, not its shrinking
// hit distance, :831-835) and u, v >= 0, u + v <= 1; the leaf's winner is
// the smallest t, ties to the largest triangle id, with u, v from that
// same candidate (:836-862).  The caller merges it with a strict
// t < hit_t (any hit: only into a ray that holds no hit yet).
//
// Fragment layouts (PTX ISA, mma.m8n8k4 with .f64): lane l holds A[l >> 2]
// [l & 3], B[l & 3][l >> 2] and D[l >> 2][2 (l & 3)], D[l >> 2][2 (l & 3)
// + 1].  D goes through shared memory to the lane of its ray.  An mma needs
// all 32 lanes: a warp runs the leaf phase together, lanes with no ray or
// no pending leaf included.

#pragma once

#include "trace_common.cuh"

namespace tpu_rt_torch {

constexpr int kMxuLeaf = 8;   // candidates per leaf: the m8 of the mma

// A warp's shared memory: its rays (for the B fragments) and the six
// products per candidate and ray, rounded to f32.  The row stride 33 keeps
// the D stores from meeting in one bank.
struct MxuWarp {
    float ray[6][32];                    // ox, oy, oz, dx, dy, dz per lane
    float out[6][kMxuLeaf][33];          // Oz, Dz, Ox, Dx, Oy, Dy [candidate][ray lane]
};

// Writes this lane's ray (zeros for a lane without one) to the warp's table.
__device__ __forceinline__ void put_ray(MxuWarp& s, int lane, const Ray& r, bool have) {
    s.ray[0][lane] = have ? r.ox : 0.0f;
    s.ray[1][lane] = have ? r.oy : 0.0f;
    s.ray[2][lane] = have ? r.oz : 0.0f;
    s.ray[3][lane] = have ? r.dx : 0.0f;
    s.ray[4][lane] = have ? r.dy : 0.0f;
    s.ray[5][lane] = have ? r.dz : 0.0f;
}

// D = A B for one m8n8k4 tile in f64 (C = 0).
__device__ __forceinline__ void dmma(double a, double b, double& d0, double& d1) {
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%4, %5};\n"
                 : "=d"(d0), "=d"(d1)
                 : "d"(a), "d"(b), "d"(0.0), "d"(0.0));
}

// This lane's A elements of the six products of the leaf whose rows are
// first .. first + count - 1 (rows past count are zero): candidate
// m = lane >> 2, column k = lane & 3.
struct LeafA {
    double a[6];   // Oz, Dz, Ox, Dx, Oy, Dy
};

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

// How the six products are formed: by the tensor cores, or (the probe's
// noM) by one f64 add and subtract of the lane's own A and B elements in
// place of each mma.
enum class Product { kMma, kNoMma };

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
            const double b = (p & 1) ? bd : bo;
            double d0, d1;
            if constexpr (kHow == Product::kMma) {
                dmma(A.a[p], b, d0, d1);
            } else {
                d0 = A.a[p] + b;
                d1 = A.a[p] - b;
            }
            s.out[p][n][col] = __double2float_rn(d0);
            s.out[p][n][col + 1] = __double2float_rn(d1);
        }
    }
    __syncwarp();
}

// The leaf's winner for this lane's ray (t = +inf, tri = -1 when no
// candidate counts).
struct LeafHit {
    float t;
    int tri;
    float u, v;
};

template <bool kStream>
__device__ __forceinline__ LeafHit leaf_best(const MxuWarp& s, int lane,
                                             const float4* __restrict__ woop, int first,
                                             int count, float t_min, float t_max) {
    LeafHit b{__int_as_float(0x7f800000), -1, 0.0f, 0.0f};
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
