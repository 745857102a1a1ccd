// AO / diffuse-bounce ray generation for NVIDIA Hopper: the whole of
// gen_ao_rays_plain (tpu_rt_torch/raygen/generators.py) in one launch.
//
// Replaces no TPU kernel: tpu_rt's gen_ao_rays (tpu_rt/raygen/generators.py)
// is jnp code that XLA fuses, the counterpart of the reference's
// rayGenAOKernel (RayGenKernels.cu:117-227).  The port's plain PyTorch
// version is some 230 small elementwise launches a batch (the Jenkins mixes
// in masked int64, a 21-step Halton loop, the tangent frame), each a few
// microseconds of device work issued at the host's pace, which left a
// conference AO frame's card idle under raygen for most of its time.  This
// kernel does the same work in one pass: each input hit is read once (by
// the S threads of its samples, from L1) and each output ray written once.
//
// One thread per output ray k = i * S + j (input slot i, sample j):
//   - the backtrack max(t - 1e-4, 0) along the incoming ray;
//   - the hit's normal ((1, 0, 0) on a miss; a clamped row of the table; 0
//     with an empty table, as the plain version's padded row), flipped
//     toward the incoming ray;
//   - the perpendicular (the z test first, then x, else y) and its
//     normalisation, the bi-perpendicular n x q;
//   - the rotation word, c of two Jenkins mixes of (seed + task_offset + i,
//     golden, golden) in native uint32, and the angle (2 pi float(c)) 2^-32;
//   - the Halton (2, 3) point of sample j, the cosine-hemisphere direction
//     x t0 + y t1 + z n and its normalisation;
// and writes origin, dirn, tmin = 0, tmax (max_dist, or -1 on a miss) and
// the identity id k.
//
// Exactness: built with -fmad=false and without fast math (IEEE sqrtf and
// division, cosf / sinf from the CUDA maths library), the float operations
// are the plain version's, in its order.  The rotation words, Halton points,
// tmin, tmax and ids equal the plain version's bit for bit; origins and
// directions may differ from it in the last bits where torch's norm
// reduction and its cos / sin round otherwise (tests/test_torch_raygen.py's
// tolerances: EPS32 times the summed magnitudes for origins, 4 EPS32 for
// directions).
//
// What bounds it: bytes.  Per input hit 32 B (origin, dirn, t, tri) and a
// 12-B normal; per output ray 36 B (origin, dirn, tmin, tmax, id).  A
// conference AO frame (307,200 hits, 8 samples) reads about 13 MB and
// writes 88 MB: some 30 us at 3.35 TB/s.  The threads' arithmetic (the
// two cos / sin pairs, two square roots, three divisions) is a few hundred
// instructions a ray, under that at the card's issue rate.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr unsigned kGolden = 0x9E3779B9u;
constexpr float kTwoPi = 0x1.921fb6p+2f;     // float32(2 pi)
constexpr float kThird = 0x1.555556p-2f;     // float32(1 / 3)
constexpr float kBacktrack = 0x1.a36e2ep-14f;  // float32(1e-4)
constexpr float kInv2_32 = 0x1p-32f;
constexpr int kHalton3Digits = 21;            // 3^21 > 2^32

// The 96-bit Jenkins mixer (RayGenKernels.cu:40-47).
__host__ __device__ __forceinline__ void jenkins_mix(unsigned& a, unsigned& b, unsigned& c) {
    a -= b; a -= c; a ^= c >> 13;
    b -= c; b -= a; b ^= a << 8;
    c -= a; c -= b; c ^= b >> 13;
    a -= b; a -= c; a ^= c >> 12;
    b -= c; b -= a; b ^= a << 16;
    c -= a; c -= b; c ^= b >> 5;
    a -= b; a -= c; a ^= c >> 3;
    b -= c; b -= a; b ^= a << 10;
    c -= a; c -= b; c ^= b >> 15;
}

// The word c of two mixes of (seed + task, golden, golden): the ray's
// random rotation about its normal.
__host__ __device__ __forceinline__ unsigned rotation_word(unsigned seed, unsigned task) {
    unsigned a = seed + task, b = kGolden, c = kGolden;
    jenkins_mix(a, b, c);
    jenkins_mix(a, b, c);
    return c;
}

// Base-2 radical inverse of j + 1 (bit reversal, RayGenKernels.cu:180-205).
__host__ __device__ __forceinline__ float halton2(unsigned j) {
    unsigned v = j + 1u;
    v = ((v >> 1) & 0x55555555u) | ((v & 0x55555555u) << 1);
    v = ((v >> 2) & 0x33333333u) | ((v & 0x33333333u) << 2);
    v = ((v >> 4) & 0x0F0F0F0Fu) | ((v & 0x0F0F0F0Fu) << 4);
    v = ((v >> 8) & 0x00FF00FFu) | ((v & 0x00FF00FFu) << 8);
    v = (v >> 16) | (v << 16);
    return static_cast<float>(v) * kInv2_32;
}

// Base-3 radical inverse of j + 1 (RayGenKernels.cu:207-215).
__host__ __device__ __forceinline__ float halton3(unsigned j) {
    unsigned hc = j + 1u;
    float y = 0.0f, yadd = 1.0f;
    for (int d = 0; d < kHalton3Digits; ++d) {
        yadd = yadd * kThird;
        y = y + static_cast<float>(hc % 3u) * yadd;
        hc /= 3u;
    }
    return y;
}

__global__ void __launch_bounds__(kBlock)
raygen_ao_kernel(const float* __restrict__ in_origin, const float* __restrict__ in_dirn,
                 const float* __restrict__ in_t, const int* __restrict__ in_tri,
                 const float* __restrict__ tri_normal, int n_tri, int n_out, int num_samples,
                 float max_dist, unsigned seed, unsigned task_offset,
                 float* __restrict__ out_origin, float* __restrict__ out_dirn,
                 float* __restrict__ out_tmin, float* __restrict__ out_tmax,
                 int* __restrict__ out_id) {
    const int k = static_cast<int>(blockIdx.x) * kBlock + static_cast<int>(threadIdx.x);
    if (k >= n_out) return;
    const int i = k / num_samples;
    const int j = k - i * num_samples;

    // Backtrack epsilon along the incoming ray (torch.maximum: NaN stays).
    const float dx = in_dirn[3 * i], dy = in_dirn[3 * i + 1], dz = in_dirn[3 * i + 2];
    const float b = in_t[i] - kBacktrack;
    const float back = b < 0.0f ? 0.0f : b;
    const float ox = in_origin[3 * i] + dx * back;
    const float oy = in_origin[3 * i + 1] + dy * back;
    const float oz = in_origin[3 * i + 2] + dz * back;

    // The normal, flipped toward the incoming ray.
    const int tri = in_tri[i];
    float nx = 1.0f, ny = 0.0f, nz = 0.0f;
    if (tri >= 0) {
        nx = 0.0f;
        if (n_tri > 0) {
            const int row = min(tri, n_tri - 1);
            nx = tri_normal[3 * row];
            ny = tri_normal[3 * row + 1];
            nz = tri_normal[3 * row + 2];
        }
    }
    if ((nx * dx + ny * dy) + nz * dz > 0.0f) {
        nx = -nx;
        ny = -ny;
        nz = -nz;
    }

    // Perpendicular (RayGenKernels.cu:152-161): y largest by default, the z
    // test first, then x.
    const float ax = fabsf(nx), ay = fabsf(ny), az = fabsf(nz);
    const float am = fmaxf(fmaxf(ax, ay), az);
    float qx = ny, qy = -nx, qz = 0.0f;
    if (am == az) {
        qx = 0.0f;
        qy = nz;
        qz = -ny;
    } else if (am == ax) {
        qx = -nz;
        qy = 0.0f;
        qz = nx;
    }
    const float ql = sqrtf((qx * qx + qy * qy) + qz * qz);
    qx = qx / ql;
    qy = qy / ql;
    qz = qz / ql;
    const float bx = ny * qz - nz * qy;
    const float by = nz * qx - nx * qz;
    const float bz = nx * qy - ny * qx;

    // The random rotation of the frame about the normal.
    const unsigned c = rotation_word(seed, task_offset + static_cast<unsigned>(i));
    const float angle = (kTwoPi * static_cast<float>(c)) * kInv2_32;
    const float ca = cosf(angle), sa = sinf(angle);
    const float t0x = qx * ca + bx * sa, t0y = qy * ca + by * sa, t0z = qz * ca + bz * sa;
    const float t1x = -qx * sa + bx * ca, t1y = -qy * sa + by * ca, t1z = -qz * sa + bz * ca;

    // Sample j: Halton (2, 3) -> cosine hemisphere.
    const float hx = halton2(static_cast<unsigned>(j));
    const float sangle = kTwoPi * halton3(static_cast<unsigned>(j));
    const float sr = sqrtf(hx);
    const float x = sr * cosf(sangle), y = sr * sinf(sangle);
    const float z = sqrtf(fmaxf((1.0f - x * x) - y * y, 0.0f));

    const float ex = (x * t0x + y * t1x) + z * nx;
    const float ey = (x * t0y + y * t1y) + z * ny;
    const float ez = (x * t0z + y * t1z) + z * nz;
    const float el = sqrtf((ex * ex + ey * ey) + ez * ez);

    out_origin[3 * k] = ox;
    out_origin[3 * k + 1] = oy;
    out_origin[3 * k + 2] = oz;
    out_dirn[3 * k] = ex / el;
    out_dirn[3 * k + 1] = ey / el;
    out_dirn[3 * k + 2] = ez / el;
    out_tmin[k] = 0.0f;
    out_tmax[k] = tri >= 0 ? max_dist : -1.0f;
    out_id[k] = k;
}

}  // namespace

// C ABI for ctypes (tpu_rt_torch/raygen/ao_kernel.py): r input hits (origin
// and dirn [r, 3] f32, t [r] f32, tri [r] i32), the scene's normals [n_tri,
// 3] f32, and outputs of r * num_samples rays (origin, dirn [n, 3], tmin,
// tmax [n] f32, id [n] i32), all contiguous.  Launches on `stream` (nothing
// when there is no output ray); returns the first CUDA error.
extern "C" int raygen_ao_launch(const void* in_origin, const void* in_dirn, const void* in_t,
                                const void* in_tri, const void* tri_normal, int n_tri, int r,
                                int num_samples, float max_dist, unsigned seed,
                                unsigned task_offset, void* out_origin, void* out_dirn,
                                void* out_tmin, void* out_tmax, void* out_id, void* stream) {
    if (r < 0 || num_samples < 1 || n_tri < 0 ||
        static_cast<long long>(r) * num_samples > 0x7fffffffll) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const int n_out = r * num_samples;
    if (n_out == 0) return static_cast<int>(cudaSuccess);
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3((n_out + kBlock - 1) / kBlock);
    config.blockDim = dim3(kBlock);
    config.stream = static_cast<cudaStream_t>(stream);
    const cudaError_t err = cudaLaunchKernelEx(
        &config, raygen_ao_kernel, static_cast<const float*>(in_origin),
        static_cast<const float*>(in_dirn), static_cast<const float*>(in_t),
        static_cast<const int*>(in_tri), static_cast<const float*>(tri_normal), n_tri, n_out,
        num_samples, max_dist, seed, task_offset, static_cast<float*>(out_origin),
        static_cast<float*>(out_dirn), static_cast<float*>(out_tmin),
        static_cast<float*>(out_tmax), static_cast<int*>(out_id));
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : last);
}
