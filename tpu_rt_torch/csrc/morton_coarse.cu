// The coarse Morton sort of a secondary batch for NVIDIA Hopper: the key
// before, and the permutation after, one stable torch.sort of 32-bit keys
// (tpu_rt_torch/rays/sort_kernel.py; rays/buffer.py sort_batch_coarse).
//
// Replaces no TPU kernel: tpu_rt's morton_sort_device_coarse
// (tpu_rt/rays/buffer.py) is jnp code and jax.lax.sort that XLA fuses.  The
// port's torch chain (rays/buffer.py morton_sort_device_coarse,
// permute_rays, inverse_permutation) builds the 30-bit key through [N, 30]
// int64 temporaries and sorts int64 keys: about 1,900 B of device traffic a
// ray for the key alone and 56 launches a batch, issued at the host's pace.
// Here:
//   - morton_coarse_keys: the batch box (lower corner and extent of the
//     rows whose three origin coordinates are finite; an axis of extent not
//     above 0 gets 1; no such row gives lo = +inf, hi = -inf) as a block
//     reduction and one atomicMin a block and bound on ordered integers,
//     then one thread a ray: q = (origin - lo) / extent * 1023 in f32, NaN
//     to 0, clamped to [0, 1023], truncated, bit i of axis d to key bit
//     3 i + d, one int32 key a ray;
//   - morton_coarse_permute: one thread an output slot j, o = order[j]:
//     origin, dirn, tmin, tmax and slot_to_id gathered from o, and
//     inv[o] = j; then one thread an id: id_to_slot'[id] = inv[id_to_slot[id]].
//
// Exactness: built with -fmad=false and without fast math, and each float
// operation of the key is the IEEE one torch uses (__fsub_rn, __fdiv_rn,
// __fmul_rn), so the keys equal morton_keys_coarse_device's bit for bit.
// Min and max are exact in any order, and a signed zero in the box moves no
// key.  The sort between the two (torch.sort(keys, stable=True)) keeps
// equal keys in index order, so the order, the rays and the maps equal the
// torch chain's.
//
// What bounds it: bytes.  A ray: 12 B read by the box, 12 read and 4
// written by the key; 8 B of order read, 32 B of ray and 4 of slot_to_id
// gathered, 40 written; 8 B of the composition.  A conference AO frame
// (2,457,600 rays) moves about 0.3 GB here and about as much in the sort:
// some 0.2 ms at 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kBoxItems = 16;  // rays a thread in the box kernel
constexpr unsigned kEmpty = 0xFFFFFFFFu;  // the box's start: no finite row
constexpr float kFloatMax = 3.40282347e38f;

// The block's per-warp minima of the box's six words.
__shared__ unsigned box_partial[6][kWarps];

// A float as an unsigned integer of the same order (finite values only).
__device__ __forceinline__ unsigned ordered(float f) {
    const unsigned u = __float_as_uint(f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned o) {
    return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// box[d] = min over finite rows of ordered(origin[d]), box[3 + d] = min of
// ~ordered(origin[d]) (the max); the wrapper fills box with kEmpty first.
__global__ void __launch_bounds__(kBlock)
box_kernel(const float* __restrict__ origin, long long n, unsigned* __restrict__ box) {
    unsigned m[6] = {kEmpty, kEmpty, kEmpty, kEmpty, kEmpty, kEmpty};
    const long long base =
        static_cast<long long>(blockIdx.x) * kBlock * kBoxItems + threadIdx.x;
    for (int k = 0; k < kBoxItems; ++k) {
        const long long i = base + static_cast<long long>(k) * kBlock;
        if (i >= n) break;
        const float x = origin[3 * i], y = origin[3 * i + 1], z = origin[3 * i + 2];
        if (fabsf(x) <= kFloatMax && fabsf(y) <= kFloatMax && fabsf(z) <= kFloatMax) {
            const unsigned ox = ordered(x), oy = ordered(y), oz = ordered(z);
            m[0] = min(m[0], ox);
            m[1] = min(m[1], oy);
            m[2] = min(m[2], oz);
            m[3] = min(m[3], ~ox);
            m[4] = min(m[4], ~oy);
            m[5] = min(m[5], ~oz);
        }
    }
    for (int off = 16; off > 0; off >>= 1) {
        for (int w = 0; w < 6; ++w) m[w] = min(m[w], __shfl_xor_sync(0xffffffffu, m[w], off));
    }
    const int warp = static_cast<int>(threadIdx.x) / 32;
    if (threadIdx.x % 32 == 0) {
        for (int w = 0; w < 6; ++w) box_partial[w][warp] = m[w];
    }
    __syncthreads();
    if (threadIdx.x < 6) {
        unsigned v = kEmpty;
        for (int k = 0; k < kWarps; ++k) v = min(v, box_partial[threadIdx.x][k]);
        if (v != kEmpty) atomicMin(&box[threadIdx.x], v);
    }
}

__global__ void __launch_bounds__(kBlock)
key_kernel(const float* __restrict__ origin, int n, const unsigned* __restrict__ box,
           int* __restrict__ keys) {
    const int i = static_cast<int>(blockIdx.x) * kBlock + static_cast<int>(threadIdx.x);
    if (i >= n) return;
    unsigned key = 0;
    for (int d = 0; d < 3; ++d) {
        const unsigned blo = box[d], bhi = box[3 + d];
        const float lo = blo == kEmpty ? __uint_as_float(0x7F800000u) : from_ordered(blo);
        const float hi = bhi == kEmpty ? __uint_as_float(0xFF800000u) : from_ordered(~bhi);
        const float span = __fsub_rn(hi, lo);
        const float extent = span > 0.0f ? span : 1.0f;
        float q = __fmul_rn(__fdiv_rn(__fsub_rn(origin[3 * static_cast<long long>(i) + d], lo),
                                      extent),
                            1023.0f);
        q = fminf(fmaxf(q, 0.0f), 1023.0f);  // fmaxf takes 0 over a NaN
        const unsigned v = static_cast<unsigned>(q);
        for (int b = 0; b < 10; ++b) key |= ((v >> b) & 1u) << (3 * b + d);
    }
    keys[i] = static_cast<int>(key);
}

__global__ void __launch_bounds__(kBlock)
permute_kernel(const long long* __restrict__ order, int n, const float* __restrict__ origin,
               const float* __restrict__ dirn, const float* __restrict__ tmin,
               const float* __restrict__ tmax, const int* __restrict__ s2i,
               float* __restrict__ out_origin, float* __restrict__ out_dirn,
               float* __restrict__ out_tmin, float* __restrict__ out_tmax,
               int* __restrict__ out_s2i, int* __restrict__ inv) {
    const int j = static_cast<int>(blockIdx.x) * kBlock + static_cast<int>(threadIdx.x);
    if (j >= n) return;
    const long long o = order[j];
    const long long j3 = 3 * static_cast<long long>(j);
    for (int d = 0; d < 3; ++d) {
        out_origin[j3 + d] = origin[3 * o + d];
        out_dirn[j3 + d] = dirn[3 * o + d];
    }
    out_tmin[j] = tmin[o];
    out_tmax[j] = tmax[o];
    out_s2i[j] = s2i[o];
    inv[o] = j;
}

// id_to_slot' = inv[id_to_slot]; a slot outside [0, n) gives -1.
__global__ void __launch_bounds__(kBlock)
compose_kernel(const int* __restrict__ i2s, int n, const int* __restrict__ inv,
               int* __restrict__ out_i2s) {
    const int k = static_cast<int>(blockIdx.x) * kBlock + static_cast<int>(threadIdx.x);
    if (k >= n) return;
    const int s = i2s[k];
    out_i2s[k] = (s >= 0 && s < n) ? inv[s] : -1;
}

cudaLaunchConfig_t config(long long threads, long long per_block, void* stream) {
    cudaLaunchConfig_t c = {};
    c.gridDim = dim3(static_cast<unsigned>((threads + per_block - 1) / per_block));
    c.blockDim = dim3(kBlock);
    c.stream = static_cast<cudaStream_t>(stream);
    return c;
}

int last_error(cudaError_t err) {
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

// C ABI for ctypes (tpu_rt_torch/rays/sort_kernel.py).  n rays' origins [n,
// 3] f32 -> keys [n] i32; box is 6 words of scratch, left holding the
// box's ordered words.  Launches on `stream` (nothing when n is 0); returns
// the first CUDA error.
extern "C" int morton_coarse_keys(const void* origin, int n, void* box, void* keys,
                                  void* stream) {
    if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return static_cast<int>(cudaSuccess);
    cudaError_t err = cudaMemsetAsync(box, 0xFF, 6 * sizeof(unsigned),
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t c = config(n, static_cast<long long>(kBlock) * kBoxItems, stream);
    err = cudaLaunchKernelEx(&c, box_kernel, static_cast<const float*>(origin),
                             static_cast<long long>(n), static_cast<unsigned*>(box));
    if (err != cudaSuccess) return last_error(err);
    c = config(n, kBlock, stream);
    err = cudaLaunchKernelEx(&c, key_kernel, static_cast<const float*>(origin), n,
                             static_cast<const unsigned*>(box), static_cast<int*>(keys));
    return last_error(err);
}

// order [n] i64 (a permutation of [0, n)); rays (origin, dirn [n, 3], tmin,
// tmax [n] f32), slot_to_id and id_to_slot [n] i32 -> the rays and
// slot_to_id gathered through order, id_to_slot' = inv[id_to_slot]; inv [n]
// i32 is scratch, left holding the inverse of order.  All contiguous.
extern "C" int morton_coarse_permute(const void* order, int n, const void* origin,
                                     const void* dirn, const void* tmin, const void* tmax,
                                     const void* s2i, const void* i2s, void* out_origin,
                                     void* out_dirn, void* out_tmin, void* out_tmax,
                                     void* out_s2i, void* out_i2s, void* inv, void* stream) {
    if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return static_cast<int>(cudaSuccess);
    cudaLaunchConfig_t c = config(n, kBlock, stream);
    cudaError_t err = cudaLaunchKernelEx(
        &c, permute_kernel, static_cast<const long long*>(order), n,
        static_cast<const float*>(origin), static_cast<const float*>(dirn),
        static_cast<const float*>(tmin), static_cast<const float*>(tmax),
        static_cast<const int*>(s2i), static_cast<float*>(out_origin),
        static_cast<float*>(out_dirn), static_cast<float*>(out_tmin),
        static_cast<float*>(out_tmax), static_cast<int*>(out_s2i), static_cast<int*>(inv));
    if (err != cudaSuccess) return last_error(err);
    err = cudaLaunchKernelEx(&c, compose_kernel, static_cast<const int*>(i2s), n,
                             static_cast<const int*>(inv), static_cast<int*>(out_i2s));
    return last_error(err);
}
