// Division by an integer that is fixed for a launch, without a division
// instruction (the card has none: `n % d` by a run-time d compiles to a
// float reciprocal, MUFU.RCP, with conversions and corrections around it).
//
// Granlund and Montgomery, "Division by invariant integers using
// multiplication" (PLDI 1994), Theorem 4.2 with N = 32: for d >= 1,
// l = ceil(log2 d) and m = floor(2^(32 + l) / d) + 1, which satisfy
// 2^(32 + l) < m d <= 2^(32 + l) + 2^l, floor(n / d) = floor(m n / 2^(32 + l))
// for every 0 <= n < 2^32.  m lies in [2^32, 2^33): it needs 33 bits for
// every d, so the card keeps its low 32 bits and adds n back:
//   q = (n + umulhi(m - 2^32, n)) >> l,
// exact while the sum stays below 2^32, which 0 <= n < 2^31 guarantees.
// The host computes (m - 2^32, l) once per launch (make_divisor); the
// card spends an IMAD.HI, an add, a shift and a multiply-subtract per
// remainder.  tests/cuda_emulation/int_div_check.cpp holds mod() to `%` on
// divisors 1 to 2^24 and numerators up to 2^31 - 1.
#pragma once

#include <cuda_runtime.h>

namespace tpu_rt_torch {

struct InvariantDivisor {
    unsigned low;   // m - 2^32
    int shift;      // l
    int d;

    // n mod d, for 0 <= n < 2^31.
    __device__ __forceinline__ int mod(int n) const {
        const unsigned u = static_cast<unsigned>(n);
        const unsigned q = (u + __umulhi(low, u)) >> shift;
        return static_cast<int>(u - q * static_cast<unsigned>(d));
    }
};

// The divisor's constants, on the host; d >= 1.
inline InvariantDivisor make_divisor(int d) {
    int l = 0;
    while ((1ull << l) < static_cast<unsigned long long>(d)) ++l;
    const unsigned long long m = (1ull << (32 + l)) / static_cast<unsigned long long>(d) + 1;
    return {static_cast<unsigned>(m - (1ull << 32)), l, d};
}

}  // namespace tpu_rt_torch
