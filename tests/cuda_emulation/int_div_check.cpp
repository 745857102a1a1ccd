// Holds the invariant-integer remainder of tpu_rt_torch/csrc/int_div.cuh to
// `%`, built with g++ against the host emulation
// (tests/test_torch_kernel_emulation.py): every divisor from 1 to 2^24, each
// power of two up to 2^30 and a few divisors up to 2^31 - 1, against the
// numerators 0 <= n < 2^31 at the edges (0, 1, around d and 2d, around the
// largest multiple of d below 2^31, 2^30, 2^31 - 1) and four pseudo-random
// ones.  Every multiplier needs 33 bits (int_div.cuh).  Prints the count of
// cases and exits with 0, or prints the first mismatch and exits with 1.
#include <cstdint>
#include <cstdio>

#include "int_div.cuh"

namespace {

constexpr std::int64_t kTop = 0x7fffffff;   // the largest numerator

bool check(int d, std::uint64_t& cases, std::uint32_t& seed) {
    const tpu_rt_torch::InvariantDivisor div = tpu_rt_torch::make_divisor(d);
    const std::int64_t dd = d, top = kTop / dd * dd;
    std::int64_t ns[20] = {0, 1, dd - 1, dd, dd + 1, 2 * dd - 1, 2 * dd, 2 * dd + 1, top - 1,
                           top, top + 1, kTop - 1, kTop, 1ll << 30, (1ll << 30) - 1, dd * 7 + 3};
    for (int i = 16; i < 20; ++i) {
        seed = seed * 1664525u + 1013904223u;
        ns[i] = seed & 0x7fffffffu;
    }
    for (const std::int64_t n : ns) {
        if (n < 0 || n > kTop) continue;
        ++cases;
        const int got = div.mod(static_cast<int>(n));
        if (got != static_cast<int>(n % dd)) {
            std::printf("mismatch: %lld mod %d = %lld, mod() gives %d\n",
                        static_cast<long long>(n), d, static_cast<long long>(n % dd), got);
            return false;
        }
    }
    return true;
}

}  // namespace

int main() {
    std::uint64_t cases = 0;
    std::uint32_t seed = 12345u;
    for (int d = 1; d <= (1 << 24); ++d) {
        if (!check(d, cases, seed)) return 1;
    }
    for (int s = 25; s <= 30; ++s) {
        if (!check(1 << s, cases, seed) || !check((1 << s) - 1, cases, seed) ||
            !check((1 << s) + 1, cases, seed)) {
            return 1;
        }
    }
    for (const int d : {641, 6700417, 1000000007, 0x7ffffffe, 0x7fffffff}) {
        if (!check(d, cases, seed)) return 1;
    }
    std::printf("%llu cases\n", static_cast<unsigned long long>(cases));
    return 0;
}
