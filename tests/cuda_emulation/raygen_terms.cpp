// The AO ray generator's kernel (tpu_rt_torch/csrc/raygen_ao.cu) built for
// the host emulation, with its per-ray rotation words and per-sample Halton
// points exported, so that tests/test_torch_kernel_emulation.py can hold
// them bit for bit to the plain version's (generators.py _hash_words,
// _halton2, _halton3).  The library's raygen_ao_launch is the kernel's own.
#include "raygen_ao.cu"

extern "C" void raygen_ao_terms(unsigned seed, unsigned task_offset, int r, int num_samples,
                                unsigned* word, float* hx, float* hy) {
    for (int i = 0; i < r; ++i) {
        word[i] = rotation_word(seed, task_offset + static_cast<unsigned>(i));
    }
    for (int j = 0; j < num_samples; ++j) {
        hx[j] = halton2(static_cast<unsigned>(j));
        hy[j] = halton3(static_cast<unsigned>(j));
    }
}
