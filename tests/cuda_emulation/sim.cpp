// The emulation's state (cuda_runtime.h): each thread's lane identity, the
// dynamic shared memory (the stack table of the shared-memory stacks, the
// tensor-core kernels' tables), the SM count and blocks per SM that
// launches see, and the grid runner (a block's lanes as threads, its warps'
// and its own barriers, the blocks one after another).
#include "cuda_runtime.h"

#include <thread>
#include <vector>

thread_local dim3 threadIdx, blockIdx;
dim3 blockDim(128);
thread_local SimWarp* sim_warp;
thread_local int sim_lane;
thread_local std::barrier<>* sim_block;
int sim_sms = 2, sim_per_sm = 2;

namespace tpu_rt_torch {
int trace_stack_smem[STACK_SIZE * 128];
alignas(16) float4 mxu_smem[48 * 1024 / sizeof(float4)];
}

void sim_run(unsigned grid, unsigned block, const std::function<void()>& body) {
    for (unsigned b = 0; b < grid; ++b) {
        std::vector<SimWarp> warps(block / 32);
        std::barrier<> block_bar(static_cast<std::ptrdiff_t>(block));
        std::vector<std::thread> lanes;
        for (unsigned t = 0; t < block; ++t) {
            lanes.emplace_back([&, t, b]() {
                threadIdx = dim3(t);
                blockIdx = dim3(b);
                sim_warp = &warps[t / 32];
                sim_lane = static_cast<int>(t % 32);
                sim_block = &block_bar;
                body();
            });
        }
        for (auto& lane : lanes) lane.join();
    }
}

extern "C" void sim_config(int sms, int per_sm) {
    sim_sms = sms;
    sim_per_sm = per_sm;
}
