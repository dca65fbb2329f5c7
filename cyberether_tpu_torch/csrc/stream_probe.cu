// The stream probe's staged copy for Hopper (sm_90a): K14 staged_copy.
// Replaces manual_kernel / manual_copy of tools/ablation/stream_probe.py,
// a copy that drives its own double-buffered DMA through the TPU's
// on-chip memory.
//
// Contract: o = x, bit for bit, over x (rows, 128) float32, any rows >= 1
// (seen as rows * 32 float4).  `stage_bytes`, a multiple of 16, is the
// counterpart of the TPU probe's chunk.
//
// What bounds it: bytes.  At (131072, 128) it moves 134.2 MB, 0.0401 ms
// at 3.35 TB/s.
//
// Design: each block owns a contiguous share of x and streams it through
// two shared-memory stages of `stage_bytes`.  Chunk i + 1 is fetched with
// cp.async (16 bytes a thread, L1 bypassed) into one stage while chunk i
// is stored out of the other.  A stage is refilled only after the block
// has finished reading it out: the barrier that ends iteration i - 1
// orders the stores of chunk i - 1 before the fetch of chunk i + 1 into
// the same stage.  (The TPU probe starts the next fetch into the slot
// whose store it waits for only an iteration later; that schedule is not
// carried over.)  Any number of chunks works, one included.  The launcher
// sizes the grid to the blocks the card holds at once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__global__ void __launch_bounds__(kThreads)
staged_copy_kernel(const float4* __restrict__ x, float4* __restrict__ o,
                   long long nvec, int stage_vec) {
    extern __shared__ __align__(16) float4 stages[];   // 2 x stage_vec
    const long long per = (nvec + gridDim.x - 1) / gridDim.x;
    const long long v0 = (long long)blockIdx.x * per;
    const long long v1 = min(nvec, v0 + per);
    if (v0 >= v1) return;
    const long long chunks = (v1 - v0 + stage_vec - 1) / stage_vec;

    auto fetch = [&](long long i) {
        float4* st = stages + (i & 1) * stage_vec;
        const long long c0 = v0 + i * stage_vec;
        const int len = (int)min((long long)stage_vec, v1 - c0);
        for (int j = threadIdx.x; j < len; j += kThreads)
            cp_async16(st + j, x + c0 + j);
        cp_async_commit();
    };

    fetch(0);
    for (long long i = 0; i < chunks; ++i) {
        if (i + 1 < chunks) {
            fetch(i + 1);            // into the stage chunk i - 1 left
            cp_async_wait<1>();      // chunk i has landed, i + 1 may not
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();             // every thread's part of chunk i
        const float4* st = stages + (i & 1) * stage_vec;
        const long long c0 = v0 + i * stage_vec;
        const int len = (int)min((long long)stage_vec, v1 - c0);
        for (int j = threadIdx.x; j < len; j += kThreads) o[c0 + j] = st[j];
        __syncthreads();             // the stage is read out: refill it
    }
}

}  // namespace

extern "C" int staged_copy_launch(const void* x, void* o, long long nvec,
                                  int stage_bytes, void* stream) {
    if (nvec < 1 || stage_bytes < 16 || stage_bytes % 16)
        return (int)cudaErrorInvalidValue;
    const int smem = 2 * stage_bytes;
    cudaError_t err = cudaFuncSetAttribute(
        staged_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, staged_copy_kernel, kThreads, smem)) != cudaSuccess)
        return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    const int stage_vec = stage_bytes / 16;
    const long long chunks = (nvec + stage_vec - 1) / stage_vec;
    const long long resident = (long long)sms * per_sm;
    const long long blocks = chunks < resident ? chunks : resident;
    staged_copy_kernel<<<(unsigned)blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(x), static_cast<float4*>(o), nvec,
        stage_vec);
    return (int)cudaGetLastError();
}
