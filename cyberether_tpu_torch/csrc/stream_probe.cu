// The stream probe's staged copy for Hopper (sm_90a): K14 staged_copy.
// Replaces manual_kernel / manual_copy of tools/ablation/stream_probe.py,
// a copy that drives its own double-buffered DMA through the TPU's
// on-chip memory.
//
// Contract: o = x, bit for bit, over x (rows, 128) float32, any rows >= 1
// (seen as rows * 32 float4; x and o 16-byte aligned).  `stage_bytes`, a
// multiple of 16, is the counterpart of the TPU probe's chunk.
//
// What bounds it: bytes.  At (131072, 128) it moves 134.2 MB, 0.0401 ms
// at 3.35 TB/s.
//
// Design: a TMA bulk-copy ring.  x is cut into chunks of `stage_bytes`,
// dealt in turn to a persistent grid, chunk c to block c mod grid, so
// that the blocks stream one window of x at a time (a contiguous share a
// block, 396 streams spread over x, ran 3-4% slower on an H100 80GB HBM3
// at 700 W, ab_spectrum.py --family probes), a grid of the blocks the card
// holds at once (one of as few blocks as take the same rounds of chunks
// ran 2% slower there).  One thread of the block issues every copy, and
// the data never passes through registers:
// - loads: cp.async.bulk global -> shared into a ring of kStages stages
//   (fewer where they pass the 227 KB a block may use: 3 at 64 KB, 2 from
//   76 KB), each completing on its stage's mbarrier by
//   complete_tx::bytes;
// - stores: cp.async.bulk shared -> global of each chunk as soon as it
//   has landed, one bulk group a chunk;
// - both with the L2 policy evict_first: the data is streamed once, and
//   the hint took 2-3% off the time (the same card);
// - a stage is refilled only after its store has read it out: after
//   issuing the store of chunk i, the thread waits until every store but
//   that newest one has read its stage (cp.async.bulk.wait_group.read 1)
//   and refills the stage of chunk i - 1 with chunk i - 1 + stages, so
//   that the ring keeps stages - 1 loads in flight while a store drains.
// Any number of chunks works, one included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;          // one warp; its first thread works
constexpr int kStages = 4;
constexpr int kSmemMax = 227 * 1024;  // a block's dynamic shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(bar) : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    while (!done)
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// bytes from global src into shared dst, completing on bar
__device__ __forceinline__ uint64_t evict_first() {
    uint64_t p;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(p));
    return p;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(evict_first())
        : "memory");
}

// bytes from shared src to global dst, as one bulk group
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           int bytes) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group"
                 ".L2::cache_hint [%0], [%1], %2, %3;"
                 :: "l"(dst), "r"(src), "r"(bytes), "l"(evict_first())
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
staged_copy_kernel(const float4* __restrict__ x, float4* __restrict__ o,
                   long long nvec, int stage_vec, int stages) {
    extern __shared__ __align__(16) unsigned char smem[];   // the ring
    if (threadIdx.x != 0) return;
    // the block's chunks: blockIdx.x + i gridDim.x, i < chunks
    const long long all = (nvec + stage_vec - 1) / stage_vec;
    if (blockIdx.x >= all) return;
    const long long chunks = (all - blockIdx.x + gridDim.x - 1) / gridDim.x;
    const uint32_t ring = smem_addr(smem);
    const int stage_bytes = stage_vec * 16;
    const uint32_t bar0 = ring + stages * stage_bytes;      // 8-aligned
    for (int s = 0; s < stages; ++s) bar_init(bar0 + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");

    // the block's chunk i: its first float4 and its length in bytes
    auto chunk = [&](long long i, int& bytes) {
        const long long c0 = (blockIdx.x + i * gridDim.x) * stage_vec;
        bytes = (int)min((long long)stage_vec, nvec - c0) * 16;
        return c0;
    };
    auto load = [&](long long i) {
        const int s = (int)(i % stages);
        int bytes;
        const long long c0 = chunk(i, bytes);
        bulk_load(ring + s * stage_bytes, x + c0, bytes, bar0 + 8 * s);
    };

    for (long long i = 0; i < chunks && i < stages; ++i) load(i);
    for (long long i = 0; i < chunks; ++i) {
        const int s = (int)(i % stages);
        bar_wait(bar0 + 8 * s, (uint32_t)((i / stages) & 1));
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        int bytes;
        const long long c0 = chunk(i, bytes);
        bulk_store(o + c0, ring + s * stage_bytes, bytes);
        if (i >= 1 && i - 1 + stages < chunks) {
            // the store of chunk i - 1 has read its stage: refill it
            asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
            load(i - 1 + stages);
        }
    }
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

}  // namespace

extern "C" int staged_copy_launch(const void* x, void* o, long long nvec,
                                  int stage_bytes, void* stream) {
    if (nvec < 1 || stage_bytes < 16 || stage_bytes % 16)
        return (int)cudaErrorInvalidValue;
    int stages = kStages;
    while (stages > 2 &&
           (long long)stages * (stage_bytes + 8) > kSmemMax)
        --stages;
    const int smem = stages * (stage_bytes + 8);
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
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
        stage_vec, stages);
    return (int)cudaGetLastError();
}
