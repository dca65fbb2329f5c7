// The platform probe's kernels for Hopper (sm_90a): K13 scale_copy and
// K15 tile_dot.  They measure what this card gives for a plain copy and
// for the channelizer DFT's (M, 128) @ (128, 128) product, and replace
// the Pallas kernels of tools/ablation/platform_probe.py (k_copy, k_dot),
// tools/ablation/stream_probe.py (copy_kernel) and
// tools/ablation/f16_probe.py (kern).
//
// K13 scale_copy.  Contract: o = s * x over x (rows, 128) float32, any
// rows >= 1, computed in float32 (s = 2: k_copy; s = 1: copy_kernel, a
// copy bit for bit).
// - What bounds it: bytes.  At (131072, 128) it moves 134.2 MB, 0.0401 ms
//   at 3.35 TB/s.
// - Design: a block of 256 threads owns `rows_per_block` rows, the
//   counterpart of the TPU's tile, and walks them as 16-byte float4
//   loads and stores, four in flight a thread before the first store.
//
// K15 tile_dot<MODE>.  Contract: o = x @ b, x (rows, 128) and b
// (128, 128) row-major in the mode's input type, o (rows, 128) float32,
// any rows >= 1.  The modes:
// - FP32:   float32, fp32 FFMA (no tensor cores);
// - TF32:   float32 inputs rounded as cvt.rna.tf32.f32, wgmma
//           m64n128k8 with float32 accumulation;
// - TF32X3: float32, each input split into hi = tf32(v) and
//           lo = tf32(v - hi); lo*hi + hi*lo + hi*hi as three m64n128k8
//           products a k step into one accumulator, the small terms
//           first (fp32-grade);
// - BF16, F16: bfloat16 or half inputs, wgmma m64n128k16 with float32
//           accumulation (F16 is f16_probe's kern).
// - What bounds it: at (131072, 128) @ (128, 128) the product is 4.29
//   GFLOP, 0.0641 ms at the 67 TFLOP/s fp32 rate, so FP32 is bound by
//   operations; TF32 and TF32X3 (3 products at 495 TFLOP/s, 0.026 ms) by
//   their 134.3 MB of bytes, 0.0401 ms; BF16 and F16 by 100.7 MB,
//   0.0300 ms.  Every tensor-core mode is a streaming problem: the
//   product has to run under the copy of x.
// - Design: a block is one producer warp and two consumer warpgroups
//   (288 threads), and walks its `rows_per_block` rows as 64-row tiles.
//   - b, once a block: the consumers stage it into shared memory
//     transposed (n rows of k, K-major), in the 128-byte swizzled layout
//     wgmma reads, already rounded (TF32: cvt.rna values; TF32X3: a b_hi
//     and a b_lo tile), from coalesced 128-byte loads of its rows.  It is
//     never converted again.
//   - x through a ring of stages (FP32 4 of 32 KB, TF32 and TF32X3 3,
//     BF16 and F16 6 of 16 KB; Dot below):
//     the producer warp's one thread waits for a stage to be free and
//     loads the next tile into it by TMA (cp.async.bulk.tensor.2d, a
//     CUtensorMap made on the host with cuTensorMapEncodeTiled, taken
//     through cudaGetDriverEntryPoint; 128-byte swizzle, 128-byte boxes
//     of 64 rows), completing on the stage's mbarrier.  Rows past `rows`
//     arrive as zeros and are not stored.
//   - The consumer warpgroups take alternate tiles; where they share
//     stages (TF32, TF32X3) they pass their full barriers in tile order,
//     one named barrier each way.  TF32 and TF32X3
//     read their A fragments from the swizzled stage (conflict-free),
//     round them (and split them) in registers, free the stage, and
//     issue wgmma with A from registers: wgmma would read raw fp32 bits
//     from shared memory and drop their low mantissa bits, not round
//     them.  BF16 and F16 issue wgmma with A and B from shared memory.
//     FP32 runs an FFMA tile of 8 x 8 outputs a thread from the stage
//     (float4 reads along k, conflict-free under the swizzle).
//   - Stores: TF32, BF16 and F16 write a tile into a staging buffer of
//     their warpgroup (the same swizzle) and store it by TMA, whole
//     512-byte rows (8-10% faster than from registers at 512 rows a
//     block); FP32 and TF32X3, with no room for the buffers beside their
//     stages, from registers, neighbouring lanes swapping a pair (one
//     shuffle) so that each thread writes 16-byte float4s.
//   Loads, products and stores of different tiles overlap inside a
//   block; one block an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;             // the probes' row width, and K
constexpr int kCopyThreads = 256;
constexpr int kCopyUnroll = 4;

__device__ __forceinline__ float4 scale4(float4 a, float s) {
    return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

__global__ void __launch_bounds__(kCopyThreads)
scale_copy_kernel(const float4* __restrict__ x, float4* __restrict__ o,
                  long long rows, int rows_per_block, float s) {
    const long long r0 = (long long)blockIdx.x * rows_per_block;
    const long long r1 = min(rows, r0 + rows_per_block);
    const long long end = r1 * (kCols / 4);
    long long v = r0 * (kCols / 4) + threadIdx.x;
    for (; v + (kCopyUnroll - 1) * kCopyThreads < end;
         v += kCopyUnroll * kCopyThreads) {
        float4 a[kCopyUnroll];
#pragma unroll
        for (int u = 0; u < kCopyUnroll; ++u) a[u] = x[v + u * kCopyThreads];
#pragma unroll
        for (int u = 0; u < kCopyUnroll; ++u)
            o[v + u * kCopyThreads] = scale4(a[u], s);
    }
    for (; v < end; v += kCopyThreads) o[v] = scale4(x[v], s);
}

// ---------------------------------------------------------------------------
// K15

enum Mode { FP32 = 0, TF32 = 1, TF32X3 = 2, BF16 = 3, F16 = 4 };

constexpr int kTileRows = 64;          // a wgmma's M: the rows of a stage
constexpr int kConsumers = 2;          // consumer warpgroups
constexpr int kDotThreads = 128 * kConsumers + 32;   // + the producer warp
constexpr int kProducerWarp = 4 * kConsumers;
static_assert(kConsumers == 2, "order_wait pairs two consumers");
constexpr int kSpanBytes = 128;        // a swizzled row span, a TMA box row

// a mode's input type, ring stages, b tiles, and whether a consumer
// stores its tile through shared memory by TMA (kTmaStore) or from
// registers.  Consumers share stages where kStages is not a multiple of
// them (kOrdered below).  TF32 stores by TMA beside 3 stages (2 stages
// and TMA stores were 3% faster than 4 stages and stores from registers
// at 512 rows a block); TF32X3's two b tiles leave room for 3 stages and
// no staging buffers.
template <int MODE> struct Dot {
    using T = float;
    static constexpr int kStages = MODE == FP32 ? 4 : 3;
    static constexpr int kBTiles = MODE == TF32X3 ? 2 : 1;
    static constexpr bool kTmaStore = MODE == TF32;
};
template <> struct Dot<BF16> {
    using T = __nv_bfloat16;
    static constexpr int kStages = 6, kBTiles = 1;
    static constexpr bool kTmaStore = true;
};
template <> struct Dot<F16> {
    using T = __half;
    static constexpr int kStages = 6, kBTiles = 1;
    static constexpr bool kTmaStore = true;
};

// the shared-memory plan of a mode: b tile(s), the ring, its barriers
template <int MODE> struct Plan {
    using T = typename Dot<MODE>::T;
    static constexpr int kElem = (int)sizeof(T);
    static constexpr int kSpan = kSpanBytes / kElem;     // elements a span
    static constexpr int kSpans = kCols / kSpan;         // spans a row
    static constexpr int kVec = 16 / kElem;              // elements a chunk
    static constexpr int kXSpanBytes = kTileRows * kSpanBytes;   // 8 KB
    static constexpr int kBSpanBytes = kCols * kSpanBytes;       // 16 KB
    static constexpr int kStageBytes = kSpans * kXSpanBytes;
    static constexpr int kBBytes = kSpans * kBSpanBytes;
    static constexpr int kStages = Dot<MODE>::kStages;
    static constexpr int kRing = Dot<MODE>::kBTiles * kBBytes;  // offset
    static constexpr int kOutBytes = kTileRows * kCols * 4;     // a tile of o
    static constexpr int kOut = kRing + kStages * kStageBytes;  // offset
    static constexpr int kBars =
        kOut + (Dot<MODE>::kTmaStore ? kConsumers * kOutBytes : 0);
    // + 1024: the dynamic buffer is aligned to the swizzle's 1024 bytes
    static constexpr size_t kSmem = 1024 + kBars + 2 * kStages * 8;
    static_assert(kSmem <= 227 * 1024, "a block's shared memory on sm_90");
};

// byte offset of element (r, c) of a matrix of 128 columns held as
// 128-byte spans of `span_bytes` each, with the 128-byte swizzle that TMA
// writes and wgmma reads: the 16-byte chunk index XOR (r mod 8)
template <int MODE>
__device__ __forceinline__ uint32_t swz(int r, int c, int span_bytes) {
    using P = Plan<MODE>;
    const int cc = c % P::kSpan;
    return (uint32_t)((c / P::kSpan) * span_bytes + r * kSpanBytes +
                      ((((cc / P::kVec) ^ (r & 7))) << 4) +
                      (cc % P::kVec) * P::kElem);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return r;
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done != 0;
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
    while (!bar_try(bar, parity)) {
    }
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// one TMA box of x, columns c0.., rows r0.., into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int r0, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
           "r"(r0), "r"(bar)
        : "memory");
}

// wgmma's shared-memory descriptor of a K-major operand in the 128-byte
// swizzle: 8-row groups 1024 bytes apart; a k step inside a span advances
// the start address by its 32 bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

#define ACC8(i)                                                          \
    "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
        "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC64                                                            \
    ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),  \
        ACC8(56)
#define D64                                                              \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
    "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
    "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
    "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d += a b, a 64 x 8 tf32 from registers (4 a thread), b 8 x 128 from
// shared memory
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t* a,
                                           uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : ACC64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a b, a 64 x 16 and b 16 x 128 from shared memory
template <int MODE>
__device__ __forceinline__ void wgmma_16(float (&d)[64], uint64_t a,
                                         uint64_t b) {
    if constexpr (MODE == BF16) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64
            ", %64, %65, p, 1, 1, 0, 0;\n}\n"
            : ACC64
            : "l"(a), "l"(b), "r"(1));
    } else {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " D64
            ", %64, %65, p, 1, 1, 0, 0;\n}\n"
            : ACC64
            : "l"(a), "l"(b), "r"(1));
    }
}

// b (k, n) row-major in device memory -> shared memory [n][k], K-major,
// swizzled, once a block by the 256 consumer threads: an item is one
// 16-byte chunk (n, k0 .. k0 + kVec - 1), the lanes of a warp on
// consecutive n, so that each load reads 32 neighbours of one row of b
// and each store is conflict-free.  TF32 stores the rounded values,
// TF32X3 hi in the first tile and lo in the second.
template <int MODE>
__device__ __forceinline__ void stage_b(const typename Dot<MODE>::T* b,
                                        unsigned char* bs, int ct) {
    using P = Plan<MODE>;
    constexpr int kItems = kCols * kCols / P::kVec;
#pragma unroll 4
    for (int it = ct; it < kItems; it += 128 * kConsumers) {
        const int n = it % kCols;
        const int k0 = (it / kCols) * P::kVec;
        const uint32_t off = swz<MODE>(n, k0, P::kBSpanBytes);
        if constexpr (P::kElem == 4) {
            float v[4];
            uint32_t h[4], l[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                v[e] = __ldg(b + (k0 + e) * kCols + n);
                h[e] = MODE == FP32 ? __float_as_uint(v[e]) : to_tf32(v[e]);
                l[e] = to_tf32(v[e] - __uint_as_float(h[e]));
            }
            *reinterpret_cast<uint4*>(bs + off) =
                make_uint4(h[0], h[1], h[2], h[3]);
            if constexpr (MODE == TF32X3)
                *reinterpret_cast<uint4*>(bs + P::kBBytes + off) =
                    make_uint4(l[0], l[1], l[2], l[3]);
        } else {
            // two 16-bit values a word, the lower k first
            const unsigned short* bu =
                reinterpret_cast<const unsigned short*>(b) + k0 * kCols + n;
            uint32_t h[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
                h[e] = (uint32_t)__ldg(bu + 2 * e * kCols) |
                       ((uint32_t)__ldg(bu + (2 * e + 1) * kCols) << 16);
            *reinterpret_cast<uint4*>(bs + off) =
                make_uint4(h[0], h[1], h[2], h[3]);
        }
    }
}

// rows r, r + 8 of a tile's 64 x 128 accumulator (wgmma's layout: pair
// 4j, 4j + 1 at row r, columns 8j + 2t, +1; pair 4j + 2, 4j + 3 at row
// r + 8): lanes t and t ^ 1 swap a pair, so that even t writes row r,
// columns 8j + 2t .. + 3, and odd t row r + 8, columns 8j + 2t - 2 .. + 1
__device__ __forceinline__ void store_acc(const float (&d)[64], float* o,
                                          long long r, long long r_end,
                                          int t) {
    const bool odd = t & 1;
    const long long row = odd ? r + 8 : r;
    float* dst = o + row * kCols + 2 * (t & ~1);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const float sx = odd ? d[4 * j] : d[4 * j + 2];
        const float sy = odd ? d[4 * j + 1] : d[4 * j + 3];
        const float rx = __shfl_xor_sync(0xffffffffu, sx, 1);
        const float ry = __shfl_xor_sync(0xffffffffu, sy, 1);
        const float4 v = odd ? make_float4(rx, ry, d[4 * j + 2], d[4 * j + 3])
                             : make_float4(d[4 * j], d[4 * j + 1], rx, ry);
        if (row < r_end) *reinterpret_cast<float4*>(dst + 8 * j) = v;
    }
}

// the warpgroup's 128 threads, on named barrier 2 + wg
__device__ __forceinline__ void wg_sync(int wg) {
    asm volatile("bar.sync %0, 128;" :: "r"(2 + wg) : "memory");
}

// the consumers' order, on named barrier 4 + c: consumer c arrives once
// it has passed its full barrier, the next one waits for that before its
// own (one arrival outstanding at most: c arrives again only after the
// next consumer has passed its barrier too)
__device__ __forceinline__ void order_arrive(int c) {
    asm volatile("bar.arrive %0, %1;" :: "r"(4 + c), "n"(256) : "memory");
}
__device__ __forceinline__ void order_wait(int c) {
    asm volatile("bar.sync %0, %1;" :: "r"(4 + c), "n"(256) : "memory");
}

// a tile's 64 x 128 accumulator (store_acc's layout) into the warpgroup's
// staging buffer, as 4 spans of 32 columns in the 128-byte swizzle, then
// to o by 4 TMA stores (rows past the tensor are not written).  The
// buffer is refilled only after the last tile's stores have read it.
__device__ __forceinline__ void stage_out(const float (&d)[64],
                                          unsigned char* buf,
                                          const CUtensorMap* omap, int wg,
                                          int r0, int w, int g, int t) {
    const bool leader = (threadIdx.x & 127) == 0;
    if (leader) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    wg_sync(wg);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int r = 16 * w + g + 8 * h, c = 8 * j + 2 * t;
            const int off = (c >> 5) * (kTileRows * kSpanBytes) +
                            r * kSpanBytes +
                            ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
            *reinterpret_cast<float2*>(buf + off) =
                make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    wg_sync(wg);
    if (leader) {
#pragma unroll
        for (int q = 0; q < kCols / 32; ++q)
            asm volatile(
                "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group "
                "[%0, {%2, %3}], [%1];"
                :: "l"(reinterpret_cast<uint64_t>(omap)),
                   "r"(smem_addr(buf + q * kTileRows * kSpanBytes)),
                   "r"(32 * q), "r"(r0)
                : "memory");
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
}

template <int MODE>
__global__ void __launch_bounds__(kDotThreads, 1)
tile_dot_kernel(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap omap,
                const typename Dot<MODE>::T* __restrict__ b,
                float* __restrict__ o, long long rows, int rows_per_block) {
    using P = Plan<MODE>;
    constexpr int S = P::kStages;
    // where the consumers share stages (S not a multiple of them), they
    // pass their full barriers in tile order, so that tile i - S has
    // arrived when tile i is awaited: phase i / S - 1 of the stage has
    // completed, and phase i / S - 2, of the same parity, cannot be
    // taken for i / S (a consumer left to run ahead did so and read a
    // stale tile)
    constexpr bool kOrdered = S % kConsumers != 0;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023))
                                      & 1023);
    unsigned char* bs = smem;                       // b tile(s)
    unsigned char* ring = smem + P::kRing;          // S stages of x
    const uint32_t full0 = smem_addr(smem + P::kBars);
    const uint32_t empty0 = full0 + 8 * S;
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;

    const long long r_begin = (long long)blockIdx.x * rows_per_block;
    const long long r_end = min(rows, r_begin + rows_per_block);
    const int tiles = (int)((r_end - r_begin + kTileRows - 1) / kTileRows);

    if (tid == 0) {
        for (int s = 0; s < S; ++s) {
            bar_init(full0 + 8 * s, 1);
            bar_init(empty0 + 8 * s, 128);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (warp == kProducerWarp) {
        // the producer: one thread keeps the ring's free stages loading
        if (lane == 0) {
            asm volatile("prefetch.tensormap [%0];"
                         :: "l"(reinterpret_cast<uint64_t>(&xmap))
                         : "memory");
            for (int i = 0; i < tiles; ++i) {
                const int s = i % S;
                bar_wait(empty0 + 8 * s, ((i / S) & 1) ^ 1);
                bar_expect(full0 + 8 * s, P::kStageBytes);
                const uint32_t dst = smem_addr(ring + s * P::kStageBytes);
#pragma unroll
                for (int q = 0; q < P::kSpans; ++q)
                    tma_load(dst + q * P::kXSpanBytes, &xmap, q * P::kSpan,
                             (int)(r_begin + (long long)i * kTileRows),
                             full0 + 8 * s);
            }
        }
        return;
    }

    // the consumers: b once, then alternate tiles
    const int ct = tid;                           // 0 .. 255
    stage_b<MODE>(b, bs, ct);
    // b's generic stores, before wgmma (the async proxy) reads them
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, %0;" :: "n"(128 * kConsumers) : "memory");

    const int wg = warp >> 2;
    const int w = warp & 3;                       // warp in the warpgroup
    const int g = lane >> 2, t = lane & 3;
    for (int i = wg; i < tiles; i += kConsumers) {
        const int s = i % S;
        const unsigned char* xs = ring + s * P::kStageBytes;
        const long long r0 = r_begin + (long long)i * kTileRows;
        if (kOrdered && i > 0) order_wait((wg + kConsumers - 1) % kConsumers);
        bar_wait(full0 + 8 * s, (i / S) & 1);
        if (kOrdered && i + 1 < tiles) order_arrive(wg);
        if constexpr (MODE == FP32) {
            // thread (tx, ty): rows ty + 8 i, columns tx + 16 j
            const int c = (warp << 5) + lane - 128 * wg;
            const int tx = c & 15, ty = c >> 4;
            float acc[8][8];
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[a][j] = 0.f;
#pragma unroll 4
            for (int k = 0; k < kCols; k += 4) {
                float4 av[8], bv[8];
#pragma unroll
                for (int a = 0; a < 8; ++a)
                    av[a] = *reinterpret_cast<const float4*>(
                        xs + swz<MODE>(ty + 8 * a, k, P::kXSpanBytes));
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    bv[j] = *reinterpret_cast<const float4*>(
                        bs + swz<MODE>(tx + 16 * j, k, P::kBSpanBytes));
#pragma unroll
                for (int a = 0; a < 8; ++a)
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        acc[a][j] = fmaf(av[a].x, bv[j].x, acc[a][j]);
                        acc[a][j] = fmaf(av[a].y, bv[j].y, acc[a][j]);
                        acc[a][j] = fmaf(av[a].z, bv[j].z, acc[a][j]);
                        acc[a][j] = fmaf(av[a].w, bv[j].w, acc[a][j]);
                    }
            }
            bar_arrive(empty0 + 8 * s);
#pragma unroll
            for (int a = 0; a < 8; ++a) {
                const long long r = r0 + ty + 8 * a;
                if (r < r_end)
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        o[r * kCols + tx + 16 * j] = acc[a][j];
            }
        } else {
            float d[64];
#pragma unroll
            for (int q = 0; q < 64; ++q) d[q] = 0.f;
            const uint32_t b_base = smem_addr(bs);
            if constexpr (MODE == TF32 || MODE == TF32X3) {
                // A fragments (rows 16 w + g, + 8; columns 8 kk + t, + 4),
                // rounded, and split for TF32X3, whose 128 registers of
                // hi and lo would serialize the products: it takes the
                // k steps in two halves
                constexpr int kHalves = MODE == TF32X3 ? 2 : 1;
                constexpr int kSteps = kCols / 8 / kHalves;
                const unsigned char* a0 = xs + (16 * w + g) * kSpanBytes + 4 * t;
#pragma unroll
                for (int h = 0; h < kHalves; ++h) {
                    uint32_t ah[kSteps][4], al[kSteps][4];
#pragma unroll
                    for (int q = 0; q < kSteps; ++q) {
                        const int kk = h * kSteps + q;
                        const unsigned char* sp = a0 + (kk >> 2) * P::kXSpanBytes;
                        const int c0 = ((2 * (kk & 3)) ^ g) << 4;
                        const int c1 = ((2 * (kk & 3) + 1) ^ g) << 4;
                        const float v[4] = {
                            *reinterpret_cast<const float*>(sp + c0),
                            *reinterpret_cast<const float*>(sp + 8 * kSpanBytes + c0),
                            *reinterpret_cast<const float*>(sp + c1),
                            *reinterpret_cast<const float*>(sp + 8 * kSpanBytes + c1)};
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            ah[q][e] = to_tf32(v[e]);
                            if constexpr (MODE == TF32X3)
                                al[q][e] = to_tf32(v[e] - __uint_as_float(ah[q][e]));
                        }
                    }
                    if (h == kHalves - 1) bar_arrive(empty0 + 8 * s);  // read
                    wgmma_fence();
#pragma unroll
                    for (int q = 0; q < kSteps; ++q) {
                        const int kk = h * kSteps + q;
                        const uint32_t boff = (kk >> 2) * P::kBSpanBytes + (kk & 3) * 32;
                        const uint64_t bh = sw128_desc(b_base + boff);
                        if constexpr (MODE == TF32X3) {
                            const uint64_t bl = sw128_desc(b_base + P::kBBytes + boff);
                            wgmma_tf32(d, al[q], bh);
                            wgmma_tf32(d, ah[q], bl);
                        }
                        wgmma_tf32(d, ah[q], bh);
                    }
                    wgmma_commit();
                    wgmma_wait();
                }
            } else {
                constexpr int kSteps = kCols / 16;
                const uint32_t a_base = smem_addr(xs);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < kSteps; ++kk) {
                    const uint32_t step = (kk & 3) * 32;
                    wgmma_16<MODE>(
                        d,
                        sw128_desc(a_base + (kk >> 2) * P::kXSpanBytes + step),
                        sw128_desc(b_base + (kk >> 2) * P::kBSpanBytes + step));
                }
                wgmma_commit();
                wgmma_wait();
                bar_arrive(empty0 + 8 * s);
            }
            if constexpr (Dot<MODE>::kTmaStore)
                stage_out(d, smem + P::kOut + wg * P::kOutBytes, &omap, wg,
                          (int)r0, w, g, t);
            else
                store_acc(d, o, r0 + 16 * w + g, r_end, t);
        }
    }
    if constexpr (Dot<MODE>::kTmaStore) {
        // the buffer stays until the last stores have read it
        if ((tid & 127) == 0)
            asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the
// library links no libcuda), or null
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
            return nullptr;
        fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

template <int MODE>
int launch_tile_dot(const void* x, const void* b, void* o, long long rows,
                    int rows_per_block, cudaStream_t stream) {
    using P = Plan<MODE>;
    using T = typename Dot<MODE>::T;
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    // x as a 2-D tensor of 128 columns: boxes of one span by 64 rows
    CUtensorMap xmap;
    const cuuint64_t dims[2] = {(cuuint64_t)kCols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)kCols * sizeof(T)};
    const cuuint32_t box[2] = {(cuuint32_t)P::kSpan, (cuuint32_t)kTileRows};
    const cuuint32_t step[2] = {1, 1};
    const CUtensorMapDataType type =
        MODE == BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
        : MODE == F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    if (encode(&xmap, type, 2, const_cast<void*>(x), dims, strides, box, step,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    // o as 2-D float32 for the TMA stores: boxes of 32 columns by 64 rows
    CUtensorMap omap;
    const cuuint64_t ostrides[1] = {(cuuint64_t)kCols * sizeof(float)};
    const cuuint32_t obox[2] = {32, (cuuint32_t)kTileRows};
    if (encode(&omap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, o, dims, ostrides,
               obox, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    static bool configured = false;
    if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(
            tile_dot_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)P::kSmem);
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
    tile_dot_kernel<MODE><<<(unsigned)blocks, kDotThreads, P::kSmem, stream>>>(
        xmap, omap, static_cast<const T*>(b), static_cast<float*>(o), rows,
        rows_per_block);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int scale_copy_launch(const void* x, void* o, long long rows,
                                 int rows_per_block, float s, void* stream) {
    if (rows < 1 || rows_per_block < 1 ||
        (rows + rows_per_block - 1) / rows_per_block > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
    scale_copy_kernel<<<(unsigned)blocks, kCopyThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(x), static_cast<float4*>(o), rows,
        rows_per_block, s);
    return (int)cudaGetLastError();
}

// K15: x (rows, 128) 16-byte aligned (TMA), b (128, 128), o (rows, 128)
// float32; rows_per_block a multiple of 64; mode a Mode.  Returns the
// launch's CUDA error code (cudaErrorNotSupported: no tensor-map encoder).
extern "C" int tile_dot_launch(const void* x, const void* b, void* o,
                               long long rows, int rows_per_block, int mode,
                               void* stream) {
    if (rows < 1 || rows > 0x7fffffffLL || rows_per_block < kTileRows ||
        rows_per_block % kTileRows || (reinterpret_cast<uintptr_t>(x) & 15) ||
        (rows + rows_per_block - 1) / rows_per_block > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (mode) {
        case FP32: return launch_tile_dot<FP32>(x, b, o, rows, rows_per_block, s);
        case TF32: return launch_tile_dot<TF32>(x, b, o, rows, rows_per_block, s);
        case TF32X3:
            return launch_tile_dot<TF32X3>(x, b, o, rows, rows_per_block, s);
        case BF16: return launch_tile_dot<BF16>(x, b, o, rows, rows_per_block, s);
        case F16: return launch_tile_dot<F16>(x, b, o, rows, rows_per_block, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
