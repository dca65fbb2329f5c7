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
// - FP32:   float32, fp32 FFMA;
// - TF32:   float32 inputs rounded as cvt.rna.tf32.f32, mma.sync
//           m16n8k8 with float32 accumulation;
// - TF32X3: float32, each input split into hi = tf32(v) and
//           lo = tf32(v - hi); hi*lo + lo*hi + hi*hi as three m16n8k8
//           products, the small terms first (fp32-grade);
// - BF16, F16: bfloat16 or half inputs, mma.sync m16n8k16 with float32
//           accumulation (F16 is f16_probe's kern).
// - What bounds it: at (131072, 128) @ (128, 128) the product is 4.29
//   GFLOP, 0.0641 ms at the 67 TFLOP/s fp32 rate, so FP32 is bound by
//   operations; TF32 and TF32X3 (3 products at 495 TFLOP/s) by their
//   134.3 MB of bytes, 0.0401 ms; BF16 and F16 by 100.7 MB, 0.0300 ms.
// - Design: b is staged once a block into shared memory, transposed
//   (n-major, k contiguous), and held there while the block walks its
//   `rows_per_block` rows in tiles of 64: each tile of x is staged by
//   coalesced 16-byte loads, then each of the 4 warps computes 16 rows x
//   128 columns with mma.sync (a thread's fragments read from padded
//   rows, so the 32 lanes hit 32 banks), or, in FP32, each thread 8 x 8
//   outputs with float4 reads along k.  Rows past `rows` stage zeros
//   and are not stored.  Staging and compute alternate behind barriers
//   (no overlap inside a block; two blocks an SM overlap each other).

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

template <int MODE> struct Input { using T = float; };
template <> struct Input<BF16> { using T = __nv_bfloat16; };
template <> struct Input<F16> { using T = __half; };

constexpr int kDotThreads = 128;       // 4 warps
constexpr int kTileRows = 64;          // rows of x staged at once
// padded shared-memory row strides, in elements: 132 floats (528 bytes)
// or 136 halves (272 bytes) keep rows 16-byte aligned and put the 8
// fragment rows a warp reads at once on distinct banks
template <int MODE> constexpr int kStride = (MODE >= BF16) ? 136 : 132;

template <int MODE>
constexpr size_t smem_bytes() {
    return (size_t)(kTileRows + kCols) * kStride<MODE> *
           sizeof(typename Input<MODE>::T);
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return r;
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
          "r"(b[1]));
}

template <int MODE>
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a,
                                          const uint32_t* b) {
    if constexpr (MODE == BF16) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    }
}

// One warp's 16 rows x 128 columns of a staged tile with mma.sync:
// xs rows 16 w .. 16 w + 15, bs the transposed b.  Fragment layouts are
// PTX's: g = lane / 4 picks the row (A) or column (B), t = lane % 4 the
// k offset.
template <int MODE>
__device__ __forceinline__ void warp_mma(const typename Input<MODE>::T* xs,
                                         const typename Input<MODE>::T* bs,
                                         float (&acc)[16][4], int w,
                                         int lane) {
    constexpr int S = kStride<MODE>;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
    const auto* a0 = xs + (16 * w + g) * S;
    const auto* a8 = a0 + 8 * S;
    if constexpr (MODE == TF32 || MODE == TF32X3) {
#pragma unroll 2
        for (int k0 = 0; k0 < kCols; k0 += 8) {
            const float av[4] = {a0[k0 + t], a8[k0 + t], a0[k0 + t + 4],
                                 a8[k0 + t + 4]};
            uint32_t ah[4], al[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                ah[i] = to_tf32(av[i]);
                if constexpr (MODE == TF32X3)
                    al[i] = to_tf32(av[i] - __uint_as_float(ah[i]));
            }
#pragma unroll
            for (int nt = 0; nt < 16; ++nt) {
                const float* bc = bs + (8 * nt + g) * S + k0;
                const float bv[2] = {bc[t], bc[t + 4]};
                uint32_t bh[2], bl[2];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    bh[i] = to_tf32(bv[i]);
                    if constexpr (MODE == TF32X3)
                        bl[i] = to_tf32(bv[i] - __uint_as_float(bh[i]));
                }
                if constexpr (MODE == TF32X3) {
                    mma_tf32(acc[nt], al, bh);
                    mma_tf32(acc[nt], ah, bl);
                }
                mma_tf32(acc[nt], ah, bh);
            }
        }
    } else {
#pragma unroll 2
        for (int k0 = 0; k0 < kCols; k0 += 16) {
            const uint32_t a[4] = {
                *reinterpret_cast<const uint32_t*>(a0 + k0 + 2 * t),
                *reinterpret_cast<const uint32_t*>(a8 + k0 + 2 * t),
                *reinterpret_cast<const uint32_t*>(a0 + k0 + 8 + 2 * t),
                *reinterpret_cast<const uint32_t*>(a8 + k0 + 8 + 2 * t)};
#pragma unroll
            for (int nt = 0; nt < 16; ++nt) {
                const auto* bc = bs + (8 * nt + g) * S + k0;
                const uint32_t b[2] = {
                    *reinterpret_cast<const uint32_t*>(bc + 2 * t),
                    *reinterpret_cast<const uint32_t*>(bc + 8 + 2 * t)};
                mma_16816<MODE>(acc[nt], a, b);
            }
        }
    }
}

template <int MODE>
__global__ void __launch_bounds__(kDotThreads, 2)
tile_dot_kernel(const typename Input<MODE>::T* __restrict__ x,
                const typename Input<MODE>::T* __restrict__ b,
                float* __restrict__ o, long long rows, int rows_per_block) {
    using T = typename Input<MODE>::T;
    constexpr int S = kStride<MODE>;
    constexpr int kVec = 16 / sizeof(T);          // elements a 16-byte load
    extern __shared__ __align__(16) unsigned char smem[];
    T* bs = reinterpret_cast<T*>(smem);           // [n][k], b transposed
    T* xs = bs + kCols * S;                       // [row][k]
    const int tid = threadIdx.x;

    // b, once a block: coalesced reads along n, transposed stores
    for (int e = tid; e < kCols * kCols; e += kDotThreads)
        bs[(e % kCols) * S + e / kCols] = b[e];

    const long long r_begin = (long long)blockIdx.x * rows_per_block;
    const long long r_end = min(rows, r_begin + rows_per_block);
    for (long long r0 = r_begin; r0 < r_end; r0 += kTileRows) {
        __syncthreads();              // the last tile's reads are done
        for (int e = tid; e < kTileRows * kCols / kVec; e += kDotThreads) {
            const int r = e / (kCols / kVec), c = (e % (kCols / kVec)) * kVec;
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (r0 + r < r_end)
                v = *reinterpret_cast<const uint4*>(x + (r0 + r) * kCols + c);
            *reinterpret_cast<uint4*>(xs + r * S + c) = v;
        }
        __syncthreads();              // the tile (and b) are staged
        if constexpr (MODE == FP32) {
            // thread (tx, ty): rows ty + 8 i, columns tx + 16 j
            const int tx = tid & 15, ty = tid >> 4;
            float acc[8][8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 1
            for (int k = 0; k < kCols; k += 4) {
                float4 a[8], bv[8];
#pragma unroll
                for (int i = 0; i < 8; ++i)
                    a[i] = *reinterpret_cast<const float4*>(
                        xs + (ty + 8 * i) * S + k);
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    bv[j] = *reinterpret_cast<const float4*>(
                        bs + (tx + 16 * j) * S + k);
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        acc[i][j] = fmaf(a[i].x, bv[j].x, acc[i][j]);
                        acc[i][j] = fmaf(a[i].y, bv[j].y, acc[i][j]);
                        acc[i][j] = fmaf(a[i].z, bv[j].z, acc[i][j]);
                        acc[i][j] = fmaf(a[i].w, bv[j].w, acc[i][j]);
                    }
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const long long r = r0 + ty + 8 * i;
                if (r < r_end)
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        o[r * kCols + tx + 16 * j] = acc[i][j];
            }
        } else {
            const int w = tid >> 5, lane = tid & 31;
            float acc[16][4];
            warp_mma<MODE>(xs, bs, acc, w, lane);
            const int g = lane >> 2, t = lane & 3;
            const long long ra = r0 + 16 * w + g, rb = ra + 8;
#pragma unroll
            for (int nt = 0; nt < 16; ++nt) {
                const int c = 8 * nt + 2 * t;
                if (ra < r_end)
                    *reinterpret_cast<float2*>(o + ra * kCols + c) =
                        make_float2(acc[nt][0], acc[nt][1]);
                if (rb < r_end)
                    *reinterpret_cast<float2*>(o + rb * kCols + c) =
                        make_float2(acc[nt][2], acc[nt][3]);
            }
        }
    }
}

template <int MODE>
int launch_tile_dot(const void* x, const void* b, void* o, long long rows,
                    int rows_per_block, cudaStream_t stream) {
    using T = typename Input<MODE>::T;
    constexpr size_t smem = smem_bytes<MODE>();
    static bool configured = false;
    if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(
            tile_dot_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
    tile_dot_kernel<MODE><<<(unsigned)blocks, kDotThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(b),
        static_cast<float*>(o), rows, rows_per_block);
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

extern "C" int tile_dot_launch(const void* x, const void* b, void* o,
                               long long rows, int rows_per_block, int mode,
                               void* stream) {
    if (rows < 1 || rows_per_block < kTileRows ||
        rows_per_block % kTileRows ||
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
