// Polyphase channelizer + per-channel FM discriminator (+ audio decimation),
// in one pass, for Hopper (sm_90a): five kernels from one template.
//
// Replaces these TPU kernels of cyberether_tpu/ops/pallas_kernels.py:
//   K1 channelize_demod_decim_v5 (body _channelize_body_v5)
//   K8 channelize_demod_decim, v4 (body _channelize_kernel_v4)
//   K9 channelize_demod_decim_v6 (body _channelize_body_v6)
//   K7 channelize_demod (bodies _channelize_kernel, v1, and
//      _channelize_kernel_v2, v2)
// and the stage ablation of tools/ablation/chan_ablate.py (make_call with
// k_full .. k_fullrate): K16, the split form with stages compiled out
// (see Stage below and channelize_ablate_launch).
// Contract, for x = (M, 2C) frames and the rows before them (hist):
//   1. FIR + DFT, frames f = -1 .. M-1, ext = hist|x, lanes [Re y | Im y]:
//      split  (K1, K9, K7 v1): z[f] = sum_{p<P} ext[f+p] * hp[p]; y = z @ B,
//                              one (2C)x(2C) fp32 product
//      folded (K8, K7 v2):     y[f] = sum_{p<P} ext[f+p] @ Bp[p], P products
//                              with Bp[p] = diag(hp[p]) B
//   2. lag:   dr + i*di = conj(y[m-1]) * y[m]; y[-1] is filtered from hist,
//             or given (K7's prev)
//   3. demod: classic  audio[j,c] = mean_d atan2(di, dr)[jD+d, c] * gain
//             coherent audio[j,c] = atan2(mean_d di, mean_d dr) * gain (K1)
//      atan2 by a minimax polynomial: 3 terms and a true fp32 division (K1),
//      5 terms and a true division (K8, K7), 5 terms and rcp.approx with one
//      Newton step (K9, as the TPU kernel's approximate reciprocal).
//   K7 takes D = 1 and also writes y[M-1] (ylast).
// The lane order is in hp and B, not in the kernel: K1, K8 and K9 take
// interleaved rows [re0, im0, re1, im1, ...] with lane-permuted matrices, K7
// re|im halves [re0 .. re(C-1) | im0 .. im(C-1)] with the plain block matrix.
//
// What bounds it on this card: operations.  At full width (C=64, P=8, D=16,
// M=131072) the DFT alone is 2*(M+1)*(2C)^2 = 4.3 GFLOP against ~69 MB of
// input and output: ~63 FLOP/byte, three times the H100's fp32 ridge
// (67 TFLOP/s over 3.35 TB/s).  So the FMA pipes, not HBM, set the floor.
// The folded form does P times the DFT's products (34.4 GFLOP at P=8): its
// algorithm, not the function, sets its time.
//
// What the design does about it:
// - Every frame depends only on the P frames before it, so each block owns
//   128 output frames and stages its own 128+P input rows (rows before
//   frame 0 come from hist; there is no halo array).  It recomputes its lag
//   frame from those rows, so no carry runs from block to block, where the
//   TPU's K7 serialized its grid on one; only block 0 takes K7's prev.
//   1024 independent blocks at full width.
// - B (64 KB at C=64) sits in shared memory, so the DFT reads no HBM.  The
//   folded form's P matrices (512 KB at P=8) do not fit: they pass through
//   one 64 KB slab of shared memory a tap at a time (read from L2, shared by
//   every block), accumulating into the same register tile.
// - The DFT is register-tiled: each thread keeps 4 columns x RPT rows of y in
//   registers and reads z and B as float4, so shared-memory bandwidth is
//   not the limit before the FMA pipe is.
// - fp32 FFMA only, no TF32: the output is held to 1e-4 of the plain version.
// wgmma/TMA/3xTF32 are left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kFrames = 128;    // output frames per block
constexpr int kThreads = 512;
constexpr int kMaxTaps = 16;

enum Atan { kPoly3Div = 0, kPoly5Div = 1, kPoly5Rcp = 2 };

// K16's stages, for ext = [hist | x] and y row r the frame r - 1 (split
// form, classic).  kFull is the shipped body, which every other entry point
// runs; each other stage is its own instance, its branches compiled out:
//   kNoFir       y row r = ext[r] @ B (no taps); lag and atan2 as kFull
//   kNoAtan      out = mean_D di * gain
//   kNoDemod     out = mean_D Re y[frame] * gain (no lag product)
//   kMatmulOnly  out = mean_D Re (x[frame] @ B): no hist, no taps, no lag,
//                no gain; the DFT covers the block's own frames only
//   kFullRate    out (M, 2C) = [atan2(di, dr) * gain | dr] at every frame
enum Stage { kFull = 0, kNoFir = 1, kNoAtan = 2, kNoDemod = 3,
             kMatmulOnly = 4, kFullRate = 5 };

template <int A>
__device__ __forceinline__ float atan2_poly(float y, float x) {
    const float ax = fabsf(x), ay = fabsf(y);
    const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
    const bool red = lo > 0.41421356f * hi;
    const float num = red ? lo - hi : lo;
    const float den = fmaxf(red ? lo + hi : hi, 1e-30f);
    float u;
    if (A == kPoly5Rcp) {
        float r;
        asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(den));
        r = r * (2.f - den * r);                // one Newton step
        u = num * r;
    } else {
        u = num / den;                          // IEEE division
    }
    const float z = u * u;
    float a;
    if (A == kPoly3Div) {                       // max error 7.3e-6 rad
        float p = 1.6837577807e-01f * z + -3.3141539781e-01f;
        p = p * z + 9.9998249344e-01f;
        a = u * p;
    } else {                                    // max error ~2e-7 rad
        float p = 6.1687607318e-02f * z + -1.0648017377e-01f;
        p = p * z + 1.4253635705e-01f;
        p = p * z + -1.9999158382e-01f;
        p = p * z + 3.3333328366e-01f;
        a = u - u * z * p;
    }
    if (red) a = 0.78539816339744831f + a;
    if (ay > ax) a = 1.5707963267948966f - a;
    if (signbit(x)) a = 3.1415926535897931f - a;
    return signbit(y) ? -a : a;
}

// YRows: the y rows a block computes (its frames and the lag frame, or
// only its frames for kMatmulOnly)
template <int C, int YRows = kFrames + 1>
struct Tiling {
    static constexpr int N = 2 * C;                         // lanes per row
    static constexpr int NG = N / 4;                        // column quads
    static constexpr int RG = kThreads / NG;                // row groups
    static constexpr int RPT = (YRows + RG - 1) / RG;       // y rows / thread
    static constexpr int ZROWS = RG * RPT;                  // padded y rows
    static_assert(kThreads % N == 0, "one FIR lane per thread");
    static_assert(kThreads % NG == 0, "whole row groups");

    // split: B, the zero-padded FIR output and the window; folded: one slab
    // of Bp and the window, padded with the rows the padded y rows read
    static size_t smem_bytes(bool folded, int P) {
        return sizeof(float) * (folded
            ? (size_t)N * N + (size_t)(ZROWS + P - 1) * N
            : (size_t)N * N + (size_t)ZROWS * N + (size_t)(kFrames + P) * N);
    }
};

// A launch's arguments (the kernel takes them one by one).
struct Args {
    const void* x;       // (M, N) frames
    const void* hist;    // (H, N) the rows before frame 0
    const float* hp;     // (P, N) taps on the lanes (split form)
    const float* b;      // (N, N) DFT matrix, or (P, N, N) folded matrices
    const float* prev;   // (N,) y[-1], or null: filtered from hist
    float* out;          // (M / D, C)
    float* ylast;        // (N,) y[M-1], or null
    int M, P, H, D, coherent;
    float gain;
};

// acc[i][j] += sum_k A[(rg + RG*i) * N + k] * sB[k * N + 4*cg + j]
template <int N, int RG, int RPT>
__device__ __forceinline__ void dft_accumulate(float (&acc)[RPT][4],
                                               const float* A, const float* sB,
                                               int cg, int rg) {
#pragma unroll 2
    for (int k = 0; k < N; k += 4) {
        const float4 b0 = *reinterpret_cast<const float4*>(sB + (k + 0) * N + cg * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(sB + (k + 1) * N + cg * 4);
        const float4 b2 = *reinterpret_cast<const float4*>(sB + (k + 2) * N + cg * 4);
        const float4 b3 = *reinterpret_cast<const float4*>(sB + (k + 3) * N + cg * 4);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const float4 z = *reinterpret_cast<const float4*>(A + (rg + RG * i) * N + k);
            acc[i][0] = fmaf(z.x, b0.x, acc[i][0]);
            acc[i][1] = fmaf(z.x, b0.y, acc[i][1]);
            acc[i][2] = fmaf(z.x, b0.z, acc[i][2]);
            acc[i][3] = fmaf(z.x, b0.w, acc[i][3]);
            acc[i][0] = fmaf(z.y, b1.x, acc[i][0]);
            acc[i][1] = fmaf(z.y, b1.y, acc[i][1]);
            acc[i][2] = fmaf(z.y, b1.z, acc[i][2]);
            acc[i][3] = fmaf(z.y, b1.w, acc[i][3]);
            acc[i][0] = fmaf(z.z, b2.x, acc[i][0]);
            acc[i][1] = fmaf(z.z, b2.y, acc[i][1]);
            acc[i][2] = fmaf(z.z, b2.z, acc[i][2]);
            acc[i][3] = fmaf(z.z, b2.w, acc[i][3]);
            acc[i][0] = fmaf(z.w, b3.x, acc[i][0]);
            acc[i][1] = fmaf(z.w, b3.y, acc[i][1]);
            acc[i][2] = fmaf(z.w, b3.z, acc[i][2]);
            acc[i][3] = fmaf(z.w, b3.w, acc[i][3]);
        }
    }
}

template <typename Tin, int C, bool Folded, int A, int Stage>
__global__ void __launch_bounds__(kThreads, 1)
channelize_kernel(const Tin* __restrict__ x, const Tin* __restrict__ hist,
                  const float* __restrict__ hp, const float* __restrict__ b,
                  const float* __restrict__ prev, float* __restrict__ out,
                  float* __restrict__ ylast, int M, int P, int H, int D,
                  int coherent, float gain) {
    static_assert(Stage == kFull || !Folded, "K16 runs the split form");
    using Tl = Tiling<C, Stage == kMatmulOnly ? kFrames : kFrames + 1>;
    constexpr int N = Tl::N, NG = Tl::NG, RG = Tl::RG, RPT = Tl::RPT,
                  ZROWS = Tl::ZROWS;

    extern __shared__ __align__(16) float smem[];
    float* sB = smem;                  // (N, N) DFT matrix, or one slab of Bp
    float* sZ = sB + N * N;            // split: (ZROWS, N) FIR output, padded
    float* sW = Folded ? sZ : sZ + ZROWS * N;   // window rows, then y

    const int tid = threadIdx.x;
    const int start = blockIdx.x * kFrames;
    const int nf = min(kFrames, M - start);   // frames of this block
    // y rows incl. the lag frame (kMatmulOnly: the block's frames alone)
    const int rows = Stage == kMatmulOnly ? nf : nf + 1;

    // 1. stage the DFT matrix of the split form and the window rows, frames
    //    start-P .. start+nf-1.  One select of two loads a value: a branchy
    //    form measured K1 0.30 ms against 0.23.  K7's hist holds P-1 rows,
    //    so block 0's first row (only its lag frame, which prev replaces,
    //    reads it) takes hist row 0 instead.  The folded form's padded y
    //    rows read zero rows past the window.  kMatmulOnly stages only the
    //    block's frames, straight into the DFT's input rows.
    if (!Folded)
        for (int i = tid; i < N * N / 4; i += kThreads)
            reinterpret_cast<float4*>(sB)[i] =
                __ldg(reinterpret_cast<const float4*>(b) + i);
    if constexpr (Stage == kMatmulOnly) {
        for (int i = tid; i < ZROWS * N; i += kThreads)
            sZ[i] = i < nf * N ? static_cast<float>(x[(size_t)start * N + i])
                               : 0.f;
    } else {
        for (int i = tid; i < (nf + P) * N; i += kThreads) {
            const int r = i / N, l = i - r * N;
            const int f = start - P + r;
            const Tin v = f < 0 ? hist[max(H + f, 0) * N + l]
                                : x[(size_t)f * N + l];
            sW[i] = static_cast<float>(v);
        }
    }
    if (Folded)
        for (int i = (nf + P) * N + tid; i < (ZROWS + P - 1) * N;
             i += kThreads)
            sW[i] = 0.f;
    __syncthreads();

    // 2-3. y rows rg + RG*i, columns 4cg..4cg+3 of thread (rg, cg)
    const int cg = tid % NG, rg = tid / NG;
    float acc[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    if (Folded) {
        // y = sum_p window[p:] @ Bp[p], one slab of Bp in shared memory at a
        // time
        for (int p = 0; p < P; ++p) {
            if (p) __syncthreads();    // every thread is done with slab p-1
            const float4* slab =
                reinterpret_cast<const float4*>(b + (size_t)p * N * N);
            for (int i = tid; i < N * N / 4; i += kThreads)
                reinterpret_cast<float4*>(sB)[i] = __ldg(slab + i);
            __syncthreads();
            dft_accumulate<N, RG, RPT>(acc, sW + p * N, sB, cg, rg);
        }
        __syncthreads();               // the window is read: y may replace it
    } else {
        if constexpr (Stage != kMatmulOnly) {
            // FIR: each thread owns one lane and keeps its taps in registers
            const int l = tid % N;
            float h[kMaxTaps];
#pragma unroll
            for (int p = 0; p < kMaxTaps; ++p)
                h[p] = p < P ? __ldg(hp + p * N + l) : 0.f;
            for (int r = tid / N; r < ZROWS; r += kThreads / N) {
                float s = 0.f;
                if (r < rows) {
                    if constexpr (Stage == kNoFir) {
                        s = sW[r * N + l];      // z = the window, no taps
                    } else {
                        s = sW[r * N + l] * h[0];
#pragma unroll
                        for (int p = 1; p < kMaxTaps; ++p)
                            if (p < P) s += sW[(r + p) * N + l] * h[p];
                    }
                }
                sZ[r * N + l] = s;
            }
            __syncthreads();
        }
        dft_accumulate<N, RG, RPT>(acc, sZ, sB, cg, rg);
        // the window is dead (the FIR finished before the last barrier)
    }
    // y rows overwrite the window; block 0 takes its lag frame from prev
    const bool seed = prev != nullptr && blockIdx.x == 0;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int r = rg + RG * i;
        if (r < rows) {
            float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            if (r == 0 && seed)
                v = make_float4(prev[cg * 4], prev[cg * 4 + 1],
                                prev[cg * 4 + 2], prev[cg * 4 + 3]);
            *reinterpret_cast<float4*>(sW + r * N + cg * 4) = v;
        }
    }
    __syncthreads();
    if (ylast != nullptr && blockIdx.x == gridDim.x - 1)
        for (int l = tid; l < N; l += kThreads)
            ylast[l] = sW[nf * N + l];

    // 4. lag product, discriminator and boxcar decimation
    if constexpr (Stage == kFullRate) {
        for (int i = tid; i < nf * C; i += kThreads) {
            const int m = i / C, c = i - m * C;
            const float* lag = sW + m * N;
            const float* cur = lag + N;
            const float pr = lag[c], pi = lag[C + c];
            const float yr = cur[c], yi = cur[C + c];
            const float dr = pr * yr + pi * yi;
            const float di = pr * yi - pi * yr;
            float* o = out + (size_t)(start + m) * N;
            o[c] = atan2_poly<A>(di, dr) * gain;
            o[C + c] = dr;
        }
        return;
    }
    const int na = nf / D;
    const float inv_d = 1.f / (float)D;
    for (int i = tid; i < na * C; i += kThreads) {
        const int j = i / C, c = i - j * C;
        float s_r = 0.f, s_i = 0.f;
        for (int d = 0; d < D; ++d) {
            const float* lag = sW + (j * D + d) * N;    // y row of frame m-1
            const float* cur = lag + N;                 // y row of frame m
            if constexpr (Stage == kMatmulOnly) {
                s_r += lag[c];           // no lag row: y row m is frame m
            } else if constexpr (Stage == kNoDemod) {
                s_r += cur[c];
            } else {
                const float pr = lag[c], pi = lag[C + c];
                const float yr = cur[c], yi = cur[C + c];
                const float dr = pr * yr + pi * yi;
                const float di = pr * yi - pi * yr;
                if constexpr (Stage == kNoAtan) {
                    s_r += di;
                } else if (coherent) {
                    s_r += dr;
                    s_i += di;
                } else {
                    s_r += atan2_poly<A>(di, dr);
                }
            }
        }
        float v;
        if constexpr (Stage == kMatmulOnly)
            v = s_r * inv_d;
        else
            v = coherent
                ? atan2_poly<A>(s_i * inv_d, s_r * inv_d) * gain
                : s_r * gain * inv_d;
        out[(size_t)(start / D + j) * C + c] = v;
    }
}

template <typename Tin, int C, bool Folded, int A, int Stage = kFull>
cudaError_t launch(const Args& a, cudaStream_t stream) {
    // kMatmulOnly's tiling needs less; the limit stays Tiling<C>'s
    const size_t smem = Tiling<C, Stage == kMatmulOnly ? kFrames
                                                       : kFrames + 1>::
        smem_bytes(Folded, a.P);
    auto kernel = channelize_kernel<Tin, C, Folded, A, Stage>;
    // the shared-memory limit is raised once per device, for the most taps
    static std::atomic<uint64_t> raised{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const uint64_t bit = uint64_t{1} << (dev & 63);
    if (!(raised.load(std::memory_order_acquire) & bit)) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)Tiling<C>::smem_bytes(Folded, kMaxTaps));
        if (err != cudaSuccess) return err;
        raised.fetch_or(bit, std::memory_order_release);
    }
    const int grid = (a.M + kFrames - 1) / kFrames;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const Tin*>(a.x), static_cast<const Tin*>(a.hist), a.hp,
        a.b, a.prev, a.out, a.ylast, a.M, a.P, a.H, a.D, a.coherent, a.gain);
    return cudaGetLastError();
}

template <typename Tin, bool Folded, int A>
cudaError_t launch_c(int C, const Args& a, cudaStream_t stream) {
    switch (C) {
        case 8:  return launch<Tin, 8, Folded, A>(a, stream);
        case 16: return launch<Tin, 16, Folded, A>(a, stream);
        case 32: return launch<Tin, 32, Folded, A>(a, stream);
        case 64: return launch<Tin, 64, Folded, A>(a, stream);
        default: return cudaErrorInvalidValue;
    }
}

bool bad_shape(int M, int P, int D) {
    return M < 1 || P < 1 || P > kMaxTaps || D < 1 || kFrames % D || M % D;
}

// K16 is instantiated for C = 8 and 64 only (its small shapes and its
// probe): six stages for every C would lengthen this source's build.
template <int Stage>
cudaError_t launch_ablate(int C, const Args& a, cudaStream_t stream) {
    switch (C) {
        case 8:  return launch<float, 8, false, kPoly5Div, Stage>(a, stream);
        case 64: return launch<float, 64, false, kPoly5Div, Stage>(a, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// Each returns the CUDA error code of its launch (0 on success).

// K1. dtype: 0 float32, 1 int8, 2 int16 (x and hist, P rows); coherent: 0
// classic, 1 coherent.
extern "C" int channelize_demod_decim_launch(
        const void* x, const void* hist, const void* hp, const void* bperm,
        void* out, int M, int C, int P, int D, int dtype, int coherent,
        float gain, void* stream) {
    if (bad_shape(M, P, D)) return (int)cudaErrorInvalidValue;
    const Args a{x, hist, static_cast<const float*>(hp),
                 static_cast<const float*>(bperm), nullptr,
                 static_cast<float*>(out), nullptr, M, P, P, D, coherent, gain};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return (int)launch_c<float, false, kPoly3Div>(C, a, s);
        case 1: return (int)launch_c<int8_t, false, kPoly3Div>(C, a, s);
        case 2: return (int)launch_c<int16_t, false, kPoly3Div>(C, a, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// K8: float32 x and hist (P rows), bp (P, 2C, 2C), classic.
extern "C" int channelize_demod_decim_v4_launch(
        const void* x, const void* hist, const void* bp, void* out, int M,
        int C, int P, int D, float gain, void* stream) {
    if (bad_shape(M, P, D)) return (int)cudaErrorInvalidValue;
    const Args a{x, hist, nullptr, static_cast<const float*>(bp), nullptr,
                 static_cast<float*>(out), nullptr, M, P, P, D, 0, gain};
    return (int)launch_c<float, true, kPoly5Div>(
        C, a, static_cast<cudaStream_t>(stream));
}

// K9: float32 x and hist (P rows), hp (P, 2C), bperm (2C, 2C), classic.
extern "C" int channelize_demod_decim_v6_launch(
        const void* x, const void* hist, const void* hp, const void* bperm,
        void* out, int M, int C, int P, int D, float gain, void* stream) {
    if (bad_shape(M, P, D)) return (int)cudaErrorInvalidValue;
    const Args a{x, hist, static_cast<const float*>(hp),
                 static_cast<const float*>(bperm), nullptr,
                 static_cast<float*>(out), nullptr, M, P, P, D, 0, gain};
    return (int)launch_c<float, false, kPoly5Rcp>(
        C, a, static_cast<cudaStream_t>(stream));
}

// K7: ext (M + P - 1, 2C) float32, its first P - 1 rows the history; prev
// (2C,) = y[-1]; demod (M, C) and ylast (2C,) out.  folded: 0 takes hp
// (P, 2C) and b (2C, 2C) (v1); 1 takes b = (P, 2C, 2C) (v2).
extern "C" int channelize_demod_launch(
        const void* ext, const void* hp, const void* b, const void* prev,
        void* demod, void* ylast, int M, int C, int P, int folded, float gain,
        void* stream) {
    if (bad_shape(M, P, 1)) return (int)cudaErrorInvalidValue;
    const float* rows = static_cast<const float*>(ext);
    const Args a{rows + (size_t)(P - 1) * 2 * C, rows,
                 static_cast<const float*>(hp), static_cast<const float*>(b),
                 static_cast<const float*>(prev), static_cast<float*>(demod),
                 static_cast<float*>(ylast), M, P, P - 1, 1, 0, gain};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return folded ? (int)launch_c<float, true, kPoly5Div>(C, a, s)
                  : (int)launch_c<float, false, kPoly5Div>(C, a, s);
}

// K16: float32 x and hist (P rows, unread by kMatmulOnly), hp (P, 2C),
// bperm (2C, 2C), the 5-term atan2 with a true division, C 8 or 64.  stage:
// a Stage; out (M / D, C), or (M, 2C) for kFullRate, which ignores D.
extern "C" int channelize_ablate_launch(
        const void* x, const void* hist, const void* hp, const void* bperm,
        void* out, int M, int C, int P, int D, int stage, float gain,
        void* stream) {
    if (stage == kFullRate) D = 1;
    if (bad_shape(M, P, D)) return (int)cudaErrorInvalidValue;
    const Args a{x, hist, static_cast<const float*>(hp),
                 static_cast<const float*>(bperm), nullptr,
                 static_cast<float*>(out), nullptr, M, P, P, D, 0, gain};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (stage) {
        case kFull:       return (int)launch_ablate<kFull>(C, a, s);
        case kNoFir:      return (int)launch_ablate<kNoFir>(C, a, s);
        case kNoAtan:     return (int)launch_ablate<kNoAtan>(C, a, s);
        case kNoDemod:    return (int)launch_ablate<kNoDemod>(C, a, s);
        case kMatmulOnly: return (int)launch_ablate<kMatmulOnly>(C, a, s);
        case kFullRate:   return (int)launch_ablate<kFullRate>(C, a, s);
        default:          return (int)cudaErrorInvalidValue;
    }
}
