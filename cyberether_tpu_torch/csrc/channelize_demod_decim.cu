// Polyphase channelizer + per-channel FM discriminator (+ audio decimation),
// in one pass, for Hopper (sm_90a): five kernels from two templates.  K1,
// K9 and K16 run the tensor-core template (channelize_tc_kernel, at the end
// of the file); K7 and K8 the FFMA template (channelize_kernel).
//
// Replaces these TPU kernels of cyberether_tpu/ops/pallas_kernels.py:
//   K1 channelize_demod_decim_v5 (body _channelize_body_v5)
//   K8 channelize_demod_decim, v4 (body _channelize_kernel_v4)
//   K9 channelize_demod_decim_v6 (body _channelize_body_v6)
//   K7 channelize_demod (bodies _channelize_kernel, v1, and
//      _channelize_kernel_v2, v2)
// and the stage ablation of tools/ablation/chan_ablate.py (make_call with
// k_full .. k_fullrate): K16, the tensor-core template with stages compiled
// out (see Stage below and channelize_ablate_launch).
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
// Its callers (K7, K8) take float32 rows, classic demodulation and the
// 5-term atan2 with a true division; the tensor-core template below runs K1,
// K9 and K16, with their input types, modes, atan2 forms and stages.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kFrames = 128;    // output frames per block
constexpr int kThreads = 512;
constexpr int kMaxTaps = 16;

enum Atan { kPoly3Div = 0, kPoly5Div = 1, kPoly5Rcp = 2 };

// K16's stages, for ext = [hist | x] and y row r the frame r - 1 (split
// form, classic), on the tensor-core template.  kFull is its whole body,
// which K1 and K9 run; each other stage is its own instance, its branches
// compiled out:
//   kNoFir       y row r = ext[r] @ B (no taps); lag and atan2 as kFull
//   kNoAtan      out = mean_D di * gain
//   kNoDemod     out = mean_D Re y[frame] * gain (no lag product)
//   kMatmulOnly  out = mean_D Re (x[frame] @ B): no hist, no taps, no lag,
//                no gain; the product covers the chunk's own frames only
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

template <int C>
struct Tiling {
    static constexpr int N = 2 * C;                         // lanes per row
    static constexpr int NG = N / 4;                        // column quads
    static constexpr int RG = kThreads / NG;                // row groups
    // y rows / thread: a block's frames and the lag frame
    static constexpr int RPT = (kFrames + 1 + RG - 1) / RG;
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

template <int C, bool Folded>
__global__ void __launch_bounds__(kThreads, 1)
channelize_kernel(const float* __restrict__ x, const float* __restrict__ hist,
                  const float* __restrict__ hp, const float* __restrict__ b,
                  const float* __restrict__ prev, float* __restrict__ out,
                  float* __restrict__ ylast, int M, int P, int H, int D,
                  float gain) {
    using Tl = Tiling<C>;
    constexpr int N = Tl::N, NG = Tl::NG, RG = Tl::RG, RPT = Tl::RPT,
                  ZROWS = Tl::ZROWS;

    extern __shared__ __align__(16) float smem[];
    float* sB = smem;                  // (N, N) DFT matrix, or one slab of Bp
    float* sZ = sB + N * N;            // split: (ZROWS, N) FIR output, padded
    float* sW = Folded ? sZ : sZ + ZROWS * N;   // window rows, then y

    const int tid = threadIdx.x;
    const int start = blockIdx.x * kFrames;
    const int nf = min(kFrames, M - start);   // frames of this block
    const int rows = nf + 1;                  // y rows incl. the lag frame

    // 1. stage the DFT matrix of the split form and the window rows, frames
    //    start-P .. start+nf-1.  One select of two loads a value: a branchy
    //    form measured K1 0.30 ms against 0.23.  K7's hist holds P-1 rows,
    //    so block 0's first row (only its lag frame, which prev replaces,
    //    reads it) takes hist row 0 instead.  The folded form's padded y
    //    rows read zero rows past the window.
    if (!Folded)
        for (int i = tid; i < N * N / 4; i += kThreads)
            reinterpret_cast<float4*>(sB)[i] =
                __ldg(reinterpret_cast<const float4*>(b) + i);
    for (int i = tid; i < (nf + P) * N; i += kThreads) {
        const int r = i / N, l = i - r * N;
        const int f = start - P + r;
        sW[i] = f < 0 ? hist[max(H + f, 0) * N + l]
                      : x[(size_t)f * N + l];
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
        // FIR: each thread owns one lane and keeps its taps in registers
        const int l = tid % N;
        float h[kMaxTaps];
#pragma unroll
        for (int p = 0; p < kMaxTaps; ++p)
            h[p] = p < P ? __ldg(hp + p * N + l) : 0.f;
        for (int r = tid / N; r < ZROWS; r += kThreads / N) {
            float s = 0.f;
            if (r < rows) {
                s = sW[r * N + l] * h[0];
#pragma unroll
                for (int p = 1; p < kMaxTaps; ++p)
                    if (p < P) s += sW[(r + p) * N + l] * h[p];
            }
            sZ[r * N + l] = s;
        }
        __syncthreads();
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
    const int na = nf / D;
    const float inv_d = 1.f / (float)D;
    for (int i = tid; i < na * C; i += kThreads) {
        const int j = i / C, c = i - j * C;
        float s_r = 0.f;
        for (int d = 0; d < D; ++d) {
            const float* lag = sW + (j * D + d) * N;    // y row of frame m-1
            const float* cur = lag + N;                 // y row of frame m
            const float pr = lag[c], pi = lag[C + c];
            const float yr = cur[c], yi = cur[C + c];
            const float dr = pr * yr + pi * yi;
            const float di = pr * yi - pi * yr;
            s_r += atan2_poly<kPoly5Div>(di, dr);
        }
        out[(size_t)(start / D + j) * C + c] = s_r * gain * inv_d;
    }
}

template <int C, bool Folded>
cudaError_t launch(const Args& a, cudaStream_t stream) {
    const size_t smem = Tiling<C>::smem_bytes(Folded, a.P);
    auto kernel = channelize_kernel<C, Folded>;
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
        static_cast<const float*>(a.x), static_cast<const float*>(a.hist),
        a.hp, a.b, a.prev, a.out, a.ylast, a.M, a.P, a.H, a.D, a.gain);
    return cudaGetLastError();
}

template <bool Folded>
cudaError_t launch_c(int C, const Args& a, cudaStream_t stream) {
    switch (C) {
        case 8:  return launch<8, Folded>(a, stream);
        case 16: return launch<16, Folded>(a, stream);
        case 32: return launch<32, Folded>(a, stream);
        case 64: return launch<64, Folded>(a, stream);
        default: return cudaErrorInvalidValue;
    }
}

bool bad_shape(int M, int P, int D) {
    return M < 1 || P < 1 || P > kMaxTaps || D < 1 || kFrames % D || M % D;
}

// ---------------------------------------------------------------------------
// K1, K9 and K16 on the tensor cores: channelize_tc_kernel.
//
// The function of channelize_kernel's decimating split form (the contract
// at the top, steps 1-3), with the DFT y = z @ B as a 3xTF32 wgmma
// product: each operand split into hi = tf32(v) (cvt.rna) and
// lo = tf32(v - hi), and lo*hi + hi*lo + hi*hi summed in fp32 by the tensor
// cores, a k step at a time (fp32-grade; one TF32 product alone misses the
// 1e-4 bar on the audio).
// - What bounds it on this card: the tensor pipe.  At full width (C=64,
//   P=8, D=16, M=131072) the three TF32 products are 12.9 GFLOP, 0.026 ms
//   at 495 TFLOP/s, against ~69 MB of HBM (0.021 ms) and 0.46 GFLOP of
//   FIR, lag products, atan2 and boxcar on the fp32 pipe (0.007 ms).
// - Design: one persistent block an SM (512 threads, four warpgroups)
//   walks a contiguous run of 128-frame chunks, so the lag frame of a
//   chunk is the last y row of the chunk before it.  A block computes its
//   first lag frame as row 127 of the chunk before its first one, by the
//   same FIR thread and wgmma tile row that compute that frame in the
//   block that owns the chunk: every y frame comes out of the same
//   arithmetic wherever it is computed, so a stream split at any frame
//   meets the whole.  A chunk passes through one buffer of shared memory:
//   1. the window, frames c0 - P + 1 .. c0 + 127, converted to fp32
//      (16-byte loads where x and hist are 16-byte aligned); the next
//      chunk's rows are prefetched into L2 while the tensor cores run;
//   2. the FIR on the FMA pipe: a thread owns one lane and N/4 consecutive
//      frames, in passes of 16 frames whose window values it holds in
//      registers beside the taps, so it reads (16 + P - 1) / 16 values an
//      output instead of P; taps outside, frames inside; z (fp32) replaces
//      the window, rows padded by 4 floats so that the A fragments below
//      are read without bank conflicts;
//   3. the product: warpgroup w takes m64 tile w / 2 and output half w % 2
//      (wgmma m64nCk8, A from registers, B from shared memory).  A is read
//      from z and rounded and split in registers (wgmma would truncate raw
//      fp32 read from shared memory) a k step at a time, two steps in
//      flight (wait_group 1), in 16 registers: 5% faster than four slices
//      of k with a wait each; two halves of k, 64 registers, spilled at
//      C = 64 and ran 9% slower than the slices.  B, bperm as given (no
//      DFT structure is assumed), is staged once a block, K-major in the
//      128-byte swizzle, split into a hi and a lo tile;
//   4. the accumulators replace z as y rows 1..128 (rows padded by 8
//      floats: conflict-free float2 stores), row 0 the lag frame;
//   5. lag products, atan2 and boxcar as in channelize_kernel.
//   The phases run in turn: shared memory (B 128 KB, the buffer 72 KB at
//   C = 64) holds no second buffer for the next chunk.  Two pairs of
//   warpgroups on two 40 KB buffers of 64-frame tiles, run apart so that
//   one's product would overlap the other's FMA work, measured no faster.
// - K16's stages (Stage above) take phases out of this template, so each
//   stage's time less kFull's is that phase's cost in the design K1 runs:
//   kNoFir and kMatmulOnly stage their z rows straight from the input at
//   z's stride and skip phase 2 (kNoFir: z row r = window row r, frame
//   c0 - P + 1 + r; kMatmulOnly: frame c0 + r, no history); kNoDemod and
//   kMatmulOnly read no lag frame, so they skip the block's first one
//   (its product included); kFullRate runs phase 5 at D = 1 and writes
//   dr beside each angle, from the y rows in place.

constexpr int kTcThreads = 512;        // four warpgroups
constexpr int kTcTile = 64;            // rows of a wgmma tile (m64)
constexpr int kTcChunk = 2 * kTcTile;  // frames a chunk: two tiles

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int C>
struct TcPlan {
    static constexpr int N = 2 * C;                 // lanes, and K
    static constexpr int NH = N / 2;                // a warpgroup's columns
    static constexpr int kSteps = N / 8;            // k steps of 8
    static constexpr int FG = kTcThreads / N;       // FIR row groups
    static constexpr int FR = kTcChunk / FG;        // FIR frames a thread
    static constexpr int kPass = FR < 16 ? FR : 16; // ... a pass
    static constexpr int ZS = N + 4;                // z row stride, floats
    static constexpr int YS = N + 8;                // y row stride, floats
    static constexpr int kSpanBytes = N * 128;      // 32 k of every n
    static constexpr int kBBytes = (N + 31) / 32 * kSpanBytes;   // a B tile
    static constexpr int kWinRows = kTcChunk + kMaxTaps - 1;
    static constexpr int kUBytes =
        cmax(kWinRows * N, cmax(kTcChunk * ZS, (kTcChunk + 1) * YS)) * 4;
    // + 1024: B is aligned to the swizzle's 1024 bytes; + the lag row
    static constexpr int kSmem = 1024 + 2 * kBBytes + kUBytes + N * 4;
    static_assert(kTcThreads % N == 0 && kTcChunk % FG == 0, "FIR groups");
    static_assert(FR % kPass == 0, "passes");
    static_assert(kSmem <= 227 * 1024, "a block's shared memory on sm_90");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
    return r;
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
// until at most N committed groups of the warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// d += a b: a 64 x 8 tf32 from registers (4 a thread: rows r, r + 8 of
// columns t and t + 4), b 8 x NH from shared memory; d, 64 x NH fp32, as
// pairs 4j, 4j + 1 at row r, columns 8j + 2t, + 1, and 4j + 2, 4j + 3 at
// row r + 8 (r = 16 warp + lane / 4, t = lane % 4)
template <int NH> struct TcMma;

#define TC_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

template <> struct TcMma<8> {
    static __device__ __forceinline__ void run(float (&d)[4],
                                               const uint32_t* a,
                                               uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
            "%0, %1, %2, %3"
            "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
            : TC_ACC4(0)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

template <> struct TcMma<16> {
    static __device__ __forceinline__ void run(float (&d)[8],
                                               const uint32_t* a,
                                               uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
            "%0, %1, %2, %3, %4, %5, %6, %7"
            "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
            : TC_ACC4(0), TC_ACC4(4)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

template <> struct TcMma<32> {
    static __device__ __forceinline__ void run(float (&d)[16],
                                               const uint32_t* a,
                                               uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
            "%13, %14, %15"
            "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
            : TC_ACC4(0), TC_ACC4(4), TC_ACC4(8), TC_ACC4(12)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

template <> struct TcMma<64> {
    static __device__ __forceinline__ void run(float (&d)[32],
                                               const uint32_t* a,
                                               uint64_t b) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
            "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31"
            "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
            : TC_ACC4(0), TC_ACC4(4), TC_ACC4(8), TC_ACC4(12), TC_ACC4(16),
              TC_ACC4(20), TC_ACC4(24), TC_ACC4(28)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
    }
};

#undef TC_ACC4

// B (N x N, b[k N + n]) into shared memory as [n][k], K-major, in the
// 128-byte swizzle (the 16-byte chunk index XOR n mod 8), hi at bs and lo a
// tile further on: an item is 4 consecutive k of one n, the lanes of a
// warp on consecutive n (coalesced loads, conflict-free stores).  At N = 16
// a row holds 16 of its 32 k.
template <int C>
__device__ __forceinline__ void tc_stage_b(const float* b, unsigned char* bs,
                                           int tid) {
    using T = TcPlan<C>;
    constexpr int N = T::N;
    for (int it = tid; it < N * N / 4; it += kTcThreads) {
        const int n = it % N, k0 = (it / N) * 4;
        const uint32_t off = (k0 / 32) * T::kSpanBytes + n * 128 +
                             ((((k0 % 32) / 4) ^ (n & 7)) << 4);
        uint32_t h[4], l[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float v = __ldg(b + (k0 + e) * N + n);
            h[e] = to_tf32(v);
            l[e] = to_tf32(v - __uint_as_float(h[e]));
        }
        *reinterpret_cast<uint4*>(bs + off) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(bs + T::kBBytes + off) =
            make_uint4(l[0], l[1], l[2], l[3]);
    }
}

// four consecutive values of a row as float32, in one load
__device__ __forceinline__ float4 load4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const int16_t* p) {
    const short4 v = __ldg(reinterpret_cast<const short4*>(p));
    return make_float4(v.x, v.y, v.z, v.w);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
    const char4 v = __ldg(reinterpret_cast<const char4*>(p));
    return make_float4(v.x, v.y, v.z, v.w);
}

// window rows [r0, r1) of the chunk at frame c0 into sw, RS floats apart,
// as float32: row r is frame c0 - P + 1 + r, from hist (its H rows end at
// frame -1) where that is negative.  Four values a load where x and hist
// are 16-byte aligned (then every row is: a row is N >= 16 values and RS a
// multiple of 4), else one.
template <typename Tin, int N, int RS = N>
__device__ __forceinline__ void tc_stage_window(
        float* sw, const Tin* x, const Tin* hist, int c0, int r0, int r1,
        int P, int H, bool vec, int tid) {
    const int f0 = c0 - P + 1;
    const auto quad = [&](int i) {
        const int r = r0 + i / (N / 4), v = i % (N / 4), f = f0 + r;
        const Tin* row = f < 0 ? hist + (size_t)(H + f) * N
                               : x + (size_t)f * N;
        reinterpret_cast<float4*>(sw + (size_t)r * RS)[v] = load4(row + 4 * v);
    };
    if (vec && sizeof(Tin) == 4) {
        for (int i = tid; i < (r1 - r0) * (N / 4); i += kTcThreads) quad(i);
    } else if (vec) {
        // one load a thread in flight: unrolled, the integer instances
        // spill at C = 64
#pragma unroll 1
        for (int i = tid; i < (r1 - r0) * (N / 4); i += kTcThreads) quad(i);
    } else {
#pragma unroll 1
        for (int i = tid; i < (r1 - r0) * N; i += kTcThreads) {
            const int r = r0 + i / N, l = i % N, f = f0 + r;
            const Tin* row = f < 0 ? hist + (size_t)(H + f) * N
                                   : x + (size_t)f * N;
            sw[(size_t)r * RS + l] = static_cast<float>(row[l]);
        }
    }
}

// z rows 0..127 of the chunk from its window, in place in u: thread
// (q, l) = (tid / N, tid % N) filters frames q FR .. q FR + FR - 1 of lane
// l, z[r] = sum_p window[r + p] hp[p] in the order p = 0 .. P - 1
template <int C>
__device__ __forceinline__ void tc_fir(unsigned char* u,
                                       const float* __restrict__ hp, int P,
                                       int tid) {
    using T = TcPlan<C>;
    constexpr int N = T::N, FR = T::FR, ZS = T::ZS, kPass = T::kPass;
    const int l = tid % N, q = tid / N;
    const float* sw = reinterpret_cast<const float*>(u) + q * FR * N + l;
    float h[kMaxTaps];
#pragma unroll
    for (int p = 0; p < kMaxTaps; ++p)
        h[p] = p < P ? __ldg(hp + p * N + l) : 0.f;
    float z[FR];
#pragma unroll
    for (int i0 = 0; i0 < FR; i0 += kPass) {
        float w[kPass + kMaxTaps - 1];
#pragma unroll
        for (int i = 0; i < kPass + kMaxTaps - 1; ++i)
            w[i] = i < kPass + P - 1 ? sw[(i0 + i) * N] : 0.f;
#pragma unroll
        for (int i = 0; i < kPass; ++i) z[i0 + i] = w[i] * h[0];
#pragma unroll
        for (int p = 1; p < kMaxTaps; ++p)
            if (p < P) {
#pragma unroll
                for (int i = 0; i < kPass; ++i)
                    z[i0 + i] = fmaf(w[i + p], h[p], z[i0 + i]);
            }
    }
    __syncthreads();                   // the window is read: z replaces it
    float* sz = reinterpret_cast<float*>(u) + q * FR * ZS + l;
#pragma unroll
    for (int i = 0; i < FR; ++i) sz[i * ZS] = z[i];
}

// d = z rows 64 tile .. + 63 @ B columns NH half .. + NH - 1, by the
// calling warpgroup (warp w of it), 3xTF32: lo*hi, hi*lo, hi*hi a k step,
// A a k step at a time, two steps in flight
template <int C>
__device__ __forceinline__ void tc_product(float (&d)[C / 2], const float* sz,
                                           uint32_t b_base, int tile,
                                           int half, int w, int lane) {
    using T = TcPlan<C>;
    constexpr int ZS = T::ZS, NH = T::NH;
    const int g = lane >> 2, t = lane & 3;
    const float* a0 = sz + (kTcTile * tile + 16 * w + g) * ZS + t;
    const uint32_t bh0 = b_base + half * NH * 128;     // 8-row groups
#pragma unroll
    for (int q = 0; q < C / 2; ++q) d[q] = 0.f;
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int kk = 0; kk < T::kSteps; ++kk) {
        // the step two back, whose registers this one takes, is done
        if (kk >= 2) wgmma_wait<1>();
        const int b = kk & 1;
        const float* p = a0 + 8 * kk;
        const float v[4] = {p[0], p[8 * ZS], p[4], p[8 * ZS + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            ah[b][e] = to_tf32(v[e]);
            al[b][e] = to_tf32(v[e] - __uint_as_float(ah[b][e]));
        }
        wgmma_fence();
        const uint32_t boff = (kk >> 2) * T::kSpanBytes + (kk & 3) * 32;
        const uint64_t bh = sw128_desc(bh0 + boff);
        TcMma<NH>::run(d, al[b], bh);          // the small terms first
        TcMma<NH>::run(d, ah[b], sw128_desc(bh0 + T::kBBytes + boff));
        TcMma<NH>::run(d, ah[b], bh);
        wgmma_commit();
    }
    wgmma_wait<0>();
}

template <typename Tin, int C, int A, int Stage = kFull>
__global__ void __launch_bounds__(kTcThreads, 1)
channelize_tc_kernel(const Tin* __restrict__ x, const Tin* __restrict__ hist,
                     const float* __restrict__ hp, const float* __restrict__ b,
                     float* __restrict__ out, int M, int P, int H, int D,
                     int coherent, float gain) {
    using T = TcPlan<C>;
    constexpr int N = T::N, NH = T::NH, YS = T::YS, ZS = T::ZS;
    // the stage filters its window (phase 2), or takes z from the input
    constexpr bool kFir = Stage != kNoFir && Stage != kMatmulOnly;
    // the stage reads the lag frame y[c0 - 1]
    constexpr bool kLag = Stage != kNoDemod && Stage != kMatmulOnly;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* bs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023))
                                    & 1023);            // B hi, then B lo
    unsigned char* u = bs + 2 * T::kBBytes;    // the window, z, y in turn
    float* lag = reinterpret_cast<float*>(u + T::kUBytes);  // y[c0 - 1]
    float* sw = reinterpret_cast<float*>(u);
    float* sy = reinterpret_cast<float*>(u);
    const int tid = threadIdx.x, lane = tid & 31, w = (tid >> 5) & 3;
    const int tile = tid >> 8, half = (tid >> 7) & 1;
    const bool vec = ((reinterpret_cast<uintptr_t>(x) |
                       reinterpret_cast<uintptr_t>(hist)) & 15) == 0;
    const int chunks = (M + kTcChunk - 1) / kTcChunk;
    const int c_begin = (int)((long long)blockIdx.x * chunks / gridDim.x);
    const int c_end = (int)((long long)(blockIdx.x + 1) * chunks / gridDim.x);
    const uint32_t b_base = smem_addr(bs);
    // the window's rows before the chunk's first frame, plus one
    const int Pw = Stage == kMatmulOnly ? 1 : P;
    float d[C / 2];

    tc_stage_b<C>(b, bs, tid);
    // B's generic stores, before wgmma (the async proxy) reads them
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if constexpr (kLag) {
        // the block's first lag frame: row 127 of the chunk before c_begin
        // (the window rows it reads alone), as tile 1, row 63 of that
        // chunk.  The other window (kNoFir: z) rows are zeros: the FIR and
        // tile 1 run whole, but a y row depends on its own z row only, and
        // rows other than 127 are never read
        if constexpr (kFir) {
            for (int i = tid; i < (kTcChunk - 1) * N; i += kTcThreads)
                sw[i] = 0.f;
            tc_stage_window<Tin, N>(sw, x, hist, (c_begin - 1) * kTcChunk,
                                    kTcChunk - 1, kTcChunk - 1 + P, P, H,
                                    vec, tid);
            __syncthreads();
            tc_fir<C>(u, hp, P, tid);
        } else {
            for (int i = tid; i < (kTcChunk - 1) * ZS; i += kTcThreads)
                sw[i] = 0.f;
            tc_stage_window<Tin, N, ZS>(sw, x, hist,
                                        (c_begin - 1) * kTcChunk,
                                        kTcChunk - 1, kTcChunk, P, H, vec,
                                        tid);
        }
        __syncthreads();
        if (tile == 1) {
            tc_product<C>(d, sy, b_base, 1, half, w, lane);
            if (w == 3 && (lane >> 2) == 7)
#pragma unroll
                for (int j = 0; j < NH / 8; ++j) {
                    const int col = half * NH + 8 * j + 2 * (lane & 3);
                    lag[col] = d[4 * j + 2];
                    lag[col + 1] = d[4 * j + 3];
                }
        }
        __syncthreads();
    }

    for (int c = c_begin; c < c_end; ++c) {
        const int c0 = c * kTcChunk;
        const int nf = min(kTcChunk, M - c0);
        if constexpr (kFir) {
            // 1-2. the window, then z in its place
            tc_stage_window<Tin, N>(sw, x, hist, c0, 0, nf + P - 1, P, H,
                                    vec, tid);
            __syncthreads();
            tc_fir<C>(u, hp, P, tid);
        } else {
            // 1. z row r is window row r (Pw = 1: frame c0 + r), at z's
            //    stride
            tc_stage_window<Tin, N, ZS>(sw, x, hist, c0, 0, nf, Pw, H, vec,
                                        tid);
        }
        __syncthreads();
        // the next chunk's rows into L2 while the tensor cores run
        if (c + 1 < c_end) {
            const int f1 = c0 + kTcChunk - Pw + 1;
            const char* p0 = reinterpret_cast<const char*>(x + (size_t)f1 * N);
            const int bytes = (min(M, c0 + 2 * kTcChunk) - f1) * N *
                              (int)sizeof(Tin);
            for (int off = tid * 128; off < bytes; off += kTcThreads * 128)
                asm volatile("prefetch.L2 [%0];" :: "l"(p0 + off));
        }
        // 3. the product
        tc_product<C>(d, sy, b_base, tile, half, w, lane);
        __syncthreads();               // every A fragment is read
        // 4. y rows 1.. replace z; row 0 is the lag frame
        {
            const int r = kTcTile * tile + 16 * w + (lane >> 2);
#pragma unroll
            for (int j = 0; j < NH / 8; ++j) {
                const int col = half * NH + 8 * j + 2 * (lane & 3);
                *reinterpret_cast<float2*>(sy + (1 + r) * YS + col) =
                    make_float2(d[4 * j], d[4 * j + 1]);
                *reinterpret_cast<float2*>(sy + (9 + r) * YS + col) =
                    make_float2(d[4 * j + 2], d[4 * j + 3]);
            }
            if constexpr (kLag)
                if (tid < N) sy[tid] = lag[tid];
        }
        __syncthreads();
        // 5. lag product, discriminator and boxcar decimation; kFullRate
        //    (D = 1) also writes dr beside each angle, in rows of 2C.  A
        //    loop of its own over the frames ran ~10% faster but spilled
        //    16-48 bytes at C = 64 in each of eight forms tried (loop
        //    invariants held across the product)
        const int na = nf / D;
        const float inv_d = 1.f / (float)D;
        for (int i = tid; i < na * C; i += kTcThreads) {
            const int j = i / C, cc = i - j * C;
            float s_r = 0.f, s_i = 0.f;
            const float* row = sy + j * D * YS + cc;   // y of frame jD - 1
            float pr = row[0], pi = row[C];
            for (int dd = 0; dd < D; ++dd) {
                row += YS;                             // frame m = jD + dd
                if constexpr (!kLag) {
                    s_r += row[0];                     // Re y[m]
                } else {
                    const float yr = row[0], yi = row[C];
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
                    if constexpr (Stage == kFullRate)
                        out[(size_t)(c0 + j) * N + C + cc] = dr;
                    pr = yr;
                    pi = yi;
                }
            }
            out[(size_t)(c0 / D + j) * (Stage == kFullRate ? N : C) + cc] =
                Stage == kMatmulOnly ? s_r * inv_d
                : Stage != kNoAtan && coherent
                    ? atan2_poly<A>(s_i * inv_d, s_r * inv_d) * gain
                    : s_r * gain * inv_d;
        }
        if constexpr (kLag)
            if (tid < N) lag[tid] = sy[nf * YS + tid];     // y[c0 + 127]
        __syncthreads();
    }
}

template <typename Tin, int C, int A, int Stage = kFull>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
    using T = TcPlan<C>;
    auto kernel = channelize_tc_kernel<Tin, C, A, Stage>;
    // kFullRate's epilogue indexes its output rows by frame at D = 1
    if constexpr (Stage == kFullRate)
        if (a.D != 1) return cudaErrorInvalidValue;
    static std::atomic<uint64_t> raised{0};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const uint64_t bit = uint64_t{1} << (dev & 63);
    if (!(raised.load(std::memory_order_acquire) & bit)) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
        if (err != cudaSuccess) return err;
        raised.fetch_or(bit, std::memory_order_release);
    }
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const int chunks = (a.M + kTcChunk - 1) / kTcChunk;
    const int grid = chunks < sms ? chunks : sms;    // persistent blocks
    kernel<<<grid, kTcThreads, T::kSmem, stream>>>(
        static_cast<const Tin*>(a.x), static_cast<const Tin*>(a.hist), a.hp,
        a.b, a.out, a.M, a.P, a.H, a.D, a.coherent, a.gain);
    return cudaGetLastError();
}

// K1 and K9: the tensor-core template at every C (faster than the FFMA
// template at each, PERF.md)
template <typename Tin, int A>
cudaError_t launch_decim(int C, const Args& a, cudaStream_t stream) {
    switch (C) {
        case 8:  return launch_tc<Tin, 8, A>(a, stream);
        case 16: return launch_tc<Tin, 16, A>(a, stream);
        case 32: return launch_tc<Tin, 32, A>(a, stream);
        case 64: return launch_tc<Tin, 64, A>(a, stream);
        default: return cudaErrorInvalidValue;
    }
}

// K16 is instantiated for C = 8 and 64 only (its small shapes and its
// probe): six stages for every C would lengthen this source's build.
template <int Stage>
cudaError_t launch_ablate(int C, const Args& a, cudaStream_t stream) {
    switch (C) {
        case 8:  return launch_tc<float, 8, kPoly5Div, Stage>(a, stream);
        case 64: return launch_tc<float, 64, kPoly5Div, Stage>(a, stream);
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
        case 0: return (int)launch_decim<float, kPoly3Div>(C, a, s);
        case 1: return (int)launch_decim<int8_t, kPoly3Div>(C, a, s);
        case 2: return (int)launch_decim<int16_t, kPoly3Div>(C, a, s);
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
    return (int)launch_c<true>(C, a, static_cast<cudaStream_t>(stream));
}

// K9: float32 x and hist (P rows), hp (P, 2C), bperm (2C, 2C), classic.
extern "C" int channelize_demod_decim_v6_launch(
        const void* x, const void* hist, const void* hp, const void* bperm,
        void* out, int M, int C, int P, int D, float gain, void* stream) {
    if (bad_shape(M, P, D)) return (int)cudaErrorInvalidValue;
    const Args a{x, hist, static_cast<const float*>(hp),
                 static_cast<const float*>(bperm), nullptr,
                 static_cast<float*>(out), nullptr, M, P, P, D, 0, gain};
    return (int)launch_decim<float, kPoly5Rcp>(
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
    return folded ? (int)launch_c<true>(C, a, s)
                  : (int)launch_c<false>(C, a, s);
}

// K16: float32 x and hist (P rows, unread by kMatmulOnly), hp (P, 2C),
// bperm (2C, 2C), the 5-term atan2 with a true division, C 8 or 64, on the
// tensor-core template.  stage: a Stage; out (M / D, C), or (M, 2C) for
// kFullRate, which ignores D.
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
