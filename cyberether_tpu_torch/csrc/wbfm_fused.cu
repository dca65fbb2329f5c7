// WBFM front end: real channel FIR + lag-1 FM discriminator (+ optional
// coherent decimation), in one pass, for Hopper (sm_90a).
//
// Replaces two TPU kernels of cyberether_tpu/ops/pallas_kernels.py:
//   wbfm_fused_v2 (_wbfm_kernel_v2): raw interleaved IQ (n, 2), 3-term
//     atan2, classic or coherent (wbfm_fused_v2_launch);
//   wbfm_fused (_wbfm_kernel): planar IQ (2, n), 5-term atan2, classic
//     (wbfm_fused_launch).
// One templated kernel serves both: input layout x polynomial, with the
// coherent group size D a runtime argument (0 = classic).
//
// Contract, for real taps h (T <= 129) and hist (2, T-1) planar, the last
// raw samples of the previous block (X[-K..-1], K = T-1):
//   y[j]  = sum_{k<T} h[k] X[j-k],   j = -1 .. n-1, X[s] = 0 for s < -K
//           (the lag of the first sample is filtered from hist alone)
//   dr + i*di = conj(y[j-1]) * y[j]
//   classic:  out[j] = atan2(di, dr) * gain                   (n,)
//   coherent: out[g] = atan2(mean di, mean dr) * gain over the group of
//             samples [gD, (g+1)D)                             (n // D,)
// with a polynomial atan2 and a true fp32 division.
//
// What bounds it on this card: operations.  At full width (n = 8,192,000,
// T = 129) the direct-form FIR is 2*2*T*n = 4.2 GFLOP against 98 MB of
// input and output: ~43 FLOP/byte, twice the H100's fp32 ridge (67 TFLOP/s
// over 3.35 TB/s).  So the FMA pipes, not HBM, set the floor.
//
// What the design does about it:
// - Each block owns up to 2176 consecutive samples (whole groups of D in
//   coherent mode) and stages its own window of raw samples, plus the T
//   before them (from hist for the first block), in shared memory.  Blocks
//   are independent: the lag sample y[start-1] is recomputed from the window
//   by one warp, so no halo array or carry crosses blocks.
// - Each thread computes 17 consecutive outputs, register-tiled: for every
//   8 taps it loads 24 window values per component once and issues 272
//   FFMAs, so shared-memory traffic stays under the FMA rate.  17 is odd,
//   so the lanes' strided shared loads and stores hit 32 distinct banks.
// - The taps sit in shared memory (every lane reads the same one: a
//   broadcast), zero-padded to a multiple of 8.
// - fp32 FFMA only, no TF32: the output is held to 1e-4 of the plain
//   version.
// The TPU kernels' band matrices, halo scalars and selector table are
// layout devices of the TPU's matrix unit and are not needed here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 17;                   // outputs per thread (odd)
constexpr int kSpan = kThreads * kPerThread;     // 2176 outputs per block
constexpr int kMaxTaps = 129;
constexpr int kTapStep = 8;
constexpr int kMaxTapsPad = (kMaxTaps + kTapStep - 1) / kTapStep * kTapStep;
constexpr int kWin = kSpan + kMaxTapsPad;        // staged window samples

template <bool Poly3>
__device__ __forceinline__ float atan2_poly(float y, float x) {
    const float ax = fabsf(x), ay = fabsf(y);
    const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
    const bool red = lo > 0.41421356f * hi;
    const float num = red ? lo - hi : lo;
    const float den = red ? lo + hi : hi;
    const float u = num / fmaxf(den, 1e-30f);   // IEEE division
    const float z = u * u;
    float a;
    if (Poly3) {                                // max error 7.3e-6 rad
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

// conj(p) * y, each product and sum rounded on its own (no FMA
// contraction), as the plain version's separate tensor ops round them.
// Where the two products nearly cancel (the first samples after a zero
// history, where the taps' ~1e-18 end values dominate y), the sign of di is
// rounding noise, and any other rounding would flip the angle by 2*pi.
__device__ __forceinline__ void lag_product(float pr, float pi, float yr,
                                            float yi, float& dr, float& di) {
    dr = __fadd_rn(__fmul_rn(pr, yr), __fmul_rn(pi, yi));
    di = __fsub_rn(__fmul_rn(pr, yi), __fmul_rn(pi, yr));
}

template <bool Planar, bool Poly3>
__global__ void __launch_bounds__(kThreads, 4)
wbfm_kernel(const float* __restrict__ x, const float* __restrict__ hist,
            const float* __restrict__ taps, float* __restrict__ out,
            int n, int T, int D, int span, float gain) {
    __shared__ float sG[kMaxTapsPad];            // taps, oldest sample first
    __shared__ float sWr[kWin], sWi[kWin];       // raw window
    __shared__ float sYr[kSpan + 1], sYi[kSpan + 1];   // y[start-1 ..]

    const int tid = threadIdx.x;
    const int K = T - 1;
    const int Tp = (T + kTapStep - 1) / kTapStep * kTapStep;
    const int64_t start = (int64_t)blockIdx.x * span;

    // 1. stage taps (sG[q] = h[K-q]) and the window sW[i] = X[start - T + i]
    for (int q = tid; q < Tp; q += kThreads)
        sG[q] = q < T ? __ldg(taps + K - q) : 0.f;
    for (int i = tid; i < kSpan + Tp; i += kThreads) {
        const int64_t s = start - T + i;
        float re = 0.f, im = 0.f;
        if (s >= 0 && s < n) {
            if (Planar) {
                re = __ldg(x + s);
                im = __ldg(x + n + s);
            } else {
                const float2 v = __ldg(reinterpret_cast<const float2*>(x) + s);
                re = v.x;
                im = v.y;
            }
        } else if (s < 0 && s >= -K) {
            re = __ldg(hist + K + s);
            im = __ldg(hist + 2 * K + s);
        }
        sWr[i] = re;
        sWi[i] = im;
    }
    __syncthreads();

    // 2. FIR.  y[start + p] = sum_{q<T} sG[q] * sW[p + 1 + q]
    //    the lag sample (p = -1): one warp, lanes over taps, then a reduction
    if (tid < 32) {
        float ar = 0.f, ai = 0.f;
        for (int q = tid; q < T; q += 32) {
            ar = fmaf(sG[q], sWr[q], ar);
            ai = fmaf(sG[q], sWi[q], ai);
        }
#pragma unroll
        for (int o = 16; o; o >>= 1) {
            ar += __shfl_xor_sync(0xffffffffu, ar, o);
            ai += __shfl_xor_sync(0xffffffffu, ai, o);
        }
        if (tid == 0) {
            sYr[0] = ar;
            sYi[0] = ai;
        }
    }
    //    the block's samples: thread t owns p = 17t .. 17t + 16
    {
        float accr[kPerThread], acci[kPerThread];
#pragma unroll
        for (int o = 0; o < kPerThread; ++o) accr[o] = acci[o] = 0.f;
        const int b = tid * kPerThread + 1;
        for (int q0 = 0; q0 < Tp; q0 += kTapStep) {
            float wr[kPerThread + kTapStep - 1], wi[kPerThread + kTapStep - 1];
#pragma unroll
            for (int i = 0; i < kPerThread + kTapStep - 1; ++i) {
                wr[i] = sWr[b + q0 + i];
                wi[i] = sWi[b + q0 + i];
            }
#pragma unroll
            for (int dq = 0; dq < kTapStep; ++dq) {
                const float g = sG[q0 + dq];
#pragma unroll
                for (int o = 0; o < kPerThread; ++o) {
                    accr[o] = fmaf(g, wr[o + dq], accr[o]);
                    acci[o] = fmaf(g, wi[o + dq], acci[o]);
                }
            }
        }
#pragma unroll
        for (int o = 0; o < kPerThread; ++o) {
            sYr[b + o] = accr[o];
            sYi[b + o] = acci[o];
        }
    }
    __syncthreads();

    // 3. lag products and discriminator.  sY[p] holds y[start + p - 1]
    if (D == 0) {
        const int64_t left = (int64_t)n - start;
        const int nf = left < span ? (int)left : span;
        for (int p = tid; p < nf; p += kThreads) {
            float dr, di;
            lag_product(sYr[p], sYi[p], sYr[p + 1], sYi[p + 1], dr, di);
            out[start + p] = atan2_poly<Poly3>(di, dr) * gain;
        }
    } else {
        const int64_t g0 = start / D;
        const int64_t left = (int64_t)(n / D) - g0;
        const int ng = left < span / D ? (int)left : span / D;
        const float fd = (float)D;
        for (int g = tid; g < ng; g += kThreads) {
            float sr = 0.f, si = 0.f;
            for (int p = g * D; p < (g + 1) * D; ++p) {
                float dr, di;
                lag_product(sYr[p], sYi[p], sYr[p + 1], sYi[p + 1], dr, di);
                sr += dr;
                si += di;
            }
            out[g0 + g] = atan2_poly<Poly3>(si / fd, sr / fd) * gain;
        }
    }
}

template <bool Planar, bool Poly3>
int launch(const void* x, const void* hist, const void* taps, void* out,
           int n, int T, int D, float gain, void* stream) {
    if (n < 1 || T < 1 || T > kMaxTaps || D < 0 || D > kSpan)
        return (int)cudaErrorInvalidValue;
    // coherent blocks hold whole groups; the last block may hold fewer
    const int span = D ? D * (kSpan / D) : kSpan;
    const int64_t grid = D ? ((int64_t)(n / D) + span / D - 1) / (span / D)
                           : ((int64_t)n + span - 1) / span;
    if (grid == 0) return (int)cudaSuccess;     // no whole group: no output
    wbfm_kernel<Planar, Poly3><<<(unsigned)grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(hist),
        static_cast<const float*>(taps), static_cast<float*>(out), n, T, D,
        span, gain);
    return (int)cudaGetLastError();
}

}  // namespace

// K4: iq (n, 2) interleaved float32; D = 0 classic -> out (n,), D > 0
// coherent -> out (n // D,).  Returns the launch's CUDA error code.
extern "C" int wbfm_fused_v2_launch(const void* iq, const void* hist,
                                    const void* taps, void* out, int n,
                                    int T, int D, float gain, void* stream) {
    return launch<false, true>(iq, hist, taps, out, n, T, D, gain, stream);
}

// K12: x (2, n) planar float32 -> out (n,).
extern "C" int wbfm_fused_launch(const void* x, const void* hist,
                                 const void* taps, void* out, int n, int T,
                                 float gain, void* stream) {
    return launch<true, false>(x, hist, taps, out, n, T, 0, gain, stream);
}
