// Radix-2 FFTs in shared memory, for Hopper (sm_90a): two kernels that
// run the same radix-2 butterflies, with three C entry points: K2, K5 (which K10
// shares) and K11.  (K3, the C2C FFT, runs the Stockham core of
// csrc/spectrum_fft.cu.)
//
// K2, the fused spectrum: window, n-point FFT, |X|^2 in dB, range scale
// and soft clip, in one pass.  Replaces spectrum_fused_ct5
// (_spectrum_ct5_kernel) of cyberether_tpu/ops/pallas_kernels.py.
//
// Contract, per row b of iq (B, n, 2) float32 interleaved re/im, with the
// window win (n,) already holding the (-1)^k sign:
//   X[k]  = sum_t win[t] * (re[t] + j im[t]) * exp(-2 pi j t k / n)
//   db[k] = 10 * log10(|X[k]|^2) + coeff     (log10 as ln * 0.4342944819,
//           the JAX kernel's form; |X|^2 = 0 gives -inf)
//   out[b, k] = 0.5 + 0.5 * tanh(4 * (db[k] * scale + offset - 0.5))
// in natural bin order, for n = 128 * m with m a power of two <= 32
// (n = 128 .. 4096).  An all-zero row gives exactly 0.
//
// What bounds it on this card: bytes.  At full width (B = 4096,
// n = 2048) K2 reads 67.1 MB and writes 33.6 MB: 0.030 ms at 3.35 TB/s,
// against ~0.9 GFLOP of fp32 work (5 n log2 n a row for the FFT, the
// window, |X|^2 and the epilogue): ~0.014 ms at 67 TFLOP/s.
//
// What the design does about it:
// - Each input element is read from device memory once and each output
//   written once, both coalesced (a float2 per sample).  Everything in
//   between stays in shared memory: a block loads its rows, with the
//   window applied, into shared memory at bit-reversed positions
//   (__brev), runs the log2 n radix-2 decimation-in-time passes in place
//   there (radix2_passes, whose butterflies the ct kernel runs in
//   registers), with a barrier
//   between passes, and writes natural order through the epilogue.
// - A block holds max(1, 1024 / n) rows, so every block has at least 512
//   butterflies a pass for its 256 threads; the shared buffer is at most
//   32 KB (n = 4096), under the default 48 KB.
// - Twiddles exp(-2 pi j k / n), k < n/2, come from a table computed in
//   float64 on the host and stored as float32; pass s reads every
//   (n / 2^(s+1))-th entry.  No sincosf.
// - fp32 FFMA only, no tensor cores; logf and tanhf are the accurate
//   library functions (the file is compiled without --use_fast_math).
//   Every product of the transform up to |X|^2 is an explicit fmaf or
//   __fmul_rn (cmul, mag2_of, the ct kernel's m-point stage and twiddle),
//   so that the plain versions (ops/kernels.py) round each of those steps
//   alike: the FFT's cancellation at a spectrum's deep nulls would
//   amplify any other difference of rounding.  The epilogues' scalar
//   arithmetic after |X|^2 (the dB scale, alog10's cubic, atanh_pade) is
//   left to nvcc's default contraction (-fmad=true); a last-bit
//   difference there is not amplified.
// The TPU kernels' m x 128 split, their 64-point sub-DFT matrices, bf16
// hi/lo splits, batch tiles and un-permute are devices of the TPU's
// matrix unit and VMEM and are not needed here.
//
// K5, the fused spectrum for n = 128 m with any 1 <= m <= 32 (m not a
// power of two has no radix-2 FFT): K2's contract.  Replaces
// spectrum_fused_ct4 (_spectrum_ct4_kernel) of
// cyberether_tpu/ops/pallas_kernels.py.  With t = 128 n1 + n2 and
// k = m k2 + k1:
//   X[m k2 + k1] = sum_n2 W_128^(n2 k2) W_n^(n2 k1)
//                        sum_n1 x[128 n1 + n2] W_m^(n1 k1)
// What bounds it: bytes at m = 12 (B = 5461, n = 1536: 67.1 MB in,
// 33.6 MB out, 0.030 ms, against 1.6 GFLOP, 0.024 ms); its direct
// m-point stage costs 4 m^2 128 FFMA a row, so operations bound it from
// m = 19 on.  What the design does about it:
// - A thread owns one column n2 of a row: it loads the m samples
//   x[128 n1 + n2] once, coalesced across the warp, windowed, into
//   registers (an instance for each bucket of m: <= 8, <= 16, <= 32, so
//   that a small m holds few), and computes its k1 outputs of the m-point
//   DFT from them, times the twiddle W_n^(k1 n2).  Both twiddles come
//   from one n-entry table (W_m^a = W_n^(128 a)), the same for every
//   thread of a warp in stage 1 (a broadcast).  m = 16, the spectrum's
//   default fft_size 2048, has an instance of its own with every stage-1
//   index compiled in and the m entries W_m^a in registers: no table
//   loads or index arithmetic a product (1.7x faster at 4096 x 2048 on an
//   H100).  A
//   block holds max(1, 4096 / n) rows; with one row, two threads split a
//   column's k1 values so that all 256 threads work.
// - It writes Y[k1] at position brev7(n2) of a 128-point row, and the m
//   128-point transforms run radix2_passes' butterflies (K2's n = 128
//   table, the same pairs in the same order) in registers: stages 0-3 on
//   16 values a thread, one exchange through shared memory, stages 4-6
//   on 8 values 16 apart: two barriers for the seven stages.
// - Rows in shared memory carry one float2 of padding a 16 and, once
//   transformed, an odd row stride, so that each of those accesses hits
//   distinct banks and the epilogue's gather in bin order at most two a
//   bank; the epilogue stores coalesced rows and divides by m as a
//   multiply-shift.
// A block's two buffers (stage 1 and the exchange) take at most 68 KB;
// every instance is compiled for 2 blocks an SM (128 registers).
// K10 and K11 compute K5's function with K5's kernel, a template on one
// axis, the epilogue (exact: logf and tanhf; approx: alog10 and atanh_pade;
// mag2: |X|^2 itself).  K10 replaces spectrum_fused_ct (ct1,
// _spectrum_ct_kernel) and runs the exact instance through K5's entry
// point; its display tier (exact=False, one default-precision matrix pass
// on the TPU) runs the same fp32 kernel.  K11 replaces spectrum_fused_ct3
// (_spectrum_ct3_kernel): its stage-2 tiers (bf16 hi/lo splits, three or
// four products, the 3-multiply form) are devices of the TPU's matrix unit
// and all run the fp32 stage; its `ep` picks the instance, and its ablation
// flags (`skip`: "s1" every stage-1 output is windowed chunk 0, "tw" no
// twiddle, "s2" no 128-point stage) are uniform runtime flags of a second
// instance of each epilogue (ABLATE), launched only when a flag is set:
// read at run time in K5's instance they cost it 7%.  The output stays in
// natural bin order with "s2" too: the twiddled stage 1 is stored at its
// natural column instead of the bit-reversed one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinElems = 1024;      // rows per block: max(1, kMinElems / n)
constexpr int kMinLog2 = 7;          // n = 128
constexpr int kMaxLog2 = 12;         // n = 4096
constexpr int kMaxChunks = 32;       // K5: m <= 32

// w v in fp32, with the fused multiply-adds spelled out (no contraction
// left to the compiler), so that a plain version can round alike.
__device__ __forceinline__ float2 cmul(float2 w, float2 v) {
    return make_float2(fmaf(w.x, v.x, -__fmul_rn(w.y, v.y)),
                       fmaf(w.x, v.y, __fmul_rn(w.y, v.x)));
}

// |x|^2 as fma(re, re, im im), spelled out for the same reason.
__device__ __forceinline__ float mag2_of(float2 x) {
    return fmaf(x.x, x.x, __fmul_rn(x.y, x.y));
}

// log2 n radix-2 decimation-in-time passes, in place, over the `rows`
// rows of n = 2^log2n values in buf, each already in bit-reversed order;
// pass s joins pairs half = 2^s apart.  Every thread of the block calls
// it: it ends each pass with a barrier.
__device__ __forceinline__ void radix2_passes(float2* buf,
                                              const float2* __restrict__ tw,
                                              int log2n, int rows) {
    const int n = 1 << log2n;
    const int half_n = n >> 1;
    for (int s = 0; s < log2n; ++s) {
        const int half = 1 << s;
        const int tw_shift = log2n - 1 - s;
        for (int b = threadIdx.x; b < rows * half_n; b += kThreads) {
            const int r = b >> (log2n - 1);
            const int bb = b & (half_n - 1);
            const int j = bb & (half - 1);
            const int i0 = (r << log2n) + ((bb >> s) << (s + 1)) + j;
            const int i1 = i0 + half;
            const float2 w = __ldg(tw + (j << tw_shift));
            const float2 u = buf[i0];
            const float2 v = buf[i1];
            const float2 t = cmul(w, v);
            buf[i0] = make_float2(u.x + t.x, u.y + t.y);
            buf[i1] = make_float2(u.x - t.x, u.y - t.y);
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(kThreads)
spectrum_kernel(const float2* __restrict__ iq, const float* __restrict__ win,
                const float2* __restrict__ tw, float* __restrict__ out,
                int B, int log2n, int rows, float coeff, float scale,
                float offset) {
    extern __shared__ float2 buf[];                 // rows * n values

    const int n = 1 << log2n;
    const int total = rows * n;
    const int64_t row0 = (int64_t)blockIdx.x * rows;
    const int brev_shift = 32 - log2n;

    // 1. windowed load into bit-reversed positions (rows past B load zeros)
    for (int i = threadIdx.x; i < total; i += kThreads) {
        const int r = i >> log2n;
        const int t = i & (n - 1);
        float2 v = make_float2(0.f, 0.f);
        if (row0 + r < B) {
            const float2 x = __ldg(iq + (row0 + r) * n + t);
            const float w = __ldg(win + t);
            v = make_float2(x.x * w, x.y * w);
        }
        buf[(r << log2n) + (int)(__brev((unsigned)t) >> brev_shift)] = v;
    }
    __syncthreads();

    // 2. the FFT passes
    radix2_passes(buf, tw, log2n, rows);

    // 3. epilogue, natural bin order, coalesced stores
    for (int i = threadIdx.x; i < total; i += kThreads) {
        const int r = i >> log2n;
        if (row0 + r >= B) break;                   // later i: later rows
        const float mag2 = mag2_of(buf[i]);
        const float db = 10.f * (logf(mag2) * 0.43429448190325176f) + coeff;
        const float norm = db * scale + offset;
        out[row0 * n + i] = 0.5f + 0.5f * tanhf(4.f * (norm - 0.5f));
    }
}

// The ct kernels' epilogue, a template axis: what a bin's X becomes.
enum CtEpilogue {
    kEpExact = 0,        // K2's display value with logf and tanhf
    kEpApprox = 1,       // the same through alog10 and atanh_pade
    kEpMag2 = 2,         // |X|^2
};

// K11's ablation flags, uniform over a launch.
constexpr int kSkipS1 = 1;   // every stage-1 output is windowed chunk 0
constexpr int kSkipTw = 2;   // no twiddle W_n^(k1 n2)
constexpr int kSkipS2 = 4;   // no 128-point stage: Y is the twiddled stage 1
constexpr int kSkipAll = kSkipS1 | kSkipTw | kSkipS2;

// log10 x from the exponent bits and a cubic in the mantissa f in
// [0.5, 1): _alog10 of the TPU kernel.  x = 0 gives a finite -38.2.
__device__ __forceinline__ float alog10(float x) {
    const int bits = __float_as_int(x);
    const int e = ((bits >> 23) & 0xFF) - 126;
    const float f = __int_as_float((bits & 0x007FFFFF) | 0x3F000000);
    float y = 1.23149591368684f;
    y = y * f + -4.11852516267426f;
    y = y * f + 6.02197014179219f;
    y = y * f + -3.13396450166353f;
    y = y + (float)e;
    return y * 0.3010299956639812f;
}

// Padé(7,6) tanh clamped at |x| = 4.5, its division as rcp.approx and one
// Newton step: _atanh_pade of the TPU kernel.
__device__ __forceinline__ float atanh_pade(float x) {
    const float xc = fminf(fmaxf(x, -4.5f), 4.5f);
    const float x2 = xc * xc;
    const float num = xc * (135135.f + x2 * (17325.f + x2 * (378.f + x2)));
    const float den = 135135.f + x2 * (62370.f + x2 * (3150.f + x2 * 28.f));
    float r;
    asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(den));
    r = r * (2.f - den * r);                    // one Newton step
    return num * r;
}

template <int EP>
__device__ __forceinline__ float ct_epilogue(float2 x, float coeff,
                                             float scale, float offset) {
    const float mag2 = mag2_of(x);
    if (EP == kEpMag2) return mag2;
    if (EP == kEpApprox) {
        // the TPU kernel's floor f32(1e-60) is 0: alog10(0) is finite
        const float db = 10.f * alog10(mag2) + coeff;
        const float norm = db * scale + offset;
        return 0.5f + 0.5f * atanh_pade(4.f * (norm - 0.5f));
    }
    const float db = 10.f * (logf(mag2) * 0.43429448190325176f) + coeff;
    const float norm = db * scale + offset;
    return 0.5f + 0.5f * tanhf(4.f * (norm - 0.5f));
}

// The ct kernel's 128-point rows in shared memory: one float2 of padding
// after every 16 values (position p at p + p / 16), so that a group of
// 16 starts at 17 g; rows 136 values apart while the 128-point stage runs
// (a warp's two rows of 8 groups on distinct banks), 137 once it is done
// (the epilogue's gather across rows k1 on distinct banks).
constexpr int kRowPad = 136;
constexpr int kOutPad = 137;
constexpr int kCtElems = 4096;       // samples a block holds, at least a row

__device__ __forceinline__ int pad16(int p) { return p + (p >> 4); }

// one radix-2 butterfly of radix2_passes' stage s: v0 (position i0, bit s
// clear) and v1 (i0 + 2^s) with the twiddle of j = i0 mod 2^s
__device__ __forceinline__ void butterfly(float2& v0, float2& v1,
                                          const float2* __restrict__ tw128,
                                          int j, int s) {
    const float2 w = __ldg(tw128 + (j << (6 - s)));
    const float2 u = v0;
    const float2 t = cmul(w, v1);
    v0 = make_float2(u.x + t.x, u.y + t.y);
    v1 = make_float2(u.x - t.x, u.y - t.y);
}

// Blocks an SM an instance is compiled for.  Measured on an H100: at 3
// (80 registers) the fixed m = 16 instance spills 132 bytes and runs 12%
// slower, and the buckets run 1-10% slower.
constexpr int kCtMinBlocks = 2;

// K5, K10 and K11: n = 128 m, 1 <= m <= MAXM; a block holds `rows` rows,
// `split` threads share a stage-1 column.  ABLATE instances read K11's
// ablation flags from `flags` at run time; the others compile them out
// (reading them cost K5 7%).  FIXED instances (not ABLATE) take m = MAXM
// and split = 1 only: every index of stage 1 is known at compile time and
// the m entries W_m^a of its table stay in registers.  Every product and
// sum is radix2_passes' and stage 1's own, in their order (the plain
// versions model them); the values live
// - in stage 1, the m-point DFT over n1 and the twiddle, in registers: a
//   thread loads its column's m samples (MAXM of them: an instance a
//   bucket of m) and writes each k1 output to row k1 at position
//   brev7(n2), X;
// - in the 128-point stage, radix2_passes' seven stages, in registers: a
//   thread holds positions 16 g .. 16 g + 15 of a row for stages 0-3
//   (X -> Y), then positions p + 16 q for stages 4-6 (Y -> X): two
//   barriers for the seven stages, and no shared-memory round trip a
//   butterfly;
// - in the epilogue, which gathers X in bin order k = m k2 + k1 (k2 = k / m
//   by a multiply-shift), at most 2-way bank conflicts, and stores
//   coalesced rows.
template <int EP, bool ABLATE, int MAXM, bool FIXED>
__global__ void __launch_bounds__(kThreads, kCtMinBlocks)
spectrum_ct_kernel(const float2* __restrict__ iq,
                   const float* __restrict__ win,
                   const float2* __restrict__ tw,
                   const float2* __restrict__ tw128,
                   float* __restrict__ out, int B, int m, int rows,
                   int split, int flags, float coeff, float scale,
                   float offset) {
    extern __shared__ float2 buf[];      // X, rows * m * kOutPad, then Y
    float2* X = buf;
    float2* Y = buf + rows * m * kOutPad;
    const int skip = ABLATE ? flags : 0;
    static_assert(!(FIXED && ABLATE), "FIXED instances take no flags");
    if (FIXED) m = MAXM;

    const int n = m << 7;
    const int64_t row0 = (int64_t)blockIdx.x * rows;
    float2 wm[FIXED ? MAXM : 1];          // W_m^a = W_n^(128 a), a < m
    if constexpr (FIXED) {
#pragma unroll
        for (int a = 0; a < MAXM; ++a) wm[a] = __ldg(tw + (a << 7));
    }

    // 1. the m-point DFT over n1 and the twiddle, one column n2 of a row
    //    an item (rows past B compute zeros and are not stored)
    for (int it = threadIdx.x; it < rows * split * 128; it += kThreads) {
        const int n2 = it & 127;
        const int q = it >> 7;
        const int r = q / split;
        const int part = q - r * split;
        const bool live = row0 + r < B;
        float2 x[MAXM];
#pragma unroll
        for (int n1 = 0; n1 < MAXM; ++n1) {
            x[n1] = make_float2(0.f, 0.f);
            if (n1 < m && live) {
                const int t = (n1 << 7) + n2;
                const float2 v = __ldg(iq + (row0 + r) * n + t);
                const float w = __ldg(win + t);
                x[n1] = make_float2(v.x * w, v.y * w);
            }
        }
        if constexpr (FIXED) {
#pragma unroll
            for (int k1 = 0; k1 < MAXM; ++k1) {
                float ar = 0.f, ai = 0.f;
#pragma unroll
                for (int n1 = 0; n1 < MAXM; ++n1) {
                    const float2 w = wm[(n1 * k1) % MAXM];
                    ar = fmaf(x[n1].x, w.x, fmaf(-x[n1].y, w.y, ar));
                    ai = fmaf(x[n1].x, w.y, fmaf(x[n1].y, w.x, ai));
                }
                X[(r * MAXM + k1) * kRowPad +
                  pad16((int)(__brev((unsigned)n2) >> 25))] =
                    cmul(__ldg(tw + k1 * n2), make_float2(ar, ai));
            }
            continue;
        }
        for (int k1 = part; k1 < m; k1 += split) {
            float ar = x[0].x, ai = x[0].y;
            if (!(skip & kSkipS1)) {
                // W_m^(n1 k1) = W_n^(128 ((n1 k1) mod m)), stepped by 128 k1
                const int step = k1 << 7;
                int idx = 0;
                ar = 0.f;
                ai = 0.f;
#pragma unroll
                for (int n1 = 0; n1 < MAXM; ++n1) {
                    if (n1 < m) {
                        const float2 w = __ldg(tw + idx);
                        ar = fmaf(x[n1].x, w.x, fmaf(-x[n1].y, w.y, ar));
                        ai = fmaf(x[n1].x, w.y, fmaf(x[n1].y, w.x, ai));
                        idx += step;
                        if (idx >= n) idx -= n;
                    }
                }
            }
            float2 y = make_float2(ar, ai);
            if (!(skip & kSkipTw))
                y = cmul(__ldg(tw + k1 * n2), y);   // W_n^(k1 n2), k1 n2 < n
            // bit-reversed for the 128-point stage; with it skipped,
            // natural in the epilogue's layout
            if (skip & kSkipS2)
                X[(r * m + k1) * kOutPad + pad16(n2)] = y;
            else
                X[(r * m + k1) * kRowPad +
                  pad16((int)(__brev((unsigned)n2) >> 25))] = y;
        }
    }
    __syncthreads();

    // 2. the m 128-point transforms of each row
    if (!(skip & kSkipS2)) {
        // stages 0-3: positions 16 g + l of a row, X -> Y
        for (int it = threadIdx.x; it < rows * m * 8; it += kThreads) {
            const int at = (it >> 3) * kRowPad + 17 * (it & 7);
            float2 v[16];
#pragma unroll
            for (int l = 0; l < 16; ++l) v[l] = X[at + l];
#pragma unroll
            for (int s = 0; s < 4; ++s)
#pragma unroll
                for (int l = 0; l < 16; ++l)
                    if (!(l & (1 << s)))
                        butterfly(v[l], v[l + (1 << s)], tw128,
                                  l & ((1 << s) - 1), s);
#pragma unroll
            for (int l = 0; l < 16; ++l) Y[at + l] = v[l];
        }
        __syncthreads();
        // stages 4-6: positions p + 16 q of a row, Y -> X
        for (int it = threadIdx.x; it < rows * m * 16; it += kThreads) {
            const int row = it >> 4, p = it & 15;
            const float2* src = Y + row * kRowPad + p;
            float2 v[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) v[q] = src[17 * q];
#pragma unroll
            for (int s = 4; s < 7; ++s)
#pragma unroll
                for (int q = 0; q < 8; ++q)
                    if (!(q & (1 << (s - 4))))
                        butterfly(v[q], v[q + (1 << (s - 4))], tw128,
                                  p + 16 * (q & ((1 << (s - 4)) - 1)), s);
            float2* dst = X + row * kOutPad + p;
#pragma unroll
            for (int q = 0; q < 8; ++q) dst[17 * q] = v[q];
        }
        __syncthreads();
    }

    // 3. epilogue in natural bin order k = m k2 + k1, coalesced stores;
    //    k2 = k / m by a multiply-shift (exact for k < 2^32 / m)
    const unsigned long long inv_m = (1ull << 32) / (unsigned)m + 1u;
    for (int r = 0; r < rows && row0 + r < B; ++r) {
        const float2* src = X + r * m * kOutPad;
        float* dst = out + (row0 + r) * n;
        for (int k = threadIdx.x; k < n; k += kThreads) {
            const int k2 = (int)(((unsigned long long)k * inv_m) >> 32);
            const int k1 = k - k2 * m;
            dst[k] = ct_epilogue<EP>(src[k1 * kOutPad + pad16(k2)], coeff,
                                     scale, offset);
        }
    }
}

}  // namespace

// log2 n of a size the kernels take, or -1.
static int kernel_log2n(int B, int n) {
    int log2n = 0;
    while ((1 << log2n) < n) ++log2n;
    if (B < 1 || n != (1 << log2n) || log2n < kMinLog2 || log2n > kMaxLog2)
        return -1;
    return log2n;
}

static int rows_per_block(int n) { return n >= kMinElems ? 1 : kMinElems / n; }

// K2: iq (B, n, 2) float32 (8-byte aligned), win (n,), tw (n/2, 2) the
// twiddle table, out (B, n).  Returns the launch's CUDA error code.
extern "C" int spectrum_fused_ct5_launch(const void* iq, const void* win,
                                         const void* tw, void* out, int B,
                                         int n, float coeff, float scale,
                                         float offset, void* stream) {
    const int log2n = kernel_log2n(B, n);
    if (log2n < 0) return (int)cudaErrorInvalidValue;
    const int rows = rows_per_block(n);
    const unsigned grid = (unsigned)((B + rows - 1) / rows);
    const size_t smem = (size_t)rows * n * sizeof(float2);
    spectrum_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(iq), static_cast<const float*>(win),
        static_cast<const float2*>(tw), static_cast<float*>(out), B, log2n,
        rows, coeff, scale, offset);
    return (int)cudaGetLastError();
}

template <int EP, bool ABLATE, int MAXM, bool FIXED = false>
static int ct_launch_instance(const void* iq, const void* win, const void* tw,
                              const void* tw128, void* out, int B, int m,
                              int skip, float coeff, float scale,
                              float offset, void* stream) {
    const auto kernel = spectrum_ct_kernel<EP, ABLATE, MAXM, FIXED>;
    static bool configured = false;
    if (!configured) {                   // a block's largest buffers: m = 32
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)((kCtElems / 128) * (kOutPad + kRowPad) * sizeof(float2)));
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    const int n = m * 128;
    const int rows = n >= kCtElems ? 1 : kCtElems / n;
    const int split = rows * 128 >= kThreads ? 1 : kThreads / (rows * 128);
    if (FIXED && (m != MAXM || split != 1)) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((B + rows - 1) / rows);
    const size_t smem = (size_t)rows * m * (kOutPad + kRowPad) * sizeof(float2);
    kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(iq), static_cast<const float*>(win),
        static_cast<const float2*>(tw), static_cast<const float2*>(tw128),
        static_cast<float*>(out), B, m, rows, split, skip, coeff, scale,
        offset);
    return (int)cudaGetLastError();
}

// the instance of the epilogue EP for m (its register bucket, or m = 16,
// the default fft_size 2048, compiled in) and skip
template <int EP, bool ABLATE>
static int ct_launch_bucket(const void* iq, const void* win, const void* tw,
                            const void* tw128, void* out, int B, int m,
                            int skip, float coeff, float scale, float offset,
                            void* stream) {
    if (!ABLATE && m == 16)
        return ct_launch_instance<EP, false, 16, true>(
            iq, win, tw, tw128, out, B, m, skip, coeff, scale, offset, stream);
    if (m <= 8)
        return ct_launch_instance<EP, ABLATE, 8>(
            iq, win, tw, tw128, out, B, m, skip, coeff, scale, offset, stream);
    if (m <= 16)
        return ct_launch_instance<EP, ABLATE, 16>(
            iq, win, tw, tw128, out, B, m, skip, coeff, scale, offset, stream);
    return ct_launch_instance<EP, ABLATE, kMaxChunks>(
        iq, win, tw, tw128, out, B, m, skip, coeff, scale, offset, stream);
}

template <int EP>
static int ct_launch(const void* iq, const void* win, const void* tw,
                     const void* tw128, void* out, int B, int n, int skip,
                     float coeff, float scale, float offset, void* stream) {
    const int m = n / 128;
    if (B < 1 || n % 128 || m < 1 || m > kMaxChunks || (skip & ~kSkipAll))
        return (int)cudaErrorInvalidValue;
    return skip ? ct_launch_bucket<EP, true>(iq, win, tw, tw128, out, B, m,
                                             skip, coeff, scale, offset,
                                             stream)
                : ct_launch_bucket<EP, false>(iq, win, tw, tw128, out, B, m,
                                              0, coeff, scale, offset,
                                              stream);
}

// K5 and K10 (the same function): iq (B, n, 2) float32 (8-byte aligned),
// win (n,), tw (n, 2) the table W_n^t, t < n, tw128 (64, 2) K2's table for
// n = 128, out (B, n); n = 128 m with 1 <= m <= 32.  Returns the launch's
// CUDA error code.
extern "C" int spectrum_fused_ct4_launch(const void* iq, const void* win,
                                         const void* tw, const void* tw128,
                                         void* out, int B, int n,
                                         float coeff, float scale,
                                         float offset, void* stream) {
    return ct_launch<kEpExact>(iq, win, tw, tw128, out, B, n, 0, coeff,
                               scale, offset, stream);
}

// K11: K5's arguments, then ep (0 exact, 1 approx, 2 |X|^2) and skip (the
// kSkip* flags).
extern "C" int spectrum_fused_ct3_launch(const void* iq, const void* win,
                                         const void* tw, const void* tw128,
                                         void* out, int B, int n, int ep,
                                         int skip, float coeff, float scale,
                                         float offset, void* stream) {
    switch (ep) {
    case kEpExact:
        return ct_launch<kEpExact>(iq, win, tw, tw128, out, B, n, skip,
                                   coeff, scale, offset, stream);
    case kEpApprox:
        return ct_launch<kEpApprox>(iq, win, tw, tw128, out, B, n, skip,
                                    coeff, scale, offset, stream);
    case kEpMag2:
        return ct_launch<kEpMag2>(iq, win, tw, tw128, out, B, n, skip,
                                  coeff, scale, offset, stream);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
