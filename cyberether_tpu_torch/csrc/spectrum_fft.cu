// A shared-memory Stockham FFT core for Hopper (sm_90a), with five C
// entry points: K3 (the forward C2C FFT), K6's FFT route (the fused
// spectrum for any n the core takes), K6's split route (the fused
// spectrum for n = n1 n2, two passes of the core: every n past 16384
// points that splits, and the few below that no block holds) and K6's
// chirp route in one launch and in three (Bluestein's transform on the
// core's passes: n with a prime factor past 1021).
//
// K3, the forward C2C FFT: replaces fft_pallas (_fft_ct_kernel) of
// cyberether_tpu/ops/pallas_kernels.py, both tiers (the display tier,
// exact=False, is one default-precision matrix pass on the TPU; the same
// fp32 kernel serves it here).  Per row b of x (B, n) complex64 (float2
// re/im):
//   out[b, k] = sum_t x[b, t] * exp(-2 pi j t k / n)
// unnormalized, in natural bin order, for n = 128 * m with m a power of
// two <= 32 (n = 128 .. 4096).
//
// K6's FFT route, the fused spectrum: replaces spectrum_fused
// (_spectrum_dft_kernel) of cyberether_tpu/ops/pallas_kernels.py for every
// n <= 16384 whose prime factors are all <= 1021 and whose passes a block
// of a runtime-plan instance holds (any n <= 128, 128 m for m <= 128:
// every n the spectrum block admits up to 16384, and every prime up to
// 1021); the split route (below) takes any other n that splits into two
// such factors (every 128 m, m <= 1024), the chirp route (below) n with a
// prime factor past 1021, and the direct product of csrc/spectrum_dft.cu
// the n no route of this file takes (past 25165824 points, where n does
// not split).  Per row b
// of iq (B, n, 2) float32 interleaved re/im, with the window win (n,) already
// holding the (-1)^k sign:
//   X[k]  = sum_t win[t] * (re[t] + j im[t]) * exp(-2 pi j t k / n)
//   db[k] = 10 * log10(|X[k]|^2) + coeff     (log10 as ln * 0.4342944819,
//           the JAX kernel's form; |X|^2 = 0 gives -inf)
//   out[b, k] = 0.5 + 0.5 * tanh(4 * (db[k] * scale + offset - 0.5))
// in natural bin order.  An all-zero row gives exactly 0.
//
// What bounds them on this card: bytes.  K3 at B = 4096, n = 2048 reads and
// writes 67.1 MB each: 0.040 ms at 3.35 TB/s, against 0.46 GFLOP (5 n log2
// n a row): ~0.007 ms at 67 TFLOP/s.  K6 at the same size reads 67.1 MB and
// writes 33.6 MB: 0.030 ms, against ~1.1 GFLOP with the epilogue.
//
// What the design does about it:
// - The plan is a list of radices whose product is n (ops/kernels.py
//   fft_plan, passed as 10-bit fields, six to each of two 64-bit words).
//   Pass p of radix R, after passes whose radices multiply to Ns, is a
//   Stockham decimation-in-time pass: group j < n / R reads x[j + r n / R],
//   r < R (natural order, so a warp's loads coalesce), multiplies value r
//   by W_(Ns R)^(r (j mod Ns)), takes the R-point DFT in registers and
//   writes output q to (j - j mod Ns) R + j mod Ns + q Ns.  After the last
//   pass the row is in natural order: no bit-reversed load or store.
// - Radices 16, 8, 4 and 2 are radix-2 networks in registers with the
//   W_16 constants, unrolled by template recursion so that every index is
//   a compile-time constant (a loop on a shifted stride left the indices
//   to run time: register selects and a jump table); 3, 5
//   and 7 direct sums over symmetric pairs with their cos/sin constants;
//   any other prime p <= 127 is a direct p-point stage in shared memory:
//   the inputs twiddled and folded into the sums and differences of
//   pairs r, p - r, then the outputs q and p - q together from one cosine
//   and one sine sum (half the products of a plain p-point sum), an item
//   being one q of four groups, so that a table entry serves four groups;
//   the p-entry table (cos, sin of 2 pi t / p) is the n-entry table's
//   entries, staged into shared memory.  A prime from 131 to 1021 is the
//   whole cost of its kernel (~2 p flops a sample): large_prime_pass takes
//   the same folded sums in Rader's order (inputs r and outputs q as
//   powers of a primitive root), where the angle of (r, q) is a function
//   of the sum of their exponents, so a thread that holds 4 consecutive
//   outputs of 4 groups in registers reads one table entry a step (a
//   sliding window) and its groups' folded inputs as broadcasts: 64 FMAs
//   for 5 shared-memory loads.
// - Powers of two from 128 to 16384 get an instance templated on log2 n:
//   the plan (ceil(log2 n / 4) passes, radices as even as they go, larger
//   first: 2048 = 16 16 8) is compiled in, a thread holds E = 16 values
//   (32 at n = 16384) in registers through every pass, the first pass
//   reads device memory (K6: windowed) and the last one writes it (K6:
//   through the epilogue), both coalesced, and the exchanges between
//   passes go through dynamic shared memory: one barrier after the
//   writes, one after the reads.  A block holds max(1, 16 T / n) rows of
//   T = max(256, n / E) threads, and an SM at least 3 such blocks of 256
//   threads (2 of 512 at n = 8192).  Every other n runs a runtime-plan
//   instance that stages the windowed rows into shared memory, runs the
//   passes there in place (row and group indices by multiply-shift
//   division) and writes through the epilogue: 256 threads that hold 16
//   values of a pass each (3 blocks an SM), or, where that block holds no
//   row or a prime pass's items do not fit, 512 that hold 32; a plan with
//   a prime past 127 runs on 256 threads that hold 12 (2 blocks an SM, 128
//   registers for the large pass's float64 sums).
// - Shared memory is padded by one float2 after every 16, so that the
//   Stockham writes at stride R (Ns = 1) and the reads at stride 1 are
//   free of bank conflicts for a half-warp of float2.  Above 48 KB
//   (n >= 8192) the launch raises the limit with cudaFuncSetAttribute; a
//   16384-point row takes 136 KB.
// - Twiddles W_n^t, t < n, come from the n-entry table made in float64 on
//   the host and stored as float32, its entries gathered on the host in
//   pass order (ptw: W_(Ns R)^(r k) at r Ns + k - 1, n - 1 entries), so
//   that a warp's twiddle loads (read through L1) coalesce: no sincosf,
//   no fast math, fp32 FFMA only, no tensor cores (TF32 misses both
//   kernels' exact tiers).  logf and tanhf are the accurate library
//   functions.
// The TPU kernels' m x 128 split, sub-DFT matrices, bf16 hi/lo splits and
// batch tiles are devices of the TPU's matrix unit and are not needed here.
//
// K6's split route: the same function for n = n1 n2 whose factors the
// core takes each (ops/kernels.py k6_split), where the FFT route does not
// take n, as a four-step FFT.
// With t = n2 t1 + t2 and k = k1 + n1 k2:
//   X[k1 + n1 k2] = sum_t2 W_n2^(t2 k2) W_n^(t2 k1)
//                   sum_t1 win x[n2 t1 + t2] W_n1^(t1 k1)
// - Pass A (columns): a block takes consecutive columns t2 of the B n2
//   columns, loads them through the window (neighbouring threads on
//   neighbouring columns, so that a load of c >= 8 columns covers whole
//   32-byte sectors), runs the n1-point FFT of each on the core's passes,
//   multiplies output k1 by W_n^(t2 k1) and writes the scratch
//   Y[b, k1, t2] (B, n) complex64, coalesced.  The pow2 instances hold a
//   block's columns in shared memory at pad(e c + column), so that the
//   passes' accesses, neighbouring columns on neighbouring threads, stay
//   free of bank conflicts; the runtime-plan instances keep their row
//   layout.  The twiddle is the n-entry table's entry t2 k1 (< n, so no
//   reduction mod n), gathered on the host into a (n1, n2) table so that
//   a warp's loads coalesce.
// - Pass B (rows): a block takes consecutive rows Y[b, k1, :] (whole rows,
//   coalesced), runs the n2-point FFT of each and K6's epilogue, and
//   stores out[b, k1 + n1 k2] through shared memory (the pow2 instances
//   stage the values at an odd row stride), so that neighbouring threads
//   store neighbouring bins k1.
// - Both passes are the core's templates: Pow2<log2 n_i> for a power of
//   two from 128 to 4096, the runtime-plan instances for any other factor,
//   with the epilogues kEpSplitCols and kEpSplitRows.  k6_split takes no
//   larger power of two (the most balanced pair of a spectrum size, 128 m
//   with m <= 1024, has none), so the split's 8192- and 16384-point
//   instances are not built.  Bound: bytes; the round trip through Y
//   moves 28 bytes a sample (8 in, 8 + 8 through Y, 4 out) against the
//   function's 12.
//
// K6's chirp route: the same function for n with a prime factor past
// 1021, which no pass of the core takes, by Bluestein's transform: with
// c_t = exp(-j pi t^2 / n) (ops/kernels.py _chirp_table: the phase from
// t^2 mod 2 n in int64, rounded once to float32),
//   X[k] = c_k sum_t (win_t x_t c_t) conj(c_(k-t)),
// a linear convolution, taken as a cyclic one of length M >= 2 n - 1
// (ops/kernels.py chirp_length: m 2^a, m = 1, 3, 5, so that every pass is
// a register radix).  With A the M-point DFT of a = win x c (zeros from n
// on) and D = conj(C) / M, C the DFT of conj(c_t) for |t| < n wrapped mod
// M (ops/kernels.py _chirp_spectrum, complex128 on the host), the forward
// DFT W of Z = conj(A) D is conj(conv): the inverse transform is the
// forward one, conjugated, and the conjugation costs nothing in the
// product.  |c_k| = 1, so |X[k]|^2 = |W[k]|^2: no final chirp, and the
// epilogue reads W's first n bins.
// - M <= 16384 (n <= 8192): one launch (kEpChirp), a block a row of M on
//   a runtime-plan instance: the chirped, windowed load, the passes, Z,
//   the passes again, the epilogue of bins k < n.
// - M past 16384: three launches on the split M = M1 M2 of ops/kernels.py
//   chirp_split (M1 a power of two from 128 to 4096), through a (B, M)
//   complex64 scratch Y.  Pass A (kEpChirpCols,
//   M1-point columns t2 of t = M2 t1 + t2) loads a in registers (x, the
//   window and the chirp for t < n, else 0) and stores W_M^(t2 k1) times
//   its output, as the split's pass A; pass B (kEpChirpRows, rows k1 of
//   Y) takes the M2-point FFT (A[k1 + M1 k2] at [k1, k2]), Z = conj(A)
//   D[k1, k2] (D gathered on the host into that layout), the M2-point FFT
//   of Z over k2 (bins m2), and stores W_M^(k1 m2) times it back in
//   place: the second transform's four steps with the roles of the
//   factors swapped, s = k1 + M1 k2 and m = m2 + M2 m1; pass A'
//   (kEpChirpOut, M1-point columns m2 of Y) stores the epilogue of bin
//   m2 + M2 m1 where it is below n, neighbouring threads on neighbouring
//   bins.  ~32 bytes a point of M through Y against the function's 12 a
//   point of n.
// The one launch and pass B run the runtime-plan instances of 256 threads
// of 16 values and 512 of 32 (chirp_length gives no prime past 127)
// whatever M; passes A and A' the pow2 instance of M1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMinLog2 = 7;          // the templated instances: n >= 128
constexpr int kK3MaxLog2 = 12;       // K3 takes n <= 4096
constexpr int kMaxPoints = 16384;    // K6's FFT route
constexpr int kSplitMaxLog2 = 12;    // the split's pow2 factors (k6_split)
constexpr int kSmallPrimeMax = 127;  // any_prime_pass takes p <= this ...
constexpr int kMaxPrime = 1021;      // ... large_prime_pass up to this
// a plan: 10-bit radices, six to each of two 64-bit words (4 bits spare)
constexpr int kRadixBits = 10;
constexpr int kRadicesAWord = 6;
constexpr int kMaxPasses = 2 * kRadicesAWord;
constexpr unsigned long long kRadixMask = (1ull << kRadixBits) - 1;
// large_prime_pass: a thread holds kLpQ consecutive outputs of one group
// (ops/kernels.py LARGE_PASS_OUTPUTS) and sums kLpK steps in fp32 before
// it adds them into its float64 sums
constexpr int kLpQ = 4;
constexpr int kLpK = 16;
constexpr int kSmemDefault = 48 * 1024;

// what a kernel loads and stores: K3's rows, K6's rows, the split
// route's pass A (columns, out to Y) and pass B (rows of Y, out to K6's
// bins), and the chirp route's row of M (one launch), pass A (columns
// of the chirped rows, out to Y), pass B (rows of Y, back in place) and
// pass A' (columns of Y, out to K6's bins)
enum Epilogue { kEpComplex = 0, kEpSpectrum = 1, kEpSplitCols = 2,
                kEpSplitRows = 3, kEpChirp = 4, kEpChirpCols = 5,
                kEpChirpRows = 6, kEpChirpOut = 7 };

// one float2 of padding after every 16
__device__ __forceinline__ int pad(int p) { return p + (p >> 4); }

__host__ __device__ constexpr int padded_size(int count) {
    return count + (count >> 4) + 1;
}

// w v in fp32 with the fused multiply-adds spelled out
__device__ __forceinline__ float2 cmul(float2 w, float2 v) {
    return make_float2(fmaf(w.x, v.x, -__fmul_rn(w.y, v.y)),
                       fmaf(w.x, v.y, __fmul_rn(w.y, v.x)));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}

// v W_16^e, e < 8 (a compile-time constant after unrolling)
__device__ __forceinline__ float2 w16(float2 v, int e) {
    switch (e) {
    case 0: return v;
    case 4: return make_float2(v.y, -v.x);
    case 1: return cmul(make_float2(0.92387953251128674f,
                                    -0.38268343236508978f), v);
    case 2: return cmul(make_float2(0.70710678118654757f,
                                    -0.70710678118654746f), v);
    case 3: return cmul(make_float2(0.38268343236508984f,
                                    -0.92387953251128674f), v);
    case 5: return cmul(make_float2(-0.38268343236508973f,
                                    -0.92387953251128674f), v);
    case 6: return cmul(make_float2(-0.70710678118654746f,
                                    -0.70710678118654757f), v);
    default: return cmul(make_float2(-0.92387953251128674f,
                                     -0.38268343236508989f), v);
    }
}

__device__ __forceinline__ int brev_bits(int i, int bits) {
    int r = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
        if (b < bits) r |= ((i >> b) & 1) << (bits - 1 - b);
    return r;
}

// One radix-2 decimation-in-frequency stage of an R-point DFT over
// v[o .. o + R): pairs HALF apart, the difference times W_(2 HALF)^k; then
// the next stage.  A template recursion, so that every index and twiddle
// is a compile-time constant and the values stay in registers.
template <int R, int HALF, int E>
__device__ __forceinline__ void dif_stage(float2 (&v)[E], int o) {
#pragma unroll
    for (int blk = 0; blk < R; blk += 2 * HALF) {
#pragma unroll
        for (int k = 0; k < HALF; ++k) {
            const float2 a = v[o + blk + k];
            const float2 b = v[o + blk + k + HALF];
            v[o + blk + k] = cadd(a, b);
            v[o + blk + k + HALF] = w16(csub(a, b), k * (8 / HALF));
        }
    }
    if constexpr (HALF > 1) dif_stage<R, HALF / 2>(v, o);
}

// The R-point DFT (R = 2, 4, 8, 16) of v[o .. o + R) in place, natural
// order out: the radix-2 stages, then the bit reversal as a renaming of
// registers.
template <int R, int E>
__device__ __forceinline__ void dft_pow2(float2 (&v)[E], int o) {
    constexpr int bits = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
    dif_stage<R, R / 2>(v, o);
    float2 t[R];
#pragma unroll
    for (int i = 0; i < R; ++i) t[i] = v[o + brev_bits(i, bits)];
#pragma unroll
    for (int i = 0; i < R; ++i) v[o + i] = t[i];
}

// cos and sin of 2 pi k / R for R = 3, 5, 7 and 0 < k < R
__device__ __forceinline__ float2 odd_cs(int R, int k) {
    switch (R * 8 + k) {
    case 25: return make_float2(-0.5f, 0.86602540378443871f);
    case 26: return make_float2(-0.5f, -0.86602540378443871f);
    case 41: return make_float2(0.30901699437494745f, 0.95105651629515353f);
    case 42: return make_float2(-0.80901699437494734f, 0.58778525229247325f);
    case 43: return make_float2(-0.80901699437494734f, -0.58778525229247325f);
    case 44: return make_float2(0.30901699437494745f, -0.95105651629515353f);
    case 57: return make_float2(0.62348980185873359f, 0.7818314824680298f);
    case 58: return make_float2(-0.22252093395631434f, 0.97492791218182362f);
    case 59: return make_float2(-0.90096886790241903f, 0.43388373911755823f);
    case 60: return make_float2(-0.90096886790241903f, -0.43388373911755823f);
    case 61: return make_float2(-0.22252093395631434f, -0.97492791218182362f);
    default: return make_float2(0.62348980185873359f, -0.7818314824680298f);
    }
}

// The R-point DFT (R = 3, 5, 7) of v[o .. o + R) in place: X[q] = v0 +
// sum over pairs r, R - r of (v_r + v_(R-r)) cos - j (v_r - v_(R-r)) sin of
// 2 pi r q / R.
template <int R, int E>
__device__ __forceinline__ void dft_odd(float2 (&v)[E], int o) {
    constexpr int H = (R - 1) / 2;
    float2 sp[H], sm[H];
    float2 x0 = v[o];
#pragma unroll
    for (int r = 1; r <= H; ++r) {
        sp[r - 1] = cadd(v[o + r], v[o + R - r]);
        sm[r - 1] = csub(v[o + r], v[o + R - r]);
        x0 = cadd(x0, sp[r - 1]);
    }
    float2 out[R];
    out[0] = x0;
#pragma unroll
    for (int q = 1; q < R; ++q) {
        float2 acc = v[o];
#pragma unroll
        for (int r = 1; r <= H; ++r) {
            const float2 cs = odd_cs(R, (r * q) % R);
            acc.x = fmaf(sp[r - 1].x, cs.x, fmaf(sm[r - 1].y, cs.y, acc.x));
            acc.y = fmaf(sp[r - 1].y, cs.x, fmaf(-sm[r - 1].x, cs.y, acc.y));
        }
        out[q] = acc;
    }
#pragma unroll
    for (int q = 0; q < R; ++q) v[o + q] = out[q];
}

template <int R, int E>
__device__ __forceinline__ void dft(float2 (&v)[E], int o) {
    if constexpr (R == 3 || R == 5 || R == 7) dft_odd<R>(v, o);
    else dft_pow2<R>(v, o);
}

// K6's epilogue: |X|^2 -> display value
__device__ __forceinline__ float spectrum_value(float2 x, float coeff,
                                                float scale, float offset) {
    const float mag2 = fmaf(x.x, x.x, __fmul_rn(x.y, x.y));
    const float db = 10.f * (logf(mag2) * 0.43429448190325176f) + coeff;
    const float norm = db * scale + offset;
    return 0.5f + 0.5f * tanhf(4.f * (norm - 0.5f));
}

// ---------------------------------------------------------------------------
// Powers of two, n = 2^LOG2N from 128 to 16384: the plan compiled in.

template <int LOG2N>
struct Pow2 {
    static constexpr int n = 1 << LOG2N;
    static constexpr int E = LOG2N == 14 ? 32 : 16;   // values a thread
    static constexpr int T = n / E > 256 ? n / E : 256;
    static constexpr int rows = T * E / n;
    // blocks an SM holds at least: 3 of 256 threads (<= 85 registers), 2
    // of 512 at n = 8192 (<= 64 registers), no spills in either
    static constexpr int min_blocks = T == 256 ? 3 : LOG2N == 13 ? 2 : 1;
    static constexpr int passes = (LOG2N + 3) / 4;
    __host__ __device__ static constexpr int bits(int p) {
        return LOG2N / passes + (p < LOG2N % passes ? 1 : 0);
    }
    // the radices' product before pass p
    __host__ __device__ static constexpr int ns(int p) {
        int b = 0;
        for (int i = 0; i < p; ++i) b += bits(i);
        return 1 << b;
    }
};

struct Args {
    const float2* in;      // K3: x; K6: iq
    const float* win;      // K6 only
    const float2* ptw;     // the passes' twiddles: r Ns + k - 1 (below)
    const float2* tw;      // W_n^t, t < n (K6's direct p-point stages)
    void* out;             // K3, pass A: float2; K6, pass B: float
    int B;                 // rows; pass A: columns
    float coeff, scale, offset;
    const float2* tws;     // pass A: W_n^(t2 k1) at k1 n2 + t2
    int other;             // pass A (A'): n2; pass B: n1
    const float2* chirp;   // the chirp route: c_t, t < n_sig
    const float2* dtab;    // ... D = conj(C) / M (pass B: at k1 M2 + k2)
    int n_sig;             // ... the rows' points, n (the transform's: M)
};

// The split's column c of B n2 (pass A, n2 = a.other): the offset
// b n1 n2 + t2 of x[b, t2], and t2.  c < 2^31 (the launcher checks).
__device__ __forceinline__ int64_t split_col(const Args& a, int64_t c,
                                             int n1, int& t2) {
    const unsigned b = (unsigned)c / (unsigned)a.other;
    t2 = (int)c - (int)(b * a.other);
    return (int64_t)b * n1 * a.other + t2;
}

// The split's row r of B n1 (pass B, n1 = a.other): the offset
// b n1 n2 + k1 of bin k1 of batch row b.  r < 2^31 (the launcher checks).
__device__ __forceinline__ int64_t split_row(const Args& a, int64_t r,
                                             int n2) {
    const unsigned b = (unsigned)r / (unsigned)a.other;
    return (int64_t)b * n2 * a.other + ((int)r - (int)(b * a.other));
}

template <int LOG2N, int PASS, int EPI>
__device__ __forceinline__ void pow2_pass(float2 (&v)[Pow2<LOG2N>::E],
                                          float2* buf, const Args a,
                                          int64_t row0) {
    using P = Pow2<LOG2N>;
    constexpr int n = P::n, E = P::E, T = P::T;
    constexpr int R = 1 << P::bits(PASS);
    constexpr int G = n / R;                    // groups a row
    constexpr int Ns = P::ns(PASS);
    constexpr bool first = PASS == 0;
    constexpr bool last = PASS == P::passes - 1;
    // the split's pass A (and the chirp route's passes A and A'): a
    // block's rows are P::rows consecutive columns, group j of column row
    // on thread j P::rows + row, value e of the column in shared memory at
    // pad(e P::rows + row)
    constexpr bool cols = EPI == kEpSplitCols || EPI == kEpChirpCols ||
                          EPI == kEpChirpOut;
    const int tid = threadIdx.x;

    // 1. the inputs of each of the thread's E / R groups, twiddled, and
    //    their R-point DFTs
#pragma unroll
    for (int i = 0; i < E / R; ++i) {
        const int g = tid + i * T;
        const int row = cols ? g % P::rows : g / G;
        const int j = cols ? g / P::rows : g % G;
        if constexpr (first && EPI == kEpChirpCols) {
            // column row0 + row (t2 of batch row b): x[b, M2 (j + r G) +
            // t2] through the window and the chirp, 0 from n_sig on
            const bool live = row0 + row < a.B;
            const unsigned col = live ? (unsigned)(row0 + row) : 0u;
            const unsigned b = col / (unsigned)a.other;
            const int t2 = (int)(col - b * a.other);
            const float2* src = a.in + (int64_t)b * a.n_sig;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int t = a.other * (j + r * G) + t2;
                float2 x = make_float2(0.f, 0.f);
                if (live && t < a.n_sig) {
                    x = __ldg(src + t);
                    const float w = __ldg(a.win + t);
                    x = cmul(__ldg(a.chirp + t),
                             make_float2(x.x * w, x.y * w));
                }
                v[i * R + r] = x;
            }
        } else if constexpr (first && EPI == kEpChirpOut) {
            // column row0 + row of Y: Y[b, j + r G, m2]
            int m2 = 0;
            const bool live = row0 + row < a.B;
            const int64_t o = live ? split_col(a, row0 + row, n, m2) : 0;
#pragma unroll
            for (int r = 0; r < R; ++r)
                v[i * R + r] = live ? __ldg(a.in + o + a.other * (j + r * G))
                                    : make_float2(0.f, 0.f);
        } else if constexpr (first && cols) {
            // column row0 + row: x[b, n2 (j + r G) + t2] through the window
            int t2 = 0;
            const bool live = row0 + row < a.B;
            const int64_t o = live ? split_col(a, row0 + row, n, t2) : 0;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                float2 x = make_float2(0.f, 0.f);
                if (live) {
                    const int t = a.other * (j + r * G);
                    x = __ldg(a.in + o + t);
                    const float w = __ldg(a.win + t + t2);
                    x = make_float2(x.x * w, x.y * w);
                }
                v[i * R + r] = x;
            }
        } else if constexpr (first) {
            const bool live = row0 + row < a.B;
            const float2* src = a.in + (row0 + row) * n + j;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                float2 x = make_float2(0.f, 0.f);
                if (live) {
                    x = __ldg(src + r * G);
                    if constexpr (EPI == kEpSpectrum) {
                        const float w = __ldg(a.win + j + r * G);
                        x = make_float2(x.x * w, x.y * w);
                    }
                }
                v[i * R + r] = x;
            }
        } else {
            const int k = j % Ns;
            const int pb = pad(row * n + j);
#pragma unroll
            for (int r = 0; r < R; ++r) {
                if constexpr (cols)
                    v[i * R + r] = buf[pad((j + r * G) * P::rows + row)];
                // with G a multiple of 16 the padding between reads is known
                else if constexpr (G % 16 == 0)
                    v[i * R + r] = buf[pb + r * (G + G / 16)];
                else
                    v[i * R + r] = buf[pad(row * n + j + r * G)];
            }
            const float2* w = a.ptw + k - 1;
#pragma unroll
            for (int r = 1; r < R; ++r)
                v[i * R + r] = cmul(__ldg(w + r * Ns), v[i * R + r]);
        }
        dft<R>(v, i * R);
    }

    // 2. the outputs: device memory after the last pass (natural order,
    //    coalesced), else shared memory for the next pass
    if constexpr (last && EPI == kEpChirpOut) {
        // the epilogue of bin m2 + M2 (j + q G) of batch row b, below n_sig
#pragma unroll
        for (int i = 0; i < E / R; ++i) {
            const int g = tid + i * T;
            const int row = g % P::rows;
            const int j = g / P::rows;
            if (row0 + row < a.B) {
                const unsigned col = (unsigned)(row0 + row);
                const unsigned b = col / (unsigned)a.other;
                const int m2 = (int)(col - b * a.other);
                float* o = static_cast<float*>(a.out) + (int64_t)b * a.n_sig;
#pragma unroll
                for (int q = 0; q < R; ++q) {
                    const int m = m2 + a.other * (j + q * G);
                    if (m < a.n_sig)
                        o[m] = spectrum_value(v[i * R + q], a.coeff, a.scale,
                                              a.offset);
                }
            }
        }
    } else if constexpr (last && cols) {
        // Y[b, k1, t2] = W_n^(t2 k1) X_t2[k1], k1 = j + q G
#pragma unroll
        for (int i = 0; i < E / R; ++i) {
            const int g = tid + i * T;
            const int row = g % P::rows;
            const int j = g / P::rows;
            if (row0 + row < a.B) {
                int t2;
                const int64_t o = split_col(a, row0 + row, n, t2);
#pragma unroll
                for (int q = 0; q < R; ++q) {
                    const int e = (j + q * G) * a.other;
                    static_cast<float2*>(a.out)[o + e] =
                        cmul(__ldg(a.tws + e + t2), v[i * R + q]);
                }
            }
        }
    } else if constexpr (last && EPI == kEpSplitRows) {
        // the bins through shared memory at the odd row stride n + 1, so
        // that neighbouring threads store neighbouring bins k1 + n1 k2
        float* fb = reinterpret_cast<float*>(buf);
        __syncthreads();                          // this pass's reads done
#pragma unroll
        for (int i = 0; i < E / R; ++i) {
            const int g = tid + i * T;
            const int row = g / G;
            const int j = g % G;
#pragma unroll
            for (int q = 0; q < R; ++q)
                fb[row * (n + 1) + j + q * G] = spectrum_value(
                    v[i * R + q], a.coeff, a.scale, a.offset);
        }
        __syncthreads();
        // T is a multiple of P::rows: the thread's row is one
        const int row = tid % P::rows;
        if (row0 + row < a.B) {
            float* o = static_cast<float*>(a.out) +
                       split_row(a, row0 + row, n);
#pragma unroll
            for (int s = 0; s < E; ++s) {
                const int k2 = (tid + s * T) / P::rows;
                o[(int64_t)a.other * k2] = fb[row * (n + 1) + k2];
            }
        }
    } else if constexpr (last) {
#pragma unroll
        for (int i = 0; i < E / R; ++i) {
            const int g = tid + i * T;
            const int row = g / G;
            const int j = g % G;
            if (row0 + row < a.B) {
                const int64_t o = (row0 + row) * n + j;
#pragma unroll
                for (int q = 0; q < R; ++q) {
                    if constexpr (EPI == kEpSpectrum)
                        static_cast<float*>(a.out)[o + q * G] =
                            spectrum_value(v[i * R + q], a.coeff, a.scale,
                                           a.offset);
                    else
                        static_cast<float2*>(a.out)[o + q * G] = v[i * R + q];
                }
            }
        }
    } else {
        if constexpr (!first) __syncthreads();    // this pass's reads done
#pragma unroll
        for (int i = 0; i < E / R; ++i) {
            const int g = tid + i * T;
            const int row = cols ? g % P::rows : g / G;
            const int j = cols ? g / P::rows : g % G;
            const int k = j % Ns;
            const int d = row * n + (j - k) * R + k;
            const int pd = pad(d);
#pragma unroll
            for (int q = 0; q < R; ++q) {
                if constexpr (cols)
                    buf[pad(((j - k) * R + k + q * Ns) * P::rows + row)] =
                        v[i * R + q];
                // known padding: Ns a multiple of 16, or (Ns = 1) a run of
                // R | 16 inside d's line of 16
                else if constexpr (Ns % 16 == 0)
                    buf[pd + q * (Ns + Ns / 16)] = v[i * R + q];
                else if constexpr (Ns == 1 && 16 % R == 0)
                    buf[pd + q] = v[i * R + q];
                else
                    buf[pad(d + q * Ns)] = v[i * R + q];
            }
        }
        __syncthreads();
        pow2_pass<LOG2N, PASS + 1, EPI>(v, buf, a, row0);
    }
}

template <int LOG2N, int EPI>
__global__ void __launch_bounds__(Pow2<LOG2N>::T, Pow2<LOG2N>::min_blocks)
fft_pow2_kernel(Args a) {
    extern __shared__ __align__(16) float2 buf[];
    float2 v[Pow2<LOG2N>::E];
    pow2_pass<LOG2N, 0, EPI>(v, buf, a,
                             (int64_t)blockIdx.x * Pow2<LOG2N>::rows);
}

// ---------------------------------------------------------------------------
// Any other n: the plan read at run time (K6 only), in three instances:
// 256 threads that hold 16 values each, 512 that hold 32, and, for a plan
// with a prime past kSmallPrimeMax, 256 that hold 12 (its pass's tiles,
// 4 outputs of one group a thread, bound a block to ~2048 values); the
// host picks the instance and the rows a block (ops/kernels.py
// _runtime_block).

template <int T_, int VALS_>
struct Any {
    static constexpr int T = T_;
    static constexpr int VALS = VALS_;
    // the instance of the plans with a large prime (large_prime_pass)
    static constexpr bool large = VALS_ == 12;
    // 3 blocks an SM of 256 threads that hold 16 (<= 85 registers); 2 of
    // the large instance (<= 128: its pass's float64 sums); 1 of 512
    static constexpr int min_blocks = VALS == 16 ? 3 : large ? 2 : 1;
    static constexpr int items = VALS / 8;    // a prime pass's items a thread
    static constexpr int dcs = VALS / 11 + 1; // .. and its groups' X_0
};

// x / d by one multiply, for 0 <= x < 2^17 and 1 <= d <= 2^16: with
// m = ceil(2^32 / d) = (2^32 + e) / d, e < d, x m / 2^32 = x / d +
// x e / (d 2^32), and x e < 2^32 keeps the floor exact.
struct Div {
    unsigned long long m;
    __device__ explicit Div(int d) : m((0x100000000ull + d - 1) / d) {}
    __device__ __forceinline__ int operator()(int x) const {
        return (int)(((unsigned long long)x * m) >> 32);
    }
};

// A pass of register radix R over the rows in buf, in place.
template <int R, int T, int VALS>
__device__ __forceinline__ void any_reg_pass(float2* buf,
                                             const float2* __restrict__ ptw,
                                             int n, int rows, int Ns) {
    constexpr int MAXG = (VALS + R - 1) / R;     // groups a thread
    float2 v[MAXG * R];
    int dst[MAXG];
    const int G = n / R;
    const int total = rows * G;
    const Div div_g(G), div_ns(Ns);
    // every group of the thread at once: one past the last is the last
    // again, not stored, so that no branch keeps a load from the others
#pragma unroll
    for (int i = 0; i < MAXG; ++i) {
        const int g = min((int)threadIdx.x + i * T, total - 1);
        const int row = div_g(g);
        const int j = g - row * G;
        const int k = j - div_ns(j) * Ns;
        dst[i] = row * n + (j - k) * R + k;
#pragma unroll
        for (int r = 0; r < R; ++r)
            v[i * R + r] = buf[pad(row * n + j + r * G)];
        const float2* w = ptw + k - 1;
#pragma unroll
        for (int r = 1; r < R; ++r)
            v[i * R + r] = cmul(__ldg(w + r * Ns), v[i * R + r]);
        dft<R>(v, i * R);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAXG; ++i) {
        if ((int)threadIdx.x + i * T < total) {
#pragma unroll
            for (int q = 0; q < R; ++q)
                buf[pad(dst[i] + q * Ns)] = v[i * R + q];
        }
    }
    __syncthreads();
}

// A direct p-point pass (p a prime, 7 < p <= kSmallPrimeMax) over the
// rows in buf, in place, on
// the symmetry of the p-point DFT.  With y_r the twiddled inputs of a
// group, s_r = y_r + y_(p-r) and d_r = y_r - y_(p-r), 0 < r <= H = (p - 1)
// / 2, and theta = 2 pi r q / p:
//   X_0 = y_0 + sum_r s_r
//   X_q, X_(p-q) = A_q + B_q, A_q - B_q for 0 < q <= H, where
//   A_q = y_0 + sum_r s_r cos theta,  B_q = -j sum_r d_r sin theta.
// An item is one q and four groups: its thread loads each table entry
// once for four groups, and a warp's items share their groups' s_r and
// d_r loads.  cs holds (cos, sin) of 2 pi t / p, t < p, from W_n^(t n / p).
template <int T, int VALS>
__device__ __forceinline__ void any_prime_pass(float2* buf, float2* cs,
                                               const float2* __restrict__ ptw,
                                               const float2* __restrict__ tw,
                                               int n, int rows, int Ns,
                                               int p) {
    using A = Any<T, VALS>;
    const int G = n / p;
    const int H = (p - 1) / 2;
    const int groups = rows * G;
    const Div div_g(G), div_h(H), div_ns(Ns);

    // 1. the table, and each group's inputs twiddled and folded: slot r
    //    takes s_r and slot p - r takes d_r
    for (int t = threadIdx.x; t < p; t += T) {
        const float2 w = __ldg(tw + t * G);
        cs[t] = make_float2(w.x, -w.y);
    }
    for (int i = threadIdx.x; i < groups * H; i += T) {
        const int g = div_h(i);
        const int r = i - g * H + 1;
        const int row = div_g(g);
        const int j = g - row * G;
        const int k = j - div_ns(j) * Ns;
        const int lo = pad(row * n + j + r * G);
        const int hi = pad(row * n + j + (p - r) * G);
        const float2* w = ptw + k - 1;
        const float2 u = cmul(__ldg(w + r * Ns), buf[lo]);
        const float2 v = cmul(__ldg(w + (p - r) * Ns), buf[hi]);
        buf[lo] = cadd(u, v);
        buf[hi] = csub(u, v);
    }
    __syncthreads();

    // 2. X_0 of the thread's groups, and A_q, B_q of its items
    float2 dc[A::dcs];
#pragma unroll
    for (int i = 0; i < A::dcs; ++i) {
        const int g = threadIdx.x + i * T;
        dc[i] = make_float2(0.f, 0.f);
        if (g < groups) {
            const int row = div_g(g);
            const int b = row * n + g - row * G;
            float2 acc = buf[pad(b)];
            for (int r = 1; r <= H; ++r) acc = cadd(acc, buf[pad(b + r * G)]);
            dc[i] = acc;
        }
    }
    const int items = ((groups + 3) >> 2) * H;
    float2 am[A::items][4], bm[A::items][4];
#pragma unroll
    for (int i = 0; i < A::items; ++i) {
        const int it = threadIdx.x + i * T;
#pragma unroll
        for (int gi = 0; gi < 4; ++gi) {
            am[i][gi] = make_float2(0.f, 0.f);
            bm[i][gi] = make_float2(0.f, 0.f);
        }
        if (it < items) {
            const int gb = div_h(it);
            const int q = it - gb * H + 1;
            int b[4];
#pragma unroll
            for (int gi = 0; gi < 4; ++gi) {
                // past the last group: the last group again, not stored
                const int g = min(4 * gb + gi, groups - 1);
                const int row = div_g(g);
                b[gi] = row * n + g - row * G;
                am[i][gi] = buf[pad(b[gi])];
            }
            int t = 0;                                   // r q mod p
            for (int r = 1; r <= H; ++r) {
                t += q;
                if (t >= p) t -= p;
                const float2 c = cs[t];
#pragma unroll
                for (int gi = 0; gi < 4; ++gi) {
                    const float2 sv = buf[pad(b[gi] + r * G)];
                    const float2 dv = buf[pad(b[gi] + (p - r) * G)];
                    am[i][gi].x = fmaf(sv.x, c.x, am[i][gi].x);
                    am[i][gi].y = fmaf(sv.y, c.x, am[i][gi].y);
                    bm[i][gi].x = fmaf(dv.y, c.y, bm[i][gi].x);
                    bm[i][gi].y = fmaf(-dv.x, c.y, bm[i][gi].y);
                }
            }
        }
    }
    __syncthreads();

    // 3. output q of group j (k = j mod Ns) to (j - k) p + k + q Ns
#pragma unroll
    for (int i = 0; i < A::dcs; ++i) {
        const int g = threadIdx.x + i * T;
        if (g < groups) {
            const int row = div_g(g);
            const int j = g - row * G;
            const int k = j - div_ns(j) * Ns;
            buf[pad(row * n + (j - k) * p + k)] = dc[i];
        }
    }
#pragma unroll
    for (int i = 0; i < A::items; ++i) {
        const int it = threadIdx.x + i * T;
        if (it < items) {
            const int gb = div_h(it);
            const int q = it - gb * H + 1;
#pragma unroll
            for (int gi = 0; gi < 4; ++gi) {
                const int g = 4 * gb + gi;
                if (g < groups) {
                    const int row = div_g(g);
                    const int j = g - row * G;
                    const int k = j - div_ns(j) * Ns;
                    const int o = row * n + (j - k) * p + k;
                    buf[pad(o + q * Ns)] = cadd(am[i][gi], bm[i][gi]);
                    buf[pad(o + (p - q) * Ns)] = csub(am[i][gi], bm[i][gi]);
                }
            }
        }
    }
    __syncthreads();
}

// The large-prime pass's shared memory: the table of lp_table_len(p)
// entries with one float2 of padding after every kLpQ, then X_0 of each
// group; its outputs a group, rounded up to whole tiles (Ha); a group's
// folded values in Rader's order (y_0, one float2 of padding, Ha s_a, Ha
// d_a: even, so that two of them load as one float4).
__host__ __device__ constexpr int lp_table_len(int p) { return p + 2 * kLpQ; }
__host__ __device__ constexpr int lp_table_slots(int p) {
    return lp_table_len(p) + lp_table_len(p) / kLpQ;
}
__host__ __device__ constexpr int lp_half(int p) {
    return ((p - 1) / 2 + kLpQ - 1) / kLpQ * kLpQ;
}
__host__ __device__ constexpr int lp_stride(int p) {
    return 2 + 2 * lp_half(p);
}

// A direct p-point pass for a prime kSmallPrimeMax < p <= kMaxPrime over
// the rows in buf, in place, register-tiled.  In Rader's order, with g a
// primitive root of p and r_a = g^a mod p for a < H = (p - 1) / 2 (one of
// each pair r, p - r), the twiddled inputs y_r of a group fold into
//   s_a = y_(r_a) + y_(p - r_a),  d_a = y_(r_a) - y_(p - r_a),
// and output q_b = g^b mod p, b < H, with c_k, s_k the cos and sin of
// 2 pi g^k / p, is
//   A = y_0 + sum_a s_a c_(a+b),  D = sum_a d_a s_(a+b),
//   X_(q_b) = A - j D,  X_(p - q_b) = A + j D;  X_0 = y_0 + sum_a s_a.
// The angle of (a, b) is a function of a + b: a thread holds the sums of
// kLpQ consecutive b of one group, and a step a reads one new table entry
// (a window that slides by one; the padding spreads the warp's windows
// over the banks) and the group's s_a and d_a (two steps a float4, the
// same address for the warp's threads of a group: broadcasts) for 4 kLpQ
// FMAs.  A sum of H terms in fp32 misses K6's 1e-4 at a bin 80 dB under
// the row's peak (1.7e-4 at p = 1021 on 129 rows, also in the order of r,
// as any_prime_pass sums), and so do partial sums of 64 steps where one
// row holds the whole spectrum's range (1.05e-4 in 500 rows of 16768 =
// 128 x 131: the split's row of a tone): the FMAs run in fp32 over kLpK
// steps, and those partial sums add into float64 sums (2.2e-5 there).
// tw holds, after the n-entry table, lp_table_len(p) (c_k, s_k) (k past
// p - 2 wraps) and then r_a, int32, for a < H (ops/kernels.py
// _core_twiddles).  The host checks that a block's tiles are at most T
// and that the folded values fit the rows' shared memory
// (any_block_valid).
template <int T, int VALS>
__device__ __forceinline__ void large_prime_pass(
    float2* buf, float2* cs, const float2* __restrict__ ptw,
    const float2* __restrict__ tw, int n, int rows, int Ns, int p) {
    const int G = n / p;
    const int H = (p - 1) / 2;
    const int Ha = lp_half(p);
    const int stride = lp_stride(p);
    const int groups = rows * G;
    const int pairs = groups * H;
    const float2* __restrict__ lt = tw + n;
    const int* __restrict__ perm =
        reinterpret_cast<const int*>(lt + lp_table_len(p));
    float2* x0 = cs + lp_table_slots(p);
    const Div div_h(H), div_g(G), div_ns(Ns);
    const int tid = threadIdx.x;

    // 1. the table into shared memory; each pair (group, a) of the thread
    //    twiddled and folded in registers (at most rows n / 2 pairs), and
    //    y_0 of group tid
    for (int k = tid; k < lp_table_len(p); k += T)
        cs[k + k / kLpQ] = __ldg(lt + k);
    constexpr int F = VALS / 2;
    float2 fs[F], fd[F];
#pragma unroll
    for (int e = 0; e < F; ++e) {
        // past the last pair: the last again, not stored
        const int i = min(tid + e * T, pairs - 1);
        const int g = div_h(i);
        const int a = i - g * H;
        const int r = __ldg(perm + a);
        const int row = div_g(g);
        const int j = g - row * G;
        const int k = j - div_ns(j) * Ns;
        const int b = row * n + j;
        const float2* w = ptw + k - 1;
        const float2 u = cmul(__ldg(w + r * Ns), buf[pad(b + r * G)]);
        const float2 v = cmul(__ldg(w + (p - r) * Ns),
                              buf[pad(b + (p - r) * G)]);
        fs[e] = cadd(u, v);
        fd[e] = csub(u, v);
    }
    float2 y0 = make_float2(0.f, 0.f);
    if (tid < groups) {
        const int row = div_g(tid);
        y0 = buf[pad(row * n + tid - row * G)];
    }
    __syncthreads();

    // 2. group g's folded values at g stride: y_0, then s_a from 2 and
    //    d_a from 2 + Ha, zeros from H to Ha
#pragma unroll
    for (int e = 0; e < F; ++e) {
        const int i = tid + e * T;
        if (i < pairs) {
            const int g = div_h(i);
            float2* u = buf + g * stride + 2 + (i - g * H);
            u[0] = fs[e];
            u[Ha] = fd[e];
        }
    }
    if (tid < groups) {
        float2* u = buf + tid * stride;
        u[0] = y0;
        for (int a = H; a < Ha; ++a)
            u[2 + a] = u[2 + Ha + a] = make_float2(0.f, 0.f);
    }
    __syncthreads();

    // 3. X_0 of each group, by a warp: the sum of its s_a in a fixed order
    const int lane = tid & 31;
    for (int g = tid >> 5; g < groups; g += T / 32) {
        const float2* u = buf + g * stride;
        float2 acc = make_float2(0.f, 0.f);
        for (int a = lane; a < H; a += 32) acc = cadd(acc, u[2 + a]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            acc.x += __shfl_xor_sync(0xffffffffu, acc.x, o);
            acc.y += __shfl_xor_sync(0xffffffffu, acc.y, o);
        }
        if (lane == 0) x0[g] = cadd(u[0], acc);
    }

    // 4. the thread's tile: outputs b0 .. b0 + kLpQ - 1 of group g (past
    //    the last group: nothing).  acc holds A.x, A.y, sum d.y s_k and
    //    sum d.x s_k, in float64, from partial sums over kLpK steps a.
    const int nbt = Ha / kLpQ;
    const int g = tid / nbt;
    const int b0 = (tid - g * nbt) * kLpQ;
    const bool live = g < groups;
    double4 acc[kLpQ];
    if (live) {
        const float2* sv = buf + g * stride;
        const float2 y = sv[0];
        sv += 2;
#pragma unroll
        for (int q = 0; q < kLpQ; ++q)
            acc[q] = make_double4(y.x, y.y, 0.0, 0.0);
        // win[m] = table entry a0 + b0 + m, at slot (a0 + b0) (kLpQ + 1)
        // / kLpQ + m + m / kLpQ (a0 and b0 are multiples of kLpQ)
        float2 win[2 * kLpQ - 1];
        const float2* tb = cs + b0 + b0 / kLpQ;
#pragma unroll
        for (int m = 0; m < kLpQ - 1; ++m) win[m] = tb[m + m / kLpQ];
        for (int a1 = 0; a1 < Ha; a1 += kLpK) {
            float4 part[kLpQ];
#pragma unroll
            for (int q = 0; q < kLpQ; ++q)
                part[q] = make_float4(0.f, 0.f, 0.f, 0.f);
            const int a2 = min(a1 + kLpK, Ha);
            for (int a0 = a1; a0 < a2; a0 += kLpQ) {
#pragma unroll
                for (int m = kLpQ - 1; m < 2 * kLpQ - 1; ++m)
                    win[m] = tb[m + m / kLpQ];
                tb += kLpQ + 1;
#pragma unroll
                for (int u = 0; u < kLpQ; u += 2) {
                    const float4 s2 =
                        *reinterpret_cast<const float4*>(sv + a0 + u);
                    const float4 d2 =
                        *reinterpret_cast<const float4*>(sv + Ha + a0 + u);
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const float sx = h ? s2.z : s2.x;
                        const float sy = h ? s2.w : s2.y;
                        const float dx = h ? d2.z : d2.x;
                        const float dy = h ? d2.w : d2.y;
#pragma unroll
                        for (int q = 0; q < kLpQ; ++q) {
                            const float2 c = win[u + h + q];
                            float4& r = part[q];
                            r.x = fmaf(sx, c.x, r.x);
                            r.y = fmaf(sy, c.x, r.y);
                            r.z = fmaf(dy, c.y, r.z);
                            r.w = fmaf(dx, c.y, r.w);
                        }
                    }
                }
#pragma unroll
                for (int m = 0; m < kLpQ - 1; ++m) win[m] = win[kLpQ + m];
            }
#pragma unroll
            for (int q = 0; q < kLpQ; ++q) {
                acc[q].x += part[q].x;
                acc[q].y += part[q].y;
                acc[q].z += part[q].z;
                acc[q].w += part[q].w;
            }
        }
    }
    __syncthreads();

    // 5. output q of group j (k = j mod Ns) to (j - k) p + k + q Ns
    if (live) {
        const int row = div_g(g);
        const int j = g - row * G;
        const int k = j - div_ns(j) * Ns;
        const int o = row * n + (j - k) * p + k;
#pragma unroll
        for (int q = 0; q < kLpQ; ++q) {
            if (b0 + q < H) {
                const int r = __ldg(perm + b0 + q);
                const double4 v = acc[q];
                buf[pad(o + r * Ns)] =
                    make_float2((float)(v.x + v.z), (float)(v.y - v.w));
                buf[pad(o + (p - r) * Ns)] =
                    make_float2((float)(v.x - v.z), (float)(v.y + v.w));
            }
        }
    }
    if (tid < groups) {
        const int row = div_g(tid);
        const int j = tid - row * G;
        const int k = j - div_ns(j) * Ns;
        buf[pad(row * n + (j - k) * p + k)] = x0[tid];
    }
    __syncthreads();
}

// K6's rows (EPI kEpSpectrum), the split's pass A (kEpSplitCols: a
// block's rows are consecutive columns) or pass B (kEpSplitRows), or the
// chirp route's rows of M (kEpChirp) or its pass B (kEpChirpRows); the
// chirp route's column passes run on the pow2 instances alone
template <int T, int VALS, int EPI>
__global__ void __launch_bounds__(T, (Any<T, VALS>::min_blocks))
spectrum_fft_any_kernel(Args a, int n, int rows, int npass,
                        unsigned long long plan_lo,
                        unsigned long long plan_hi) {
    extern __shared__ __align__(16) float2 buf[];
    float2* cs = buf + padded_size(rows * n);        // a prime pass's table
    const int64_t row0 = (int64_t)blockIdx.x * rows;
    const int total = rows * n;
    const Div div_n(n);

    // 1. the windowed rows into shared memory (rows past B load zeros),
    //    every load of the thread in flight at once
    const int64_t last = (int64_t)a.B * n - 1;       // the input's end
    if constexpr (EPI == kEpSplitCols) {
        // value t1 of column row0 + c at pad(c n + t1), neighbouring
        // threads on neighbouring columns (a column past B loads column 0
        // and stores nothing)
        const Div div_rows(rows);
#pragma unroll
        for (int e = 0; e < VALS; ++e) {
            const int i = min((int)threadIdx.x + e * T, total - 1);
            const int t1 = div_rows(i);
            const int c = i - t1 * rows;
            const bool live = row0 + c < a.B;
            int t2;
            const int64_t o = split_col(a, live ? row0 + c : 0, n, t2);
            const int t = a.other * t1;
            const float2 x = __ldg(a.in + o + t);
            const float w = live ? __ldg(a.win + t + t2) : 0.f;
            if ((int)threadIdx.x + e * T < total)
                buf[pad(c * n + t1)] = make_float2(x.x * w, x.y * w);
        }
    } else if constexpr (EPI == kEpSplitRows) {
#pragma unroll
        for (int e = 0; e < VALS; ++e) {
            const int i = min((int)threadIdx.x + e * T, total - 1);
            const int64_t src = row0 * n + i;
            const float2 x = __ldg(a.in + (src < last ? src : last));
            if ((int)threadIdx.x + e * T < total)
                buf[pad(i)] = src <= last ? x : make_float2(0.f, 0.f);
        }
    } else if constexpr (EPI == kEpChirp) {
        // value t of row r: x[t] through the window and the chirp, 0 from
        // t = n_sig on and on a row past B (8 values' loads in flight at a
        // time: unrolled 16 deep, with the chirp's loads, it spilled)
#pragma unroll 8
        for (int e = 0; e < VALS; ++e) {
            const int i = min((int)threadIdx.x + e * T, total - 1);
            const int r = div_n(i);
            const int t = i - r * n;
            const int tc = min(t, a.n_sig - 1);
            const int64_t b = min(row0 + r, (int64_t)a.B - 1);
            const float2 x = __ldg(a.in + b * a.n_sig + tc);
            const float w = row0 + r < a.B && t < a.n_sig
                ? __ldg(a.win + tc) : 0.f;
            if ((int)threadIdx.x + e * T < total)
                buf[pad(i)] = cmul(__ldg(a.chirp + tc),
                                   make_float2(x.x * w, x.y * w));
        }
    } else if constexpr (EPI == kEpChirpRows) {
        // rows of Y, which this launch overwrites: plain loads, not the
        // read-only path
#pragma unroll
        for (int e = 0; e < VALS; ++e) {
            const int i = min((int)threadIdx.x + e * T, total - 1);
            const int64_t src = row0 * n + i;
            const float2 x = a.in[src < last ? src : last];
            if ((int)threadIdx.x + e * T < total)
                buf[pad(i)] = src <= last ? x : make_float2(0.f, 0.f);
        }
    } else {
#pragma unroll
        for (int e = 0; e < VALS; ++e) {
            const int i = min((int)threadIdx.x + e * T, total - 1);
            const int t = i - div_n(i) * n;
            const int64_t src = row0 * n + i;
            const float2 x = __ldg(a.in + (src < last ? src : last));
            const float w = src <= last ? __ldg(a.win + t) : 0.f;
            if ((int)threadIdx.x + e * T < total)
                buf[pad(i)] = make_float2(x.x * w, x.y * w);
        }
    }
    __syncthreads();

    // 2. the passes; the chirp route's rows of M (pass B's rows of Y) run
    //    them twice, with Z = conj(A) D at each bin between (one copy of
    //    the passes' code)
    constexpr bool twice = EPI == kEpChirp || EPI == kEpChirpRows;
    for (int round = 0; round < (twice ? 2 : 1); ++round) {
        if (twice && round == 1) {
            // bin k of row r: D at k (a row of M), or at k1 n + k with k1 the
            // row's index mod M1 (pass B's rows of Y)
            const int k10 = EPI == kEpChirpRows
                ? (int)((unsigned long long)row0 % (unsigned)a.other) : 0;
            const Div div_m1(EPI == kEpChirpRows ? a.other : 1);
            for (int i = threadIdx.x; i < total; i += T) {
                const int r = div_n(i);
                int d = i - r * n;
                if constexpr (EPI == kEpChirpRows)
                    d += (k10 + r - div_m1(k10 + r) * a.other) * n;
                const float2 v = buf[pad(i)];
                buf[pad(i)] = cmul(__ldg(a.dtab + d), make_float2(v.x, -v.y));
            }
            __syncthreads();
        }
        int Ns = 1;
        unsigned long long word = plan_lo;
        for (int p = 0; p < npass; ++p) {
            if (p == kRadicesAWord) word = plan_hi;
            const int R = (int)(word & kRadixMask);
            word >>= kRadixBits;
            switch (R) {
            case 2: any_reg_pass<2, T, VALS>(buf, a.ptw, n, rows, Ns); break;
            case 3: any_reg_pass<3, T, VALS>(buf, a.ptw, n, rows, Ns); break;
            case 4: any_reg_pass<4, T, VALS>(buf, a.ptw, n, rows, Ns); break;
            case 5: any_reg_pass<5, T, VALS>(buf, a.ptw, n, rows, Ns); break;
            case 7: any_reg_pass<7, T, VALS>(buf, a.ptw, n, rows, Ns); break;
            case 8: any_reg_pass<8, T, VALS>(buf, a.ptw, n, rows, Ns); break;
            case 16: any_reg_pass<16, T, VALS>(buf, a.ptw, n, rows, Ns); break;
            default:
                // the host sends a prime past kSmallPrimeMax to the large
                // instance alone
                if constexpr (Any<T, VALS>::large) {
                    if (R > kSmallPrimeMax) {
                        large_prime_pass<T, VALS>(buf, cs, a.ptw, a.tw, n,
                                                  rows, Ns, R);
                        break;
                    }
                }
                any_prime_pass<T, VALS>(buf, cs, a.ptw, a.tw, n, rows, Ns, R);
                break;
            }
            Ns *= R;
        }
    }

    // 3. the outputs, coalesced: K6's epilogue in natural bin order; pass
    //    A's Y[b, k1, t2] = W_n^(t2 k1) X_t2[k1]; pass B's epilogue at bin
    //    k1 + n1 k2, neighbouring threads on neighbouring rows k1; the
    //    chirp route's pass B's W_M^(k1 m2) V[k1, m2] back into its row of
    //    Y, and its one launch's epilogue of bins k < n_sig
    if constexpr (EPI == kEpSplitCols) {
        const Div div_rows(rows);
#pragma unroll
        for (int e = 0; e < VALS; ++e) {
            const int i = threadIdx.x + e * T;
            const int k1 = div_rows(i);
            const int c = i - k1 * rows;
            if (i < total && row0 + c < a.B) {
                int t2;
                const int64_t o = split_col(a, row0 + c, n, t2);
                const int k = k1 * a.other;
                static_cast<float2*>(a.out)[o + k] =
                    cmul(__ldg(a.tws + k + t2), buf[pad(c * n + k1)]);
            }
        }
    } else if constexpr (EPI == kEpSplitRows) {
        const Div div_rows(rows);
#pragma unroll
        for (int e = 0; e < VALS; ++e) {
            const int i = threadIdx.x + e * T;
            const int k2 = div_rows(i);
            const int r = i - k2 * rows;
            if (i < total && row0 + r < a.B)
                static_cast<float*>(a.out)[split_row(a, row0 + r, n) +
                                           (int64_t)a.other * k2] =
                    spectrum_value(buf[pad(r * n + k2)], a.coeff, a.scale,
                                   a.offset);
        }
    } else if constexpr (EPI == kEpChirpRows) {
        const int k10 = (int)((unsigned long long)row0 % (unsigned)a.other);
        const Div div_m1(a.other);
#pragma unroll 8
        for (int e = 0; e < VALS; ++e) {
            const int i = threadIdx.x + e * T;
            const int r = div_n(i);
            if (i < total && row0 + r < a.B) {
                const int k1 = k10 + r - div_m1(k10 + r) * a.other;
                static_cast<float2*>(a.out)[row0 * n + i] =
                    cmul(__ldg(a.tws + k1 * n + i - r * n), buf[pad(i)]);
            }
        }
    } else if constexpr (EPI == kEpChirp) {
#pragma unroll
        for (int e = 0; e < VALS; ++e) {
            const int i = threadIdx.x + e * T;
            const int r = div_n(i);
            const int k = i - r * n;
            if (i < total && row0 + r < a.B && k < a.n_sig)
                static_cast<float*>(a.out)[(row0 + r) * a.n_sig + k] =
                    spectrum_value(buf[pad(i)], a.coeff, a.scale, a.offset);
        }
    } else {
#pragma unroll
        for (int e = 0; e < VALS; ++e) {
            const int i = threadIdx.x + e * T;
            if (i < total && row0 + div_n(i) < a.B)
                static_cast<float*>(a.out)[row0 * n + i] =
                    spectrum_value(buf[pad(i)], a.coeff, a.scale, a.offset);
        }
    }
}

// ---------------------------------------------------------------------------
// Host side

int radix_at(int p, unsigned long long lo, unsigned long long hi) {
    const unsigned long long w = p < kRadicesAWord ? lo : hi;
    return (int)((w >> (kRadixBits * (p % kRadicesAWord))) & kRadixMask);
}

bool is_register_radix(int r) {
    return r == 2 || r == 3 || r == 4 || r == 5 || r == 7 || r == 8 ||
           r == 16;
}

bool is_prime(int r) {
    if (r < 2) return false;
    for (int d = 2; d * d <= r; ++d)
        if (r % d == 0) return false;
    return true;
}

// A plan's radices multiply to n, each a register radix or a prime
// <= kMaxPrime, and every field past the last pass, and every bit past
// the fields, is 0: no radix is cut.
bool plan_valid(int n, int npass, unsigned long long lo,
                unsigned long long hi) {
    constexpr int used = kRadixBits * kRadicesAWord;
    if (npass < 0 || npass > kMaxPasses || lo >> used || hi >> used)
        return false;
    long long prod = 1;
    for (int p = 0; p < npass; ++p) {
        const int r = radix_at(p, lo, hi);
        if (!is_register_radix(r) && !(is_prime(r) && r <= kMaxPrime))
            return false;
        prod *= r;
        if (prod > n) return false;
    }
    for (int p = npass; p < kMaxPasses; ++p)
        if (radix_at(p, lo, hi) != 0) return false;
    return prod == n;
}

// The plan's prime past kSmallPrimeMax (large_prime_pass), or 0
int large_prime(int npass, unsigned long long lo, unsigned long long hi) {
    int big = 0;
    for (int p = 0; p < npass; ++p) {
        const int r = radix_at(p, lo, hi);
        if (!is_register_radix(r) && r > kSmallPrimeMax) big = r;
    }
    return big;
}

// A block of the runtime-plan instance that threads (256 or 512) and the
// plan name (a plan with a large prime: 256 threads of 12 values; else
// 256 of 16 or 512 of 32), rows rows, holds every pass of the plan: rows
// n values at most VALS a thread; for each prime pass <= kSmallPrimeMax
// at most Any::items items a thread; for a large prime, its tiles (Ha /
// kLpQ a group) at most one a thread, and the groups' folded values
// inside the rows' shared memory.
bool any_block_valid(int n, int threads, int rows, int npass,
                     unsigned long long lo, unsigned long long hi) {
    const bool large = large_prime(npass, lo, hi) != 0;
    const int vals = threads == 256 ? (large ? 12 : 16)
                     : threads == 512 && !large ? 32 : 0;
    if (vals == 0 || rows < 1 || (int64_t)rows * n > (int64_t)vals * threads)
        return false;
    for (int p = 0; p < npass; ++p) {
        const int r = radix_at(p, lo, hi);
        if (is_register_radix(r)) continue;
        const int groups = rows * (n / r);
        if (r > kSmallPrimeMax) {
            const int tiles = lp_half(r) / kLpQ * groups;
            if (tiles > threads ||
                groups * lp_stride(r) > padded_size(rows * n))
                return false;
            continue;
        }
        const int64_t items = ((int64_t)groups + 3) / 4 * ((r - 1) / 2);
        if (items > (int64_t)vals / 8 * threads) return false;
    }
    return true;
}

// The float2 a block reserves past its rows for its prime passes: a
// small prime's p-entry table; a large prime's padded table and its
// groups' X_0 (none without a prime pass)
int table_slots(int n, int rows, int npass, unsigned long long lo,
                unsigned long long hi) {
    int most = 0;
    for (int p = 0; p < npass; ++p) {
        const int r = radix_at(p, lo, hi);
        if (is_register_radix(r)) continue;
        const int need = r > kSmallPrimeMax
            ? lp_table_slots(r) + rows * (n / r) : r;
        most = need > most ? need : most;
    }
    return most;
}

template <int T, int VALS, int EPI>
int launch_any(const Args& a, int n, int rows, int npass,
               unsigned long long lo, unsigned long long hi,
               cudaStream_t stream) {
    const unsigned grid = (unsigned)((a.B + rows - 1) / rows);
    const size_t smem = (size_t)(padded_size(rows * n) +
                                 table_slots(n, rows, npass, lo, hi)) *
                        sizeof(float2);
    auto kernel = spectrum_fft_any_kernel<T, VALS, EPI>;
    if (smem > kSmemDefault) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, T, smem, stream>>>(a, n, rows, npass, lo, hi);
    return (int)cudaGetLastError();
}

template <int LOG2N>
bool is_pow2_plan(int npass, unsigned long long lo, unsigned long long hi) {
    using P = Pow2<LOG2N>;
    if (npass != P::passes) return false;
    for (int p = 0; p < npass; ++p)
        if (radix_at(p, lo, hi) != 1 << P::bits(p)) return false;
    return true;
}

template <int LOG2N, int EPI>
int launch_pow2(const Args& a, int npass, unsigned long long lo,
                unsigned long long hi, cudaStream_t stream) {
    using P = Pow2<LOG2N>;
    if (!is_pow2_plan<LOG2N>(npass, lo, hi))
        return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((a.B + P::rows - 1) / P::rows);
    const size_t smem = (size_t)padded_size(P::rows * P::n) * sizeof(float2);
    auto kernel = fft_pow2_kernel<LOG2N, EPI>;
    if (smem > kSmemDefault) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, P::T, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <int EPI>
int pow2_dispatch(int log2n, const Args& a, int npass, unsigned long long lo,
                  unsigned long long hi, cudaStream_t stream) {
    switch (log2n) {
    case 7: return launch_pow2<7, EPI>(a, npass, lo, hi, stream);
    case 8: return launch_pow2<8, EPI>(a, npass, lo, hi, stream);
    case 9: return launch_pow2<9, EPI>(a, npass, lo, hi, stream);
    case 10: return launch_pow2<10, EPI>(a, npass, lo, hi, stream);
    case 11: return launch_pow2<11, EPI>(a, npass, lo, hi, stream);
    case 12: return launch_pow2<12, EPI>(a, npass, lo, hi, stream);
    }
    if constexpr (EPI == kEpSpectrum) {
        switch (log2n) {
        case 13: return launch_pow2<13, EPI>(a, npass, lo, hi, stream);
        case 14: return launch_pow2<14, EPI>(a, npass, lo, hi, stream);
        }
    }
    return (int)cudaErrorInvalidValue;
}

// log2 n if n is a power of two, else -1
int exact_log2(int n) {
    int b = 0;
    while ((1 << b) < n) ++b;
    return n == 1 << b ? b : -1;
}

// One launch of the core for n-point rows (K6's, or a pass of the split):
// the pow2 instance for a power of two >= 128, else the runtime-plan
// instance of the block that threads and rows name, if it holds every
// pass.
template <int EPI>
int core_launch(const Args& a, int n, int npass, unsigned long long lo,
                unsigned long long hi, int threads, int rows,
                cudaStream_t s) {
    const int log2n = exact_log2(n);
    if (log2n >= kMinLog2)
        return pow2_dispatch<EPI>(log2n, a, npass, lo, hi, s);
    if (!any_block_valid(n, threads, rows, npass, lo, hi))
        return (int)cudaErrorInvalidValue;
    if (large_prime(npass, lo, hi))
        return launch_any<256, 12, EPI>(a, n, rows, npass, lo, hi, s);
    return threads == 256
        ? launch_any<256, 16, EPI>(a, n, rows, npass, lo, hi, s)
        : launch_any<512, 32, EPI>(a, n, rows, npass, lo, hi, s);
}

// A block of the chirp route's instances (256 threads of 16 values, 512
// of 32) that holds every pass of a valid plan with no prime past
// kSmallPrimeMax
bool chirp_block_valid(int n, int threads, int rows, int npass,
                       unsigned long long lo, unsigned long long hi) {
    return plan_valid(n, npass, lo, hi) && !large_prime(npass, lo, hi) &&
           any_block_valid(n, threads, rows, npass, lo, hi);
}

// One launch of the chirp route over n-point rows (chirp_block_valid has
// passed)
template <int EPI>
int chirp_launch(const Args& a, int n, int npass, unsigned long long lo,
                 unsigned long long hi, int threads, int rows,
                 cudaStream_t s) {
    return threads == 256
        ? launch_any<256, 16, EPI>(a, n, rows, npass, lo, hi, s)
        : launch_any<512, 32, EPI>(a, n, rows, npass, lo, hi, s);
}

// The chirp route's column passes (A, A') for M1 points: the pow2
// instance of a power of two from 128 to 2^kSplitMaxLog2, with its
// compiled plan
bool chirp_cols_valid(int n, int npass, unsigned long long lo,
                      unsigned long long hi) {
    const int log2n = exact_log2(n);
    return log2n >= kMinLog2 && log2n <= kSplitMaxLog2 &&
           plan_valid(n, npass, lo, hi);
}

}  // namespace

// K3: x (B, n) complex64 as float2 (8-byte aligned), ptw (n - 1, 2) the
// passes' twiddles (below), out (B, n) complex64, the plan (npass radices,
// kRadixBits bits each, kRadicesAWord to each of lo and hi, pass 0
// lowest: ops/kernels.py _packed_plan) that ops/kernels.py fft_plan(n)
// gives; n = 128 m with m a power of two <= 32.  ptw holds, for each pass
// of radix R after radices whose product is Ns, W_n^(r k n / (Ns R)) at
// r Ns + k - 1 for 0 < r < R and k < Ns (ops/kernels.py
// _stockham_twiddles: the n-entry table's entries in pass order, so that
// a warp's twiddle loads coalesce).  Returns the launch's CUDA error code.
extern "C" int fft_pallas_launch(const void* x, const void* ptw, void* out,
                                 int B, int n, int npass,
                                 unsigned long long plan_lo,
                                 unsigned long long plan_hi, void* stream) {
    const int log2n = exact_log2(n);
    if (B < 1 || log2n < kMinLog2 || log2n > kK3MaxLog2)
        return (int)cudaErrorInvalidValue;
    Args a{static_cast<const float2*>(x), nullptr,
           static_cast<const float2*>(ptw), nullptr, out, B, 0.f, 0.f, 0.f};
    return pow2_dispatch<kEpComplex>(log2n, a, npass, plan_lo, plan_hi,
                                     static_cast<cudaStream_t>(stream));
}

// K6's FFT route: iq (B, n, 2) float32 (8-byte aligned), win (n,), ptw as
// for K3, tw the table W_n^t, t < n, and for a plan with a prime past
// kSmallPrimeMax the large-prime pass's tables after it (ops/kernels.py
// _core_twiddles), out (B, n), the plan as for K3; 1 <= n <= 16384 with
// every prime factor <= kMaxPrime.  Unless n is a power of two >= 128,
// the runtime-plan instance takes the block that threads (256 or 512) and
// rows name (ops/kernels.py _runtime_block), if it holds every pass.
// Returns the launch's CUDA error code.
extern "C" int spectrum_fft_launch(const void* iq, const void* win,
                                   const void* ptw, const void* tw,
                                   void* out, int B, int n,
                                   int npass, unsigned long long plan_lo,
                                   unsigned long long plan_hi, int threads,
                                   int rows, float coeff, float scale,
                                   float offset, void* stream) {
    if (B < 1 || n < 1 || n > kMaxPoints ||
        !plan_valid(n, npass, plan_lo, plan_hi))
        return (int)cudaErrorInvalidValue;
    Args a{static_cast<const float2*>(iq), static_cast<const float*>(win),
           static_cast<const float2*>(ptw), static_cast<const float2*>(tw),
           out, B, coeff, scale, offset};
    return core_launch<kEpSpectrum>(a, n, npass, plan_lo, plan_hi, threads,
                                    rows, static_cast<cudaStream_t>(stream));
}

// K6's split route for n = n1 n2: iq (B, n, 2) float32 (8-byte aligned),
// win (n,); for factor i (1, 2) ptw_i and tw_i as K6's FFT route takes
// them for n_i points, its plan (npass_i, lo_i, hi_i) and, unless n_i is
// a power of two >= 128, its runtime-plan block (threads_i, rows_i); tws
// (n1, n2, 2) float32 the n-entry table's W_n^(t2 k1) at k1 n2 + t2
// (ops/kernels.py _split_tables); y (B, n) complex64 scratch; out (B, n).
// 2 <= n_i <= 16384, every prime factor <= kMaxPrime, a power of two at most
// 2^kSplitMaxLog2, B n_i < 2^31.  Launches
// pass A (columns: n1-point FFTs, the twiddle, into y) and then pass B
// (rows of y: n2-point FFTs and the epilogue, into out) on the stream.
// Returns the first launch's CUDA error code that is not 0.
extern "C" int spectrum_split_launch(
    const void* iq, const void* win, const void* ptw1, const void* tw1,
    const void* ptw2, const void* tw2, const void* tws, void* y, void* out,
    int B, int n1, int n2, int npass1, unsigned long long lo1,
    unsigned long long hi1, int threads1, int rows1, int npass2,
    unsigned long long lo2, unsigned long long hi2, int threads2, int rows2,
    float coeff, float scale, float offset, void* stream) {
    if (B < 1 || n1 < 2 || n2 < 2 || n1 > kMaxPoints || n2 > kMaxPoints ||
        (int64_t)B * n1 > INT32_MAX || (int64_t)B * n2 > INT32_MAX ||
        exact_log2(n1) > kSplitMaxLog2 || exact_log2(n2) > kSplitMaxLog2 ||
        !plan_valid(n1, npass1, lo1, hi1) || !plan_valid(n2, npass2, lo2, hi2))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Args pa{static_cast<const float2*>(iq),
                  static_cast<const float*>(win),
                  static_cast<const float2*>(ptw1),
                  static_cast<const float2*>(tw1), y, B * n2, 0.f, 0.f, 0.f,
                  static_cast<const float2*>(tws), n2};
    const int err = core_launch<kEpSplitCols>(pa, n1, npass1, lo1, hi1,
                                              threads1, rows1, s);
    if (err != 0) return err;
    const Args pb{static_cast<const float2*>(y), nullptr,
                  static_cast<const float2*>(ptw2),
                  static_cast<const float2*>(tw2), out, B * n1, coeff, scale,
                  offset, nullptr, n1};
    return core_launch<kEpSplitRows>(pb, n2, npass2, lo2, hi2, threads2,
                                     rows2, s);
}

// K6's chirp route in one launch, M <= 16384 (ops/kernels.py
// chirp_length): iq (B, n, 2) float32 (8-byte aligned), win (n,), chirp
// (n, 2) c_t (_chirp_table), dtab (M, 2) D = conj(C) / M (_chirp_spectrum),
// ptw and tw as K6's FFT route takes them for M points, out (B, n); M >=
// 2 n - 1; the plan of M (no prime past kSmallPrimeMax) and its
// runtime-plan block (threads 256 or 512, rows), which must hold every
// pass.  Returns the launch's CUDA error code.
extern "C" int spectrum_chirp_launch(
    const void* iq, const void* win, const void* chirp, const void* dtab,
    const void* ptw, const void* tw, void* out, int B, int n, int M,
    int npass, unsigned long long plan_lo, unsigned long long plan_hi,
    int threads, int rows, float coeff, float scale, float offset,
    void* stream) {
    if (B < 1 || n < 1 || M > kMaxPoints || M < 2 * (int64_t)n - 1 ||
        !chirp_block_valid(M, threads, rows, npass, plan_lo, plan_hi))
        return (int)cudaErrorInvalidValue;
    const Args a{static_cast<const float2*>(iq),
                 static_cast<const float*>(win),
                 static_cast<const float2*>(ptw),
                 static_cast<const float2*>(tw), out, B, coeff, scale,
                 offset, nullptr, 0, static_cast<const float2*>(chirp),
                 static_cast<const float2*>(dtab), n};
    return chirp_launch<kEpChirp>(a, M, npass, plan_lo, plan_hi, threads,
                                  rows, static_cast<cudaStream_t>(stream));
}

// K6's chirp route in three launches, M = M1 M2 past 16384 (ops/kernels.py
// chirp_length, chirp_split): iq, win, chirp as above; dtab (M, 2) D with
// bin k1 + M1 k2 at k1 M2 + k2; for factor i (1, 2) ptw_i and tw_i as K6's
// FFT route takes them for M_i points, and its plan (no prime past
// kSmallPrimeMax); M1 a power of two from 128 to 2^kSplitMaxLog2 (its
// pow2 instance), and M2's runtime-plan block, which must hold every
// pass; tws (M1, M2, 2) W_M^(t2 k1) at k1 M2 + t2 (_split_tables); y (B,
// M) complex64 scratch; out (B, n).  M >= 2 n - 1, 2 <= M_i <= 16384, B M_i <
// 2^31.  Launches pass A (M1-point columns of the chirped rows, the
// twiddle, into y), pass B (rows of y: the M2-point FFT, Z, the M2-point
// FFT, the twiddle, back into y) and pass A' (M1-point columns of y, the
// epilogue of bins below n, into out) on the stream, once every plan and
// block has been checked.  Returns the first launch's CUDA error code that
// is not 0.
extern "C" int spectrum_chirp_split_launch(
    const void* iq, const void* win, const void* chirp, const void* dtab,
    const void* ptw1, const void* tw1, const void* ptw2, const void* tw2,
    const void* tws, void* y, void* out, int B, int n, int M1, int M2,
    int npass1, unsigned long long lo1, unsigned long long hi1,
    int npass2, unsigned long long lo2, unsigned long long hi2,
    int threads2, int rows2, float coeff, float scale, float offset,
    void* stream) {
    if (B < 1 || n < 1 || M1 < 2 || M2 < 2 || M1 > kMaxPoints ||
        M2 > kMaxPoints || (int64_t)M1 * M2 < 2 * (int64_t)n - 1 ||
        (int64_t)B * M1 > INT32_MAX || (int64_t)B * M2 > INT32_MAX ||
        !chirp_cols_valid(M1, npass1, lo1, hi1) ||
        !chirp_block_valid(M2, threads2, rows2, npass2, lo2, hi2))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float2* c = static_cast<const float2*>(chirp);
    const float2* w = static_cast<const float2*>(tws);
    const float2* yin = static_cast<const float2*>(y);
    const Args pa{static_cast<const float2*>(iq),
                  static_cast<const float*>(win),
                  static_cast<const float2*>(ptw1),
                  static_cast<const float2*>(tw1), y, B * M2, 0.f, 0.f, 0.f,
                  w, M2, c, nullptr, n};
    const int log2m1 = exact_log2(M1);
    int err = pow2_dispatch<kEpChirpCols>(log2m1, pa, npass1, lo1, hi1, s);
    if (err != 0) return err;
    const Args pb{yin, nullptr, static_cast<const float2*>(ptw2),
                  static_cast<const float2*>(tw2), y, B * M1, 0.f, 0.f, 0.f,
                  w, M1, nullptr, static_cast<const float2*>(dtab), n};
    err = chirp_launch<kEpChirpRows>(pb, M2, npass2, lo2, hi2, threads2,
                                     rows2, s);
    if (err != 0) return err;
    const Args pc{yin, nullptr, static_cast<const float2*>(ptw1),
                  static_cast<const float2*>(tw1), out, B * M2, coeff, scale,
                  offset, nullptr, M2, nullptr, nullptr, n};
    return pow2_dispatch<kEpChirpOut>(log2m1, pc, npass1, lo1, hi1, s);
}
