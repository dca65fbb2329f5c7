// K6, the fused spectrum by the full DFT, for Hopper (sm_90a): window,
// n-point DFT as one tiled product, |X|^2 in dB, range scale and soft
// clip, for any n.  Replaces spectrum_fused (_spectrum_dft_kernel) of
// cyberether_tpu/ops/pallas_kernels.py.
//
// Contract, per row b of iq (B, n, 2) float32 interleaved re/im, any
// B >= 1 and n >= 1, with the window win (n,) already holding the
// (-1)^k sign and tw (n, 2) the table W_n^j = [cos, -sin](2 pi j / n),
// j < n, computed in float64 on the host:
//   X[k]  = sum_t win[t] * (re[t] + j im[t]) * W_n^((t k) mod n)
//   db[k] = 10 * log10(|X[k]|^2) + coeff     (log10 as ln * 0.4342944819,
//           the JAX kernel's form; |X|^2 = 0 gives -inf)
//   out[b, k] = 0.5 + 0.5 * tanh(4 * (db[k] * scale + offset - 0.5))
// in natural bin order.  An all-zero row gives exactly 0.
//
// What bounds it on this card: operations.  A complex multiply-add is 4
// FFMA, so the product is 8 B n^2 fp32 flops: at B = 4096, n = 2048
// 137.4 GFLOP, 2.05 ms at 67 TFLOP/s, against 100.7 MB of input and
// output (0.030 ms at 3.35 TB/s).
//
// What the design does about it: an SGEMM-shaped tiling in fp32 FFMA.
// - A block of 256 threads owns a tile of 64 rows x 64 bins; a thread
//   owns 4 x 4 complex outputs (rows ty + 16 i, bins tx + 16 j, so its
//   shared-memory reads are broadcasts or 16 consecutive float2).
// - It walks t in chunks of 16.  Each chunk stages into shared memory
//   the windowed samples (64 rows x 16, coalesced rows of 128 bytes)
//   and the twiddles (16 x 64 bins), gathered from the n-entry table at
//   (t k) mod n.  That index is computed once per thread in 64 bits and
//   then stepped by (16 k) mod n with one conditional subtraction per
//   staged entry, never per FMA.  The n x n C/S matrices never exist.
// - A chunk's 16 products are summed in registers first and then added
//   to the running sum: a blocked sum, whose rounding error grows with
//   n / 16 and not with n.
// - Rows past B and samples or bins past n stage zeros, and their
//   outputs are not stored, so any B and n work.
// No tensor cores: TF32 misses the exact tier, and a 3xTF32 or wgmma
// design is later work.  logf and tanhf are the accurate library
// functions (the file is compiled without --use_fast_math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // 16 x 16
constexpr int kTile = 64;            // rows and bins of a block's tile
constexpr int kChunk = 16;           // samples staged a step
constexpr int kPer = 4;              // rows and bins of a thread

__global__ void __launch_bounds__(kThreads)
spectrum_dft_kernel(const float2* __restrict__ iq,
                    const float* __restrict__ win,
                    const float2* __restrict__ tw, float* __restrict__ out,
                    int B, int n, float coeff, float scale, float offset) {
    __shared__ float2 xs[kChunk][kTile + 1];      // padded: 2-way stores
    __shared__ float2 ws[kChunk][kTile];

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int64_t row0 = (int64_t)blockIdx.y * kTile;
    const int k0 = blockIdx.x * kTile;

    // staging of x: sample xt of rows xr + 16 q
    const int xt = tid & 15;
    const int xr = tid >> 4;
    // staging of twiddles: bin kw at samples wt + 4 q; idx[q] is
    // ((t0 + wt + 4 q) kw) mod n for the chunk at t0
    const int wb = tid & 63;
    const int wt = tid >> 6;
    const int kw = k0 + wb;
    const bool bin_live = kw < n;
    int idx[kPer];
    int step = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q)
        idx[q] = bin_live ? (int)((int64_t)(wt + 4 * q) * kw % n) : 0;
    if (bin_live) step = (int)((int64_t)kChunk * kw % n);

    float2 acc[kPer][kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] = make_float2(0.f, 0.f);

    for (int t0 = 0; t0 < n; t0 += kChunk) {
        {
            const int t = t0 + xt;
            const float w = t < n ? __ldg(win + t) : 0.f;
#pragma unroll
            for (int q = 0; q < kPer; ++q) {
                const int64_t row = row0 + xr + 16 * q;
                float2 v = make_float2(0.f, 0.f);
                if (row < B && t < n) {
                    v = __ldg(iq + row * n + t);
                    v = make_float2(v.x * w, v.y * w);
                }
                xs[xt][xr + 16 * q] = v;
            }
        }
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
            const int t = t0 + wt + 4 * q;
            ws[wt + 4 * q][wb] = bin_live && t < n ? __ldg(tw + idx[q])
                                                   : make_float2(0.f, 0.f);
            idx[q] += step;
            if (idx[q] >= n) idx[q] -= n;
        }
        __syncthreads();

        float2 part[kPer][kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
            for (int j = 0; j < kPer; ++j) part[i][j] = make_float2(0.f, 0.f);
#pragma unroll
        for (int tt = 0; tt < kChunk; ++tt) {
            float2 a[kPer], w[kPer];
#pragma unroll
            for (int i = 0; i < kPer; ++i) a[i] = xs[tt][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < kPer; ++j) w[j] = ws[tt][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < kPer; ++i)
#pragma unroll
                for (int j = 0; j < kPer; ++j) {
                    float2& p = part[i][j];
                    p.x = fmaf(a[i].x, w[j].x, fmaf(-a[i].y, w[j].y, p.x));
                    p.y = fmaf(a[i].x, w[j].y, fmaf(a[i].y, w[j].x, p.y));
                }
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i)
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
                acc[i][j].x += part[i][j].x;
                acc[i][j].y += part[i][j].y;
            }
        __syncthreads();
    }

    // epilogue, natural bin order
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
        const int64_t row = row0 + ty + 16 * i;
        if (row >= B) continue;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            const int k = k0 + tx + 16 * j;
            if (k >= n) continue;
            const float2 x = acc[i][j];
            const float mag2 = x.x * x.x + x.y * x.y;
            const float db =
                10.f * (logf(mag2) * 0.43429448190325176f) + coeff;
            const float norm = db * scale + offset;
            out[row * n + k] = 0.5f + 0.5f * tanhf(4.f * (norm - 0.5f));
        }
    }
}

}  // namespace

// K6: iq (B, n, 2) float32 (8-byte aligned), win (n,), tw (n, 2) the
// table W_n^j, out (B, n).  Returns the launch's CUDA error code.
extern "C" int spectrum_fused_launch(const void* iq, const void* win,
                                     const void* tw, void* out, int B, int n,
                                     float coeff, float scale, float offset,
                                     void* stream) {
    const int64_t row_tiles = ((int64_t)B + kTile - 1) / kTile;
    if (B < 1 || n < 1 || row_tiles > 65535 || n > (1 << 29))
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((n + kTile - 1) / kTile), (unsigned)row_tiles);
    spectrum_dft_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(iq), static_cast<const float*>(win),
        static_cast<const float2*>(tw), static_cast<float*>(out), B, n,
        coeff, scale, offset);
    return (int)cudaGetLastError();
}
