// Forward real FFT to the permuted half spectrum (kernel of
// engine/kernels/fft_half.py; replaces folve_tpu fft_half.py
// pallas_fft_real_half and, over a window of k1 rows,
// pallas_fft_real_half_rows).
//
// Bound on the H100: bytes (each signal reads L floats and writes
// 2*k1_n*cols; an FFT is ~6 FLOP per byte, below the fp32 balance).
// One block per signal runs the whole transform as radix FFTs
// (fft_radix.cuh) with the complex [m1, m2] intermediate in shared
// memory, so device memory sees each input once and each output once:
//   1A  m1-point column FFTs, pass A, straight from device memory: only
//       the rows = ceil(L/m2) non-zero input rows are read, and when they
//       are at most half (the engine's 2x zero pad) the first layer of
//       each register DFT is pruned;
//   1B  pass B of the column FFTs, then the twiddle W_n^{k1*n2}; only
//       the window's k1 rows are kept;
//   2A, 2B  m2-point row FFTs of the window's rows; only bins
//       k2 < cols are stored.
// The intermediate is 132 KB at n = 16384, so one block (512 threads)
// fills one SM, and the flagship's 128 signals fill one wave of the 132
// SMs.  A k1 window repeats stage 1 whole (a column FFT yields all of
// its k1 rows at once) and runs stage 2 on its rows only.
#include "fft_radix.cuh"

using folve::Plan;
namespace radix = folve::radix;

namespace {

template <int M1, int M2>
__global__ void __launch_bounds__(radix::Shape<M1, M2>::THREADS, 1)
    fft_half_radix_kernel(const float* __restrict__ x, float* __restrict__ yr,
                          float* __restrict__ yi, Plan P, int length,
                          int k1_start, int k1_n) {
  using S = radix::Shape<M1, M2>;
  constexpr int P1 = S::P1, Q1 = S::Q1, P2 = S::P2, Q2 = S::Q2;
  constexpr int LD = S::LD, NT = S::THREADS, COLS = S::COLS;
  extern __shared__ float smem[];
  float2* sm = reinterpret_cast<float2*>(smem);  // [M1][LD] complex
  const int tid = threadIdx.x;
  const long r = blockIdx.x;
  const float* xs = x + r * length;
  // W_m1^j and W_m2^j: row 1 of the DFT factors.
  const float* w1r = P.f1r + M1;
  const float* w1i = P.f1i + M1;
  const float* w2r = P.f2r + M2;
  const float* w2i = P.f2i + M2;

  // 1A: item (b, n2); inputs n1 = Q1*a + b of column n2; row c*Q1 + b.
  {
    constexpr int ITEMS = Q1 * M2, IPT = radix::per_thread<ITEMS, NT>();
    const bool low_half = 2 * length <= M1 * M2;
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (ITEMS % NT != 0 && item >= ITEMS) break;
      const int n2 = item % M2, b = item / M2;
      float re[P1], im[P1];
#pragma unroll
      for (int a = 0; a < P1; ++a) {
        const int i = (Q1 * a + b) * M2 + n2;  // zero padding past length
        re[a] = i < length ? __ldg(xs + i) : 0.f;
        im[a] = 0.f;
      }
      if (low_half)
        radix::dft_low_half<P1, false>(re, im);
      else
        radix::dft<P1, false>(re, im);
#pragma unroll
      for (int c = 0; c < P1; ++c) {
        float vr = re[radix::brev<P1>(c)], vi = im[radix::brev<P1>(c)];
        radix::cmul<false>(vr, vi, __ldg(w1r + b * c), __ldg(w1i + b * c));
        sm[(c * Q1 + b) * LD + n2] = make_float2(vr, vi);
      }
    }
  }
  __syncthreads();

  // 1B: item (c, n2); Q1-point DFTs over b; k1 = c + P1*d, times
  // W_n^{k1*n2}; the window's rows go to rows k1 - k1_start.
  {
    constexpr int ITEMS = P1 * M2, IPT = radix::per_thread<ITEMS, NT>();
    float re[IPT][Q1], im[IPT][Q1];
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (ITEMS % NT != 0 && item >= ITEMS) break;
      const int n2 = item % M2, c = item / M2;
#pragma unroll
      for (int b = 0; b < Q1; ++b)
        radix::sload(sm[(c * Q1 + b) * LD + n2], re[it][b], im[it][b]);
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (ITEMS % NT != 0 && item >= ITEMS) break;
      const int n2 = item % M2, c = item / M2;
      radix::dft<Q1, false>(re[it], im[it]);
#pragma unroll
      for (int d = 0; d < Q1; ++d) {
        const int k1 = c + P1 * d, kk = k1 - k1_start;
        if (kk < 0 || kk >= k1_n) continue;
        float vr = re[it][radix::brev<Q1>(d)], vi = im[it][radix::brev<Q1>(d)];
        radix::cmul<false>(vr, vi, __ldg(P.twr + k1 * M2 + n2),
                           __ldg(P.twi + k1 * M2 + n2));
        sm[kk * LD + n2] = make_float2(vr, vi);
      }
    }
  }
  __syncthreads();

  // 2A: item (kk, b2), kk fastest; inputs n2 = Q2*a + b2 of row kk;
  // output c2 goes to column b2*P2 + c2.
  {
    constexpr int IPT = radix::per_thread<M1 * Q2, NT>();
    const int items = k1_n * Q2;
    float re[IPT][P2], im[IPT][P2];
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (item >= items) break;
      const int kk = item % k1_n, b2 = item / k1_n;
#pragma unroll
      for (int a = 0; a < P2; ++a)
        radix::sload(sm[kk * LD + Q2 * a + b2], re[it][a], im[it][a]);
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (item >= items) break;
      const int kk = item % k1_n, b2 = item / k1_n;
      radix::dft<P2, false>(re[it], im[it]);
#pragma unroll
      for (int c2 = 0; c2 < P2; ++c2) {
        float vr = re[it][radix::brev<P2>(c2)], vi = im[it][radix::brev<P2>(c2)];
        radix::cmul<false>(vr, vi, __ldg(w2r + b2 * c2), __ldg(w2i + b2 * c2));
        sm[kk * LD + b2 * P2 + c2] = make_float2(vr, vi);
      }
    }
  }
  __syncthreads();

  // 2B: item (kk, c2), c2 fastest; Q2-point DFTs over b2; bin
  // k2 = c2 + P2*d2 stored when k2 < cols.
  {
    const int items = k1_n * P2;
    const long K = (long)k1_n * COLS;
    float* outr = yr + r * K;
    float* outi = yi + r * K;
    for (int item = tid; item < items; item += NT) {
      const int c2 = item % P2, kk = item / P2;
      float re[Q2], im[Q2];
#pragma unroll
      for (int b = 0; b < Q2; ++b)
        radix::sload(sm[kk * LD + b * P2 + c2], re[b], im[b]);
      radix::dft<Q2, false>(re, im);
#pragma unroll
      for (int d2 = 0; d2 <= Q2 / 2; ++d2) {
        const int k2 = c2 + P2 * d2;
        if (k2 < COLS) {
          outr[kk * COLS + k2] = re[radix::brev<Q2>(d2)];
          outi[kk * COLS + k2] = im[radix::brev<Q2>(d2)];
        }
      }
    }
  }
}

}  // namespace

// x [R, length] -> yr, yi [R, k1_n*cols]: the k1 rows [k1_start,
// k1_start + k1_n) of the half spectrum (the window (0, m1) is all of it);
// plan: packed plan factors.  n = m1*m2 from 128 to 16384.
extern "C" int folve_fft_real_half_rows(const float* x, float* yr, float* yi,
                                        const float* plan, int R, int length,
                                        int m1, int m2, int k1_start, int k1_n,
                                        void* stream) {
  const Plan P = folve::make_plan(plan, m1, m2);
  return radix::with_sizes(m1, m2, [&](auto sz) {
    using Z = decltype(sz);
    using S = radix::Shape<Z::M1, Z::M2>;
    auto kernel = fft_half_radix_kernel<Z::M1, Z::M2>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)S::SMEM);
    kernel<<<R, S::THREADS, S::SMEM, (cudaStream_t)stream>>>(
        x, yr, yi, P, length, k1_start, k1_n);
    return (int)cudaGetLastError();
  });
}
