// Forward real FFT to the permuted half spectrum (kernel of
// engine/kernels/fft_half.py; replaces folve_tpu fft_half.py
// pallas_fft_real_half and, over a window of k1 rows,
// pallas_fft_real_half_rows).
//
// Bound on the H100: bytes (each signal reads L floats and writes
// 2*k1_n*cols; an FFT is ~6 FLOP per byte, below the fp32 balance).
// One block per signal runs the whole transform as radix FFTs
// (radix::forward in fft_radix.cuh, the body the fused step in
// conv_step.cu shares) with the complex [m1, m2] intermediate in shared
// memory, so device memory sees each input once and each output once;
// this kernel stores the window's bins in the canonical order
// kk*cols + k2.  The intermediate is 132 KB at n = 16384, so one block
// (512 threads) fills one SM, and the flagship's 128 signals fill one
// wave of the 132 SMs.  A k1 window repeats stage 1 whole (a column FFT
// yields all of its k1 rows at once) and runs stage 2 on its rows only.
#include "fft_radix.cuh"

using folve::Plan;
namespace radix = folve::radix;

namespace {

template <int M1, int M2>
__global__ void __launch_bounds__(radix::Shape<M1, M2>::THREADS, 1)
    fft_half_radix_kernel(const float* __restrict__ x, float* __restrict__ yr,
                          float* __restrict__ yi, Plan P, int length,
                          int k1_start, int k1_n) {
  constexpr int COLS = radix::Shape<M1, M2>::COLS;
  extern __shared__ float smem[];
  const long r = blockIdx.x;
  radix::forward<M1, M2>(
      reinterpret_cast<float2*>(smem), x + r * length, length, P, k1_start,
      k1_n, [&] {
        const long K = (long)k1_n * COLS;
        float* outr = yr + r * K;
        float* outi = yi + r * K;
        return [=](int kk, int k2, float re, float im) {
          outr[kk * COLS + k2] = re;
          outi[kk * COLS + k2] = im;
        };
      });
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
