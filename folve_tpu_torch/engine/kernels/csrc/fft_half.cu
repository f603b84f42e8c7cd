// Forward real FFT to the permuted half spectrum (kernel of
// engine/kernels/fft_half.py; replaces folve_tpu fft_half.py
// pallas_fft_real_half).
//
// Grid (k1-row tiles, R): output row k1 depends only on row k1 of stage
// 1, so the transform is independent across k1 rows.  A block stages its
// signal's non-zero rows [rows, m2] (32 KB at n = 16384) in shared memory
// once and gives each warp whole k1 rows.
#include "fft_common.cuh"

using folve::Plan;

namespace {

constexpr int kThreads = 256;
constexpr int kRowTile = 32;

__global__ void __launch_bounds__(kThreads)
    fft_real_half_kernel(const float* __restrict__ x, float* __restrict__ yr,
                         float* __restrict__ yi, Plan P, int length,
                         int rows) {
  extern __shared__ float smem[];
  const int m2 = P.m2;
  float* A = smem;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  float* trow = smem + rows * m2 + warp * 2 * m2;
  const long r = blockIdx.y;
  const float* xs = x + r * length;
  for (int i = threadIdx.x; i < rows * m2; i += blockDim.x)
    A[i] = i < length ? xs[i] : 0.f;
  __syncthreads();
  const long K = (long)P.m1 * P.cols;
  float* outr = yr + r * K;
  float* outi = yi + r * K;
  const int k1_end = min((int)(blockIdx.x + 1) * kRowTile, P.m1);
  for (int k1 = blockIdx.x * kRowTile + warp; k1 < k1_end; k1 += nwarps) {
    const int cols = P.cols;
    folve::fwd_row(P, A, rows, k1, trow, [&](int c, float re, float im) {
      outr[k1 * cols + c] = re;
      outi[k1 * cols + c] = im;
    });
  }
}

}  // namespace

// x [R, length] -> yr, yi [R, m1*cols]; plan: packed plan factors.
extern "C" int folve_fft_real_half(const float* x, float* yr, float* yi,
                                   const float* plan, int R, int length,
                                   int m1, int m2, void* stream) {
  const Plan P = folve::make_plan(plan, m1, m2);
  const int rows = min(m1, (length + m2 - 1) / m2);
  const size_t smem = (size_t)(rows * m2 + (kThreads / 32) * 2 * m2) *
                      sizeof(float);
  cudaFuncSetAttribute(fft_real_half_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid((m1 + kRowTile - 1) / kRowTile, R);
  fft_real_half_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, yr, yi, P, length, rows);
  return (int)cudaGetLastError();
}
