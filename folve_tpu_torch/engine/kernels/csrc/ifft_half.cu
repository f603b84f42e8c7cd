// Inverse FFT from the weighted half spectrum plus overlap-add (kernel of
// engine/kernels/ifft_half.py; replaces folve_tpu ifft_half.py
// pallas_ifft_ola), and the plain inverse over a window of k1 rows
// (replaces pallas_ifft_partial_rows and, over all rows,
// pallas_ifft_from_half); see ifft_rows_kernel below.
//
// One block per (stream, block t, channel): stage 2 contracts every k1
// row, so a block holds the whole V = [m1, m2] complex intermediate in
// shared memory (128 KB at n = 16384).  The TPU kernel carries the
// overlap tail across a sequential t grid; here blocks run in no order,
// so each block adds its head half into y[t] and its tail half into
// y[t+1] with atomicAdd, into an output the wrapper pre-sets to
// (tail_in, 0, ..., 0).  Every output sample receives exactly two terms
// (head of t, tail of t-1), and a two-term float sum is the same in
// either order, so the result is deterministic and equal to head + tail.
// This keeps all S*T*C blocks in flight, where a t-loop inside one block
// per channel would leave most of the 132 SMs idle.
#include "fft_common.cuh"

using folve::Plan;

namespace {

constexpr int kThreads = folve::kBlockThreads;

__global__ void __launch_bounds__(kThreads, 1)
    ifft_ola_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                    float* __restrict__ y, float* __restrict__ new_tail, Plan P,
                    int T, int C) {
  extern __shared__ float smem[];
  const int m1 = P.m1, m2 = P.m2, cols = P.cols;
  float* Vr = smem;
  float* Vi = Vr + m1 * m2;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  float* trow = Vi + m1 * m2 + warp * 2 * m2;
  const int c = blockIdx.x % C, t = blockIdx.x / C, s = blockIdx.y;
  const long K = (long)m1 * cols, B = (long)m1 * m2 / 2;
  const long row = ((long)s * T + t) * C + c;
  const float* ar = yr + row * K;
  const float* ai = yi + row * K;
  for (int k1 = warp; k1 < m1; k1 += nwarps) {
    folve::inv_row(
        P, k1, trow,
        [&](int cc, float& re, float& im) {
          const float w = __ldg(P.wn + k1 * cols + cc);
          re = ar[k1 * cols + cc] * w;
          im = ai[k1 * cols + cc] * w;
        },
        Vr, Vi);
  }
  __syncthreads();
  float acc[folve::kMaxJ];
  folve::inv_stage2(P, Vr, Vi, acc);
  const int b = threadIdx.x % m2, g = threadIdx.x / m2, G = kThreads / m2;
  const int half = m1 / 2;
  float* head = y + row * B;
  float* next = t + 1 < T ? y + (row + C) * B : nullptr;
  float* tail_out = new_tail + ((long)s * C + c) * B;
#pragma unroll
  for (int j = 0; j < folve::kMaxJ; ++j) {
    const int n1 = g + j * G;
    if (n1 >= m1) continue;
    const long idx = (long)n1 * m2 + b;
    if (n1 < half)
      atomicAdd(head + idx, acc[j]);
    else if (next != nullptr)
      atomicAdd(next + idx - B, acc[j]);
    else
      tail_out[idx - B] = acc[j];
  }
}

// One block per signal: the inverse from the k1 rows [k1_start, k1_start +
// k1_n) of the weighted half spectrum, without overlap-add.  Stage 1 and
// the twiddle run only for the window's rows (written into their own rows
// of the shared V [m1, m2]), and stage 2 contracts over those rows alone,
// so the output [m1, m2] = all n samples is this window's partial sum: a
// frequency shard's share, which the caller adds to the other shards'
// (the TPU path's psum).  The window (0, m1) is the whole inverse.
__global__ void __launch_bounds__(kThreads, 1)
    ifft_rows_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                     float* __restrict__ out, Plan P, int k1_start, int k1_n) {
  extern __shared__ float smem[];
  const int m1 = P.m1, m2 = P.m2, cols = P.cols;
  float* Vr = smem;
  float* Vi = Vr + m1 * m2;
  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  float* trow = Vi + m1 * m2 + warp * 2 * m2;
  const long row = blockIdx.x;
  const long K = (long)k1_n * cols;
  const float* ar = yr + row * K;
  const float* ai = yi + row * K;
  for (int kk = warp; kk < k1_n; kk += nwarps) {
    const int k1 = k1_start + kk;
    folve::inv_row(
        P, k1, trow,
        [&](int cc, float& re, float& im) {
          const float w = __ldg(P.wn + k1 * cols + cc);
          re = ar[kk * cols + cc] * w;
          im = ai[kk * cols + cc] * w;
        },
        Vr, Vi);
  }
  __syncthreads();
  float acc[folve::kMaxJ];
  folve::inv_stage2_rows(P, Vr, Vi, k1_start, k1_start + k1_n, acc);
  const int b = threadIdx.x % m2, g = threadIdx.x / m2, G = kThreads / m2;
  float* o = out + row * ((long)m1 * m2);
#pragma unroll
  for (int j = 0; j < folve::kMaxJ; ++j) {
    const int n1 = g + j * G;
    if (n1 < m1) o[(long)n1 * m2 + b] = acc[j];
  }
}

}  // namespace

// yr, yi [R, k1_n*cols] (unweighted half-spectrum rows [k1_start,
// k1_start + k1_n)) -> out [R, n]: this window's partial inverse; the
// window (0, m1) gives the whole inverse.
extern "C" int folve_ifft_partial_rows(const float* yr, const float* yi,
                                       float* out, const float* plan, int R,
                                       int m1, int m2, int k1_start, int k1_n,
                                       void* stream) {
  const Plan P = folve::make_plan(plan, m1, m2);
  const size_t smem =
      (size_t)(2 * m1 * m2 + (kThreads / 32) * 2 * m2) * sizeof(float);
  cudaFuncSetAttribute(ifft_rows_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  ifft_rows_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(
      yr, yi, out, P, k1_start, k1_n);
  return (int)cudaGetLastError();
}

// yr, yi [S, T, C, m1*cols] (unweighted half spectra); y [S, T, C, n/2]
// pre-set to tail_in at t = 0 and zero elsewhere; new_tail [S, C, n/2].
extern "C" int folve_ifft_ola(const float* yr, const float* yi, float* y,
                              float* new_tail, const float* plan, int S, int T,
                              int C, int m1, int m2, void* stream) {
  const Plan P = folve::make_plan(plan, m1, m2);
  const size_t smem =
      (size_t)(2 * m1 * m2 + (kThreads / 32) * 2 * m2) * sizeof(float);
  cudaFuncSetAttribute(ifft_ola_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  const dim3 grid(T * C, S);
  ifft_ola_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      yr, yi, y, new_tail, P, T, C);
  return (int)cudaGetLastError();
}
