// Frequency-delay-line MAC over (history, new spectra) without a window
// concat (kernel of engine/kernels/fdl_mac.py; replaces folve_tpu
// fdl_mac.py pallas_fdl_mac_split).
//
//   Y[s, t, o] = sum_p sum_i H[s, p, i, o] * W[s, t + P-1 - p, i]
//
// where window row w reads hist[w] for w < P-1 and x[w - (P-1)] after.
// Elementwise in bins and memory-bound: one thread per (bin, t, stream),
// neighbouring threads on neighbouring bins so every load is coalesced;
// the p, Cin and Cout loops run in registers.  H is read by the T
// threads of one bin; those reads after the first hit L2.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    fdl_mac_split_kernel(const float* __restrict__ h, long h_stride,
                         const float* __restrict__ hist_re,
                         const float* __restrict__ hist_im,
                         const float* __restrict__ xr,
                         const float* __restrict__ xi, float* __restrict__ yr,
                         float* __restrict__ yi, int P, int Cin, int Cout,
                         int T, int K) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const int t = blockIdx.y, s = blockIdx.z;
  const float* hs = h + s * h_stride;
  const long hist_s = (long)s * (P - 1) * Cin * K;
  const long x_s = (long)s * T * Cin * K;
  for (int o = 0; o < Cout; ++o) {
    float ar = 0.f, ai = 0.f;
    for (int p = 0; p < P; ++p) {
      const int w = t + P - 1 - p;
      for (int i = 0; i < Cin; ++i) {
        float vr, vi;
        if (w < P - 1) {
          const long off = hist_s + ((long)w * Cin + i) * K + k;
          vr = hist_re[off];
          vi = hist_im[off];
        } else {
          const long off = x_s + ((long)(w - (P - 1)) * Cin + i) * K + k;
          vr = xr[off];
          vi = xi[off];
        }
        const float* hp = hs + (long)((p * Cin + i) * Cout + o) * 2 * K + k;
        const float hr = hp[0], hi = hp[K];
        ar += vr * hr - vi * hi;
        ai += vr * hi + vi * hr;
      }
    }
    const long yo = (((long)s * T + t) * Cout + o) * K + k;
    yr[yo] = ar;
    yi[yo] = ai;
  }
}

}  // namespace

// h [S or 1, P, Cin, Cout, 2, K] (h_stride = elements per stream, 0 when
// shared); hist [S, P-1, Cin, K]; x [S, T, Cin, K]; y [S, T, Cout, K].
extern "C" int folve_fdl_mac_split(const float* h, long h_stride,
                                   const float* hist_re, const float* hist_im,
                                   const float* xr, const float* xi,
                                   float* yr, float* yi, int S, int P,
                                   int Cin, int Cout, int T, int K,
                                   void* stream) {
  const dim3 grid((K + kThreads - 1) / kThreads, T, S);
  fdl_mac_split_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      h, h_stride, hist_re, hist_im, xr, xi, yr, yi, P, Cin, Cout, T, K);
  return (int)cudaGetLastError();
}
