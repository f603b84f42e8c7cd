// Frequency-delay-line MAC over (history, new spectra) without a window
// concat (kernel of engine/kernels/fdl_mac.py; replaces folve_tpu
// fdl_mac.py pallas_fdl_mac_split), and the same MAC over a concatenated
// window (replaces pallas_fdl_mac; see fdl_mac_window_kernel below).
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

// The MAC over one concatenated window xall [S, T+P-1, Cin, K]:
//
//   Y[s, t, o] = sum_p sum_i H[s, p, i, o] * Xall[s, t + P-1 - p, i]
//
// the route for a single partition (P = 1: the window is the new spectra
// alone, so no empty history is ever read) and for deep FDLs (min(P, T)
// above 32, e.g. a 1,048,576-tap filter at T = 64).  Same layout as the
// split kernel: one thread per (bin, t, stream), the p, Cin and Cout
// loops in registers; the T re-reads of one bin's H (34 MB per stream at
// P = 128) come from the 50 MB L2.  Offsets are 64-bit.
__global__ void __launch_bounds__(kThreads)
    fdl_mac_window_kernel(const float* __restrict__ h, long h_stride,
                          const float* __restrict__ xr,
                          const float* __restrict__ xi, float* __restrict__ yr,
                          float* __restrict__ yi, int P, int Cin, int Cout,
                          int T, int K) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const int t = blockIdx.y, s = blockIdx.z;
  const float* hs = h + s * h_stride;
  const long x_s = (long)s * (T + P - 1) * Cin * K;
  for (int o = 0; o < Cout; ++o) {
    float ar = 0.f, ai = 0.f;
    for (int p = 0; p < P; ++p) {
      const long w = t + P - 1 - p;
      for (int i = 0; i < Cin; ++i) {
        const long off = x_s + (w * Cin + i) * K + k;
        const float vr = xr[off], vi = xi[off];
        const float* hp = hs + ((long)(p * Cin + i) * Cout + o) * 2 * K + k;
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
// shared); xall [S, T+P-1, Cin, K]; y [S, T, Cout, K].
extern "C" int folve_fdl_mac(const float* h, long h_stride, const float* xr,
                             const float* xi, float* yr, float* yi, int S,
                             int P, int Cin, int Cout, int T, int K,
                             void* stream) {
  const dim3 grid((K + kThreads - 1) / kThreads, T, S);
  fdl_mac_window_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      h, h_stride, xr, xi, yr, yi, P, Cin, Cout, T, K);
  return (int)cudaGetLastError();
}

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
