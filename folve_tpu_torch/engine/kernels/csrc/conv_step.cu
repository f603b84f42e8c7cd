// Fused convolution step: forward FFT -> FDL MAC -> inverse + overlap-add
// + clipping max in one kernel (kernel of engine/kernels/conv_step.py;
// replaces folve_tpu conv_step.py _kernel behind pallas_conv_step_fused
// and pallas_conv_step_fused_pre).
//
// The TPU kernel keeps the filter spectra H and the ring of the last P-1
// block spectra resident in VMEM.  At the flagship shape H is 4.3 MB and
// the ring 2.0 MB per stream: far beyond the 227 KB of shared memory a
// block can have.  So:
//  * one block per stream loops over the chunk's T blocks in order (the
//    ring and the overlap tail carry from block t to t+1);
//  * the ring, the current block's spectra and the MAC result live in
//    device-memory scratch given by the wrapper (16 MB of ring at S = 8,
//    which stays in the 50 MB L2), and H is read from device memory;
//  * shared memory holds the FFT working set: the input block [rows, m2]
//    and the inverse's V = [m1, m2] complex (176 KB at n = 16384).
// Only S blocks run, on S of 132 SMs: this first design is right and
// simple, not fast.
//
// Layouts.  Spectra inside the kernel (ring, h_perm, MAC result) use the
// transposed-tile flatten kk = c*m1 + q of the JAX fused kernel, so
// h_perm and a hist_t carry are read as they are; a canonical hist
// (hist_t = 0, bin q*cols + c) is re-indexed on import and export.
// hist_in/hist_out are separate buffers (the TPU kernel aliases them;
// across independent blocks in place would be a race).
//
// Ring slots: slot b mod (P-1) holds block b's spectra.  At t = 0 old
// block -p sits in slot P-1-p = its hist row.  Block t reads slot
// (t - p + P-1) mod (P-1) for partition p >= 1 and then overwrites slot
// t mod (P-1), which only partition P-1 of the same bin read: the thread
// that owns a bin does both, so no barrier separates them.
#include "fft_common.cuh"

using folve::Plan;

namespace {

constexpr int kThreads = folve::kBlockThreads;

__device__ __forceinline__ int canon_bin(int kk, int m1, int cols) {
  const int c = kk / m1, q = kk - c * m1;
  return q * cols + c;
}

struct Args {
  const float* h;         // [P, Cin, Cout, 2, K] transposed bins
  const float* x;         // [S, T, Cin, B]
  const float* hist_re;   // [S, P-1, Cin, K]
  const float* hist_im;
  const float* tail_in;   // [S, Cout, B]
  const int* valid;       // [S, T]
  float* y;               // [S, T, Cout, B]
  float* hist_re_out;     // [S, P-1, Cin, K]
  float* hist_im_out;
  float* tail_out;        // [S, Cout, B]
  float* max_out;         // [S]
  float* ring;            // scratch [S, P-1, Cin, 2, K]
  float* cur;             // scratch [S, Cin, 2, K]
  float* acc;             // scratch [S, Cout, 2, K]
  int P, Cin, Cout, T, hist_t;
};

__global__ void __launch_bounds__(kThreads, 1)
    conv_step_kernel(Args a, Plan P) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads / 32];
  const int m1 = P.m1, m2 = P.m2, cols = P.cols;
  const int K = m1 * cols, half = m1 / 2, rows = m1 / 2, B = half * m2;
  const int pm1 = a.P - 1, Cin = a.Cin, Cout = a.Cout, T = a.T;
  const int tid = threadIdx.x, warp = tid >> 5, nwarps = kThreads / 32;
  float* A = smem;
  float* Vr = A + rows * m2;
  float* Vi = Vr + m1 * m2;
  float* trow = Vi + m1 * m2 + warp * 2 * m2;
  const int s = blockIdx.x;

  const long hist_s = (long)s * pm1 * Cin * K;
  const float* hin_r = a.hist_re + hist_s;
  const float* hin_i = a.hist_im + hist_s;
  float* hout_r = a.hist_re_out + hist_s;
  float* hout_i = a.hist_im_out + hist_s;
  float* ring = a.ring + (long)s * pm1 * Cin * 2 * K;
  float* cur = a.cur + (long)s * Cin * 2 * K;
  float* accb = a.acc + (long)s * Cout * 2 * K;
  float* tail = a.tail_out + (long)s * Cout * B;

  // --- import: ring from hist, tail, and the T < P-1 hist shift -------
  for (long idx = tid; idx < (long)pm1 * Cin * K; idx += kThreads) {
    const int kk = (int)(idx % K);
    const long row = idx / K;
    const long src = row * K + (a.hist_t ? kk : canon_bin(kk, m1, cols));
    ring[row * 2 * K + kk] = hin_r[src];
    ring[(row * 2 + 1) * K + kk] = hin_i[src];
  }
  for (int idx = tid; idx < Cout * B; idx += kThreads)
    tail[idx] = a.tail_in[(long)s * Cout * B + idx];
  // Hist rows that outlive the whole chunk move from row T+j to row j.
  const int nshift = max(0, pm1 - T);
  for (long idx = tid; idx < (long)nshift * Cin * K; idx += kThreads) {
    hout_r[idx] = hin_r[(long)T * Cin * K + idx];
    hout_i[idx] = hin_i[(long)T * Cin * K + idx];
  }
  const int first_exported = max(0, T - pm1);
  float mx = 0.f;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // --- forward FFT of each input channel -> cur -------------------
    for (int i = 0; i < Cin; ++i) {
      const float* xb = a.x + (((long)s * T + t) * Cin + i) * B;
      for (int idx = tid; idx < B; idx += kThreads) A[idx] = xb[idx];
      __syncthreads();
      float* cr = cur + (long)i * 2 * K;
      float* ci = cr + K;
      for (int k1 = warp; k1 < m1; k1 += nwarps) {
        folve::fwd_row(P, A, rows, k1, trow, [&](int c, float re, float im) {
          cr[c * m1 + k1] = re;
          ci[c * m1 + k1] = im;
        });
      }
      __syncthreads();
    }

    // --- FDL MAC (weighted for the inverse), ring update, export ------
    const bool exporting = t >= first_exported;
    const int j_out = T >= pm1 ? t - first_exported : t + (pm1 - T);
    const int slot_w = t % pm1;
    for (int kk = tid; kk < K; kk += kThreads) {
      const int cb = canon_bin(kk, m1, cols);
      const float w = __ldg(P.wn + cb);
      for (int o = 0; o < Cout; ++o) {
        float ar = 0.f, ai = 0.f;
        for (int p = 0; p < a.P; ++p) {
          const float* src =
              p == 0 ? cur : ring + (long)((t - p + pm1) % pm1) * Cin * 2 * K;
          for (int i = 0; i < Cin; ++i) {
            const float xr = src[(long)i * 2 * K + kk];
            const float xi = src[((long)i * 2 + 1) * K + kk];
            const float* hp =
                a.h + (long)((p * Cin + i) * Cout + o) * 2 * K + kk;
            const float hr = __ldg(hp), hi = __ldg(hp + K);
            ar += xr * hr - xi * hi;
            ai += xr * hi + xi * hr;
          }
        }
        accb[(long)o * 2 * K + kk] = ar * w;
        accb[((long)o * 2 + 1) * K + kk] = ai * w;
      }
      for (int i = 0; i < Cin; ++i) {
        const float xr = cur[(long)i * 2 * K + kk];
        const float xi = cur[((long)i * 2 + 1) * K + kk];
        ring[((long)slot_w * Cin + i) * 2 * K + kk] = xr;
        ring[(((long)slot_w * Cin + i) * 2 + 1) * K + kk] = xi;
        if (exporting) {
          const long dst = ((long)j_out * Cin + i) * K + (a.hist_t ? kk : cb);
          hout_r[dst] = xr;
          hout_i[dst] = xi;
        }
      }
    }
    __syncthreads();

    // --- inverse FFT + overlap-add + masked max|y| --------------------
    const int vb = a.valid[(long)s * T + t];
    const int b = tid % m2, g = tid / m2, G = kThreads / m2;
    for (int o = 0; o < Cout; ++o) {
      const float* yw_r = accb + (long)o * 2 * K;
      const float* yw_i = yw_r + K;
      for (int k1 = warp; k1 < m1; k1 += nwarps) {
        folve::inv_row(
            P, k1, trow,
            [&](int c, float& re, float& im) {
              re = yw_r[c * m1 + k1];
              im = yw_i[c * m1 + k1];
            },
            Vr, Vi);
      }
      __syncthreads();
      float accv[folve::kMaxJ];
      folve::inv_stage2(P, Vr, Vi, accv);
      float* yo = a.y + (((long)s * T + t) * Cout + o) * B;
      float* to = tail + (long)o * B;
#pragma unroll
      for (int j = 0; j < folve::kMaxJ; ++j) {
        const int n1 = g + j * G;
        if (n1 < half) {
          const int idx = n1 * m2 + b;
          const float v = accv[j] + to[idx];
          yo[idx] = v;
          if (idx < vb) mx = fmaxf(mx, fabsf(v));
        }
      }
      __syncthreads();  // every head has read the old tail
#pragma unroll
      for (int j = 0; j < folve::kMaxJ; ++j) {
        const int n1 = g + j * G;
        if (n1 >= half && n1 < m1) to[(n1 - half) * m2 + b] = accv[j];
      }
      __syncthreads();
    }
  }

  // --- per-stream clipping max ----------------------------------------
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, off));
  if ((tid & 31) == 0) red[warp] = mx;
  __syncthreads();
  if (tid == 0) {
    float m = 0.f;
    for (int w = 0; w < nwarps; ++w) m = fmaxf(m, red[w]);
    a.max_out[s] = m;
  }
}

}  // namespace

extern "C" int folve_conv_step(
    const float* h, const float* x, const float* hist_re,
    const float* hist_im, const float* tail_in, const int* valid, float* y,
    float* hist_re_out, float* hist_im_out, float* tail_out, float* max_out,
    float* ring, float* cur, float* acc, const float* plan, int S, int P,
    int Cin, int Cout, int T, int m1, int m2, int hist_t, void* stream) {
  const Plan pl = folve::make_plan(plan, m1, m2);
  const Args a{h,           x,        hist_re,  hist_im, tail_in, valid,
               y,           hist_re_out, hist_im_out, tail_out, max_out,
               ring,        cur,      acc,      P,       Cin,     Cout,
               T,           hist_t};
  const size_t smem = (size_t)((m1 / 2) * m2 + 2 * m1 * m2 +
                               (kThreads / 32) * 2 * m2) *
                      sizeof(float);
  cudaFuncSetAttribute(conv_step_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  conv_step_kernel<<<S, kThreads, smem, (cudaStream_t)stream>>>(a, pl);
  return (int)cudaGetLastError();
}
