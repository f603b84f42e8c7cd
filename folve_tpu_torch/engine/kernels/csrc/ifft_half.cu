// Inverse FFT from the weighted half spectrum over a window of k1 rows,
// with two epilogues: the overlap-add (replaces folve_tpu ifft_half.py
// pallas_ifft_ola) and a plain store of the window's partial inverse
// (replaces pallas_ifft_partial_rows and, over all rows,
// pallas_ifft_from_half).
//
// Bound on the H100: bytes (each signal reads 2*k1_n*cols floats and
// writes n; an FFT is ~6 FLOP per byte, below the fp32 balance).  One
// block per signal runs the inverse as radix FFTs (fft_radix.cuh) with
// the complex [m1, m2] intermediate in shared memory (132 KB at
// n = 16384: one 512-thread block per SM), so device memory sees each
// input once and each output once:
//   0   the window's rows Y[k1, c] * wn[k1, c] (multiplicity / n) into
//       shared memory, coalesced;
//   1'A, 1'B  m2-point inverse row FFTs of the window's rows, with zeros
//       for c >= cols (pass A's register DFTs are pruned to the low half
//       plus the one bin c = m2/2), then the conjugate twiddle;
//   2'A, 2'B  m1-point inverse column FFTs with zeros outside the
//       window's rows, real part only, into the epilogue.
// This is the function of the dense stages of engine/rfft.py over the
// same weighted rectangle and window, so a window gives its shard's
// partial and the partials of windows that tile the m1 rows sum to the
// whole inverse.
//
// The overlap-add epilogue: the TPU kernel carries the overlap tail
// across a sequential t grid; here blocks run in no order, so each block
// adds its head half into y[t] and its tail half into y[t+1] with
// atomicAdd, into an output the wrapper pre-sets to (tail_in, 0, ..., 0).
// Every output sample receives exactly two terms (head of t, tail of
// t-1), and a two-term float sum is the same in either order, so the
// result is deterministic and equal to head + tail.  This keeps all
// S*T*C blocks in flight.
#include "fft_radix.cuh"

using folve::Plan;
namespace radix = folve::radix;

namespace {

// Overlap-add: grid (T*C, S); sample i of the block's inverse goes to
// its head half y[t] or, past n/2, the head of y[t+1] (the new tail at
// the last t).
struct OlaEpilogue {
  float* y;
  float* new_tail;
  int T, C, B;
  struct At {
    float* head;
    float* next;
    float* tail;
    int B;
    __device__ void operator()(int i, float v) const {
      if (i < B)
        atomicAdd(head + i, v);
      else if (next != nullptr)
        atomicAdd(next + i - B, v);
      else
        tail[i - B] = v;
    }
  };
  __device__ long row() const {
    return ((long)blockIdx.y * T + blockIdx.x / C) * C + blockIdx.x % C;
  }
  __device__ At at(long row) const {
    const int c = blockIdx.x % C, t = blockIdx.x / C;
    return {y + row * B, t + 1 < T ? y + (row + C) * B : nullptr,
            new_tail + ((long)blockIdx.y * C + c) * B, B};
  }
};

// Row window: grid (R); the block's partial inverse, all n samples.
struct RowsEpilogue {
  float* out;
  int n;
  struct At {
    float* o;
    __device__ void operator()(int i, float v) const { o[i] = v; }
  };
  __device__ long row() const { return blockIdx.x; }
  __device__ At at(long row) const { return {out + row * n}; }
};

template <int M1, int M2, class Epilogue>
__global__ void __launch_bounds__(radix::Shape<M1, M2>::THREADS, 1)
    ifft_half_radix_kernel(const float* __restrict__ yr,
                           const float* __restrict__ yi, Plan P, int k1_start,
                           int k1_n, Epilogue epi) {
  using S = radix::Shape<M1, M2>;
  constexpr int P1 = S::P1, Q1 = S::Q1, P2 = S::P2, Q2 = S::Q2;
  constexpr int LD = S::LD, NT = S::THREADS, COLS = S::COLS;
  extern __shared__ float smem[];
  float2* sm = reinterpret_cast<float2*>(smem);  // [M1][LD] complex
  const int tid = threadIdx.x;
  const long row = epi.row();
  const long K = (long)k1_n * COLS;
  const float* ar = yr + row * K;
  const float* ai = yi + row * K;
  const float* w1r = P.f1r + M1;
  const float* w1i = P.f1i + M1;
  const float* w2r = P.f2r + M2;
  const float* w2i = P.f2i + M2;

  // 0: weighted window rows, row kk at kk*LD, columns c < cols.
  for (int i = tid; i < K; i += NT) {
    const int kk = i / COLS, c = i - kk * COLS;
    const float w = __ldg(P.wn + k1_start * COLS + i);
    sm[kk * LD + c] = make_float2(ar[i] * w, ai[i] * w);
  }
  __syncthreads();

  // 1'A: item (kk, b), kk fastest; inputs c = Q2*a + b, non-zero for
  // a < P2/2 and, at b = 0, a = P2/2 (bin m2/2, added as (-1)^c2 times
  // its value); output c2 goes to column b*P2 + c2, times W_m2^{-b*c2}.
  {
    constexpr int IPT = radix::per_thread<M1 * Q2, NT>();
    const int items = k1_n * Q2;
    float re[IPT][P2], im[IPT][P2], er[IPT], ei[IPT];
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (item >= items) break;
      const int kk = item % k1_n, b = item / k1_n;
#pragma unroll
      for (int a = 0; a < P2 / 2; ++a)
        radix::sload(sm[kk * LD + Q2 * a + b], re[it][a], im[it][a]);
      er[it] = ei[it] = 0.f;
      if (b == 0) radix::sload(sm[kk * LD + M2 / 2], er[it], ei[it]);
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (item >= items) break;
      const int kk = item % k1_n, b = item / k1_n;
      radix::dft_low_half<P2, true>(re[it], im[it]);
#pragma unroll
      for (int c2 = 0; c2 < P2; ++c2) {
        const float sgn = (c2 & 1) ? -1.f : 1.f;
        float vr = re[it][radix::brev<P2>(c2)] + sgn * er[it];
        float vi = im[it][radix::brev<P2>(c2)] + sgn * ei[it];
        radix::cmul<true>(vr, vi, __ldg(w2r + b * c2), __ldg(w2i + b * c2));
        sm[kk * LD + b * P2 + c2] = make_float2(vr, vi);
      }
    }
  }
  __syncthreads();

  // 1'B: item (kk, c2), c2 fastest; Q2-point inverse DFTs over b;
  // n2 = c2 + P2*d, times conj(W_n^{k1*n2}); V[kk][n2] in place.
  {
    constexpr int IPT = radix::per_thread<M1 * P2, NT>();
    const int items = k1_n * P2;
    float re[IPT][Q2], im[IPT][Q2];
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (item >= items) break;
      const int c2 = item % P2, kk = item / P2;
#pragma unroll
      for (int b = 0; b < Q2; ++b)
        radix::sload(sm[kk * LD + b * P2 + c2], re[it][b], im[it][b]);
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (item >= items) break;
      const int c2 = item % P2, kk = item / P2, k1 = k1_start + kk;
      radix::dft<Q2, true>(re[it], im[it]);
#pragma unroll
      for (int d = 0; d < Q2; ++d) {
        const int n2 = c2 + P2 * d;
        float vr = re[it][radix::brev<Q2>(d)], vi = im[it][radix::brev<Q2>(d)];
        radix::cmul<true>(vr, vi, __ldg(P.twr + k1 * M2 + n2),
                          __ldg(P.twi + k1 * M2 + n2));
        sm[kk * LD + n2] = make_float2(vr, vi);
      }
    }
  }
  __syncthreads();

  // 2'A: item (b, n2), n2 fastest; inputs k1 = Q1*a + b of column n2,
  // zero outside the window; output c goes to row c*Q1 + b, times
  // W_m1^{-b*c}.
  {
    constexpr int ITEMS = Q1 * M2, IPT = radix::per_thread<ITEMS, NT>();
    float re[IPT][P1], im[IPT][P1];
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (ITEMS % NT != 0 && item >= ITEMS) break;
      const int n2 = item % M2, b = item / M2;
#pragma unroll
      for (int a = 0; a < P1; ++a) {
        const int kk = Q1 * a + b - k1_start;
        re[it][a] = im[it][a] = 0.f;
        if (kk >= 0 && kk < k1_n)
          radix::sload(sm[kk * LD + n2], re[it][a], im[it][a]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (ITEMS % NT != 0 && item >= ITEMS) break;
      const int n2 = item % M2, b = item / M2;
      radix::dft<P1, true>(re[it], im[it]);
#pragma unroll
      for (int c = 0; c < P1; ++c) {
        float vr = re[it][radix::brev<P1>(c)], vi = im[it][radix::brev<P1>(c)];
        radix::cmul<true>(vr, vi, __ldg(w1r + b * c), __ldg(w1i + b * c));
        sm[(c * Q1 + b) * LD + n2] = make_float2(vr, vi);
      }
    }
  }
  __syncthreads();

  // 2'B: item (c, n2), n2 fastest; Q1-point inverse DFTs over b; the
  // real part of sample (c + P1*d)*m2 + n2 goes to the epilogue.
  {
    constexpr int ITEMS = P1 * M2;
    const auto store = epi.at(row);
    for (int item = tid; item < ITEMS; item += NT) {
      const int n2 = item % M2, c = item / M2;
      float re[Q1], im[Q1];
#pragma unroll
      for (int b = 0; b < Q1; ++b)
        radix::sload(sm[(c * Q1 + b) * LD + n2], re[b], im[b]);
      radix::dft<Q1, true>(re, im);
#pragma unroll
      for (int d = 0; d < Q1; ++d)
        store((c + P1 * d) * M2 + n2, re[radix::brev<Q1>(d)]);
    }
  }
}

template <class Epilogue>
int launch(const float* yr, const float* yi, const float* plan, int m1,
           int m2, int k1_start, int k1_n, Epilogue epi, dim3 grid,
           void* stream) {
  const Plan P = folve::make_plan(plan, m1, m2);
  return radix::with_sizes(m1, m2, [&](auto sz) {
    using Z = decltype(sz);
    using S = radix::Shape<Z::M1, Z::M2>;
    auto kernel = ifft_half_radix_kernel<Z::M1, Z::M2, Epilogue>;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)S::SMEM);
    kernel<<<grid, S::THREADS, S::SMEM, (cudaStream_t)stream>>>(
        yr, yi, P, k1_start, k1_n, epi);
    return (int)cudaGetLastError();
  });
}

}  // namespace

// yr, yi [R, k1_n*cols] (unweighted half-spectrum rows [k1_start,
// k1_start + k1_n)) -> out [R, n]: this window's partial inverse; the
// window (0, m1) gives the whole inverse.  n = m1*m2 from 128 to 16384.
extern "C" int folve_ifft_partial_rows(const float* yr, const float* yi,
                                       float* out, const float* plan, int R,
                                       int m1, int m2, int k1_start, int k1_n,
                                       void* stream) {
  return launch(yr, yi, plan, m1, m2, k1_start, k1_n,
                RowsEpilogue{out, m1 * m2}, dim3(R), stream);
}

// yr, yi [S, T, C, m1*cols] (unweighted half spectra); y [S, T, C, n/2]
// pre-set to tail_in at t = 0 and zero elsewhere; new_tail [S, C, n/2].
extern "C" int folve_ifft_ola(const float* yr, const float* yi, float* y,
                              float* new_tail, const float* plan, int S, int T,
                              int C, int m1, int m2, void* stream) {
  return launch(yr, yi, plan, m1, m2, 0, m1,
                OlaEpilogue{y, new_tail, T, C, m1 * m2 / 2}, dim3(T * C, S),
                stream);
}
