// Radix FFTs in shared memory and registers: the bodies of the forward
// (fft_half.cu), inverse (ifft_half.cu) and fused (conv_step.cu) kernels.
//
// Both transforms keep the four-step factorisation n = m1*m2 of
// engine/rfft.py (input index m2*n1 + n2, output bin k1 + m1*k2: the
// permuted [k1, k2] layout) and run each of its two stages as m-point
// FFTs, m in {m1, m2}.  An m-point FFT is split once more, m = p*q with
// p, q <= 16 (split_p): with input index q*a + b and output index
// c + p*d,
//   X[c + p*d] = sum_b W_q^{b d} * (W_m^{b c} * sum_a x[q*a + b] W_p^{a c}),
// so pass A runs a p-point DFT in registers for each residue b and
// multiplies by W_m^{b c}, and pass B, after an exchange through shared
// memory, runs a q-point DFT for each c.  A register DFT is a radix-2
// decimation-in-frequency network, fully unrolled, whose constants
// W_16^k are float literals (no __sinf/__cosf).  Every other twiddle is
// read from the packed plan: W_m^j is row 1 of the DFT factor f1 or f2,
// and W_n^{k1*n2} is the table tw; the host computes both in float64
// and rounds them once to fp32.  All arithmetic is fp32 on the CUDA
// cores.
#pragma once

#include <cuda_runtime.h>

#include "fft_common.cuh"

namespace folve {
namespace radix {

// p of the m = p*q split (p >= q, both <= 16); m in {8, ..., 128}.
__host__ __device__ constexpr int split_p(int m) {
  return m >= 128 ? 16 : m >= 32 ? 8 : 4;
}

// cos(2*pi*k/16), k taken mod 16.
__host__ __device__ constexpr float cos16(int k) {
  constexpr float c1 = 0.92387953251128674f;  // cos(pi/8)
  constexpr float c2 = 0.70710678118654752f;  // cos(pi/4)
  constexpr float c3 = 0.38268343236508977f;  // cos(3*pi/8)
  k &= 15;
  return k == 0 ? 1.f : k == 1 ? c1 : k == 2 ? c2 : k == 3 ? c3
       : k == 4 ? 0.f : k == 5 ? -c3 : k == 6 ? -c2 : k == 7 ? -c1
       : k == 8 ? -1.f : k == 9 ? -c1 : k == 10 ? -c2 : k == 11 ? -c3
       : k == 12 ? 0.f : k == 13 ? c3 : k == 14 ? c2 : c1;
}

// sin(2*pi*k/16) = cos(2*pi*(k - 4)/16).
__host__ __device__ constexpr float sin16(int k) { return cos16(k + 12); }

// Bit reversal of k in log2(P) bits.
template <int P>
__host__ __device__ constexpr int brev(int k) {
  int r = 0;
  for (int m = 1; m < P; m <<= 1) {
    r = (r << 1) | (k & 1);
    k >>= 1;
  }
  return r;
}

// (re, im) *= W_16^k, W = exp(-2*pi*i/16), or its conjugate (Inv).
template <bool Inv>
__device__ __forceinline__ void rot16(float& re, float& im, int k) {
  k &= 15;
  if (k == 0) return;
  if (k == 8) {
    re = -re;
    im = -im;
    return;
  }
  const float c = cos16(k), s = Inv ? sin16(k) : -sin16(k);
  if (k == 4 || k == 12) {  // c = 0, s = +-1
    const float r = -im * s;
    im = re * s;
    re = r;
    return;
  }
  const float r = re * c - im * s;
  im = fmaf(re, s, im * c);
  re = r;
}

// A complex value of a shared [row][LD] float2 plane: one 64-bit access.
__device__ __forceinline__ void sload(const float2& v, float& re, float& im) {
  re = v.x;
  im = v.y;
}

// (re, im) *= (wr + i*wi), or by its conjugate (Inv).
template <bool Inv>
__device__ __forceinline__ void cmul(float& re, float& im, float wr, float wi) {
  if (Inv) wi = -wi;
  const float r = re * wr - im * wi;
  im = fmaf(re, wi, im * wr);
  re = r;
}

// Radix-2 decimation-in-frequency layers of span LEN, LEN/2, ..., 2 over
// P points in registers (LEN = P: the whole P-point DFT).  Output k
// lands at index brev<P>(k).
template <int P, int LEN, bool Inv>
__device__ __forceinline__ void dif(float (&re)[P], float (&im)[P]) {
  if constexpr (LEN >= 2) {
    constexpr int H = LEN / 2;
#pragma unroll
    for (int s = 0; s < P; s += LEN) {
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const float ar = re[s + j], ai = im[s + j];
        const float br = re[s + j + H], bi = im[s + j + H];
        re[s + j] = ar + br;
        im[s + j] = ai + bi;
        re[s + j + H] = ar - br;
        im[s + j + H] = ai - bi;
        rot16<Inv>(re[s + j + H], im[s + j + H], j * (16 / LEN));
      }
    }
    dif<P, H, Inv>(re, im);
  }
}

// P-point DFT in registers, output k at index brev<P>(k).
template <int P, bool Inv>
__device__ __forceinline__ void dft(float (&re)[P], float (&im)[P]) {
  dif<P, P, Inv>(re, im);
}

// P-point DFT of inputs whose upper half (indices >= P/2) is zero: the
// first layer needs no additions, only the twiddle.
template <int P, bool Inv>
__device__ __forceinline__ void dft_low_half(float (&re)[P], float (&im)[P]) {
#pragma unroll
  for (int j = 0; j < P / 2; ++j) {
    re[j + P / 2] = re[j];
    im[j + P / 2] = im[j];
    rot16<Inv>(re[j + P / 2], im[j + P / 2], j * (16 / P));
  }
  dif<P, P / 2, Inv>(re, im);
}

// Compile-time shape of one transform size, shared by both kernels.
template <int M1_, int M2_>
struct Shape {
  static constexpr int M1 = M1_, M2 = M2_, N = M1 * M2;
  static constexpr int P1 = split_p(M1), Q1 = M1 / P1;
  static constexpr int P2 = split_p(M2), Q2 = M2 / P2;
  static constexpr int COLS = M2 / 2 + 1;
  // Row stride of the shared [m1][LD] complex (float2) intermediate.
  // Odd, so the 16 lanes of a half-warp on 16 rows hit 16 distinct 8-byte
  // bank pairs; lanes on one row are conflict-free at any stride.
  static constexpr int LD = M2 + 1;
  static constexpr int THREADS =
      N >= 16384 ? 512 : N >= 8192 ? 256 : N >= 4096 ? 128 : 64;
  static constexpr size_t SMEM = (size_t)M1 * LD * sizeof(float2);
};

// Work items a thread takes in a pass of `items` items.
template <int ITEMS, int THREADS>
__host__ __device__ constexpr int per_thread() {
  return (ITEMS + THREADS - 1) / THREADS;
}

// Forward real FFT of one signal, run by a whole block of
// Shape<M1, M2>::THREADS threads: xs[0, length) zero padded to n = M1*M2
// (read straight from device memory), `sm` the block's [M1][LD] float2
// intermediate (Shape::SMEM bytes).  Bin (k1, k2) of the window's rows,
// k1 = k1_start + kk for kk < k1_n, k2 < COLS, goes to
// store(kk, k2, re, im), store = make_store() made at pass 2B (so the
// caller's output pointers are not held live through the passes before),
// called by the one thread that last read sm[kk * LD + k2], so it may
// write the value back there.
//   1A  m1-point column FFTs, pass A: only the rows = ceil(length/m2)
//       non-zero input rows are read, and when they are at most half
//       (the engine's 2x zero pad) the first layer of each register DFT
//       is pruned;
//   1B  pass B of the column FFTs, then the twiddle W_n^{k1*n2}; only
//       the window's k1 rows are kept;
//   2A, 2B  m2-point row FFTs of the window's rows; only bins
//       k2 < cols are stored.
template <int M1, int M2, class MakeStore>
__device__ __forceinline__ void forward(float2* sm, const float* xs,
                                        int length, const Plan& P,
                                        int k1_start, int k1_n,
                                        MakeStore make_store) {
  using S = Shape<M1, M2>;
  constexpr int P1 = S::P1, Q1 = S::Q1, P2 = S::P2, Q2 = S::Q2;
  constexpr int LD = S::LD, NT = S::THREADS, COLS = S::COLS;
  const int tid = threadIdx.x;
  // W_m1^j and W_m2^j: row 1 of the DFT factors.
  const float* w1r = P.f1r + M1;
  const float* w1i = P.f1i + M1;
  const float* w2r = P.f2r + M2;
  const float* w2i = P.f2i + M2;

  // 1A: item (b, n2); inputs n1 = Q1*a + b of column n2; row c*Q1 + b.
  {
    constexpr int ITEMS = Q1 * M2, IPT = per_thread<ITEMS, NT>();
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
        dft_low_half<P1, false>(re, im);
      else
        dft<P1, false>(re, im);
#pragma unroll
      for (int c = 0; c < P1; ++c) {
        float vr = re[brev<P1>(c)], vi = im[brev<P1>(c)];
        cmul<false>(vr, vi, __ldg(w1r + b * c), __ldg(w1i + b * c));
        sm[(c * Q1 + b) * LD + n2] = make_float2(vr, vi);
      }
    }
  }
  __syncthreads();

  // 1B: item (c, n2); Q1-point DFTs over b; k1 = c + P1*d, times
  // W_n^{k1*n2}; the window's rows go to rows k1 - k1_start.
  {
    constexpr int ITEMS = P1 * M2, IPT = per_thread<ITEMS, NT>();
    float re[IPT][Q1], im[IPT][Q1];
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (ITEMS % NT != 0 && item >= ITEMS) break;
      const int n2 = item % M2, c = item / M2;
#pragma unroll
      for (int b = 0; b < Q1; ++b)
        sload(sm[(c * Q1 + b) * LD + n2], re[it][b], im[it][b]);
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (ITEMS % NT != 0 && item >= ITEMS) break;
      const int n2 = item % M2, c = item / M2;
      dft<Q1, false>(re[it], im[it]);
#pragma unroll
      for (int d = 0; d < Q1; ++d) {
        const int k1 = c + P1 * d, kk = k1 - k1_start;
        if (kk < 0 || kk >= k1_n) continue;
        float vr = re[it][brev<Q1>(d)], vi = im[it][brev<Q1>(d)];
        cmul<false>(vr, vi, __ldg(P.twr + k1 * M2 + n2),
                    __ldg(P.twi + k1 * M2 + n2));
        sm[kk * LD + n2] = make_float2(vr, vi);
      }
    }
  }
  __syncthreads();

  // 2A: item (kk, b2), kk fastest; inputs n2 = Q2*a + b2 of row kk;
  // output c2 goes to column b2*P2 + c2.
  {
    constexpr int IPT = per_thread<M1 * Q2, NT>();
    const int items = k1_n * Q2;
    float re[IPT][P2], im[IPT][P2];
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (item >= items) break;
      const int kk = item % k1_n, b2 = item / k1_n;
#pragma unroll
      for (int a = 0; a < P2; ++a)
        sload(sm[kk * LD + Q2 * a + b2], re[it][a], im[it][a]);
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (item >= items) break;
      const int kk = item % k1_n, b2 = item / k1_n;
      dft<P2, false>(re[it], im[it]);
#pragma unroll
      for (int c2 = 0; c2 < P2; ++c2) {
        float vr = re[it][brev<P2>(c2)], vi = im[it][brev<P2>(c2)];
        cmul<false>(vr, vi, __ldg(w2r + b2 * c2), __ldg(w2i + b2 * c2));
        sm[kk * LD + b2 * P2 + c2] = make_float2(vr, vi);
      }
    }
  }
  __syncthreads();

  // 2B: item (kk, c2), c2 fastest; Q2-point DFTs over b2; bin
  // k2 = c2 + P2*d2 stored when k2 < cols.
  {
    const int items = k1_n * P2;
    const auto store = make_store();
    for (int item = tid; item < items; item += NT) {
      const int c2 = item % P2, kk = item / P2;
      float re[Q2], im[Q2];
#pragma unroll
      for (int b = 0; b < Q2; ++b) sload(sm[kk * LD + b * P2 + c2], re[b], im[b]);
      dft<Q2, false>(re, im);
#pragma unroll
      for (int d2 = 0; d2 <= Q2 / 2; ++d2) {
        const int k2 = c2 + P2 * d2;
        if (k2 < COLS) store(kk, k2, re[brev<Q2>(d2)], im[brev<Q2>(d2)]);
      }
    }
  }
}

// Inverse from the weighted half spectrum over a window of k1_n rows,
// run by a whole block of Shape<M1, M2>::THREADS threads.  On entry `sm`
// ([M1][LD] float2) holds row k1 = k1_start + kk at kk * LD, columns
// c < COLS, as Y[k1, c] * wn[k1, c] (multiplicity / n); the caller fills
// it and synchronises.  The real part of sample i of the window's
// partial inverse goes to store(i, v), once per sample, with
// store = make_store() made at pass 2'B.
//   1'A, 1'B  m2-point inverse row FFTs of the window's rows, with zeros
//       for c >= cols (pass A's register DFTs are pruned to the low half
//       plus the one bin c = m2/2), then the conjugate twiddle;
//   2'A, 2'B  m1-point inverse column FFTs with zeros outside the
//       window's rows, real part only.
template <int M1, int M2, class MakeStore>
__device__ __forceinline__ void inverse(float2* sm, const Plan& P,
                                        int k1_start, int k1_n,
                                        MakeStore make_store) {
  using S = Shape<M1, M2>;
  constexpr int P1 = S::P1, Q1 = S::Q1, P2 = S::P2, Q2 = S::Q2;
  constexpr int LD = S::LD, NT = S::THREADS;
  const int tid = threadIdx.x;
  const float* w1r = P.f1r + M1;
  const float* w1i = P.f1i + M1;
  const float* w2r = P.f2r + M2;
  const float* w2i = P.f2i + M2;

  // 1'A: item (kk, b), kk fastest; inputs c = Q2*a + b, non-zero for
  // a < P2/2 and, at b = 0, a = P2/2 (bin m2/2, added as (-1)^c2 times
  // its value); output c2 goes to column b*P2 + c2, times W_m2^{-b*c2}.
  {
    constexpr int IPT = per_thread<M1 * Q2, NT>();
    const int items = k1_n * Q2;
    float re[IPT][P2], im[IPT][P2], er[IPT], ei[IPT];
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (item >= items) break;
      const int kk = item % k1_n, b = item / k1_n;
#pragma unroll
      for (int a = 0; a < P2 / 2; ++a)
        sload(sm[kk * LD + Q2 * a + b], re[it][a], im[it][a]);
      er[it] = ei[it] = 0.f;
      if (b == 0) sload(sm[kk * LD + M2 / 2], er[it], ei[it]);
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (item >= items) break;
      const int kk = item % k1_n, b = item / k1_n;
      dft_low_half<P2, true>(re[it], im[it]);
#pragma unroll
      for (int c2 = 0; c2 < P2; ++c2) {
        const float sgn = (c2 & 1) ? -1.f : 1.f;
        float vr = re[it][brev<P2>(c2)] + sgn * er[it];
        float vi = im[it][brev<P2>(c2)] + sgn * ei[it];
        cmul<true>(vr, vi, __ldg(w2r + b * c2), __ldg(w2i + b * c2));
        sm[kk * LD + b * P2 + c2] = make_float2(vr, vi);
      }
    }
  }
  __syncthreads();

  // 1'B: item (kk, c2), c2 fastest; Q2-point inverse DFTs over b;
  // n2 = c2 + P2*d, times conj(W_n^{k1*n2}); V[kk][n2] in place.
  {
    constexpr int IPT = per_thread<M1 * P2, NT>();
    const int items = k1_n * P2;
    float re[IPT][Q2], im[IPT][Q2];
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (item >= items) break;
      const int c2 = item % P2, kk = item / P2;
#pragma unroll
      for (int b = 0; b < Q2; ++b)
        sload(sm[kk * LD + b * P2 + c2], re[it][b], im[it][b]);
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (item >= items) break;
      const int c2 = item % P2, kk = item / P2, k1 = k1_start + kk;
      dft<Q2, true>(re[it], im[it]);
#pragma unroll
      for (int d = 0; d < Q2; ++d) {
        const int n2 = c2 + P2 * d;
        float vr = re[it][brev<Q2>(d)], vi = im[it][brev<Q2>(d)];
        cmul<true>(vr, vi, __ldg(P.twr + k1 * M2 + n2),
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
    constexpr int ITEMS = Q1 * M2, IPT = per_thread<ITEMS, NT>();
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
        if (kk >= 0 && kk < k1_n) sload(sm[kk * LD + n2], re[it][a], im[it][a]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < IPT; ++it) {
      const int item = tid + it * NT;
      if (ITEMS % NT != 0 && item >= ITEMS) break;
      const int n2 = item % M2, b = item / M2;
      dft<P1, true>(re[it], im[it]);
#pragma unroll
      for (int c = 0; c < P1; ++c) {
        float vr = re[it][brev<P1>(c)], vi = im[it][brev<P1>(c)];
        cmul<true>(vr, vi, __ldg(w1r + b * c), __ldg(w1i + b * c));
        sm[(c * Q1 + b) * LD + n2] = make_float2(vr, vi);
      }
    }
  }
  __syncthreads();

  // 2'B: item (c, n2), n2 fastest; Q1-point inverse DFTs over b; the
  // real part of sample (c + P1*d)*m2 + n2 goes to the store.
  {
    constexpr int ITEMS = P1 * M2;
    const auto store = make_store();
    for (int item = tid; item < ITEMS; item += NT) {
      const int n2 = item % M2, c = item / M2;
      float re[Q1], im[Q1];
#pragma unroll
      for (int b = 0; b < Q1; ++b) sload(sm[(c * Q1 + b) * LD + n2], re[b], im[b]);
      dft<Q1, true>(re, im);
#pragma unroll
      for (int d = 0; d < Q1; ++d) store((c + P1 * d) * M2 + n2, re[brev<Q1>(d)]);
    }
  }
}

// Overlap-add store of one (stream, block, channel) inverse of n = 2*B
// samples: sample i goes to its head half head[i] or, past B, to the
// head of the next block (next[i - B]), or to the new tail at the last
// block (next == nullptr).  head and next are pre-set (to tail_in at the
// first block, zero after), so every output sample receives exactly two
// terms, the head of block t and the tail of block t-1; a two-term float
// sum is the same in either order, so the atomics leave a deterministic
// result equal to head + tail.
struct OlaStore {
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

template <int A, int B>
struct Sizes {
  static constexpr int M1 = A, M2 = B;
};

// Calls f(Sizes<m1, m2>{}) for the factorisations rfft._split_factors
// gives for n = 128 ... 16384; cudaErrorInvalidValue for any other.
template <class F>
int with_sizes(int m1, int m2, F&& f) {
  if (m1 == 16 && m2 == 8) return f(Sizes<16, 8>{});
  if (m1 == 16 && m2 == 16) return f(Sizes<16, 16>{});
  if (m1 == 32 && m2 == 16) return f(Sizes<32, 16>{});
  if (m1 == 32 && m2 == 32) return f(Sizes<32, 32>{});
  if (m1 == 64 && m2 == 32) return f(Sizes<64, 32>{});
  if (m1 == 64 && m2 == 64) return f(Sizes<64, 64>{});
  if (m1 == 128 && m2 == 64) return f(Sizes<128, 64>{});
  if (m1 == 128 && m2 == 128) return f(Sizes<128, 128>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace radix
}  // namespace folve
