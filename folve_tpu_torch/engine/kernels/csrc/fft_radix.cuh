// Radix FFTs in shared memory and registers: the building blocks of the
// forward (fft_half.cu) and inverse (ifft_half.cu) kernels.
//
// Both kernels keep the four-step factorisation n = m1*m2 of
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
